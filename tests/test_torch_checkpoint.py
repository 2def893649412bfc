"""Checkpoint and restore in the port, against the JAX package.

Mirrors ``test_session_api.py``'s checkpoint scenarios and
``test_fleet.py``'s store scenarios. Each runs through the JAX package's
``StreamEngine`` and the port's on the same inputs at the same batch
shape (the shared set-up below): the rows come out in the same order
with the same results, and the exported carries (numpy arrays keyed
conv1/conv2/fc1/fc2) equal the JAX package's. Inside the port, restore
into a fresh engine equals the uninterrupted run bit for bit, at B in
{1, 8} and pipeline depths 0 and 1, with a parked carry and queued
windows at the cut; an export/import round trip is exact.

The shared set-up of the four serving-surface test files
(``test_torch_{checkpoint,deadline,lane_control,recovery}.py``) lives
here, above this file's tests; the other three import it. A
:class:`Side` is one package's serving surface at the tests' small size
(``SNNConfig(32x32, T=4, conv 4/8, fc 32->11)`` and the JAX package's TCN
smoke config): its engines, policies, sessions, fault injector and store.
Each scenario is written once as a function of a side and run through the
JAX package and the port on the same inputs: the same numpy weights
(He-init from a numpy seed, the SNN's rounded to multiples of 2**-8, so
every current is exact and the event wing agrees bit for bit; each
package ternarizes and packs the TCN's float weights itself) and windows
from the same numpy generators and seeds.

Tolerances between the packages: labels, event-wing logits and energy
equal; PWM within ``PWM_ATOL`` (the softmax's exp and sum round
differently); frame and fused logits within ``FRAME_LOGITS_ATOL`` (the
frame convs sum in another order than XLA's; ``test_torch_tcn.py``).
Inside the port, every contract is bit for bit.
"""
import dataclasses
import functools
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

PWM_ATOL = 1e-6
FRAME_LOGITS_ATOL = 1e-5
LAYERS = ("conv1", "conv2", "fc1", "fc2")
SIZE = dict(height=32, width=32)
NET = dict(conv1_features=4, conv2_features=8, hidden=32, num_classes=11)


def _he(rng, shape, fan_in, gain, dyadic):
    w = rng.normal(size=shape) * gain * np.sqrt(2.0 / fan_in)
    if dyadic:
        w = np.round(w * 256.0) / 256.0
    return w.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _np_weights():
    """(SNN weights rounded to 2**-8, float TCN weights): He-init numpy
    trees in the JAX package's layout (HWIO convs)."""
    from repro_torch.configs import TCN_SMOKE
    from repro_torch.core.snn import SNNConfig
    out = []
    for seed, cfg, dyadic in ((0, SNNConfig(time_bins=4, **NET, **SIZE),
                               True), (1, TCN_SMOKE, False)):
        rng = np.random.default_rng(seed)
        g = cfg.init_gain
        out.append({
            "conv1": {"w": _he(rng, (3, 3, cfg.in_channels,
                                     cfg.conv1_features),
                               9 * cfg.in_channels, g, dyadic)},
            "conv2": {"w": _he(rng, (3, 3, cfg.conv1_features,
                                     cfg.conv2_features),
                               9 * cfg.conv1_features, g, dyadic)},
            "fc1": {"w": _he(rng, (cfg.flat_dim, cfg.hidden), cfg.flat_dim,
                             g, dyadic)},
            "fc2": {"w": _he(rng, (cfg.hidden, cfg.num_classes), cfg.hidden,
                             g, dyadic)},
        })
    return tuple(out)


class Stub:
    """A minimal split-less, stateless engine: items are int tokens whose
    value is echoed in the logits, so results are checkable."""

    def __init__(self, result_cls, modality="stub"):
        self.result_cls = result_cls
        self.modality = modality
        self.duration_us = None
        self.infer_calls = 0

    def validate(self, item):
        pass

    def prepare(self, items, *, batch_size):
        assert len(items) == batch_size
        return list(items)

    def shape_key(self, batch):
        return (len(batch),)

    def _result(self, it):
        return self.result_cls(
            label_pred=np.zeros(1, np.int64), pwm=np.zeros((1, 4)),
            latency_ms=1.0, energy_mj=1.0, breakdown={}, realtime=True,
            sustained_rate_hz=1.0,
            logits=np.full((1, 4), float(it), np.float32))

    def infer(self, batch):
        self.infer_calls += 1
        return [None if it is None else self._result(it) for it in batch]


class WarmStub(Stub):
    """Stub + the warmup surface, recording every warm call."""

    def __init__(self, result_cls, modality="stub"):
        super().__init__(result_cls, modality)
        self.warmed = []
        self._compiled = set()

    def warmup(self, shape_keys):
        self.warmed.append(tuple(shape_keys))
        self._compiled.update(shape_keys)

    def compiled_shape_keys(self):
        return set(self._compiled)

    def infer(self, batch):
        self._compiled.add((len(batch),))
        return super().infer(batch)


class Side:
    """One package's serving surface: ``Side("jax")`` or ``Side("port")``."""

    def __init__(self, name):
        self.name = name
        snn, tcn = _np_weights()
        if name == "jax":
            import jax.numpy as jnp

            from repro.core import FrameTCNEngine, SNNConfig, TCNConfig
            from repro.core import events, frames
            from repro.core._api import (EngineConfig, FaultConfig,
                                         RecoveryConfig)
            from repro.core.pipeline import (BatchedClosedLoop,
                                             ClosedLoopResult)
            from repro.fleet import (CheckpointStore, FaultInjector,
                                     InjectedFault)
            from repro.serving import (DeadlinePolicy, FairQuantumPolicy,
                                       FusionSession, StreamCheckpoint,
                                       StreamEngine, StreamStats,
                                       late_logit_fusion)
            from repro.core.tcn import pack_tcn
            cfg = SNNConfig(time_bins=4, **NET, **SIZE)
            tcfg = TCNConfig(**NET, **SIZE)
            params = jax.tree_util.tree_map(jnp.asarray, snn)
            tpacked = pack_tcn(jax.tree_util.tree_map(jnp.asarray, tcn))
            self.loop = lambda **kw: BatchedClosedLoop(params, cfg, **kw)
            self.frame = lambda **kw: FrameTCNEngine(
                tpacked, tcfg, prepacked=True, **kw)
        else:
            from repro_torch.configs import TCN_SMOKE
            from repro_torch.convert import (snn_params_from_numpy,
                                             tcn_params_from_numpy)
            from repro_torch.core import events, frames
            from repro_torch.core._api import (EngineConfig, FaultConfig,
                                               RecoveryConfig)
            from repro_torch.core.engine import FrameTCNEngine
            from repro_torch.core.pipeline import (BatchedClosedLoop,
                                                   ClosedLoopResult)
            from repro_torch.core.snn import SNNConfig
            from repro_torch.core.tcn import pack_tcn
            from repro_torch.fleet import (CheckpointStore, FaultInjector,
                                           InjectedFault)
            from repro_torch.serving import (DeadlinePolicy,
                                             FairQuantumPolicy,
                                             FusionSession, StreamCheckpoint,
                                             StreamEngine, StreamStats,
                                             late_logit_fusion)
            cfg = SNNConfig(time_bins=4, **NET, **SIZE)
            tcfg = TCN_SMOKE
            params = snn_params_from_numpy(snn)
            tpacked = pack_tcn(tcn_params_from_numpy(tcn))
            self.loop = lambda **kw: BatchedClosedLoop(
                params, cfg, device="cpu", **kw)
            self.frame = lambda **kw: FrameTCNEngine(
                tpacked, tcfg, prepacked=True, device="cpu", **kw)
        self.cfg, self.tcfg = cfg, tcfg
        self.events, self.frames_mod = events, frames
        self.EngineConfig, self.RecoveryConfig = EngineConfig, RecoveryConfig
        self.FaultConfig, self.FaultInjector = FaultConfig, FaultInjector
        self.InjectedFault, self.CheckpointStore = (InjectedFault,
                                                    CheckpointStore)
        self.DeadlinePolicy = DeadlinePolicy
        self.FairQuantumPolicy = FairQuantumPolicy
        self.FusionSession, self.StreamEngine = FusionSession, StreamEngine
        self.StreamCheckpoint, self.StreamStats = (StreamCheckpoint,
                                                   StreamStats)
        self.late_logit_fusion = late_logit_fusion
        self.ClosedLoopResult = ClosedLoopResult

    def __repr__(self):
        return f"<Side {self.name}>"

    # -- inputs ------------------------------------------------------------

    def windows(self, n, seed, mean_events=1500):
        rng = np.random.default_rng(seed)
        return [self.events.synthetic_gesture_events(
            rng, (seed + i) % 11, mean_events=mean_events, **SIZE)
            for i in range(n)]

    def frames(self, n, seed):
        rng = np.random.default_rng(seed)
        return [self.frames_mod.synthetic_gesture_frames(
            rng, (seed + i) % 11, **SIZE) for i in range(n)]

    # -- engines -----------------------------------------------------------

    def stub(self, modality="stub", warm=False):
        return (WarmStub if warm else Stub)(self.ClosedLoopResult, modality)

    def engine(self, lanes=("event",), wrap=None, **config):
        """A StreamEngine over fresh engines for ``lanes`` ("event",
        "frame", or stub engines passed in), each wrapped by ``wrap``."""
        engines = [self.loop() if m == "event" else
                   self.frame() if m == "frame" else m for m in lanes]
        if wrap is not None:
            engines = [wrap(e) for e in engines]
        return self.StreamEngine(engines=engines,
                                 config=self.EngineConfig(**config))

    def alone(self, stream_id, windows, stateful=True):
        """One stream's windows served alone on a fresh 1-slot engine, in
        seq order: the uninterrupted run. The port's own contracts are
        held against it, so only the port's side runs it (``None`` on the
        JAX side, which would only compile another engine)."""
        if self.name != "port":
            return None
        eng = self.engine(max_streams=1)
        h = eng.open(stream_id=stream_id, stateful=stateful)
        for w in windows:
            h.submit(w)
        return sorted(eng.run(), key=lambda r: r.seq)


SIDES = ("jax", "port")


@functools.lru_cache(maxsize=None)
def side(name):
    return Side(name)


def both(scenario, *args, **kw):
    """``scenario(side, ...)`` run through the JAX package and the port."""
    return scenario(side("jax"), *args, **kw), \
        scenario(side("port"), *args, **kw)


def key(rows):
    return [(r.stream_id, r.seq, r.status, r.modality) for r in rows]


def assert_result_close(want, got, exact):
    """A JAX result against the port's: labels and energy equal; logits
    equal (``exact``, the event wing) or within ``FRAME_LOGITS_ATOL``;
    PWM within ``PWM_ATOL``."""
    np.testing.assert_array_equal(np.asarray(want.label_pred),
                                  np.asarray(got.label_pred))
    if exact:
        np.testing.assert_array_equal(np.asarray(want.logits), got.logits)
    else:
        np.testing.assert_allclose(got.logits, np.asarray(want.logits),
                                   rtol=0, atol=FRAME_LOGITS_ATOL)
    np.testing.assert_allclose(got.pwm, np.asarray(want.pwm), rtol=0,
                               atol=PWM_ATOL)
    assert want.energy_mj == got.energy_mj


def assert_rows_match(want, got):
    """JAX rows against the port's: same order of (stream, seq, status,
    modality), results as :func:`assert_result_close`."""
    assert key(want) == key(got)
    for a, b in zip(want, got):
        assert (a.result is None) == (b.result is None)
        if a.result is not None:
            assert_result_close(a.result, b.result,
                                exact=a.modality == "event")


def assert_bitwise(want, got):
    """Two runs of the port (or two of one package): same results, bit
    for bit, matched by (stream, seq)."""
    a = {(r.stream_id, r.seq): r for r in want}
    b = {(r.stream_id, r.seq): r for r in got}
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = a[k].result, b[k].result
        assert a[k].status == b[k].status
        if x is None:
            assert y is None
            continue
        for f in ("label_pred", "logits", "pwm"):
            np.testing.assert_array_equal(np.asarray(getattr(x, f)),
                                          np.asarray(getattr(y, f)))
        assert x.energy_mj == y.energy_mj and x.latency_ms == y.latency_ms


def assert_carry_equal(want, got):
    """Exported carries (numpy arrays by layer) equal bit for bit."""
    if want is None:
        assert got is None
        return
    assert set(want) == set(got) == set(LAYERS)
    for k in LAYERS:
        assert isinstance(got[k], np.ndarray)
        np.testing.assert_array_equal(np.asarray(want[k]), got[k])


def fault_kinds(eng):
    return [(f["kind"], f["modality"], f["stream"], f["seq"])
            for f in eng.fault_log]

def _migrate(s, b, depth, full=4, cut=2):
    """``b + 1`` stateful streams over ``b`` slots (so at least one carry
    is parked at the cut): windows [0, cut) served on engine A, window
    ``cut`` queued, every stream checkpointed (through pickle), restored
    into a fresh engine B, and the rest served there. Returns (rows of A
    then B, checkpoints, rows of one uninterrupted engine)."""
    streams = {f"cam{i}": s.windows(full, seed=120 + 5 * i + b)
               for i in range(b + 1)}

    def engine():
        return s.engine(max_streams=b, pipeline_depth=depth)

    eng_a = engine()
    h_a = {sid: eng_a.open(stream_id=sid, stateful=True) for sid in streams}
    for sid, ws in streams.items():
        for w in ws[:cut]:
            h_a[sid].submit(w)
    rows = eng_a.run()
    for sid, ws in streams.items():
        h_a[sid].submit(ws[cut])
    assert eng_a._lanes["event"].parked
    ckpts = pickle.loads(pickle.dumps(
        {sid: h.checkpoint() for sid, h in h_a.items()}))
    eng_b = engine()
    h_b = {sid: eng_b.restore(ckpts[sid]) for sid in streams}
    for sid, ws in streams.items():
        assert h_b[sid].queued == 1 and h_b[sid].next_seq == cut + 1
        for w in ws[cut + 1:]:
            h_b[sid].submit(w)
    rows += eng_b.run()
    if s.name != "port":
        return rows, ckpts, None
    whole = engine()
    h_w = {sid: whole.open(stream_id=sid, stateful=True) for sid in streams}
    for sid, ws in streams.items():
        for w in ws:
            h_w[sid].submit(w)
    return rows, ckpts, whole.run()


@pytest.mark.parametrize("depth", [0, 1], ids=["sync", "pipelined"])
@pytest.mark.parametrize("b", [1, 8])
def test_checkpoint_restore_roundtrip(b, depth):
    (j_rows, j_ck, _), (t_rows, t_ck, t_whole) = both(_migrate, b, depth)
    assert len(t_rows) == 4 * (b + 1)
    assert_rows_match(j_rows, t_rows)
    for sid, ck in t_ck.items():
        assert ck.next_seq == 3 and [q[1] for q in ck.queued] == [2]
        assert ck.stateful and ck.duration_us == j_ck[sid].duration_us
        assert_carry_equal(j_ck[sid].state, ck.state)
    assert_bitwise(t_whole, t_rows)


def _queued_and_deadline(s):
    """A checkpoint taken with one window served and one queued, on a
    handle with a default deadline: both migrate."""
    ws = s.windows(4, seed=140)
    eng_a = s.engine(max_streams=1)
    h = eng_a.open(stream_id="s", stateful=True, deadline=5.0)
    h.submit(ws[0])
    h.submit(ws[1], deadline=2.0)
    rows = eng_a.step()
    assert [r.seq for r in rows] == [0]
    ck = pickle.loads(pickle.dumps(h.checkpoint()))
    assert ck.next_seq == 2 and ck.deadline == 5.0
    assert [(q[1], q[2]) for q in ck.queued] == [(1, 2.0)]
    eng_b = s.engine(max_streams=1)
    h_b = eng_b.restore(ck)
    assert h_b.queued == 1 and h_b.stats.queued == 1 and h_b.deadline == 5.0
    h_b.submit(ws[2])
    h_b.submit(ws[3])
    assert [q.deadline for q in eng_b._lanes["event"].queues["s"]] == [
        2.0, 5.0, 5.0]
    rows += eng_b.run()
    assert [r.seq for r in rows] == [0, 1, 2, 3]
    # The restored carry is re-exported unchanged (contract 4).
    again = eng_b.open(stream_id="t", stateful=True).restore(
        dataclasses.replace(ck, stream_id="t", queued=()))
    return rows, ck, again.checkpoint(), s.alone("s", ws)


def test_checkpoint_carries_queued_windows_and_deadline():
    (j_rows, j_ck, _, _), (t_rows, t_ck, t_again, t_alone) = both(
        _queued_and_deadline)
    assert_rows_match(j_rows, t_rows)
    assert_carry_equal(j_ck.state, t_ck.state)
    assert_carry_equal(t_ck.state, t_again.state)
    assert_bitwise(t_alone, t_rows)


def _parked_and_cold(s):
    """Two stateful streams over one slot: at the checkpoint one carry is
    in the state buffer, the other parked; a third stream never served
    checkpoints a cold start (``state=None``)."""
    streams = {"s0": s.windows(4, seed=130), "s1": s.windows(4, seed=131)}
    eng_a = s.engine(max_streams=1)
    h_a = {sid: eng_a.open(stream_id=sid, stateful=True) for sid in streams}
    cold = eng_a.open(stream_id="cold", stateful=True)
    for sid, ws in streams.items():
        for w in ws[:2]:
            h_a[sid].submit(w)
    rows = eng_a.run()
    lane = eng_a._lanes["event"]
    assert list(lane.parked) and any(o in streams
                                     for o in lane.state_streams)
    ckpts = {sid: h.checkpoint() for sid, h in h_a.items()}
    assert cold.checkpoint().state is None
    eng_b = s.engine(max_streams=1)
    for sid, ws in streams.items():
        h = eng_b.restore(ckpts[sid])
        for w in ws[2:]:
            h.submit(w)
    rows += eng_b.run()
    return rows, ckpts, {sid: s.alone(sid, ws)
                        for sid, ws in streams.items()}


def test_checkpoint_of_parked_carry():
    (j_rows, j_ck, _), (t_rows, t_ck, t_alone) = both(_parked_and_cold)
    assert_rows_match(j_rows, t_rows)
    for sid in t_ck:
        assert_carry_equal(j_ck[sid].state, t_ck[sid].state)
        assert_bitwise(t_alone[sid],
                       [r for r in t_rows if r.stream_id == sid])


@pytest.mark.parametrize("name", ["jax", "port"])
def test_checkpoint_rejects_inflight_windows(name):
    s = side(name)
    eng = s.engine(max_streams=1, pipeline_depth=1)
    h = eng.open(stream_id="s", stateful=True)
    h.submit(s.windows(1, seed=150)[0])
    eng.step()                                   # dispatched, uncollected
    with pytest.raises(ValueError, match="in-flight"):
        h.checkpoint()
    eng.flush()
    assert h.checkpoint().next_seq == 1


@pytest.mark.parametrize("name", ["jax", "port"])
def test_restore_validation(name):
    s = side(name)
    ws = s.windows(2, seed=160)
    eng = s.engine(max_streams=1)
    h = eng.open(stream_id="s", stateful=True)
    h.submit(ws[0])
    eng.run()
    ck = h.checkpoint()
    with pytest.raises(ValueError, match="fresh"):
        h.restore(ck)
    with pytest.raises(ValueError, match="stateful"):
        s.engine(max_streams=1).open(stream_id="s").restore(ck)
    eng_c = s.engine(max_streams=1, duration_us=150_000)
    with pytest.raises(ValueError, match="duration_us"):
        eng_c.restore(ck)
    assert eng_c.handles == {}                   # half-open handle closed
    eng_d = s.engine(max_streams=1)
    assert eng_d.restore(ck).stream_id == "s"
    assert eng_d.restore(ck, stream_id="s2").stream_id == "s2"
    with pytest.raises(ValueError, match="no engine"):
        eng_d.restore(dataclasses.replace(ck, modality="frame"))
    with pytest.raises(ValueError, match="carried-state"):
        s.engine(lanes=(s.stub(),)).open(stateful=True)


@pytest.mark.parametrize("name", ["jax", "port"])
def test_restore_validates_queued_windows(name):
    """A checkpointed frame an engine cannot serve rejects the restore up
    front, and the duration latched while validating is rolled back."""
    s = side(name)
    fr_eng = s.engine(lanes=("frame",), max_streams=1)
    h = fr_eng.open(stream_id="cam")
    h.submit(s.frames(1, seed=260)[0])           # queued, unserved
    ck = h.checkpoint()
    small = s.frames_mod.synthetic_gesture_frames(
        np.random.default_rng(0), 1, height=16, width=16)
    with pytest.raises(ValueError, match="geometry"):
        fr_eng.open(stream_id="x").submit(small)
    other = s.engine(lanes=("frame",), max_streams=1)
    bad = dataclasses.replace(ck, queued=((small, 0, None),))
    with pytest.raises(ValueError, match="geometry"):
        other.restore(bad)
    assert other.handles == {}
    assert other.engines["frame"].duration_us is None
    assert other.restore(ck).queued == 1
    assert [r.seq for r in other.run()] == [0]


def _fusion_migrate(s, n=4, cut=2):
    """A stateful FusionSession checkpointed after ``cut`` ticks (through
    pickle), restored on a fresh engine, and run on: rows, the checkpoint
    and an uninterrupted session's rows."""
    evs, frs = s.windows(n, seed=220), s.frames(n, seed=221)

    def engine():
        return s.engine(lanes=("event", "frame"), max_streams=1)

    ref = None
    if s.name == "port":
        oracle = s.FusionSession(engine(), session_id="o", stateful=True)
        for k in range(n):
            oracle.submit(evs[k], frs[k])
        ref = oracle.run()
    sess_a = s.FusionSession(engine(), session_id="m", stateful=True)
    for k in range(cut):
        sess_a.submit(evs[k], frs[k])
    got = sess_a.run()
    ck = pickle.loads(pickle.dumps(sess_a.checkpoint()))
    sess_b = s.FusionSession.restore(engine(), ck)
    assert sess_b.session_id == "m" and sess_b.event.next_seq == cut
    for k in range(cut, n):
        sess_b.submit(evs[k], frs[k])
    got += sess_b.run()
    return got, ck, ref


def test_fusion_session_checkpoint_restore():
    (j_got, j_ck, _), (t_got, t_ck, t_ref) = both(_fusion_migrate)
    assert_rows_match(j_got, t_got)
    assert t_ck["next_tick"] == j_ck["next_tick"] == 2
    assert t_ck["fusion_rule"] == j_ck["fusion_rule"]
    for wing in ("event", "frame"):
        assert t_ck[wing].next_seq == j_ck[wing].next_seq
    assert_carry_equal(j_ck["event"].state, t_ck["event"].state)
    assert t_ck["frame"].state == {} == dict(j_ck["frame"].state)
    assert [r.seq for r in t_ref] == [r.seq for r in t_got] == [0, 1, 2, 3]
    for a, b in zip(t_ref, t_got):
        for f in ("label_pred", "logits", "pwm"):
            np.testing.assert_array_equal(getattr(a.result, f),
                                          getattr(b.result, f))
        assert a.result.energy_mj == b.result.energy_mj


@pytest.mark.parametrize("name", ["jax", "port"])
def test_fusion_restore_rule_and_cleanup(name):
    """A custom rule must be passed again; a wing that cannot restore
    strands nothing; a half-fused session refuses to checkpoint."""
    s = side(name)

    def engine(**kw):
        return s.engine(lanes=("event", "frame"), max_streams=1, **kw)

    sess = s.FusionSession(engine(), session_id="m", stateful=True,
                           fusion=s.late_logit_fusion(0.9, 0.1))
    sess.submit(s.windows(1, seed=250)[0], s.frames(1, seed=251)[0])
    sess.run()
    ck = sess.checkpoint()
    fresh = engine()
    with pytest.raises(ValueError, match="rules are code"):
        s.FusionSession.restore(fresh, ck)
    assert fresh.handles == {}
    target = s.engine(lanes=("event", s.frame(duration_us=150_000)),
                      max_streams=1)
    with pytest.raises(ValueError, match="duration_us"):
        s.FusionSession.restore(target, ck,
                                fusion=s.late_logit_fusion(0.9, 0.1))
    assert target.handles == {}                  # nothing stranded
    ok = s.FusionSession.restore(fresh, ck,
                                 fusion=s.late_logit_fusion(0.9, 0.1))
    assert ok.session_id == "m"
    ok._pending["event"][0] = object()
    with pytest.raises(ValueError, match="half-fused"):
        ok.checkpoint()


def _store_scenario(s):
    """A session and a stream through a CheckpointStore: single-use ids,
    fresh copies, LRU eviction, failed restores keep the checkpoint."""
    store = s.CheckpointStore(capacity=2)
    evs, frs = s.windows(3, seed=300), s.frames(3, seed=301)
    sess = s.FusionSession(s.engine(lanes=("event", "frame"), max_streams=1),
                           session_id="f", stateful=True)
    sess.submit(evs[0], frs[0])
    rows = sess.run()
    sid = sess.checkpoint_to(store)
    assert store.ids() == [sid]
    dst = s.engine(lanes=("event", "frame"), max_streams=1)
    moved = s.FusionSession.restore_from(dst, store, sid)
    with pytest.raises(ValueError, match="single-use"):
        s.FusionSession.restore_from(dst, store, sid)
    for k in (1, 2):
        moved.submit(evs[k], frs[k])
    rows += moved.run()

    src = s.engine(max_streams=1)
    h = src.open(stream_id="s", stateful=True)
    h.submit(evs[0])
    h.submit(evs[1])
    src.step()
    cid = store.put(h.checkpoint())
    got = store.get(cid)
    assert got.next_seq == 2 and store.get(cid) is not got
    occupied = s.engine(max_streams=1)
    occupied.open(stream_id="s")
    with pytest.raises(ValueError):
        store.restore_into(occupied, cid)
    assert cid in store
    new = store.restore_into(occupied, cid, stream_id="s2")
    assert new.stream_id == "s2" and cid not in store
    with pytest.raises(ValueError, match="single-use"):
        store.get(cid)
    with pytest.raises(ValueError, match="already used"):
        store.put({"n": 0}, ckpt_id=cid)
    rows += occupied.run()
    a, b = store.put({"n": 1}), store.put({"n": 2})
    store.get(a)                                 # refresh a
    store.put({"n": 3})                          # evicts b, the LRU
    assert b not in store and a in store and store.stats["evicted"] == 1
    with pytest.raises(Exception):
        store.put(s.StreamCheckpoint(
            stream_id="x", modality="event", stateful=False, next_seq=0,
            duration_us=None, state=None, queued=((lambda: 0, 0, None),)))
    return rows


def test_store_and_session_checkpoint_to_restore_from():
    j_rows, t_rows = both(_store_scenario)
    assert_rows_match(j_rows, t_rows)
    assert [(r.stream_id, r.seq) for r in t_rows] == [
        ("f", 0), ("f", 1), ("f", 2), ("s2", 1)]
