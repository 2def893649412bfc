"""The port's seven serving and LM examples (``examples/torch_*.py``)
against the JAX package.

Each example runs once, in-process, through ``main(["--device", "cpu",
"--smoke"])`` (module-scoped fixtures), and the figures it returns are
held against the JAX package's objects run in this process on the same
numpy weights (``examples/torch_common``: He-init, the SNN's rounded to
2**-8) and on windows drawn from the same numpy generators and seeds, as
the JAX examples draw them:

  * event and frame examples (quickstart, closed_loop_control,
    multi_stream_control, hetero_control): labels, ``latency_ms`` and
    ``energy_mj`` equal, PWM within ``PWM_ATOL`` (the softmax's exp and
    sum round differently), the stateful tracker's and its twin's fc1
    firing rates equal;
  * fusion_control and fault_tolerant_control: the fused and degraded
    tick counts, fused labels and the supervisor's counts equal the JAX
    package's, and the port's own bitwise checks (the migration, every
    fused and recovered window against its uninterrupted run) pass;
  * serve_ternary_lm at ``--steps 0``: the quantization stats equal, and
    the fp and ternary greedy tokens equal the JAX package's from the
    same parameters.

No timing figure is asserted on the CPU (fusion_control runs with
``ratio_gate=False``; its ratio is a reading).
"""
import dataclasses
import functools
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
sys.path.insert(0, os.path.abspath(EXAMPLES))

import torch_closed_loop_control as closed_loop  # noqa: E402
import torch_common as common  # noqa: E402
import torch_fault_tolerant_control as fault_tolerant  # noqa: E402
import torch_fusion_control as fusion  # noqa: E402
import torch_hetero_control as hetero  # noqa: E402
import torch_multi_stream_control as multi_stream  # noqa: E402
import torch_quickstart as quickstart  # noqa: E402
import torch_serve_ternary_lm as serve_lm  # noqa: E402
from repro_torch.configs import SMOKE, TCN_SMOKE  # noqa: E402

PWM_ATOL = 1e-6
ARGS = ["--device", "cpu", "--smoke"]


@pytest.fixture(scope="module")
def port():
    """Every example's figures, each run once on the CPU at --smoke, on
    one intra-op thread: the tensors are tiny, and beside the suite's
    other workers the default thread count oversubscribes the cores (six
    concurrent runs took 73 s each instead of 2.8)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return {
            "quickstart": quickstart.main(ARGS),
            "closed_loop": closed_loop.main(ARGS),
            "multi_stream": multi_stream.main(ARGS),
            "hetero": hetero.main(ARGS),
            "fusion": fusion.main(ARGS, ratio_gate=False),
            "fault_tolerant": fault_tolerant.main(ARGS),
            "serve": serve_lm.main(ARGS + ["--steps", "0"]),
        }
    finally:
        torch.set_num_threads(threads)


class Jax:
    """The JAX package's side: its modules, and engines over the same
    numpy weights as the examples'."""

    def __init__(self):
        from repro.core import FrameTCNEngine, events, frames
        from repro.core._api import (EngineConfig, FaultConfig,
                                     RecoveryConfig)
        from repro.core.pipeline import BatchedClosedLoop
        from repro.fleet import (CheckpointStore, FaultInjector,
                                 LaneSupervisor)
        from repro.serving import (DeadlinePolicy, FusionSession,
                                   StreamEngine, late_logit_fusion)
        self.FrameTCNEngine, self.events, self.frames = (
            FrameTCNEngine, events, frames)
        self.EngineConfig, self.FaultConfig, self.RecoveryConfig = (
            EngineConfig, FaultConfig, RecoveryConfig)
        self.BatchedClosedLoop = BatchedClosedLoop
        self.CheckpointStore, self.FaultInjector = (CheckpointStore,
                                                    FaultInjector)
        self.LaneSupervisor, self.DeadlinePolicy = (LaneSupervisor,
                                                    DeadlinePolicy)
        self.FusionSession, self.StreamEngine = FusionSession, StreamEngine
        self.late_logit_fusion = late_logit_fusion
        as_j = functools.partial(jax.tree_util.tree_map, jnp.asarray)
        self.snn = as_j(common.np_snn_params(SMOKE))
        self.tcn = as_j(common.np_tcn_params(TCN_SMOKE))
        # One engine of each wing, shared by every StreamEngine the tests
        # build: an engine holds no stream state (the lanes do), and each
        # new instance would trace and lower its steps again.
        self.ev = self.BatchedClosedLoop(self.snn, SMOKE)
        self.fr = self.FrameTCNEngine(self.tcn, TCN_SMOKE)

    def event(self):
        return self.ev

    def frame(self):
        return self.fr

    def pipe(self, window):
        """``ClosedLoopPipeline(params, cfg)(window)``: the B=1 call of
        the shared event engine."""
        return self.ev.infer_windows([window])[0]

    def window(self, rng, label, mean_events):
        return self.events.synthetic_gesture_events(
            rng, label, mean_events=mean_events, height=SMOKE.height,
            width=SMOKE.width)

    def head_ticks(self, seed, n):
        """``torch_common.Wings.ticks`` drawn by the JAX package."""
        rng = np.random.default_rng(seed)
        out = []
        for k in range(n):
            label = k % SMOKE.num_classes
            out.append((self.window(rng, label, 4000),
                        self.frames.synthetic_gesture_frames(
                            rng, label, height=TCN_SMOKE.height,
                            width=TCN_SMOKE.width)))
        return out


@pytest.fixture(scope="module")
def jx():
    return Jax()


def _close(want, got):
    """A JAX result against an example's row: label, latency and energy
    equal, PWM within PWM_ATOL."""
    assert int(np.asarray(want.label_pred)[0]) == got["label"]
    np.testing.assert_allclose(got["pwm"], np.asarray(want.pwm)[0],
                               rtol=0, atol=PWM_ATOL)
    assert want.latency_ms == got["latency_ms"]
    assert want.energy_mj == got["energy_mj"]


def _by_key(rows):
    return {(r["stream"], r["seq"]): r for r in rows}


def test_quickstart(port, jx):
    rng = np.random.default_rng(0)
    w = jx.window(rng, quickstart.LABEL, 6000)
    got = port["quickstart"]
    assert got["num_events"] == w.num_events
    want = jx.pipe(w)
    _close(want, got)
    assert sorted(got["stages"]) == sorted(want.breakdown["stages"])
    for name, st in want.breakdown["stages"].items():
        assert got["stages"][name]["time_ms"] == st["time_ms"]


def test_closed_loop_control(port, jx):
    got = port["closed_loop"]
    rng = np.random.default_rng(7)
    for i, g in enumerate(closed_loop.GESTURES):
        want = jx.pipe(jx.window(rng, g, 5000))
        _close(want, {"label": got["labels"][i], "pwm": got["pwm"][i],
                      "latency_ms": got["latency_ms"][i],
                      "energy_mj": got["energy_mj"][i]})


def test_multi_stream_control(port, jx):
    """The same six streams over four slots through the JAX package's
    StreamEngine (a 1-device mesh serves exactly as none), then the
    stateful tracker beside its stateless twin."""
    got = port["multi_stream"]
    rng = np.random.default_rng(7)
    work = {f"cam{s}": [jx.window(rng, (s + k) % SMOKE.num_classes, 5000)
                        for k in range(multi_stream.WINDOWS_PER_STREAM)]
            for s in range(multi_stream.NUM_STREAMS)}
    repeated = jx.window(rng, 3, 5000)
    eng = jx.StreamEngine(jx.snn, SMOKE,
                          jx.EngineConfig(max_streams=multi_stream.SLOTS))
    hs = {sid: eng.open(stream_id=sid) for sid in work}
    for sid, ws in work.items():
        hs[sid].submit(ws[0])
    rows = eng.run()
    for sid, ws in work.items():
        for w in ws:
            hs[sid].submit(w)
    rows += eng.run()
    ports = _by_key(got["rows"])
    assert sorted(ports) == sorted((r.stream_id, r.seq) for r in rows)
    for r in rows:
        _close(r.result, ports[(r.stream_id, r.seq)])
    tracker = eng.open(stream_id="tracker", stateful=True)
    twin = eng.open(stream_id="twin")
    for _ in range(multi_stream.WINDOWS_PER_STREAM):
        tracker.submit(repeated)
        twin.submit(repeated)
    rates = {"tracker": {}, "twin": {}}
    for r in eng.run():
        rates[r.stream_id][r.seq] = r.result.breakdown["firing_rates"]["fc1"]
    for name, by_seq in rates.items():
        assert [float(by_seq[k]) for k in sorted(by_seq)] == \
            got["fc1_rates"][name]
    assert len(set(got["fc1_rates"]["twin"])) == 1
    assert len(set(got["fc1_rates"]["tracker"])) > 1


def test_hetero_control(port, jx):
    """Event and frame streams under DeadlinePolicy: the same rows in the
    same order as the JAX package's engine."""
    got = port["hetero"]
    eng = jx.StreamEngine(
        engines=[jx.event(), jx.frame()],
        config=jx.EngineConfig(max_streams=hetero.SLOTS,
                               policy=jx.DeadlinePolicy(fair_quantum=2)))
    hs = {}
    for s in range(hetero.EVENT_STREAMS):
        hs[f"dvs{s}"] = eng.open(modality="event", stream_id=f"dvs{s}")
    for s in range(hetero.FRAME_STREAMS):
        hs[f"cam{s}"] = eng.open(modality="frame", stream_id=f"cam{s}")
    rng = np.random.default_rng(7)
    rows = []
    for k in range(hetero.WINDOWS_PER_STREAM + 1):
        for s in range(hetero.EVENT_STREAMS):
            hs[f"dvs{s}"].submit(jx.window(rng, (s + k) % 11, 4000),
                                 deadline=float(10 * k + s))
        for s in range(hetero.FRAME_STREAMS):
            hs[f"cam{s}"].submit(
                jx.frames.synthetic_gesture_frames(
                    rng, (s + k) % 11, height=TCN_SMOKE.height,
                    width=TCN_SMOKE.width),
                deadline=float(10 * k + 100 + s))
        if k in (0, hetero.WINDOWS_PER_STREAM):
            rows += eng.run()
    assert [(r.stream_id, r.seq, r.modality) for r in rows] == \
        [(r["stream"], r["seq"], r["modality"]) for r in got["rows"]]
    for r, g in zip(rows, got["rows"]):
        _close(r.result, g)
    assert got["compiled_shapes"] == {
        m: [list(k) for k in sorted(eng.compiled_shapes(m))]
        for m in hetero.SLOTS}


def test_fusion_control(port, jx):
    """The fused session's ticks against the JAX package's; the port's
    migration through a pickled checkpoint is bit for bit."""
    got = port["fusion"]
    assert got["migration_bitwise"]
    assert got["ratio"] > 0
    eng = jx.StreamEngine(engines=[jx.event(), jx.frame()],
                          config=jx.EngineConfig(
                              max_streams={"event": 1, "frame": 1}))
    sess = jx.FusionSession(eng, session_id="uav0", stateful=True,
                            fusion=jx.late_logit_fusion(0.6, 0.4))
    for ev_w, fr_w in jx.head_ticks(7, fusion.TICKS):
        sess.submit(ev_w, fr_w)
    rows = sess.run()
    assert sess.stats["ticks_fused"] == got["ticks_fused"] == fusion.TICKS
    assert [r.seq for r in rows] == [t["seq"] for t in got["ticks"]]
    for r, g in zip(rows, got["ticks"]):
        _close(r.result, g)


def test_fault_tolerant_control(port, jx):
    """Act 1's fused and degraded ticks and act 2's served windows and
    supervisor counts equal the JAX package's on the same schedule; the
    port's bitwise asserts passed inside the example."""
    got = port["fault_tolerant"]
    act1, act2 = got["act1"], got["act2"]
    assert act1["fused_bitwise"] and act2["recovered_bitwise"]
    ticks = jx.head_ticks(7, fault_tolerant.TICKS)
    recovery = jx.RecoveryConfig(max_retries=0, backoff_steps=0,
                                 dead_after=1, checkpoint_every=2)

    inj = jx.FaultInjector(jx.FaultConfig(seed=3))
    eng = jx.StreamEngine(
        engines=[inj.wrap(jx.event()), inj.wrap(jx.frame())],
        config=jx.EngineConfig(max_streams={"event": 1, "frame": 1},
                               recovery=recovery))
    sess = jx.FusionSession(eng, session_id="uav0", stateful=True)
    rows = []
    for k, (ev_w, fr_w) in enumerate(ticks):
        if k == fault_tolerant.KILL_AT:
            inj.kill("frame")
        if k == fault_tolerant.REVIVE_AT:
            inj.revive("frame")
            eng.replace_lane_engine("frame", engine=inj.wrap(jx.frame()))
        sess.submit(ev_w, fr_w)
        rows.extend(sess.step())
    sess.absorb(eng.flush())
    rows.extend(sess.drain())
    assert [r.status for r in rows] == act1["statuses"]
    assert (sess.ticks_fused, sess.ticks_degraded) == \
        (act1["ticks_fused"], act1["ticks_degraded"])
    assert [int(np.asarray(r.result.label_pred)[0]) for r in rows] == \
        act1["labels"]

    inj = jx.FaultInjector(jx.FaultConfig(seed=3))
    make = lambda: inj.wrap(jx.event())  # noqa: E731
    eng = jx.StreamEngine(engines=[make()], config=jx.EngineConfig(
        max_streams=1, recovery=recovery))
    sup = jx.LaneSupervisor(eng, store=jx.CheckpointStore(capacity=4),
                            rebuild=lambda modality: make())
    sup.watch(eng.open(modality="event", stream_id="imu", stateful=True))
    out = []
    for k, (w, _) in enumerate(ticks):
        if k == fault_tolerant.KILL_AT:
            inj.kill("event")
        if k == fault_tolerant.REVIVE_AT:
            inj.revive("event")
        sup.submit("imu", w)
        out.extend(sup.tick(eng.step()))
    for _ in range(12):
        out.extend(sup.tick(eng.step()))
    ok = sorted((r for r in out if r.ok), key=lambda r: r.seq)
    assert (len(ok), len(out) - len(ok)) == (act2["ok"], act2["failed"])
    assert {k: sup.stats[k] for k in act2["supervisor"]} == \
        act2["supervisor"]
    assert [int(np.asarray(r.result.label_pred)[0]) for r in ok] == \
        act2["labels"]


def test_serve_ternary_lm(port):
    """The untrained model's quantization and greedy tokens, fp and
    ternary, against the JAX package's from the same parameters."""
    from repro.configs import get_config
    from repro.models import build_model
    from repro.serving import ServeConfig, generate, quantize_for_serving
    from repro_torch.models import build_model as port_model
    got = port["serve"]
    assert got["steps"] == 0 and got["losses"] == []
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              **{k: getattr(serve_lm.model_config(), k)
                                 for k in ("d_model", "d_ff", "num_heads",
                                           "num_kv_heads", "head_dim")})
    params = jax.tree_util.tree_map(jnp.asarray, common.np_lm_params(
        port_model(serve_lm.model_config()), seed=0))
    qparams, stats = quantize_for_serving(params)
    assert dict(stats) == got["quant_stats"]
    assert stats["quantized"] > 0
    model = build_model(cfg)
    sc = ServeConfig(max_new_tokens=serve_lm.NEW_TOKENS)
    prompts = jnp.asarray(serve_lm.prompts(), jnp.int32)
    for p, key in ((params, "tokens_fp"), (qparams, "tokens_ternary")):
        toks, _ = generate(model, p, prompts, sc)
        assert np.asarray(toks).tolist() == got[key], key
