"""Slot sharding over a device mesh in the port, on the CPU.

Mirrors ``tests/test_sharded_engine.py``'s contracts on logical meshes:
``make_mesh(n, devices=[torch.device("cpu")] * n)`` names the CPU ``n``
times, and each position runs one shard of the slots (the port's
counterpart of XLA's forced host devices). Inside the port every check is
bit for bit against the unsharded engine:

  * a sharded ``StreamEngine`` serves the same rows (prediction, PWM,
    logits) and carries the same state as the unsharded one at n in
    {1, 2, 4} shards x {4, 8} slots x pipeline depths 0 and 1, stateful
    and stateless streams interleaved, more streams than slots;
  * stateful windows on a sharded engine equal one uninterrupted scan;
  * a checkpoint taken at 4 shards restores on 1 and unsharded, and the
    reverse, and a migration crosses between sharded and unsharded
    engines, continuing bit for bit;
  * nothing in a shard's step reads another shard's rows;
  * indivisible lanes, batches, resizes and autoscaler bounds raise;
    ``attach_mesh``'s rules, ``engines=`` threading, megastep + mesh
    refused; ``FusionSession`` and ``replace_lane_engine`` on sharded
    lanes.

Against the JAX package: the sharded slice's rows equal the unsharded JAX
engines' at the same batch shape (event wing with weights on a 2**-8 grid:
labels, logits and carried state exact, PWM within 1e-6; frame wing:
labels exact, logits within 1e-5 and PWM within 1e-6, the tolerances of
``test_torch_tcn.py``), and ``place`` puts every block where JAX's
``NamedSharding.devices_indices_map`` says, on a 2x4 mesh of forced host
devices in a subprocess.

The frame wing's conv1 under mkldnn on the CPU is not batch-invariant (it
picks an algorithm per batch size), and a shard convolves B/n frames where
the unsharded engine convolves B: sharded frame rows equal unsharded ones
here because the ternary threshold absorbs those ulps at these sizes, as
the port's B=1-against-batched frame contract already rests on. The event
wing's convolutions sum exact products (binary spikes, 2**-8 weights).
"""
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from test_torch_checkpoint import FRAME_LOGITS_ATOL, PWM_ATOL, side
from test_torch_stream import _oracle

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.core._api import EngineConfig, FleetConfig  # noqa: E402
from repro_torch.distributed import (NamedSharding, ShardedTensor,  # noqa
                                     gather, make_mesh, place, shardings,
                                     slot_shardings)
from repro_torch.fleet import LaneAutoscaler, migrate_stream  # noqa: E402
from repro_torch.serving import FusionSession, StreamEngine  # noqa: E402

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
CPU = torch.device("cpu")


def cpu_mesh(n):
    """A logical mesh: the CPU at ``n`` positions of one ``data`` axis."""
    return make_mesh(n, devices=[CPU] * n)


@pytest.fixture(scope="module")
def s():
    return side("port")


def engine(s, mesh=None, lanes=("event",), **config):
    engines = [s.loop() if m == "event" else s.frame() for m in lanes]
    return StreamEngine(engines=engines,
                        config=EngineConfig(mesh=mesh, **config))


def streams_of(s, n_streams, n_windows, seed=0):
    return {f"s{i}": s.windows(n_windows, seed=seed + i)
            for i in range(n_streams)}


def serve(eng, streams, stateful_ids=()):
    """Every (stream, seq) row's (label, pwm, logits), and each stateful
    stream's exported carry after the run."""
    hs = {sid: eng.open(stream_id=sid, stateful=sid in stateful_ids)
          for sid in sorted(streams)}
    for k in range(len(next(iter(streams.values())))):
        for sid in sorted(streams):
            hs[sid].submit(streams[sid][k])
    rows = {(r.stream_id, r.seq): (r.result.label_pred, r.result.pwm,
                                   r.result.logits) for r in eng.run()}
    carries = {sid: hs[sid].checkpoint().state for sid in stateful_ids}
    return rows, carries


def assert_rows_equal(a, b):
    assert set(a) == set(b), (sorted(a), sorted(b))
    for key in a:
        for x, y in zip(a[key], b[key]):
            np.testing.assert_array_equal(x, y, err_msg=str(key))


def assert_carries_equal(a, b):
    assert set(a) == set(b)
    for sid in a:
        assert set(a[sid]) == set(b[sid])
        for k in a[sid]:
            np.testing.assert_array_equal(a[sid][k], b[sid][k],
                                          err_msg=f"{sid} {k}")


# ----------------------------------------------------------------------
# The tentpole: sharded serving == unsharded serving, bit for bit.
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("slots", [4, 8])
def test_sharded_serving_bitwise_parity(s, n, slots):
    """Sync and pipelined, stateful and stateless streams interleaved,
    more streams than slots (parking and regathering run sharded); the
    lane's state is laid out on the mesh, one block of B/n rows a
    shard."""
    streams = streams_of(s, slots + 2, 2, seed=11)
    stateful = tuple(sorted(streams))[::2]
    mesh = cpu_mesh(n)
    for depth in (0, 1):
        base = engine(s, max_streams=slots, pipeline_depth=depth)
        shard = engine(s, mesh, max_streams=slots, pipeline_depth=depth)
        want, want_carry = serve(base, streams, stateful)
        got, got_carry = serve(shard, streams, stateful)
        assert_rows_equal(want, got)
        assert_carries_equal(want_carry, got_carry)
        state = shard._lanes["event"].state
        assert set(state) == {"conv1", "conv2", "fc1", "fc2"}
        for plane in state.values():
            assert isinstance(plane, ShardedTensor)
            assert plane.shape[0] == slots and len(plane.blocks) == n
            assert {b.shape[0] for b in plane.blocks} == {slots // n}


@pytest.mark.parametrize("n", [1, 2, 4])
def test_stateful_windows_match_uninterrupted_scan_sharded(s, n):
    """W windows served stateful on a sharded engine == one uninterrupted
    scan over the concatenated events (labels and PWM) and == the stream
    served alone on an unsharded 1-slot engine (every row bit for bit);
    beside three other streams, so the stream's row is not in shard 0."""
    ws = s.windows(3, seed=21)
    want = s.alone("x", ws)
    scan = _oracle(s.loop().params, ws)
    eng = engine(s, cpu_mesh(n), max_streams=4)
    others = [eng.open(stream_id=f"o{i}") for i in range(3)]
    h = eng.open(stream_id="x", stateful=True)
    for k, w in enumerate(ws):
        for o in others:
            o.submit(s.windows(1, seed=30 + k)[0])
        h.submit(w)
    got = sorted((r for r in eng.run() if r.stream_id == "x"),
                 key=lambda r: r.seq)
    assert [r.seq for r in got] == [0, 1, 2]
    for (label, pwm), b in zip(scan, got):
        np.testing.assert_array_equal(b.result.label_pred, label)
        np.testing.assert_array_equal(b.result.pwm, pwm)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a.result.logits, b.result.logits)
        np.testing.assert_array_equal(a.result.pwm, b.result.pwm)
        np.testing.assert_array_equal(a.result.label_pred,
                                      b.result.label_pred)


@pytest.mark.parametrize("src,dst", [(4, 1), (1, 4), (4, None), (None, 4)])
def test_checkpoint_migrates_across_device_counts(s, src, dst):
    """A checkpoint taken on a ``src``-shard engine (None: unsharded)
    restores on a ``dst``-shard one and continues bit for bit: exported
    carries are host numpy (the pickle holds no ShardedTensor), so the
    mesh layout never leaks into the checkpoint."""
    ws = s.windows(4, seed=41)
    mesh = lambda n: None if n is None else cpu_mesh(n)
    ref = engine(s, mesh(src), max_streams=4)
    h = ref.open(stream_id="mig", stateful=True)
    for w in ws:
        h.submit(w)
    want = {r.seq: r.result.logits for r in ref.run()}
    a = engine(s, mesh(src), max_streams=4)
    ha = a.open(stream_id="mig", stateful=True)
    ha.submit(ws[0])
    ha.submit(ws[1])
    a.run()
    blob = pickle.dumps(ha.checkpoint())
    assert b"ShardedTensor" not in blob
    b = engine(s, mesh(dst), max_streams=4)
    hb = b.open(stream_id="mig", stateful=True).restore(pickle.loads(blob))
    hb.submit(ws[2])
    hb.submit(ws[3])
    got = {r.seq: r.result.logits for r in b.run()}
    assert set(got) == {2, 3}
    for k in (2, 3):
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


@pytest.mark.parametrize("depth", [0, 1])
def test_migration_between_sharded_and_unsharded(s, depth):
    """``migrate_stream`` from a 4-shard engine to an unsharded one and
    back, live (a window in flight at depth 1): every row of the moved
    stream is bitwise the uninterrupted run's."""
    ws = s.windows(6, seed=43)
    want = {r.seq: r.result.logits for r in s.alone("m", ws)}
    sharded = engine(s, cpu_mesh(4), max_streams=4, pipeline_depth=depth)
    plain = engine(s, max_streams=4, pipeline_depth=depth)
    h = sharded.open(stream_id="m", stateful=True)
    got = {}
    for k, w in enumerate(ws):
        h.submit(w)
        got.update({r.seq: r.result.logits for r in h.engine.step()})
        if k in (1, 3):
            rec = migrate_stream(h, plain if h.engine is sharded
                                 else sharded)
            got.update({r.seq: r.result.logits for r in rec.displaced})
            h = rec.handle
    for eng in (sharded, plain):
        got.update({r.seq: r.result.logits for r in eng.run()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_no_shard_reads_another_shards_rows(s):
    """Each shard's step gets B/n rows: its own block of a state already on
    the mesh (the block itself, no copy) and its rows of the batch; and
    changing every window outside shard 0's rows leaves shard 0's rows
    (results and carried state) as they were."""
    loop = s.loop(mesh=cpu_mesh(4))
    seen = []
    build = loop._build_run

    def spying(key, shard=None):
        run = build(key, shard)

        def spy(args):
            seen.append(args)
            return run(args)
        return spy

    loop._build_run = spying
    ws = s.windows(8, seed=51)
    other = ws[:2] + s.windows(6, seed=52)
    results, states = [], []
    for batch_ws in (ws, other):
        batch = s.events.pad_event_windows(batch_ws, max_events=4096)
        state = loop.init_state(8)
        seen.clear()
        res, st = loop.infer(batch, state)
        assert len(seen) == 4
        for i, (events, block) in enumerate(seen):
            assert events.shape[1] == 2
            assert all(block[k] is state[k].blocks[i] for k in state)
        results.append(res)
        states.append(st)
    for a, b in zip(results[0][:2], results[1][:2]):
        np.testing.assert_array_equal(a.logits, b.logits)
        np.testing.assert_array_equal(a.pwm, b.pwm)
    for k in states[0]:
        assert torch.equal(states[0][k].blocks[0], states[1][k].blocks[0])
    assert not torch.equal(states[0]["conv1"].blocks[1],
                           states[1]["conv1"].blocks[1])


# ----------------------------------------------------------------------
# Divisibility, attach_mesh, megastep.
# ----------------------------------------------------------------------

def test_slot_divisibility_enforced(s):
    """Lane slot counts, batches, resizes and the autoscaler's
    ``min_slots`` that do not divide over the slot axis fail loudly: no
    silent fallback to one device."""
    mesh = cpu_mesh(4)
    with pytest.raises(ValueError, match="divide"):
        engine(s, mesh, max_streams=6)
    with pytest.raises(ValueError, match="divide"):
        engine(s, mesh, lanes=("event", "frame"),
               max_streams={"event": 4, "frame": 6})
    loop = s.loop(mesh=mesh, duration_us=300_000)
    batch = s.events.pad_event_windows(s.windows(6, seed=61),
                                       max_events=4096)
    with pytest.raises(ValueError, match="divide"):
        loop.infer(batch)
    with pytest.raises(ValueError, match="divide"):
        loop.warmup([(6, 64)])
    assert loop.compiled_shape_keys() == set()
    frame = s.frame(mesh=mesh)
    f = s.frames(1, seed=62)[0]
    frame.validate(f)
    with pytest.raises(ValueError, match="divide"):
        frame.infer(frame.prepare([f] * 6, batch_size=6))
    eng = engine(s, mesh, max_streams=4)
    with pytest.raises(ValueError, match="divide"):
        eng.resize_lane(slots=6)
    assert len(eng._lanes["event"].slots) == 4
    assert eng.resize_lane(slots=8) == []
    with pytest.raises(ValueError, match="divide"):
        LaneAutoscaler(eng, config=FleetConfig(min_slots=2, max_slots=16))
    LaneAutoscaler(eng, config=FleetConfig(min_slots=4, max_slots=16))
    LaneAutoscaler(engine(s, max_streams=4),
                   config=FleetConfig(min_slots=2, max_slots=16))


def test_attach_mesh_rules(s):
    """Same mesh: a no-op; a different mesh: ValueError; after a key was
    warmed: RuntimeError; ``engines=`` threads the serving mesh onto
    caller engines (idempotent with a pre-attached one) and refuses a
    conflict or an engine without ``attach_mesh``; the weights sit on
    every shard's device and ``init_state`` comes back on the mesh."""
    mesh, other = cpu_mesh(2), make_mesh((2,), ("x",), devices=[CPU] * 2)
    eng = s.loop(mesh=mesh, duration_us=300_000)
    eng.attach_mesh(mesh)
    with pytest.raises(ValueError, match="different mesh"):
        eng.attach_mesh(other)
    warm = s.loop(duration_us=300_000)
    warm.warmup([(2, 64)])
    with pytest.raises(RuntimeError, match="compiled"):
        warm.attach_mesh(mesh)
    with pytest.raises(ValueError, match="device type"):
        s.loop().attach_mesh(make_mesh(2, devices=[torch.device("meta")]
                                       * 2))
    for sh in eng._shards:
        assert sh.device == CPU
        assert all(w.device == CPU for layer in sh.weights.values()
                   for w in layer.values())
    state = eng.init_state(4)
    assert all(isinstance(a, ShardedTensor) and len(a.blocks) == 2
               for a in state.values())
    assert all(isinstance(a, torch.Tensor) for a in
               eng.init_state(1).values())
    assert eng._zero_state_for(4) is eng._zero_state_for(4)

    pre = s.loop(mesh=mesh)
    bare = s.frame()
    served = StreamEngine(engines=[pre, bare],
                          config=EngineConfig(max_streams=4, mesh=mesh))
    assert served.mesh is mesh and pre.mesh is mesh and bare.mesh is mesh
    with pytest.raises(ValueError, match="different mesh"):
        StreamEngine(engines=[s.loop(mesh=other)],
                     config=EngineConfig(max_streams=4, mesh=mesh))
    with pytest.raises(ValueError, match="attach_mesh"):
        StreamEngine(engines=[s.stub()],
                     config=EngineConfig(max_streams=4, mesh=mesh))


def test_megastep_and_mesh_refused(s):
    """The fused megastep is single-device, as in the JAX package."""
    mesh = cpu_mesh(2)
    with pytest.raises(ValueError, match="megastep"):
        EngineConfig(megastep=True, mesh=mesh)
    with pytest.raises(ValueError, match="megastep"):
        StreamEngine(engines=[s.loop(mesh=mesh), s.frame()],
                     config=EngineConfig(megastep=True))
    with pytest.raises(ValueError, match="megastep"):
        s.loop(mesh=mesh)._mega_parts((2, 64, 300_000))
    eng = StreamEngine(engines=[s.loop(), s.frame()],
                       config=EngineConfig(megastep=True, max_streams=2))
    with pytest.raises(ValueError, match="single-device"):
        eng.replace_lane_engine("frame", engine=s.frame(mesh=mesh))


# ----------------------------------------------------------------------
# Sessions and lane control on sharded lanes.
# ----------------------------------------------------------------------

@pytest.mark.parametrize("depth", [0, 1])
def test_fusion_session_over_sharded_lanes(s, depth):
    """FusionSessions over a sharded event and frame lane (one mesh)
    == over the unsharded engine, bit for bit, ticks still paired."""
    evs = [s.windows(2, seed=70 + i) for i in range(3)]
    frs = [s.frames(2, seed=80 + i) for i in range(3)]

    def fused(mesh):
        eng = engine(s, mesh, lanes=("event", "frame"), max_streams=4,
                     pipeline_depth=depth)
        sess = [FusionSession(eng, session_id=f"f{i}", stateful=i != 1)
                for i in range(3)]
        for t in range(2):
            for fs, e, f in zip(sess, evs, frs):
                fs.submit(e[t], f[t])
        out = {}
        for _ in range(20):
            rows = eng.step()
            for fs in sess:
                rows = fs.absorb(rows)
                out.update({(r.stream_id, r.seq): (r.result.logits,
                                                   r.result.pwm)
                            for r in fs.drain()})
            if len(out) == 6:
                break
        paired = sum(eng.stream_stats[sid].fusion_ticks_paired
                     for sid in eng.stream_stats)
        return out, paired

    want, paired = fused(None)
    got, got_paired = fused(cpu_mesh(4))
    assert len(want) == 6 and got_paired == paired > 0
    assert_rows_equal(want, got)


@pytest.mark.parametrize("abort", [True, False])
def test_replace_lane_engine_on_a_sharded_lane(s, abort):
    """abort (or drain) + replace_lane_engine on a sharded lane: an
    unattached replacement gets the serving mesh, one on another mesh is
    refused, and a stateful stream restored from its checkpoint continues
    bitwise the uninterrupted run."""
    mesh = cpu_mesh(2)
    ws = s.windows(4, seed=91)
    want = {r.seq: r.result.logits for r in s.alone("r", ws)}
    eng = engine(s, mesh, max_streams=2, pipeline_depth=1)
    h = eng.open(stream_id="r", stateful=True)
    h.submit(ws[0])
    h.submit(ws[1])
    got = {r.seq: r.result.logits for r in eng.run()}
    ckpt = h.checkpoint()
    h.submit(ws[2])
    eng.step()                        # ws[2] in flight
    if abort:
        assert eng.abort_lane() == 1
    else:
        got.update({r.seq: r.result.logits for r in eng.drain_lane()})
    with pytest.raises(ValueError, match="different mesh"):
        eng.replace_lane_engine(engine=s.loop(mesh=make_mesh(
            (2,), ("x",), devices=[CPU] * 2)))
    fresh = s.loop()
    eng.replace_lane_engine(engine=fresh)
    assert fresh.mesh is mesh
    h.close()
    h = eng.open(stream_id="r", stateful=True).restore(ckpt)
    for w in ws[2:]:
        h.submit(w)
    got.update({r.seq: r.result.logits for r in eng.run()})
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def test_supervised_replacement_attaches_the_serving_mesh(s):
    """``test_torch_fleet.py``'s supervised lane death on a sharded lane:
    the supervisor's rebuilt engine (built unattached) is attached to the
    serving mesh by ``replace_lane_engine``, and every window the stream
    reported successful is bitwise the uninterrupted run's."""
    from repro_torch.fleet import LaneSupervisor
    mesh = cpu_mesh(2)
    ws = s.windows(8, seed=7)
    recovery = s.RecoveryConfig(max_retries=0, backoff_steps=0,
                                dead_after=1, checkpoint_every=2)
    inj = s.FaultInjector()
    eng = StreamEngine(engines=[inj.wrap(s.loop())], config=EngineConfig(
        max_streams=2, recovery=recovery, mesh=mesh))
    rebuilt = []

    def rebuild(modality):
        rebuilt.append(s.loop())
        return inj.wrap(rebuilt[-1])

    sup = LaneSupervisor(eng, store=s.CheckpointStore(capacity=4),
                         rebuild=rebuild)
    sid = sup.watch(eng.open(modality="event", stateful=True)).stream_id
    rows = []
    for k, w in enumerate(ws):
        sup.submit(sid, w)
        if k == 4:
            inj.kill("event")
        rows += sup.tick(eng.step())
        if k == 5:
            inj.revive("event")
    for _ in range(8):
        rows += sup.tick(eng.step())
    assert sup.stats["restores"] >= 1 and len(rebuilt) >= 1
    assert all(e.mesh is mesh for e in rebuilt)
    ok = sorted((r for r in rows if r.ok), key=lambda r: r.seq)
    assert [r.seq for r in ok] == list(range(8))
    for a, b in zip(s.alone(sid, ws), ok):
        np.testing.assert_array_equal(a.result.logits, b.result.logits)
        np.testing.assert_array_equal(a.result.pwm, b.result.pwm)


# ----------------------------------------------------------------------
# Against the JAX package.
# ----------------------------------------------------------------------

def test_sharded_slice_matches_jax(s):
    """The sharded port (4 shards, B=8) against the unsharded JAX engines
    at the same batch shape: two chained stateful event steps (labels,
    logits and carried state exact; PWM within 1e-6) and a frame step
    (labels exact, logits within 1e-5, PWM within 1e-6)."""
    j = side("jax")
    mesh = cpu_mesh(4)
    jloop, loop = j.loop(), s.loop(mesh=mesh)
    jstate, state = jloop.init_state(8), loop.init_state(8)
    for k in range(2):
        ws = s.windows(7, seed=100 + k) + [None]
        batch = s.events.pad_event_windows(ws, max_events=4096,
                                           batch_size=8)
        want, jstate = jloop.infer(batch, jstate)
        got, state = loop.infer(batch, state)
        assert want[7] is None and got[7] is None
        for a, b in zip(want[:7], got[:7]):
            np.testing.assert_array_equal(a.label_pred, b.label_pred)
            np.testing.assert_array_equal(a.logits, b.logits)
            np.testing.assert_allclose(b.pwm, a.pwm, rtol=0, atol=PWM_ATOL)
        for name, plane in gather(state).items():
            np.testing.assert_array_equal(plane.numpy(),
                                          np.asarray(jstate[name]))
    frs = s.frames(8, seed=110)
    want = j.frame().infer_frames(frs)
    got = s.frame(mesh=mesh).infer_frames(frs)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a.label_pred, b.label_pred)
        np.testing.assert_allclose(b.logits, a.logits, rtol=0,
                                   atol=FRAME_LOGITS_ATOL)
        np.testing.assert_allclose(b.pwm, a.pwm, rtol=0, atol=PWM_ATOL)


def test_place_matches_jax_named_sharding():
    """On a 2x4 mesh of forced host devices (a subprocess, so the flag
    does not reach this process): each position's block of ``place``
    equals the global tensor at JAX's ``devices_indices_map`` of the same
    spec, for the slot specs of a state tree and for ``param_pspecs`` of
    two archs (SMOKE widths), train and serve."""
    code = textwrap.dedent("""
        import numpy as np, torch, jax
        from jax.sharding import NamedSharding as JNamed, PartitionSpec as P
        from repro.launch.mesh import make_mesh_for
        from repro.configs import get_config as jget
        from repro.models import build_model as jbuild
        from repro.distributed import sharding as JSH
        from repro_torch.configs import get_config
        from repro_torch.models import build_model
        from repro_torch.distributed import make_mesh, place, shardings
        from repro_torch.distributed import sharding as SH

        jmesh = make_mesh_for((2, 4), ("data", "model"))
        mesh = make_mesh((2, 4), ("data", "model"),
                         devices=[torch.device("cpu")] * 8)
        jpos = {d: i for i, d in enumerate(jmesh.devices.flat)}
        checked = 0

        def check(shape, spec):
            global checked
            full = torch.arange(int(np.prod(shape)),
                                dtype=torch.float64).reshape(shape)
            placed = place(full, shardings(mesh, spec))
            want = JNamed(jmesh, P(*spec)).devices_indices_map(shape)
            for dev, idx in want.items():
                block = placed.blocks[jpos[dev]]
                assert torch.equal(block, full[idx]), (shape, spec, dev)
            checked += 1

        def flat(tree, out):
            if isinstance(tree, dict):
                for v in tree.values():
                    flat(v, out)
            else:
                out.append(tree)
            return out

        for shape in ((8,), (8, 3), (8, 2, 5)):
            check(shape, SH.slot_pspec(len(shape), mesh))
        for arch in ("llama3.2-1b", "deepseek-moe-16b"):
            defs = flat(build_model(get_config(arch, smoke=True)).defs(), [])
            jdefs = flat(jbuild(jget(arch, smoke=True)).defs(), [])
            for mode in ("train", "serve"):
                specs = flat(SH.param_pspecs(
                    build_model(get_config(arch, smoke=True)).defs(), mesh,
                    mode), [])
                for d, jd, spec in zip(defs, jdefs, specs):
                    assert tuple(d.shape) == tuple(jd.shape)
                    check(tuple(d.shape), spec)
        print("CHECKED", checked)
    """)
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "CHECKED" in out.stdout
    assert int(out.stdout.split("CHECKED")[1]) > 40, out.stdout


def test_place_gather_and_rows():
    """``place`` and ``gather`` are inverses; a tree already placed with
    its sharding is returned as it is; replicated positions on one device
    share a block; ``with_row`` and ``from_rows`` touch only the blocks
    that hold the row; an indivisible split raises."""
    mesh = cpu_mesh(4)
    tree = {"a": torch.arange(24.0).reshape(8, 3), "n": None,
            "b": np.arange(8, dtype=np.int32)}
    sh = slot_shardings(mesh, tree)
    assert sh == shardings(mesh, {"a": ("data", None), "n": None,
                                  "b": ("data",)})
    assert sh["a"] == NamedSharding(mesh, ("data", None))
    placed = place(tree, sh)
    assert placed["n"] is None and place(placed, sh)["a"] is placed["a"]
    # Placing a placed tree by its own slot rules moves nothing either
    # (the dispatch of a state already on the mesh).
    again = place(placed, slot_shardings(mesh, placed))
    assert again["a"] is placed["a"] and again["b"] is placed["b"]
    back = gather(placed)
    assert torch.equal(back["a"], tree["a"])
    assert torch.equal(back["b"], torch.from_numpy(tree["b"]))
    a = placed["a"]
    assert [b.shape for b in a.blocks] == [torch.Size([2, 3])] * 4
    assert torch.equal(a[5], tree["a"][5]) and torch.equal(a[-1],
                                                           tree["a"][7])
    with pytest.raises(IndexError):
        a[8]
    new = a.with_row(5, torch.full((3,), -1.0))
    assert torch.equal(a.gather(), tree["a"])
    assert new.blocks[0] is a.blocks[0] and new.blocks[2] is not a.blocks[2]
    assert new.gather()[5].tolist() == [-1.0] * 3
    rows = ShardedTensor.from_rows([tree["a"][i] for i in range(8)],
                                   a.sharding)
    assert torch.equal(rows.gather(), tree["a"])
    rep = place(tree["a"], NamedSharding(mesh, ()))
    assert all(b is rep.blocks[0] for b in rep.blocks)
    with pytest.raises(ValueError, match="divide"):
        place(torch.zeros(6, 2), NamedSharding(mesh, ("data",)))
    two = make_mesh((2, 2), ("data", "model"), devices=[CPU] * 4)
    m = place(torch.arange(16.0).reshape(4, 4),
              NamedSharding(two, ("data", "model")))
    assert torch.equal(m.blocks[3], torch.tensor([[10.0, 11.0],
                                                  [14.0, 15.0]]))
    with pytest.raises(ValueError, match="slot-major"):
        m[0]
    assert torch.equal(gather(m), torch.arange(16.0).reshape(4, 4))
