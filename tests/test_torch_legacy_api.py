"""The legacy call forms of the port's ``StreamEngine``, against the JAX
package.

Mirrors ``test_session_api.py``'s deprecation and shim scenarios: the
pre-config construction kwargs (``max_streams=``, ``fair_quantum=``,
``policy=``, ``duration_us=``, ``window_ms=``, ``fuse_fc=``,
``pipeline_depth=``) and the id-keyed calls (``submit(stream_id,
window)``, ``stateful_of``, ``reset_state``, ``retire``, ``handle``,
``has_stream``). Each scenario runs through the JAX package's engine and
the port's on the same inputs (the shared set-up of
``test_torch_checkpoint.py``): the same rows, the same warnings, the same
errors. Inside the port, every legacy form gives the bits of the handle
API's run.
"""
import warnings

import numpy as np
import pytest

from test_torch_checkpoint import (assert_bitwise, assert_rows_match, both,
                                   key, side)

torch = pytest.importorskip("torch")

LEGACY = dict(max_streams=3, fair_quantum=2, duration_us=300_000,
              window_ms=50.0, fuse_fc=True, pipeline_depth=1)


def legacy_engine(s, **kw):
    """``StreamEngine(params, cfg, **kw)``: the port's on the CPU."""
    extra = {"device": "cpu"} if s.name == "port" else {}
    return s.StreamEngine(s.loop().params, s.cfg, **kw, **extra)


def deprecations(fn):
    """``fn()``'s result and the messages of the DeprecationWarnings it
    raised."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(w.message) for w in rec
                 if w.category is DeprecationWarning]


# ----------------------------------------------------------------------
# Construction kwargs.
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(LEGACY) + ["policy"])
def test_each_construction_kwarg_builds_the_engine_config(name):
    s = side("port")
    value = (s.DeadlinePolicy() if name == "policy" else LEGACY[name])
    eng, warned = deprecations(lambda: legacy_engine(s, **{name: value}))
    assert eng.config == s.EngineConfig(**{name: value})
    assert len(warned) == 1 and "EngineConfig" in warned[0]
    assert eng.loop.device.type == "cpu"


def _construction(s):
    a, warned_a = deprecations(lambda: legacy_engine(s, **LEGACY))
    b, warned_b = deprecations(lambda: legacy_engine(s, max_streams=2))
    _, quiet = deprecations(lambda: legacy_engine(
        s, config=s.EngineConfig(max_streams=2)))
    errors = []
    for kw in (dict(config=s.EngineConfig(), max_streams=2),
               dict(config=s.EngineConfig(), pipeline_depth=0)):
        with pytest.raises(ValueError, match="mutually exclusive") as e:
            legacy_engine(s, **kw)
        errors.append(str(e.value))
    with pytest.raises(ValueError, match="fuse_fc") as e:
        deprecations(lambda: s.StreamEngine(engines=[s.loop()],
                                            fuse_fc=True))
    errors.append(str(e.value).split(";")[0])
    return (warned_a, warned_b, quiet, errors,
            (a.pipeline_depth, len(a._lanes["event"].slots),
             a.policy.fair_quantum, a.loop.duration_us))


def test_construction_kwargs_warn_once_per_engine_and_refuse_config():
    j, t = both(_construction)
    assert j == t
    warned_a, warned_b, quiet, errors, built = t
    assert len(warned_a) == len(warned_b) == 1 and quiet == []
    assert built == (1, 3, 2, 300_000)


def test_kwargs_keep_device_and_model():
    s = side("port")
    from repro_torch.core.energy import KrakenModel
    model = KrakenModel()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        eng = legacy_engine(s, max_streams=2, model=model)
        assert eng.loop.model is model and eng.loop.device.type == "cpu"
        if not torch.cuda.is_available():
            # No card: the default device is the card, and it raises.
            with pytest.raises(RuntimeError, match="device='cpu'"):
                s.StreamEngine(s.loop().params, s.cfg, max_streams=2)
        # A mesh now shards the built engine's slots (here a logical mesh
        # of two CPU shards); anything but a Mesh is refused.
        from repro_torch.distributed import make_mesh
        mesh = make_mesh(2, devices=[torch.device("cpu")] * 2)
        sharded = legacy_engine(s, config=s.EngineConfig(max_streams=2,
                                                         mesh=mesh))
        assert sharded.mesh is mesh and sharded.loop.mesh is mesh
        assert sharded.loop.devices == (torch.device("cpu"),) * 2
        with pytest.raises(TypeError, match="Mesh"):
            legacy_engine(s, config=s.EngineConfig(mesh=object()))


# ----------------------------------------------------------------------
# The id-keyed submit.
# ----------------------------------------------------------------------

def _id_keyed(s, depth):
    """Three streams (one stateful) through the legacy kwargs and the
    id-keyed submit, beside the same streams through EngineConfig and
    handles; the first submit's warning and the later submits' silence."""
    streams = {f"cam{i}": s.windows(3, seed=10 + i) for i in range(3)}
    stateful = {"cam1"}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        legacy = legacy_engine(s, max_streams=2, pipeline_depth=depth)
    warned = []
    for sid, ws in streams.items():
        for w in ws:
            seq, got = deprecations(lambda: legacy.submit(
                sid, w, stateful=sid in stateful))
            warned += got
    rows = legacy.run()
    modern = s.engine(max_streams=2, pipeline_depth=depth)
    hs = {sid: modern.open(stream_id=sid, stateful=sid in stateful)
          for sid in streams}
    for sid, ws in streams.items():
        for w in ws:
            hs[sid].submit(w)
    return rows, warned, modern.run() if s.name == "port" else None


@pytest.mark.parametrize("depth", [0, 1], ids=["sync", "pipelined"])
def test_id_keyed_submit_gives_the_handle_api_bits(depth):
    (j_rows, j_warned, _), (t_rows, t_warned, t_modern) = both(_id_keyed,
                                                               depth)
    assert j_warned == t_warned and len(t_warned) == 1
    assert "open(modality" in t_warned[0]
    assert_rows_match(j_rows, t_rows)
    assert key(t_rows) == key(t_modern)
    assert_bitwise(t_modern, t_rows)


def _rejections(s):
    """Submits that are refused: none registers a stream, burns a
    sequence number or moves the lane's latched duration."""
    eng = s.engine(lanes=("event", s.stub()), max_streams=1,
                   duration_us=300_000)
    short = s.events.synthetic_gesture_events(
        np.random.default_rng(0), 1, mean_events=200,
        duration_us=100_000, height=32, width=32)
    good = s.windows(1, seed=3)[0]
    errors = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        for call in (lambda: eng.submit("a", short, modality="event"),
                     lambda: eng.submit("b", 1, modality="stub",
                                        stateful=True),
                     lambda: eng.submit("c", good),
                     lambda: eng.submit("d", good, modality="frame")):
            with pytest.raises(ValueError) as e:
                call()
            errors.append(str(e.value))
        state = (sorted(eng.handles), sorted(eng.stream_stats),
                 eng.pending(), eng.has_stream("a"))
        first = eng.submit("a", good, modality="event", stateful=True)
        with pytest.raises(ValueError, match="latched"):
            eng.submit("a", good, stateful=False)
        with pytest.raises(ValueError, match="bound to modality"):
            eng.submit("a", good, modality="stub")
        second = eng.submit("a", good)
    return errors, state, (first, second, eng.stateful_of("a")), key(
        eng.run())


def test_rejected_first_submit_registers_no_stream():
    j, t = both(_rejections)
    assert j == t
    errors, state, seqs, rows = t
    assert state == ([], [], 0, False)
    assert seqs == (0, 1, True) and len(rows) == 2


# ----------------------------------------------------------------------
# The id-keyed lookups.
# ----------------------------------------------------------------------

def _lookups(s):
    """handle / has_stream / stateful_of / reset_state / retire through
    the stream id, against the handle's own calls."""
    ws = s.windows(4, seed=21)
    eng = s.engine(max_streams=2)
    h = eng.open(stream_id="s", stateful=True)
    other = eng.open(stream_id="o")
    for w in ws[:2]:
        h.submit(w)
        other.submit(w)
    rows = eng.run()
    found = (eng.handle("s") is h, eng.has_stream("s"),
             eng.stateful_of("s"), eng.stateful_of("o"))
    eng.reset_state("s")
    for w in ws[2:]:
        h.submit(w)
    rows += eng.run()
    other.submit(ws[0])
    other.submit(ws[1])
    dropped = eng.retire("o")
    missing = []
    for call in (eng.handle, eng.stateful_of, eng.reset_state, eng.retire):
        with pytest.raises(KeyError, match="unknown stream") as e:
            call("o")
        missing.append(str(e.value))
    with pytest.raises(ValueError, match="not stateful"):
        s.engine(max_streams=1).open(stream_id="x")._engine.reset_state("x")
    fresh = None
    if s.name == "port":
        # After reset_state, the stream's windows are a fresh stream's.
        fresh = s.alone("s", ws[2:])
    return rows, found, dropped, other.closed, eng.has_stream("o"), \
        missing, fresh


def test_id_keyed_lookups_forward_to_the_handle():
    (j_rows, *j_rest, _), (t_rows, *t_rest, fresh) = both(_lookups)
    assert j_rest == t_rest
    found, dropped, closed, has, missing = t_rest
    assert found == (True, True, True, False)
    assert dropped == 2 and closed and not has
    assert_rows_match(j_rows, t_rows)
    after = [r for r in t_rows if r.stream_id == "s" and r.seq >= 2]
    assert_bitwise(fresh, [type(r)(r.stream_id, r.seq - 2, r.result,
                                   r.modality) for r in after])
