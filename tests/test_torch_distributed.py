"""The port's distribution layer against the JAX package's: meshes, the
sharding rules (``distributed.sharding``, ``_quantized_pspecs`` of the
dry run), annotations, and the production meshes of ``launch.mesh``.

The JAX rules read only ``mesh.axis_names`` and ``mesh.devices.shape``,
so a duck-typed mesh stands in on the JAX side (no forced host devices).
A JAX spec is compared as ``tuple(spec)``, the port's is that tuple.
Every comparison is exact: the rules are integer arithmetic on shapes.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.shapes import cells_for as jax_cells_for  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving.serve import \
    quantize_for_serving as jax_quantize  # noqa: E402
from repro_torch import distributed as D  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.distributed import annotate, sharding as SH  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.launch import steps as ST  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

MESHES = {
    "2x4": ((2, 4), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}


class _JaxMesh:
    """What the JAX rules read of a mesh."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape)


def _meshes(name):
    shape, axes = MESHES[name]
    port = D.make_mesh(shape, axes,
                       devices=[torch.device("meta")] * int(np.prod(shape)))
    return _JaxMesh(shape, axes), port


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _jax_flat_specs(tree):
    return {k: tuple(v) for k, v in _flat(tree).items()}


def _jax_quantized_pspecs():
    """The JAX dry run's ``_quantized_pspecs``. Importing its module sets
    XLA_FLAGS for 512 forced host devices (it expects to run first);
    the variable is put back at once, before any JAX backend reads it."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as jax_dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return jax_dryrun._quantized_pspecs


def test_archs_are_the_jax_packages():
    assert ARCHS == JAX_ARCHS


# -- meshes --------------------------------------------------------------

def test_make_mesh_forms_and_errors():
    meta = [torch.device("meta")] * 8
    m = D.make_mesh(devices=meta)
    assert m.axis_names == ("data",) and m.devices.shape == (8,)
    assert D.make_mesh(4, devices=meta).devices.shape == (4,)
    m = D.make_mesh((2, 2, 2), ("pod", "data", "model"), devices=meta)
    assert m.shape == {"pod": 2, "data": 2, "model": 2} and m.size == 8
    assert list(m.devices.reshape(-1)) == meta
    assert m == D.make_mesh((2, 2, 2), ("pod", "data", "model"),
                            devices=meta)
    with pytest.raises(ValueError, match="axes required"):
        D.make_mesh((2, 4), devices=meta)
    with pytest.raises(ValueError, match="disagree"):
        D.make_mesh((2, 4), ("data",), devices=meta)
    with pytest.raises(RuntimeError, match="need 16 devices, have 8"):
        D.make_mesh((4, 4), ("data", "model"), devices=meta)
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match="need 1 devices, have 0"):
            D.make_mesh()


def test_slot_axis():
    meta = [torch.device("meta")] * 4
    assert D.slot_axis(D.make_mesh((2, 2), ("data", "model"),
                                   devices=meta)) == "data"
    assert D.slot_axis(D.make_mesh((2, 2), ("x", "y"),
                                   devices=meta)) == "x"


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_meshes(multi_pod):
    m = LM.make_production_mesh(multi_pod=multi_pod)
    want = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else \
        ((16, 16), ("data", "model"))
    assert (m.devices.shape, m.axis_names) == want
    assert all(d.type == "meta" for d in m.device_list)
    assert LM.make_mesh is D.make_mesh
    if torch.cuda.device_count() < m.size:
        with pytest.raises(RuntimeError, match=f"need {m.size} devices"):
            LM.make_mesh_for(*want)


def test_annotations_are_identities_and_mesh_is_a_context():
    x = torch.ones(4, 2)
    assert annotate.current_mesh() is None
    _, mesh = _meshes("2x4")
    with mesh:
        assert annotate.current_mesh() is mesh
        assert D.constrain(x, ("batch", None)) is x
        assert annotate.unshard_fsdp(x, ("data", "model")) is x
    assert annotate.current_mesh() is None
    assert annotate.get_execution_mode() == "train"
    with annotate.execution_mode("serve"):
        assert annotate.get_execution_mode() == "serve"
    assert annotate.get_execution_mode() == "train"


# -- the rules against the JAX package's -----------------------------------

@pytest.mark.parametrize("case", [
    ((64, 8, 16), ("embed", "heads", "head_dim"), ("data", "model", None)),
    ((64, 10, 16), ("embed", "heads", "head_dim"), ("data", None, "model")),
    ((63, 9, 15), ("embed", "heads", "head_dim"), (None, None, None)),
    ((254, 64), ("vocab", "embed"), (None, "data")),
])
def test_resolve_spec_fallbacks(case):
    shape, axes, want = case
    jmesh, mesh = _meshes("2x4")
    assert SH.resolve_spec(shape, axes, mesh) == want
    assert tuple(JSH.resolve_spec(shape, axes, jmesh)) == want


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_param_and_opt_specs_equal_jax(mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    for arch in ARCHS:
        jdefs = jax_build_model(jax_get_config(arch)).defs()
        defs = build_model(get_config(arch)).defs()
        for mode in ("train", "serve"):
            want = _jax_flat_specs(JSH.param_pspecs(jdefs, jmesh, mode))
            got = _flat(SH.param_pspecs(defs, mesh, mode))
            assert got == want, (arch, mode)
        want = _jax_flat_specs(JSH.opt_pspecs(jdefs, jmesh))
        assert _flat(SH.opt_pspecs(defs, mesh)) == want, arch


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_and_cache_specs_equal_jax(mesh_name):
    jmesh, mesh = _meshes(mesh_name)
    assert SH.batch_axes(mesh) == JSH.batch_axes(jmesh)
    for arch in ARCHS:
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        for cell in jax_cells_for(jcfg):
            b = cell.global_batch
            assert SH._batch_dim_spec(mesh, b) == JSH._batch_dim_spec(jmesh,
                                                                      b)
            want = {k: tuple(v) for k, v in
                    JSH.batch_pspecs(jcfg, jmesh, b, cell.kind).items()}
            assert SH.batch_pspecs(cfg, mesh, b, cell.kind) == want
            if cell.kind != "decode":
                continue
            jcache = JST.abstract_cache(jcfg, cell)
            cache = ST.abstract_cache(cfg, SHAPES[cell.name])
            want = {k: tuple(v) for k, v in
                    JSH.cache_pspecs(jcfg, jmesh, jcache, b).items()}
            assert SH.cache_pspecs(cfg, mesh, cache, b) == want, \
                (arch, cell.name)


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_specs_equal_jax(arch):
    """Ternary decode params: the port's meta tree through its
    ``quantize_for_serving``, the JAX package's through ``eval_shape`` of
    its own, and each dry run's ``_quantized_pspecs`` over them, on every
    mesh."""
    jax_rule = _jax_quantized_pspecs()
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jmodel = jax_build_model(jcfg)
    jq = jax.eval_shape(lambda p: jax_quantize(p)[0],
                        jmodel.abstract_params())
    q = DR.abstract_cell(cfg, SHAPES["decode_32k"], "ternary")["params"]
    for mesh_name in MESHES:
        jmesh, mesh = _meshes(mesh_name)
        jspecs = jax_rule(JSH.param_pspecs(jmodel.defs(), jmesh), jq, jmesh)
        specs = DR._quantized_pspecs(
            SH.param_pspecs(build_model(cfg).defs(), mesh), q, mesh)
        assert _flat(specs) == _jax_flat_specs(jspecs), mesh_name


def test_slot_specs_equal_jax():
    jmesh, mesh = _meshes("2x4")
    state = {"v": [np.zeros((8, 3)), np.zeros((8, 2, 5))],
             "t": np.zeros((8,)), "none": None}
    port_state = {"v": [torch.zeros(8, 3), torch.zeros(8, 2, 5)],
                  "t": torch.zeros(8), "none": None}
    for ndim in (1, 3):
        assert SH.slot_pspec(ndim, mesh) == tuple(JSH.slot_pspec(ndim,
                                                                 jmesh))
        assert SH.slot_pspec(ndim) == tuple(JSH.slot_pspec(ndim))
        assert SH.slot_pspec(ndim, axis="x") == tuple(
            JSH.slot_pspec(ndim, axis="x"))
    want = jax.tree.map(tuple, JSH.slot_state_pspecs(state, jmesh),
                        is_leaf=lambda x: isinstance(x, P))
    got = SH.slot_state_pspecs(port_state, mesh)
    assert got == {"v": want["v"], "t": want["t"], "none": None}
