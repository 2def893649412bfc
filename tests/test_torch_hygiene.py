"""Hygiene of the port: its imports, its devices, its kernel wrappers.

  * ``repro_torch`` and every submodule import without pulling in ``jax``
    or any module of the JAX package (checked in a fresh subprocess);
  * entry points default to the card and raise without one unless the
    caller passes ``device="cpu"`` -- nothing moves to the CPU by itself;
  * the kernel wrappers refuse a wrong dtype, shape (or K4 head dim) or
    device, and the dispatchers send CPU tensors to the plain versions.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import SMOKE, TCN_SMOKE  # noqa: E402
from repro_torch.configs.rwkv6_7b import SMOKE as LM_SMOKE  # noqa: E402
from repro_torch.core.engine import FrameTCNEngine  # noqa: E402
from repro_torch.core.lif import LIFParams  # noqa: E402
from repro_torch.core.pipeline import (BatchedClosedLoop,  # noqa: E402
                                       ClosedLoopPipeline)
from repro_torch.core.snn import init_snn  # noqa: E402
from repro_torch.core.tcn import init_tcn  # noqa: E402
from repro_torch.data import (TokenTaskConfig,  # noqa: E402
                              dvs_gesture_batch, token_batch)
from repro_torch.kernels import fc_lif_scan as k2  # noqa: E402
from repro_torch.kernels import lif_scan as k1  # noqa: E402
from repro_torch.kernels import ternary_matmul as k3  # noqa: E402
from repro_torch.kernels import wkv6_scan as k4  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import (BatchScheduler, StreamEngine,  # noqa: E402
                                 generate)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")
P = LIFParams()

_IMPORT_ALL = r"""
import importlib, os, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for first in names:
    # A fresh import of the port with ``first`` imported first: an import
    # cycle shows up as an ImportError here.
    for m in [m for m in sys.modules if m.startswith("repro_torch")]:
        del sys.modules[m]
    importlib.import_module(first)
for name in names:
    importlib.import_module(name)
# The port's examples (examples/torch_*.py and the helpers they share).
sys.path.insert(0, sys.argv[1])
examples = sorted(f[:-3] for f in os.listdir(sys.argv[1])
                  if f.startswith("torch_") and f.endswith(".py"))
for name in examples:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro"
             or m.startswith("repro."))
assert not bad, bad
print(len(names), len(examples))
"""


def test_port_imports_neither_jax_nor_repro():
    """Every module of the port imports cleanly when it is the first one
    imported, and the whole package, with the port's examples
    (``examples/torch_*.py``), pulls in neither jax nor repro."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL,
                           os.path.abspath(EXAMPLES)], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    n_modules, n_examples = map(int, proc.stdout.split()[:2])
    assert n_modules >= 38
    assert n_examples >= 10


def _params():
    rng = np.random.default_rng(0)
    mk = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    return {"conv1": {"w": mk(4, 2, 3, 3)}, "conv2": {"w": mk(8, 4, 3, 3)},
            "fc1": {"w": mk(SMOKE.flat_dim, 32)}, "fc2": {"w": mk(32, 11)}}


def _tcn_params():
    rng = np.random.default_rng(1)
    mk = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    return {"conv1": {"w": mk(4, 1, 3, 3)}, "conv2": {"w": mk(8, 4, 3, 3)},
            "fc1": {"w": mk(TCN_SMOKE.flat_dim, 32)},
            "fc2": {"w": mk(32, 11)}}


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card path is moot")
    for make in (lambda: BatchedClosedLoop(_params(), SMOKE),
                 lambda: ClosedLoopPipeline(_params(), SMOKE),
                 lambda: StreamEngine(_params(), SMOKE),
                 lambda: FrameTCNEngine(_tcn_params(), TCN_SMOKE)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert BatchedClosedLoop(_params(), SMOKE, device="cpu").device.type \
        == "cpu"
    assert FrameTCNEngine(_tcn_params(), TCN_SMOKE,
                          device="cpu").device.type == "cpu"


def test_lm_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card path is moot")
    model = build_model(LM_SMOKE)
    params = model.init(device="cpu")
    assert params["embed"].device.type == "cpu"
    prompts = np.ones((1, 2), np.int64)
    for make in (lambda: model.init(),
                 lambda: model.init_cache(1, 4),
                 lambda: generate(model, params, prompts),
                 lambda: BatchScheduler(model, params),
                 lambda: serve_cli.main([])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert BatchScheduler(model, params, device="cpu").device.type == "cpu"
    assert generate(model, params, prompts, device="cpu")[0].shape == (1, 32)


def test_training_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card path is moot")
    tk = TokenTaskConfig(vocab_size=16, seq_len=8, batch_size=2)
    small = dict(height=32, width=32, time_bins=4, mean_events=500)
    for make in (lambda: init_snn(0, SMOKE),
                 lambda: init_tcn(0, TCN_SMOKE),
                 lambda: dvs_gesture_batch(2, 0, **small),
                 lambda: token_batch(tk, 0)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert init_snn(0, SMOKE, device="cpu")["fc1"]["w"].device.type == "cpu"
    assert init_tcn(0, TCN_SMOKE, device="cpu")["fc2"]["w"].device.type \
        == "cpu"
    batch = dvs_gesture_batch(2, 0, device="cpu", **small)
    assert batch.vox.device.type == "cpu" and batch.labels.dtype == torch.int64
    assert token_batch(tk, 0, device="cpu")["tokens"].device.type == "cpu"


def test_lif_wrapper_refuses_bad_inputs():
    before = k1.launches
    cur = torch.zeros(4, 8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k1.lif_scan_cuda(cur.double(), P)
    with pytest.raises(ValueError, match="v0 shape"):
        k1.lif_scan_cuda(cur, P, torch.zeros(7))
    with pytest.raises(ValueError, match="contiguous"):
        k1.lif_scan_cuda(torch.zeros(8, 4).t(), P)
    with pytest.raises(ValueError, match="CUDA"):
        k1.lif_scan_cuda(cur, P)                     # a CPU tensor
    assert k1.launches == before


def test_fc_wrapper_refuses_bad_inputs():
    before = k2.launches
    s, w = torch.zeros(4, 2, 16), torch.zeros(16, 8)
    with pytest.raises(TypeError, match="spikes"):
        k2.fc_lif_scan_cuda(s.half(), w, P)
    with pytest.raises(TypeError, match="weights"):
        k2.fc_lif_scan_cuda(s, w.double(), P)
    with pytest.raises(ValueError, match="do not match"):
        k2.fc_lif_scan_cuda(s, torch.zeros(15, 8), P)
    with pytest.raises(ValueError, match="v0 shape"):
        k2.fc_lif_scan_cuda(s, w, P, torch.zeros(3, 8))
    with pytest.raises(ValueError, match="CUDA"):
        k2.fc_lif_scan_cuda(s, w, P)                 # CPU tensors
    assert k2.launches == before


def _wkv_inputs(b=2, t=3, h=2, hd=16, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn(b, t, h, hd, generator=g).to(dtype)
               for _ in range(3))
    logw = -torch.rand(b, t, h, hd, generator=g)
    return r, k, v, logw, (torch.randn(h, hd, generator=g) * 0.1).to(dtype)


def test_wkv6_wrapper_refuses_bad_inputs():
    before = k4.launches
    r, k, v, logw, u = _wkv_inputs()
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k4.wkv6_scan_cuda(r.double(), k, v, logw, u)
    with pytest.raises(TypeError, match="logw"):
        k4.wkv6_scan_cuda(r, k, v, logw.bfloat16(), u)
    with pytest.raises(TypeError, match="k dtype"):
        k4.wkv6_scan_cuda(r, k.bfloat16(), v, logw, u)
    with pytest.raises(TypeError, match="state0"):
        k4.wkv6_scan_cuda(r, k, v, logw, u, torch.zeros(2, 2, 16, 16).half())
    with pytest.raises(ValueError, match="v shape"):
        k4.wkv6_scan_cuda(r, k, v[:, :2], logw, u)
    with pytest.raises(ValueError, match="u shape"):
        k4.wkv6_scan_cuda(r, k, v, logw, u[:1])
    with pytest.raises(ValueError, match="state0 shape"):
        k4.wkv6_scan_cuda(r, k, v, logw, u, torch.zeros(2, 2, 16, 8))
    with pytest.raises(ValueError, match="head dim 8"):
        k4.wkv6_scan_cuda(*_wkv_inputs(hd=8))
    with pytest.raises(ValueError, match="contiguous"):
        k4.wkv6_scan_cuda(r.transpose(0, 1).contiguous().transpose(0, 1),
                          k, v, logw, u)
    with pytest.raises(ValueError, match="CUDA"):
        k4.wkv6_scan_cuda(r, k, v, logw, u)          # CPU tensors
    assert k4.launches == before


def test_cpu_tensors_take_the_plain_versions():
    before = (k1.launches, k2.launches, k3.launches, k4.launches)
    cur = torch.rand(4, 8)
    assert all(torch.equal(a, b) for a, b in zip(
        k1.lif_scan_fwd(cur, P), k1.lif_scan_plain(cur, P)))
    s, w = torch.rand(4, 2, 16), torch.rand(16, 8)
    assert all(torch.equal(a, b) for a, b in zip(
        k2.fc_lif_scan_fwd(s, w, P), k2.fc_lif_scan_plain(s, w, P)))
    x = torch.rand(3, 16)
    wp = torch.randint(0, 255, (4, 8), dtype=torch.uint8)
    scale = torch.rand(8)
    assert torch.equal(k3.ternary_matmul_fwd(x, wp, scale),
                       k3.ternary_matmul_plain(x, wp, scale))
    r, k, v, logw, u = _wkv_inputs(dtype=torch.bfloat16)
    assert all(torch.equal(a, b) for a, b in zip(
        k4.wkv6_scan_fwd(r, k, v, logw, u),
        k4.wkv6_scan_plain(r, k, v, logw, u)))
    assert (k1.launches, k2.launches, k3.launches, k4.launches) == before
