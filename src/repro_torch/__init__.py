"""ColibriES on PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

The layout mirrors the JAX package, so each module's counterpart is found
by name: ``core/`` (LIF dynamics, event voxelization, the spiking CNN, the
batched closed loop), ``kernels/`` (the hand-written CUDA kernels, each with
its plain PyTorch version), ``serving/`` (the streaming engine) and
``configs/``. ``convert`` carries JAX parameter trees across.

This package imports ``torch`` and ``numpy`` only: never ``jax``, never the
JAX package. Entry points run on the card unless the caller passes
``device="cpu"``.
"""
import torch

# Precision policy, set once for the whole package. cuDNN convolutions
# default to TF32, which keeps about three decimal digits: a conv current
# that far off flips spikes whose membrane sits near v_th, so float32
# convs and matmuls must run in full float32 here.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless asked otherwise.

    ``None`` means ``cuda``. Without a card, only an explicit CPU device is
    accepted; anything else raises rather than moving the work to the CPU.
    ``meta`` (shapes and dtypes, no storage) is accepted for the abstract
    specs of ``launch.steps``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
