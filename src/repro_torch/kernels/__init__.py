"""The port's kernels: each CUDA kernel beside its plain PyTorch version.

  * ``lif_scan``    -- K1, the fused LIF scan (``csrc/lif_scan.cu``).
  * ``fc_lif_scan`` -- K2, fused ``spikes @ W`` + LIF (``csrc/fc_lif_scan.cu``).

``ops`` holds the differentiable wrappers the model calls. The package
re-exports no function, so ``repro_torch.kernels.lif_scan`` always names
the kernel's module (with its ``launches`` counter).
"""
