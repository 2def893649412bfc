"""The port's kernels: each CUDA kernel beside its plain PyTorch version.

  * ``lif_scan``    -- K1, the fused LIF scan (``csrc/lif_scan.cu``).
  * ``fc_lif_scan`` -- K2, fused ``spikes @ W`` + LIF (``csrc/fc_lif_scan.cu``).
  * ``ternary_matmul`` -- K3, packed-ternary matmul
    (``csrc/ternary_matmul.cu``).
  * ``wkv6_scan``   -- K4, the RWKV-6 WKV recurrence (``csrc/wkv6_scan.cu``).

``ops`` holds the wrappers the models call, ``ref`` the plain oracles.
The package re-exports no function, so ``repro_torch.kernels.lif_scan``
always names the kernel's module (with its ``launches`` counter).
"""
