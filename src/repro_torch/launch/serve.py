"""Serving launcher: batched generation, optional CUTIE ternary weights.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --full --quant ternary --requests 8 --new-tokens 24
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \\
      --device cpu

Runs on the card unless given ``--device cpu``; SMOKE sizes unless given
``--full``. The arch names are the JAX package's, and every one of them
is served. The enc-dec arch (``seamless-m4t-medium``) decodes here as in
the JAX package's launcher: with zero cross-attention K/V, no encoder
pass.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config
from repro_torch.models import build_model
from repro_torch.serving import quantize_for_serving
from repro_torch.serving.scheduler import BatchScheduler, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCHS)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--quant", default=None, choices=["ternary"])
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    if args.quant == "ternary":
        params, stats = quantize_for_serving(params)
        print(f"ternary: {stats['quantized']} tensors packed, "
              f"{stats['bytes_before'] / 1e6:.1f} -> "
              f"{stats['bytes_after'] / 1e6:.1f} MB weights")

    rng = np.random.default_rng(0)
    reqs = [Request(
        id=i,
        prompt=rng.integers(2, cfg.vocab_size,
                            size=rng.integers(2, args.prompt_len + 1)),
        max_new_tokens=args.new_tokens)
        for i in range(args.requests)]

    sched = BatchScheduler(model, params, max_batch=args.max_batch,
                           cache_len=args.prompt_len + args.new_tokens + 1,
                           device=dev)
    done = sched.run(reqs)
    for r in done:
        print(f"req {r.id}: prompt[{len(r.prompt)}] -> "
              f"{r.output[:10]}{'...' if len(r.output) > 10 else ''}")
    st = sched.stats
    print(f"served {len(done)} requests in {st['batches']} batches; "
          f"{st['decode_steps']} decode steps; "
          f"{st['tokens'] / max(st['wall_s'], 1e-9):.1f} tok/s host")


if __name__ == "__main__":
    main()
