"""Training launcher: any assigned arch, SMOKE size on the CPU or the
card, full size on the card.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --steps 50 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --steps 100 --batch 4 --seq 1024 --remat

The flags are the JAX package's launcher's, plus ``--device`` (the card
unless given ``cpu``). Without ``--smoke`` the config is the published
one at full width and depth: run it on the card only. ``--mesh`` is
refused: the port trains on one device (training over a mesh, FSDP/TP
with collectives, is the part of ROADMAP item 11 still to port; serving
shards its slots, ``EngineConfig.mesh``). The task is
``data.token_batch``'s ``"repeat"``; the enc-dec's encoder frames are
drawn from a ``torch.Generator`` seeded with the step, so they differ
from the JAX launcher's (``jax.random.normal``) while the tokens agree.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config
from repro_torch.data import TokenTaskConfig, token_batch
from repro_torch.models import build_model
from repro_torch.training import AdamWConfig, Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default=None,
                    help="refused: the port trains on one device "
                         "(ROADMAP item 11)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-compression", type=float, default=None)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port trains on one device; "
            f"training over a mesh waits for ROADMAP item 11")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family in ("encdec", "vlm") and args.smoke:
        print(f"note: {args.arch} needs frames/patches; using token-only "
              "batches against the decoder/backbone")
    model = build_model(cfg)
    print(f"{cfg.name}: {model.num_params() / 1e6:.1f}M params on {dev}")

    tk = TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                         batch_size=args.batch, task="repeat")

    def batch_fn(step):
        b = token_batch(tk, step, device=dev)
        if cfg.family == "encdec":
            fd = cfg.frontend_dim or cfg.d_model
            g = torch.Generator(device=dev).manual_seed(step)
            b["frames"] = torch.randn((args.batch, args.seq, fd),
                                      generator=g, device=dev)
        return b

    tcfg = TrainerConfig(
        total_steps=args.steps,
        ckpt_every=max(args.steps // 4, 1),
        ckpt_dir=args.ckpt_dir or f"checkpoints/{args.arch}",
        log_every=max(args.steps // 10, 1),
        remat=args.remat,
        grad_compression_ratio=args.grad_compression,
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps),
    )
    trainer = Trainer(model, tcfg, batch_fn, device=dev)
    res = trainer.run_with_restarts(torch.Generator(device=dev)
                                    .manual_seed(0))
    h = res["history"]
    print(f"done: loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f} over "
          f"{res['final_step']} steps; stragglers={trainer.straggler_steps}")
    return res


if __name__ == "__main__":
    main()
