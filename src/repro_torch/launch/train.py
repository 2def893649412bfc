"""Training launcher: any assigned arch, SMOKE size on the CPU or the
card, full size on the card, on one device or over a mesh of ranks.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --steps 50 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --steps 100 --batch 4 --seq 1024 --remat
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --mesh 2x2 --spawn --steps 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch \\
      deepseek-moe-16b --smoke --mesh 2x2 --spawn --steps 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-vl-2b \\
      --smoke --mesh 2x2 --spawn --steps 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \\
      --smoke --mesh 1x4 --spawn --steps 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --smoke --mesh 2x2x1 --spawn --steps 2 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch \\
      seamless-m4t-medium --smoke --mesh 2x2 --spawn --steps 2 --device cpu
  # one process a rank, e.g. rank 1 of 4 (every rank the same flags):
  PYTHONPATH=src python -m repro_torch.launch.train --mesh 2x2 \\
      --world-size 4 --rank 1 --address localhost --port 29500 ...

The flags are the JAX package's launcher's, plus ``--device`` (the card
unless given ``cpu``) and the process flags. Without ``--smoke`` the
config is the published one at full width and depth: run it on the card
only. With ``--mesh DxM``, params, AdamW moments and batch rows are
sharded by ``param_pspecs``/``opt_pspecs``/``batch_pspecs`` over a
``(data=D, model=M)`` process mesh (FSDP over ``data``, TP over
``model``; ``training.Trainer(shardings=...)``), with ``--mesh PxDxM``
over ``(pod=P, data=D, model=M)`` (``pod`` pure data parallelism: params
copied, batch rows split, gradients summed over it), one process a rank:
``--spawn`` starts every rank on this host, otherwise this process
is rank ``--rank`` of ``--world-size`` and joins ``tcp://ADDRESS:PORT``.
A batch that does not divide ``data`` is copied over it, as the JAX
package lays it out. A ``--mesh`` of one part raises ``ValueError``, as
the JAX package's launcher does (``Trainer`` itself takes a ``("data",)``
mesh).
``--backend`` is ``gloo`` on the CPU; on the card ``nccl`` when there is
a card a rank, else ``gloo`` (ranks sharing a card). Rank ``r`` runs on
``cuda:(r % cards)``. Every family trains over a mesh; rwkv6 or zamba2
heads (or MoE experts) that the model axis would split are refused by
name. The task is
``data.token_batch``'s ``"repeat"``; the enc-dec's encoder frames are
drawn from a ``torch.Generator`` seeded with the step, so they differ
from the JAX launcher's (``jax.random.normal``) while the tokens agree.
"""
from __future__ import annotations

import argparse
import math

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config
from repro_torch.data import TokenTaskConfig, token_batch
from repro_torch.distributed import runtime
from repro_torch.models import build_model
from repro_torch.training import AdamWConfig, Trainer, TrainerConfig
from repro_torch.training.trainer import refuse_unsupported, state_shardings


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mesh", default=None,
                    help="DxM: (data=D, model=M) over D*M ranks; PxDxM: "
                         "(pod=P, data=D, model=M) over P*D*M ranks")
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--address", default="localhost")
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--spawn", action="store_true",
                    help="start every rank of --mesh on this host")
    ap.add_argument("--backend", default=None, choices=runtime.BACKENDS)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-compression", type=float, default=None)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap


def _mesh_shape(text: str, cfg):
    """``--mesh``'s shape: ``DxM`` over ``("data", "model")``, ``PxDxM``
    over ``("pod", "data", "model")``; any other number of parts raises
    ``ValueError``, as the JAX package's launcher does."""
    shape = tuple(int(x) for x in text.split("x"))
    if len(shape) not in (2, 3):
        raise ValueError(f"--mesh {text}: DxM (or PxDxM)")
    refuse_unsupported(cfg, runtime.MESH_AXES[len(shape)], shape[-1])
    return shape


def main(argv=None):
    args = _parser().parse_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    if not args.mesh:
        return _train(args, resolve_device(args.device), None)
    shape = _mesh_shape(args.mesh, cfg)
    world = math.prod(shape)
    if args.world_size not in (None, world):
        raise ValueError(f"--world-size {args.world_size} for a "
                         f"{args.mesh} mesh")
    if args.spawn:
        runtime.spawn(_rank_main, world,
                      (args, shape, args.port or runtime.free_port()))
        return None
    if args.rank is None or args.port is None:
        raise ValueError("--mesh without --spawn needs --rank and --port")
    return _rank_main(args.rank, world, args, shape, args.port)


def _rank_main(rank: int, world: int, args, shape, port: int):
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        dev = torch.device("cuda", rank % cards)
        backend = args.backend or ("nccl" if cards >= world else "gloo")
    else:
        backend = args.backend or "gloo"
    pmesh = runtime.init(args.address, port, world, rank, backend=backend,
                         device=dev, shape=shape)
    return _train(args, dev, pmesh)


def _train(args, dev, pmesh):
    cfg = get_config(args.arch, smoke=args.smoke)
    lead = pmesh is None or pmesh.rank == 0
    if cfg.family in ("encdec", "vlm") and args.smoke and lead:
        print(f"note: {args.arch} needs frames/patches; using token-only "
              "batches against the decoder/backbone")
    model = build_model(cfg)
    if lead:
        where = dev if pmesh is None else (
            f"a {pmesh.shape} mesh of {pmesh.size} ranks ({pmesh.backend})")
        print(f"{cfg.name}: {model.num_params() / 1e6:.1f}M params on "
              f"{where}")

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
    shardings = None if pmesh is None else state_shardings(
        model, pmesh, args.grad_compression is not None)
    trainer = Trainer(model, tcfg, batch_fn, shardings=shardings,
                      device=dev)
    res = trainer.run_with_restarts(torch.Generator(device=dev)
                                    .manual_seed(0))
    h = res["history"]
    if lead:
        print(f"done: loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f} over "
              f"{res['final_step']} steps; "
              f"stragglers={trainer.straggler_steps}")
    return res


if __name__ == "__main__":
    main()
