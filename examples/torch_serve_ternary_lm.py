"""Serve an LM with CUTIE-style ternary weights on the PyTorch/CUDA port
(the paper's technique carried to the LM serving path).

The port's counterpart of ``examples/serve_ternary_lm.py``: trains a
small llama3.2-family model briefly on the synthetic repeat task
(``Trainer``), quantizes its GEMM weights to packed 2-bit ternary
(``quantize_for_serving``: on the card those products run through kernel
K3), and serves the same prompts greedily from both variants, reporting
the weight-byte compression, the decode rate (tokens/s on the host's
clock, the card synchronized) and the greedy tokens' agreement.

The start weights are drawn with numpy from the model's declarations
(``torch_common.np_lm_params``). ``--steps 0`` serves them untrained.

Run:  PYTHONPATH=src python examples/torch_serve_ternary_lm.py [--smoke]
      [--steps N] [--device cpu]   (the default device is the card)
"""
import dataclasses

import torch

from torch_common import lm_params, parser

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.data import TokenTaskConfig, token_batch
from repro_torch.models import build_model
from repro_torch.serving import ServeConfig, generate, quantize_for_serving
from repro_torch.training import (AdamWConfig, Trainer, TrainerConfig,
                                  adamw_init)

PROMPTS, PROMPT_LEN, NEW_TOKENS = 4, 8, 12


def model_config():
    """llama3.2-family reduced config, widened so that quantization
    bites (the MLP's 256 x 512 products are packed)."""
    return dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                               d_model=256, d_ff=512, num_heads=8,
                               num_kv_heads=4, head_dim=32)


def task():
    cfg = model_config()
    return TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=32,
                           batch_size=16, task="repeat")


def prompts():
    """The served prompts: the first tokens of the task's batch 999."""
    return token_batch(task(), 999, device="cpu")["tokens"][
        :PROMPTS, :PROMPT_LEN].numpy()


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=None,
                    help="training steps (default 60; 8 with --smoke)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    steps = args.steps if args.steps is not None else (
        8 if args.smoke else 60)
    model = build_model(model_config())
    params = lm_params(model, seed=0, device=dev)

    losses = []
    if steps:
        tk = task()
        tr = Trainer(model, TrainerConfig(
            total_steps=steps, ckpt_every=0, log_every=20,
            opt=AdamWConfig(lr=5e-3, warmup_steps=min(5, steps),
                            total_steps=steps)),
            lambda s: token_batch(tk, s, device=dev), device=dev)
        print(f"training the base model on the repeat task ({steps} "
              f"steps)...")
        res = tr.run(start_state={"params": params,
                                  "opt": adamw_init(params),
                                  "err": torch.zeros((), device=dev)})
        params = res["state"]["params"]
        losses = [h["loss"] for h in res["history"]]

    qparams, stats = quantize_for_serving(params)
    print(f"\nternary serving quantization: {stats['quantized']} tensors "
          f"packed, {stats['kept']} kept fp")
    print(f"  weight bytes {stats['bytes_before'] / 1e6:.1f} MB -> "
          f"{stats['bytes_after'] / 1e6:.1f} MB "
          f"({stats['bytes_before'] / stats['bytes_after']:.2f}x)")

    sc = ServeConfig(max_new_tokens=NEW_TOKENS)
    toks_f, st_f = generate(model, params, prompts(), sc, device=dev)
    toks_q, st_q = generate(model, qparams, prompts(), sc, device=dev)
    agree = float((toks_f == toks_q).mean())
    print(f"\nfull-precision serve: {st_f.tokens_per_s:.1f} tok/s (host)")
    print(f"ternary serve:        {st_q.tokens_per_s:.1f} tok/s (host)")
    print(f"greedy token agreement: {agree:.2f}")
    print("full:    ", toks_f[0].tolist())
    print("ternary: ", toks_q[0].tolist())
    return {"steps": steps, "losses": losses, "quant_stats": dict(stats),
            "tokens_fp": toks_f.tolist(), "tokens_ternary": toks_q.tolist(),
            "agreement": agree, "fp_tokens_per_s": st_f.tokens_per_s,
            "ternary_tokens_per_s": st_q.tokens_per_s}


if __name__ == "__main__":
    main()
