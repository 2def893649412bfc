#!/usr/bin/env python3
"""End-to-end rates of two or more checkouts of the repo on one GPU, in
one run, so that the machine is the same for each:

    python3 tools/e2e_ab.py [--lm] [--out FILE] ROOT [ROOT ...]

Each ROOT is the root of a checkout (for a comparison with a parent
commit, unpack it with ``git archive`` into a directory that .gitignore
lists, and give the roots in the order parent, change, change, parent).
For each ROOT in turn, a fresh process imports that checkout's
``chip_smoke.py`` and port, builds its kernels, and measures what its
``chip_smoke.py`` measures: the event lane's windows/s at B=8 and B=1
(``throughput``), then frame-lane windows/s at B=8 and fused ticks/s of
8 FusionSessions (``frame_end_to_end``; with the cross-wing megastep off
and, where the checkout has it, on). With ``--lm`` it then builds the
full rwkv6-7b in bf16 from chip_smoke's seed and measures decode tokens/s
at B=4 (20 samples of 16 ``make_serve_step`` steps) and prefill tokens/s
at B=4, S=2048 (``make_prefill_step``, median of 3), as chip_smoke's
``lm_end_to_end`` does. Prints one JSON line per ROOT with the medians,
and writes every line of every run to ``--out``.
"""
import argparse
import json
import os
import subprocess
import sys


def one(root, lm):
    """Measure the checkout at ``root`` (run in a process of its own)."""
    import torch
    sys.path[:0] = [root, os.path.join(root, "src")]
    import chip_smoke as cs
    import repro_torch  # noqa: F401  (sets the precision policy)
    from repro_torch.configs import CONFIG
    from repro_torch.convert import snn_params_from_numpy
    from repro_torch.kernels import _build
    from repro_torch.kernels import (fc_lif_scan, lif_scan, ternary_matmul,
                                     wkv6_scan)
    _build.build_all([lif_scan.KERNEL, fc_lif_scan.KERNEL,
                      ternary_matmul.KERNEL, wkv6_scan.KERNEL])
    dev = torch.device("cuda")
    params = snn_params_from_numpy(cs._np_params(CONFIG, dyadic=True))
    pool = [w for ws in cs._windows(8, 4, cs.SEED + 3) for w in ws]
    cs.emit("event_B8", **cs.throughput(torch, dev, params, 8, pool))
    cs.emit("event_B1", **cs.throughput(torch, dev, params, 1, pool))
    cs.frame_end_to_end(torch, dev)
    if lm:
        cs.emit("lm", **lm_rates(torch, cs, dev))
    return 0


def lm_rates(torch, cs, dev):
    """Decode and prefill tokens/s of the full rwkv6-7b in bf16, with the
    weights chip_smoke draws (``_lm_params``)."""
    import statistics
    import time
    import numpy as np
    from repro_torch.configs.rwkv6_7b import CONFIG
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import build_model
    model = build_model(CONFIG)
    params = cs._lm_params(torch, model, cs.SEED + 16, dev)
    step = make_serve_step(model.cfg)
    cache = model.init_cache(cs.LM_BATCH, 64, device=dev)
    tok = torch.ones((cs.LM_BATCH, 1), dtype=torch.long, device=dev)
    for _ in range(3):
        tok, cache = step(params, cache, tok)
    rates = []
    for _ in range(cs.DECODE_SAMPLES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(cs.DECODE_STEPS):
            tok, cache = step(params, cache, tok)
        torch.cuda.synchronize()
        rates.append(cs.LM_BATCH * cs.DECODE_STEPS
                     / (time.perf_counter() - t0))
    prefill = make_prefill_step(model.cfg)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(
        cs.SEED + 15).integers(0, model.cfg.vocab_size,
                               (cs.LM_BATCH, cs.LM_PREFILL_S))).to(dev)}
    prefill(params, batch)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return dict(decode_tokens_per_s_median=statistics.median(rates),
                decode_tokens_per_s_min=min(rates),
                decode_tokens_per_s_max=max(rates),
                prefill_s=times,
                prefill_tokens_per_s=(cs.LM_BATCH * cs.LM_PREFILL_S
                                      / statistics.median(times)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--out", default=None)
    ap.add_argument("--lm", action="store_true",
                    help="also measure rwkv6-7b decode and prefill rates")
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return one(os.path.abspath(args.roots[0]), args.lm)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    lines = [json.dumps({"phase": "device", "nvidia_smi": smi.strip()})]
    print(lines[0], flush=True)
    for i, root in enumerate(args.roots):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one",
             *(["--lm"] if args.lm else []), os.path.abspath(root)],
            capture_output=True, text=True)
        got = {}
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                row = json.loads(line)
                lines.append(json.dumps({"run": i, "root": root, **row}))
                got[row.get("phase")] = row
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        fe = got["frame_end_to_end"]
        mega = fe.get("fused_B8_megastep")
        summary = dict(
            run=i, root=root,
            event_windows_per_s_B8=got["event_B8"]["windows_per_s_median"],
            event_windows_per_s_B1=got["event_B1"]["windows_per_s_median"],
            frame_windows_per_s_B8=fe["frame_lane_B8"][
                "windows_per_s_median"],
            fused_ticks_per_s_B8=fe["fused_B8"]["ticks_per_s_median"],
            fused_ticks_per_s_B8_megastep=(
                None if mega is None else mega["ticks_per_s_median"]))
        if args.lm:
            summary.update(
                decode_tokens_per_s_B4=got["lm"]["decode_tokens_per_s_median"],
                prefill_tokens_per_s_B4=got["lm"]["prefill_tokens_per_s"])
        lines.append(json.dumps({"phase": "summary", **summary}))
        print(lines[-1], flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
