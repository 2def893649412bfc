#!/usr/bin/env python3
"""End-to-end rates of two or more checkouts of the repo on one GPU, in
one run, so that the machine is the same for each:

    python3 tools/e2e_ab.py [--out FILE] ROOT [ROOT ...]

Each ROOT is the root of a checkout (for a comparison with a parent
commit, unpack it with ``git archive`` into a directory that .gitignore
lists, and give the roots in the order parent, change, change, parent).
For each ROOT in turn, a fresh process imports that checkout's
``chip_smoke.py`` and port, builds its kernels K1-K3, and measures what
its ``chip_smoke.py`` measures: the event lane's windows/s at B=8
(``throughput``), then frame-lane windows/s at B=8 and fused ticks/s of
8 FusionSessions (``frame_end_to_end``). Prints one JSON line per ROOT
with the medians, and writes every line of every run to ``--out``.
"""
import argparse
import json
import os
import subprocess
import sys


def one(root):
    """Measure the checkout at ``root`` (run in a process of its own)."""
    import torch
    sys.path[:0] = [root, os.path.join(root, "src")]
    import chip_smoke as cs
    import repro_torch  # noqa: F401  (sets the precision policy)
    from repro_torch.configs import CONFIG
    from repro_torch.convert import snn_params_from_numpy
    from repro_torch.kernels import _build
    from repro_torch.kernels import fc_lif_scan, lif_scan, ternary_matmul
    _build.build_all([lif_scan.KERNEL, fc_lif_scan.KERNEL,
                      ternary_matmul.KERNEL])
    dev = torch.device("cuda")
    params = snn_params_from_numpy(cs._np_params(CONFIG, dyadic=True))
    pool = [w for ws in cs._windows(8, 4, cs.SEED + 3) for w in ws]
    cs.emit("event_B8", **cs.throughput(torch, dev, params, 8, pool))
    cs.frame_end_to_end(torch, dev)
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--out", default=None)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        return one(os.path.abspath(args.roots[0]))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    lines = [json.dumps({"phase": "device", "nvidia_smi": smi.strip()})]
    print(lines[0], flush=True)
    for i, root in enumerate(args.roots):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one",
             os.path.abspath(root)], capture_output=True, text=True)
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
        summary = dict(
            run=i, root=root,
            event_windows_per_s_B8=got["event_B8"]["windows_per_s_median"],
            frame_windows_per_s_B8=fe["frame_lane_B8"][
                "windows_per_s_median"],
            fused_ticks_per_s_B8=fe["fused_B8"]["ticks_per_s_median"])
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
