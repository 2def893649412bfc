#!/usr/bin/env python3
"""Measurements behind K4's design (``src/repro_torch/csrc/wkv6_scan.cu``)
on one NVIDIA H100. Run from the root of a checkout:

    python3 tools/k4_probe.py [--out k4_probe.json] [--only NAME ...]
                              [--sass PATH] [--extra NAME=PATH ...]

Prints one JSON line per phase (and writes them all to ``--out``):

  1. ``device``: the card's name, power limit and top SM clock;
  2. ``ptxas``: registers, stack and spills of the bf16-model instance
     (bf16 r/k/v/u, f32 logw, hd = 64) of every variant (``nvcc -Xptxas
     -v``); with ``--sass PATH``, the committed build's SASS listing
     (``cuobjdump -sass``) in that file;
  3. ``k4_variants``: the committed source and copies whose ``IS``
     (i-segment width), ``TC`` (steps a staged time chunk), ``CPT``
     (columns a thread), ``COL_SPLIT`` (blocks a (b, h)), ``HELPERS``
     (helper warps a block) or ``MINB`` (the blocks an SM the register
     budget is cut for) line is replaced, and each ``--extra`` source
     with the same C entry points (e.g. a parent commit's), built with
     one nvcc each, all at once. Each variant is first held bit for bit
     against ``wkv6_scan_plain(..., seg=IS)`` of its own IS (bf16 with
     f32 logw at T = 1 from a state, T = 37 ragged from a state and
     T = 256; f32 at hd = 32 and hd = 16, T = 37); a source without IS,
     an earlier design with another order, is held to nothing. Then each
     is timed at the LM's calls (B = 4, H = 64, hd = 64, bf16, f32 logw):
     prefill T = 2048 and T = 256 from zeros, decode T = 1 from a state,
     each from a cold and a warm L2 as ``chip_smoke.py`` times them, with
     its geometry (threads and shared bytes a block, blocks an SM);
  4. ``empty_call``: an add on one element timed the same way, the fixed
     cost of any call under this harness;
  5. ``clock``: the SM clock (nvidia-smi) while the committed kernel runs
     prefill calls back to back, and the cycles a step that gives.
"""
import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "src", "repro_torch", "_build", "probe")

# Variants: constexpr lines of the committed source replaced.
VARIANTS = {
    "committed": {},
    "cpt1": {"CPT": "1"},
    "is32": {"IS": "32"},
    "is32_cpt1": {"IS": "32", "CPT": "1"},
    "tc8": {"TC": "8"},
    "tc32": {"TC": "32"},
    "is32_tc8": {"IS": "32", "TC": "8"},
    "is32_tc32": {"IS": "32", "TC": "32"},
    "split2": {"COL_SPLIT": "2"},
    "split2_cpt1": {"COL_SPLIT": "2", "CPT": "1"},
    "split2_is32": {"COL_SPLIT": "2", "IS": "32"},
    "cpt4": {"CPT": "4"},
    "cpt4_tc8": {"CPT": "4", "TC": "8"},
    "split2_tc8": {"COL_SPLIT": "2", "TC": "8"},
    "minb4": {"MINB": "4"},
    "helpers1": {"HELPERS": "1"},
    "helpers4": {"HELPERS": "4"},
}
SRC = os.path.join(ROOT, "src", "repro_torch", "csrc", "wkv6_scan.cu")
ENTRY = {"bf16": "wkv6_scan_bf16_lwf32", "f32": "wkv6_scan_f32"}


def emit(out, phase, **fields):
    line = json.dumps({"phase": phase, **fields})
    print(line, flush=True)
    out.append(line)


def constant(text, key):
    found = re.search(rf"constexpr int {key} = (\d+);", text)
    return None if found is None else int(found.group(1))


def variant_source(name, subs):
    with open(SRC) as f:
        text = f.read()
    for key, value in subs.items():
        head = re.search(rf"constexpr int {key} = ", text)
        end = text.index(";", head.end())
        text = text[:head.end()] + value + text[end:]
    os.makedirs(BUILD, exist_ok=True)
    path = os.path.join(BUILD, f"k4_{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    return path, constant(text, "IS")


def build(sources):
    """Build {name: .cu path}, one nvcc each, all at once; returns the
    loaded libraries and each build's ptxas lines for the bf16-model
    instance at hd = 64."""
    from repro_torch.kernels import _build
    procs = {}
    for name, src in sources.items():
        lib = os.path.join(BUILD, f"libk4_{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               lib, src]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs, reports = {}, {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        at = next(i for i, line in enumerate(lines)
                  if "kernelI13__nv_bfloat16fLi64E" in line)
        reports[name] = [line.strip() for line in lines[at + 1:at + 3]]
        libs[name] = ctypes.CDLL(lib)
    return libs, reports


def entry(lib, kind):
    fn = getattr(lib, ENTRY[kind])
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def geometry(lib):
    if not hasattr(lib, "wkv6_scan_geometry"):
        return None
    out = (ctypes.c_int * 5)()
    if lib.wkv6_scan_geometry(64, out) != 0:
        raise RuntimeError("wkv6_scan_geometry failed")
    return dict(zip(("IS", "TC", "threads", "smem_bytes", "blocks_per_sm"),
                    out))


def runner(torch, fn, r, k, v, lw, u, s0):
    """A call of a variant's entry on preallocated outputs."""
    b, t, h, hd = r.shape
    o = torch.empty_like(r)
    st = torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device)
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
            u.data_ptr(), None if s0 is None else s0.data_ptr(),
            o.data_ptr(), st.data_ptr(), b, t, h, hd)

    def run():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"K4 variant launch failed: CUDA error {rc}")
        return o, st
    return run


# (name, B, T, H, hd, kind, state0) of the bit-for-bit checks.
CHECKS = [("decode_T1", 4, 1, 64, 64, "bf16", True),
          ("ragged_T37", 4, 37, 64, 64, "bf16", True),
          ("T256", 4, 256, 64, 64, "bf16", False),
          ("hd32_T37", 2, 37, 4, 32, "f32", False),
          ("hd16_T37", 2, 37, 4, 16, "f32", True)]
# (name, T, state0) of the timed LM calls, B = 4, H = 64, hd = 64, bf16.
TIMED = [("prefill_T2048", 2048, False), ("T256", 256, False),
         ("decode_T1", 1, True)]
CLOCK_REPLAYS = 15     # x 200 prefill calls, ~2 s of device time


def variants_phase(torch, libs, seg, out):
    import chip_smoke as cs
    from repro_torch.kernels import wkv6_scan as k4
    dev = torch.device("cuda")
    flush = torch.ones(cs.FLUSH_BYTES // 4, device=dev)
    g = torch.Generator().manual_seed(17)
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    checks, plains = [], {}
    for case in CHECKS:
        name, b, t, h, hd, kind, state = case
        ins = cs._wkv_inputs(torch, g, dev, b, t, h, hd, dt[kind], state)
        checks.append((case, ins))
        for s in set(seg.values()) - {None}:
            plains[name, s] = k4.wkv6_scan_plain(*ins, seg=s)
    timed = {name: cs._wkv_inputs(torch, g, dev, cs.LM_BATCH, t, 64, 64,
                                  torch.bfloat16, state)
             for name, t, state in TIMED}
    rows = []
    for var, lib in libs.items():
        row = dict(variant=var, subs=VARIANTS.get(var, "--extra source"),
                   geometry=geometry(lib),
                   bitwise={})
        for (name, *_, kind, _s), ins in checks:
            got = runner(torch, entry(lib, kind), *ins)()
            torch.cuda.synchronize()
            # A source without IS (an earlier design) has another order:
            # timed beside the others, held to nothing.
            row["bitwise"][name] = (None if seg[var] is None else cs._bitwise(
                torch, plains[name, seg[var]], got))
        for name, t, state in TIMED:
            run = runner(torch, entry(lib, "bf16"), *timed[name])
            row[name] = dict(ms=cs._device_ms(torch, run, flush),
                             warm_l2_ms=cs._warm_ms(torch, run))
        rows.append(row)
        print(json.dumps(row), flush=True)
    emit(out, "k4_variants", unit="ms of device time a call (chip_smoke's "
         "_device_ms from a cold L2, _warm_ms warm); B=4, H=64, hd=64, bf16 "
         "r/k/v/u, f32 logw", rows=rows)
    bad = [r["variant"] for r in rows
           if False in r["bitwise"].values()]
    if bad:
        raise AssertionError(f"variants that differ from the plain "
                             f"version of their IS: {bad}")
    return timed


def empty_phase(torch, out):
    import chip_smoke as cs
    flush = torch.ones(cs.FLUSH_BYTES // 4, device="cuda")
    x = torch.zeros(1, device="cuda")
    emit(out, "empty_call", what="x.add_(1) on one element",
         ms=cs._device_ms(torch, lambda: x.add_(1), flush),
         warm_l2_ms=cs._warm_ms(torch, lambda: x.add_(1)))


def clock_phase(torch, lib, timed, out):
    """The SM clock while the committed kernel runs prefill calls back to
    back (queued in one CUDA graph), sampled by nvidia-smi."""
    import chip_smoke as cs
    run = runner(torch, entry(lib, "bf16"), *timed["prefill_T2048"])
    graph = cs._graph(torch, run, calls=200)
    samples = []

    def sample():
        time.sleep(0.05)
        for _ in range(4):
            samples.append(subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader"], capture_output=True,
                text=True).stdout.strip())
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(CLOCK_REPLAYS):
        graph.replay()
    b.record()
    thread = threading.Thread(target=sample)
    thread.start()
    thread.join()
    b.synchronize()
    ms = a.elapsed_time(b) / (CLOCK_REPLAYS * 200)
    mhz = [float(s.split()[0]) for s in samples if s]
    emit(out, "clock", samples=samples, prefill_ms_warm=ms,
         cycles_a_step=(ms * 1e-3 * statistics.median(mhz) * 1e6 / 2048
                        if mhz else None))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", nargs="*", default=None,
                    help="build and time only these variants")
    ap.add_argument("--extra", action="append", default=[],
                    metavar="NAME=PATH",
                    help="also build and time this K4 source (same C entry "
                         "points)")
    ap.add_argument("--sass", default=None,
                    help="write the committed build's SASS listing here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k4_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = []
    emit(out, "device", nvidia_smi=smi.strip(), torch=torch.__version__)
    names = args.only or list(VARIANTS)
    if "committed" not in names:
        names = ["committed", *names]
    sources, seg = {}, {}
    for name in names:
        sources[name], seg[name] = variant_source(name, VARIANTS[name])
    for name, path in (e.split("=", 1) for e in args.extra):
        with open(path) as f:
            sources[name], seg[name] = path, constant(f.read(), "IS")
    libs, reports = build(sources)
    emit(out, "ptxas", instance="bf16 r/k/v/u, f32 logw, hd=64",
         report=reports)
    if args.sass:
        from repro_torch.kernels import _build
        tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
        with open(args.sass, "w") as f:
            subprocess.run([tool, "-sass", os.path.join(
                BUILD, "libk4_committed.so")], stdout=f, check=True)
    timed = variants_phase(torch, libs, seg, out)
    empty_phase(torch, out)
    clock_phase(torch, libs["committed"], timed, out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
