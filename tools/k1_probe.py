#!/usr/bin/env python3
"""Measurements behind K1's design (``src/repro_torch/csrc/lif_scan.cu``)
on one NVIDIA H100. Run from the root of a checkout:

    python3 tools/k1_probe.py [--out k1_probe.json] [--only NAME ...]
                              [--extra NAME=PATH ...] [--sass PATH]
                              [--ab NAME ... [--rounds N]]
                              [--host ROOT ...]

Prints one JSON line per phase (and writes them all to ``--out``):

  1. ``device``: the card's name, power limit and top SM clock;
  2. ``ptxas``: registers, stack and spills of every variant's f32 and
     bf16 instances (``nvcc -Xptxas -v``);
  3. ``k1_variants``: the committed source and copies whose ``TC``
     (steps a chunk: 4, 8 or 16) or ``THREADS`` (a block: 128 or 256)
     line is replaced, and each ``--extra`` source with the same C entry points (e.g. the
     parent commit's), built with one nvcc each, all at once. Each is
     first held bit for bit against ``lif_scan_plain`` (the main path's
     shapes in f32 and bf16 with and without ``v0``, ragged rows, a row
     narrower than a block, T = 1 and T = 17, misaligned storage), then
     timed at the event wing's calls (conv1 ``(16, 8, 32, 32, 16)`` and
     conv2 ``(16, 8, 16, 16, 32)``, f32, ``v0`` of zeros, as
     ``chip_smoke.py`` times them) from a cold and a warm L2;
  4. ``t_sweep``: the committed source and every ``--extra`` source at
     conv1's 131,072 neurons for T = 1, 4, 16 and 64, cold and warm: a
     time that grows by one memory round trip a step is latency, a time
     that stays flat is the call's fixed cost;
  5. ``empty_call``: an add on one element timed the same way, the fixed
     cost of any call under this harness;
  6. ``k1_graph``: the committed and every ``--extra`` source, and an
     empty call, launched ``GRAPH_CALLS`` times in one CUDA graph, each
     launch on buffers of its own (conv1's 16 sets hold 5x the L2), from
     a cold L2: the graph's time over its launches is a launch's time
     with the fixed cost spread over the graph, read against the bytes
     bound without subtracting anything;
  7. ``clock``: the SM clock (nvidia-smi) while the committed kernel runs
     conv1 calls back to back;
  8. with ``--sass PATH``: the committed build's SASS listing
     (``cuobjdump -sass``) in that file, and ``sass``: for every kernel
     instance of the committed and ``--extra`` builds, the global loads
     (``LDG``) before its first global store (``STG``);
  9. with ``--ab NAME ...``: ``k1_ab``, those builds and an empty call
     in ``--rounds`` rounds (order reversed every other round), each
     timing conv1 and conv2 cold and warm, and T = 1 and T = 4 calls at
     conv1's neurons, all on the same buffers: the medians and quartiles
     of a step (and of the short calls) over the rounds (give a second copy
     of the committed source with ``--extra`` for an A/A control);
  10. with ``--host ROOT ...``: ``k1_host``, host microseconds a call in
     each checkout ROOT (one process each, in the order given: parent,
     change, change, parent), 200 calls queued without a
     synchronisation, median of 5 (this checkout's
     ``chip_smoke._host_us``), at conv1 and conv2: ``ops.lif_scan``
     under ``no_grad`` (what the engine calls), the wrapper
     ``lif_scan_cuda``, and the library's entry through ctypes with every
     argument ready.
"""
import argparse
import ctypes
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "src", "repro_torch", "_build", "probe")
SRC = os.path.join(ROOT, "src", "repro_torch", "csrc", "lif_scan.cu")

# Variants: constexpr lines of the committed source replaced.
VARIANTS = {"committed": {}}
for _tc in (4, 8, 16):
    for _th in (128, 256):
        VARIANTS[f"tc{_tc}_b{_th}"] = {"TC": str(_tc), "THREADS": str(_th)}
ENTRY = {"f32": "lif_scan_f32", "bf16": "lif_scan_bf16"}
# The event wing's two calls a step: (T, B, H, W, C).
CONV1 = (16, 8, 32, 32, 16)
CONV2 = (16, 8, 16, 16, 32)
SWEEP_T = (1, 4, 16, 64)
GRAPH_CALLS = 16                  # launches in one graph, buffers each


def emit(out, phase, **fields):
    line = json.dumps({"phase": phase, **fields})
    print(line, flush=True)
    out.append(line)


def variant_source(name, subs):
    with open(SRC) as f:
        text = f.read()
    for key, value in subs.items():
        head = re.search(rf"constexpr int {key} = ", text)
        end = text.index(";", head.end())
        text = text[:head.end()] + value + text[end:]
    os.makedirs(BUILD, exist_ok=True)
    path = os.path.join(BUILD, f"k1_{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def build(sources):
    """Build {name: .cu path}, one nvcc each, all at once; returns the
    loaded libraries, each build's ptxas lines and library paths."""
    from repro_torch.kernels import _build
    procs = {}
    for name, src in sources.items():
        lib = os.path.join(BUILD, f"libk1_{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               lib, src]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs, reports, paths = {}, {}, {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        reports[name] = [line.strip() for line in log.splitlines()
                         if "registers" in line or "spill" in line
                         or "Compiling entry" in line]
        libs[name] = ctypes.CDLL(lib)
        paths[name] = lib
    return libs, reports, paths


def entry(lib, kind):
    fn = getattr(lib, ENTRY[kind])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_float,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def geometry(lib):
    if not hasattr(lib, "lif_scan_geometry"):
        return None
    out = (ctypes.c_int * 3)()
    lib.lif_scan_geometry(out)
    return dict(zip(("TC", "TAIL", "THREADS"), out))


def runner(torch, fn, cur, v0, p, outs=None):
    """A call of a library's entry on preallocated outputs (``outs``, a
    (spikes, v_final) pair, or new ones)."""
    spk, vfin = outs if outs is not None else (
        torch.empty_like(cur),
        torch.empty(cur.shape[1:], dtype=cur.dtype, device=cur.device))
    args = (cur.data_ptr(), None if v0 is None else v0.data_ptr(),
            spk.data_ptr(), vfin.data_ptr(), cur[0].numel(), cur.shape[0],
            float(p.alpha), float(p.v_th))

    def run():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"K1 variant launch failed: CUDA error {rc}")
        return spk, vfin
    return run


# (name, shape (T, ...), dtype, v0, misaligned) of the bit-for-bit checks.
CHECKS = [("conv1_f32_v0", CONV1, "f32", True, False),
          ("conv1_bf16_v0", CONV1, "bf16", True, False),
          ("conv2_f32", CONV2, "f32", False, False),
          ("conv2_bf16_v0", CONV2, "bf16", True, False),
          ("T17_n37_f32_v0", (17, 37), "f32", True, False),
          ("T17_n37_bf16", (17, 37), "bf16", False, False),
          ("T1_conv2_f32_v0", (1,) + CONV2[1:], "f32", True, False),
          ("T5_n12_bf16_v0", (5, 12), "bf16", True, False),
          ("T5_n16_bf16_v0", (5, 16), "bf16", True, False),
          ("misaligned_conv2_f32_v0", CONV2, "f32", True, True),
          ("misaligned_T17_bf16_v0", (17, 3, 40), "bf16", True, True)]


def _inputs(torch, g, shape, kind, with_v0, misaligned, dev):
    import chip_smoke as cs
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[kind]
    cur = (torch.randn(*shape, generator=g) * 0.6 + 0.3).to(dt).to(dev)
    v0 = ((torch.rand(*shape[1:], generator=g) * 1.4 - 0.2).to(dev)
          if with_v0 else None)
    if misaligned:
        cur = cs._misaligned(torch, cur)
        v0 = None if v0 is None else cs._misaligned(torch, v0)
    return cur, v0


def variants_phase(torch, libs, out):
    import chip_smoke as cs
    from repro_torch.configs import CONFIG
    from repro_torch.kernels import lif_scan as k1
    p = CONFIG.lif
    dev = torch.device("cuda")
    flush = torch.ones(cs.FLUSH_BYTES // 4, device=dev)
    g = torch.Generator().manual_seed(21)
    checks = []
    for name, shape, kind, with_v0, mis in CHECKS:
        cur, v0 = _inputs(torch, g, shape, kind, with_v0, mis, dev)
        checks.append((name, kind, cur, v0, k1.lif_scan_plain(cur, p, v0)))
    timed = {name: (torch.randn(*shape, generator=g) * 0.6 + 0.3).to(dev)
             for name, shape in (("conv1", CONV1), ("conv2", CONV2))}
    rows = []
    for var, lib in libs.items():
        row = dict(variant=var, subs=VARIANTS.get(var, "--extra source"),
                   geometry=geometry(lib), bitwise={})
        for name, kind, cur, v0, want in checks:
            got = runner(torch, entry(lib, kind), cur, v0, p)()
            torch.cuda.synchronize()
            row["bitwise"][name] = cs._bitwise(torch, want, got)
        for name, cur in timed.items():
            run = runner(torch, entry(lib, "f32"), cur,
                         torch.zeros(cur.shape[1:], device=dev), p)
            row[name] = dict(ms=cs._device_ms(torch, run, flush),
                             warm_l2_ms=cs._warm_ms(torch, run))
        row["step_ms"] = row["conv1"]["ms"] + row["conv2"]["ms"]
        row["step_warm_l2_ms"] = (row["conv1"]["warm_l2_ms"]
                                  + row["conv2"]["warm_l2_ms"])
        rows.append(row)
        print(json.dumps(row), flush=True)
    emit(out, "k1_variants", unit="ms of device time a call (chip_smoke's "
         "_device_ms from a cold L2, _warm_ms warm); f32, v0 of zeros",
         shapes={"conv1": CONV1, "conv2": CONV2}, rows=rows,
         fastest_cold=sorted((r["step_ms"], r["variant"]) for r in rows)[:5])
    bad = [r["variant"] for r in rows if not all(r["bitwise"].values())]
    if bad:
        raise AssertionError(f"variants that differ from the plain "
                             f"version: {bad}")


def sweep_phase(torch, libs, out):
    import chip_smoke as cs
    from repro_torch.configs import CONFIG
    p = CONFIG.lif
    dev = torch.device("cuda")
    flush = torch.ones(cs.FLUSH_BYTES // 4, device=dev)
    g = torch.Generator().manual_seed(22)
    v0 = torch.zeros(CONV1[1:], device=dev)
    rows = {}
    for t in SWEEP_T:
        cur = (torch.randn(t, *CONV1[1:], generator=g) * 0.6 + 0.3).to(dev)
        rows[f"T{t}"] = {}
        for var, lib in libs.items():
            run = runner(torch, entry(lib, "f32"), cur, v0, p)
            rows[f"T{t}"][var] = dict(ms=cs._device_ms(torch, run, flush),
                                      warm_l2_ms=cs._warm_ms(torch, run))
    emit(out, "t_sweep", n=int(v0.numel()), unit="ms a call, f32, v0 of "
         "zeros", rows=rows)


def _quartiles(xs):
    xs = sorted(xs)
    q = statistics.quantiles(xs, n=4) if len(xs) > 1 else xs * 3
    return dict(median=statistics.median(xs), q1=q[0], q3=q[2])


def ab_phase(torch, libs, names, rounds, out):
    """``rounds`` rounds over ``names`` (and an empty call), the order
    reversed every other round, each timing conv1 and conv2 cold and
    warm and T = 1 and T = 4 calls at conv1's neurons (the kernel's
    single-step and TAIL loops) cold and warm: medians and quartiles of
    the step and of the short calls over the rounds. Every
    build reads and writes the same buffers, so that where they lie in
    memory favours none of them; an ``--extra`` copy of the committed
    source among ``names`` measures what is left of such bias."""
    import chip_smoke as cs
    from repro_torch.configs import CONFIG
    p = CONFIG.lif
    dev = torch.device("cuda")
    flush = torch.ones(cs.FLUSH_BYTES // 4, device=dev)
    g = torch.Generator().manual_seed(23)
    calls = {}
    for shape in (CONV1, CONV2, (1,) + CONV1[1:], (4,) + CONV1[1:]):
        cur = (torch.randn(*shape, generator=g) * 0.6 + 0.3).to(dev)
        v0 = torch.zeros(shape[1:], device=dev)
        outs = (torch.empty_like(cur), torch.empty_like(v0))
        for name in names:
            calls.setdefault(name, []).append(
                runner(torch, entry(libs[name], "f32"), cur, v0, p, outs))
    one = torch.zeros(1, device=dev)
    calls["empty"] = [lambda: one.add_(1)] * 4
    order = [*names, "empty"]
    keys = ("conv1", "conv2", "t1", "t4")
    steps = {name: dict(cold=[], warm=[],
                        **{k + w: [] for k in keys for w in ("", "_warm")})
             for name in order}
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            cold = [cs._device_ms(torch, f, flush) for f in calls[name]]
            warm = [cs._warm_ms(torch, f) for f in calls[name]]
            steps[name]["cold"].append(cold[0] + cold[1])
            steps[name]["warm"].append(warm[0] + warm[1])
            for k, c, w in zip(keys, cold, warm):
                steps[name][k].append(c)
                steps[name][k + "_warm"].append(w)
    rows = {name: {k: _quartiles(v) for k, v in st.items()}
            for name, st in steps.items()}
    emit(out, "k1_ab", rounds=rounds, unit="ms of a step (conv1 + conv2; "
         "for empty, two empty calls) and of each call alone (t1, t4: "
         "T = 1 and 4 at conv1's neurons; for empty, one empty call), "
         "f32, v0 of zeros; "
         "median and quartiles over the rounds", rows=rows, samples=steps)


def graph_phase(torch, libs, out):
    """Each build at conv1 and conv2 (and an empty call) launched
    GRAPH_CALLS times in one CUDA graph, every launch on buffers of its
    own (the same for every build), from a cold L2: a launch's time with
    the graph's fixed cost spread over its launches. Median of
    chip_smoke's REPS replays."""
    import chip_smoke as cs
    from repro_torch.configs import CONFIG
    p = CONFIG.lif
    dev = torch.device("cuda")
    flush = torch.ones(cs.FLUSH_BYTES // 4, device=dev)
    g = torch.Generator().manual_seed(24)
    sets = {name: [((torch.randn(*shape, generator=g) * 0.6 + 0.3).to(dev),
                    torch.zeros(shape[1:], device=dev),
                    (torch.empty(shape, device=dev),
                     torch.empty(shape[1:], device=dev)))
                   for _ in range(GRAPH_CALLS)]
            for name, shape in (("conv1", CONV1), ("conv2", CONV2))}

    def per_launch(fns):
        def run():
            for fn in fns:
                fn()
        return cs._device_ms(torch, run, flush) / len(fns)
    rows = {}
    for var, lib in libs.items():
        fn = entry(lib, "f32")
        rows[var] = {name: per_launch([runner(torch, fn, cur, v0, p, o)
                                       for cur, v0, o in ins])
                     for name, ins in sets.items()}
    ones = [torch.zeros(1, device=dev) for _ in range(GRAPH_CALLS)]
    rows["empty"] = per_launch([lambda x=x: x.add_(1) for x in ones])
    bound = {}
    for name, shape in (("conv1", CONV1), ("conv2", CONV2)):
        t, n = shape[0], math.prod(shape[1:])
        # chip_smoke's K1 bound: currents, spikes, v0 and v_final.
        bound[name] = cs._bound_ms(4 * (2 * t * n + 2 * n), 3 * t * n)[0]
    emit(out, "k1_graph", calls=GRAPH_CALLS, unit="ms a launch: one CUDA "
         "graph of that many launches, each on its own buffers, from a "
         "cold L2, over its launches; f32, v0 of zeros", rows=rows,
         bound_ms=bound)


def empty_phase(torch, out):
    import chip_smoke as cs
    flush = torch.ones(cs.FLUSH_BYTES // 4, device="cuda")
    x = torch.zeros(1, device="cuda")
    emit(out, "empty_call", what="x.add_(1) on one element",
         ms=cs._device_ms(torch, lambda: x.add_(1), flush),
         warm_l2_ms=cs._warm_ms(torch, lambda: x.add_(1)))


def clock_phase(torch, lib, out):
    """The SM clock while the committed kernel runs conv1 calls back to
    back (queued in one CUDA graph), sampled by nvidia-smi."""
    import chip_smoke as cs
    from repro_torch.configs import CONFIG
    dev = torch.device("cuda")
    cur = torch.rand(CONV1, device=dev)
    run = runner(torch, entry(lib, "f32"), cur,
                 torch.zeros(CONV1[1:], device=dev), CONFIG.lif)
    graph = cs._graph(torch, run, calls=500)
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
    replays = 400
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    thread = threading.Thread(target=sample)
    thread.start()
    thread.join()
    b.synchronize()
    emit(out, "clock", samples=samples,
         conv1_ms_warm=a.elapsed_time(b) / (replays * 500))


def sass_phase(paths, listing, out):
    """Global loads before the first global store, per kernel instance."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    counts = {}
    for name, lib in paths.items():
        text = subprocess.run([tool, "-sass", lib], capture_output=True,
                              text=True, check=True).stdout
        if name == "committed" and listing:
            with open(listing, "w") as f:
                f.write(text)
        per = {}
        for block in text.split("Function : ")[1:]:
            fname = block.split("\n", 1)[0].strip()
            loads = 0
            for line in block.splitlines():
                if re.search(r"\bSTG\b", line):
                    break
                if re.search(r"\bLDG\b", line):
                    loads += 1
            per[fname] = loads
        counts[name] = per
    emit(out, "sass", what="LDG instructions before the first STG, per "
         "kernel instance", counts=counts)


def host_one(root):
    """Host time a call of K1 in the checkout at ``root`` (run in a
    process of its own); prints one JSON line."""
    import torch
    sys.path[:0] = [ROOT, os.path.join(root, "src")]
    import chip_smoke as cs
    import repro_torch  # noqa: F401
    from repro_torch.configs import CONFIG
    from repro_torch.kernels import lif_scan as k1
    from repro_torch.kernels import ops
    from repro_torch.kernels._build import load_library
    p = CONFIG.lif
    dev = torch.device("cuda")
    lib = load_library(k1.KERNEL)
    bare = entry(lib, "f32")
    rows = {}
    for name, shape in (("conv1", CONV1), ("conv2", CONV2)):
        cur = torch.rand(shape, device=dev)
        v0 = torch.zeros(shape[1:], device=dev)
        spk, vfin = torch.empty_like(cur), torch.empty_like(v0)
        stream = torch.cuda.current_stream().cuda_stream
        args = (cur.data_ptr(), v0.data_ptr(), spk.data_ptr(),
                vfin.data_ptr(), v0.numel(), shape[0], float(p.alpha),
                float(p.v_th), stream)

        def engine_call():
            with torch.no_grad():
                return ops.lif_scan(cur, p, v0)
        rows[name] = dict(
            ops_lif_scan_no_grad=cs._host_us(torch, engine_call),
            lif_scan_cuda=cs._host_us(
                torch, lambda: k1.lif_scan_cuda(cur, p, v0)),
            ctypes_entry=cs._host_us(torch, lambda: bare(*args)))
    print(json.dumps(dict(root=root, host_us=rows)), flush=True)
    return 0


def host_phase(roots, out):
    rows = []
    for i, root in enumerate(roots):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--host-one",
             os.path.abspath(root)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"host timing failed in {root}:\n"
                               f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
        line = [x for x in proc.stdout.splitlines() if x.startswith("{")][-1]
        rows.append(dict(run=i, **json.loads(line)))
    emit(out, "k1_host", unit="host microseconds a call, 200 calls queued "
         "without a synchronisation (chip_smoke's _host_us), median of 5; "
         "f32, v0 of zeros", shapes={"conv1": CONV1, "conv2": CONV2},
         rows=rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--only", nargs="*", default=None,
                    help="build and time only these variants")
    ap.add_argument("--extra", action="append", default=[],
                    metavar="NAME=PATH",
                    help="also build and time this K1 source (same C entry "
                         "points)")
    ap.add_argument("--sass", default=None,
                    help="write the committed build's SASS listing here")
    ap.add_argument("--ab", nargs="*", default=[], metavar="NAME",
                    help="time these built variants (and --extra sources) "
                         "against each other in alternating rounds")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--host", nargs="*", default=[], metavar="ROOT",
                    help="time the host cost of a call in these checkouts")
    ap.add_argument("--host-one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k1_probe: no CUDA device", file=sys.stderr)
        return 2
    if args.host_one:
        return host_one(args.host_one)
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = []
    emit(out, "device", nvidia_smi=smi.strip(), torch=torch.__version__)
    names = args.only if args.only is not None else list(VARIANTS)
    if "committed" not in names:
        names = ["committed", *names]
    sources = {name: variant_source(name, VARIANTS[name]) for name in names}
    extra = dict(e.split("=", 1) for e in args.extra)
    libs, reports, paths = build({**sources, **extra})
    emit(out, "ptxas", report=reports)
    variants_phase(torch, libs, out)
    sweep_phase(torch, {"committed": libs["committed"],
                        **{n: libs[n] for n in extra}}, out)
    if args.ab:
        ab_phase(torch, libs, args.ab, args.rounds, out)
    empty_phase(torch, out)
    graph_phase(torch, {"committed": libs["committed"],
                        **{n: libs[n] for n in extra}}, out)
    clock_phase(torch, libs["committed"], out)
    sass_phase({"committed": paths["committed"],
                **{n: paths[n] for n in extra}}, args.sass, out)
    if args.host:
        host_phase(args.host, out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
