#!/usr/bin/env python3
"""Measurements behind K2's design (``src/repro_torch/csrc/fc_lif_scan.cu``)
on one NVIDIA H100. Run from the root of a checkout:

    python3 tools/k2_probe.py [--out k2_probe.json]

Prints one JSON line per phase (and writes them all to ``--out``):

  1. ``smem_rate``: cycles an SM spends per warp-wide shared load
     (``tools/smem_rate.cu``) by the bytes a lane reads (4, 8, 16) and the
     distinct addresses of a warp (all 32, K2's spike-tile and weight-tile
     patterns, one), at 4 and 16 warps an SM, with the SM clock the run
     kept (clock cycles over event time), and the SM clock under a spin;
     the instruction mix of the committed K2 (``cuobjdump -sass``, the
     listing in ``src/repro_torch/_build/probe/k2_sass.txt``);
  2. ``k2_tiles``: K2 at the event wing's fc1 and fc2 (T=16, B=8) with the
     committed tile shapes and with variants, each built from a copy of
     ``csrc/fc_lif_scan.cu`` whose ``using Wide``/``using Narrow`` or
     ``NSTAGE`` line is replaced; each variant is first held bit for bit against
     ``fc_lif_scan_plain``, then timed from a cold and a warm L2 as
     ``chip_smoke.py`` times it; fc1 also with bf16 spikes (the same
     values: the spike tile in 16 bits) and at K=128 (the fixed costs),
     beside an add on one element (the harness's floor).
"""
import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(ROOT, "tools")
BUILD = os.path.join(ROOT, "src", "repro_torch", "_build", "probe")

# Tile<RT, CT, TC, KC, BATCH>: rows and columns a thread, threads along the
# columns, the K chunk, groups of products formed ahead. A variant replaces
# the source's Wide or Narrow tile, its NSTAGE, or its sum_chunk (by the
# one in the named file).
# Thread -> (row group tr, column group tc) maps other than the source's
# (which takes TC = 8 only): the plain one, for any TC, and two more.
LANES_PLAIN = "tc = tid % C::TC, tr = tid / C::TC"
LANES_MOD8 = "tc = tid % 8, tr = tid / 8"
LANES_DIV4 = "tc = (tid % 32) / 4, tr = (tid / 32) * 4 + tid % 4"
WIDE = {"wide_committed": {},
        "wide_kc128": {"Wide": "Tile<2, 2, 8, 128, 2>"},
        "wide_kc32": {"Wide": "Tile<2, 2, 8, 32, 2>"},
        "wide_batch1": {"Wide": "Tile<2, 2, 8, 64, 1>"},
        "wide_tc16": {"Wide": "Tile<2, 2, 16, 64, 2>",
                      "lanes": LANES_PLAIN},
        "wide_rows4_uniform": {"Wide": "Tile<4, 1, 32, 64, 2>",
                               "lanes": LANES_PLAIN},
        "wide_cols4": {"Wide": "Tile<1, 4, 8, 64, 2>"},
        "wide_rows2": {"Wide": "Tile<2, 1, 8, 64, 2>"},
        "wide_cols2": {"Wide": "Tile<1, 2, 8, 64, 2>"},
        "wide_one": {"Wide": "Tile<1, 1, 8, 64, 8>"},
        "wide_nstage2": {"NSTAGE": "2"},
        "wide_nstage3": {"NSTAGE": "3"},
        "wide_nstage6": {"NSTAGE": "6"},
        "wide_prefetch": {"sum": "k2_sum_prefetch.cuh"},
        # Weight columns interleaved (lane % 8), rows by lane groups of 8.
        "wide_lanes_mod8": {"lanes": LANES_MOD8},
        # Weight columns by lane groups of 4, rows interleaved (lane % 4).
        "wide_lanes_div4": {"lanes": LANES_DIV4},
        "wide_rows2_prefetch": {"Wide": "Tile<2, 1, 8, 64, 2>",
                                "sum": "k2_sum_prefetch.cuh"},
        "wide_cols2_prefetch": {"Wide": "Tile<1, 2, 8, 64, 2>",
                                "sum": "k2_sum_prefetch.cuh"}}
# Lane address patterns of tools/smem_rate.cu, in its order.
PATTERNS = ("distinct", "rows4", "cols8", "uniform", "mod4", "div4", "div8",
            "div2", "mod2", "mod4_rows", "div2_mod16", "bits04_rows")
# Variants timed with bf16 spikes too (the spike tile in 16 bits).
BF16 = ("wide_committed", "wide_tc16", "wide_batch1")
NARROW = {"narrow_committed": {},
          "narrow_kc64": {"Narrow": "Tile<1, 1, 8, 64, 8>"},
          "narrow_batch4": {"Narrow": "Tile<1, 1, 8, 128, 4>"},
          "narrow_tc4": {"Narrow": "Tile<1, 1, 4, 128, 8>",
                         "lanes": LANES_PLAIN},
          "narrow_prefetch": {"sum": "k2_sum_prefetch.cuh"},
          "narrow_lanes_mod8": {"lanes": LANES_MOD8},
          "narrow_lanes_div4": {"lanes": LANES_DIV4}}


def emit(out, phase, **fields):
    line = json.dumps({"phase": phase, **fields})
    print(line, flush=True)
    out.append(line)


def _nvcc_cmd(src, lib):
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build
    return [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src]


def build(sources):
    """Build {name: .cu path} with one nvcc each, all at once."""
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        lib = os.path.join(BUILD, f"lib{name}.so")
        procs[name] = (lib, subprocess.Popen(
            _nvcc_cmd(src, lib), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def variant_source(name, subs):
    with open(os.path.join(ROOT, "src", "repro_torch", "csrc",
                           "fc_lif_scan.cu")) as f:
        text = f.read()
    for key, value in subs.items():
        if key == "lanes":  # the thread -> (row, column) map of fc_kernel
            start = text.index("static_assert(C::TC == 8")
            end = text.index(";", text.index("const int tid = ", start))
            text = text[:start] + "const int tid = threadIdx.x, " + value \
                + text[end:]
            continue
        if key == "sum":    # the sum_chunk function, from a file in tools/
            start = text.index("// One staged chunk into")
            end = text.index("// The block's currents")
            with open(os.path.join(TOOLS, value)) as f:
                text = text[:start] + f.read() + text[end:]
            continue
        head = (f"constexpr int {key} = " if key == "NSTAGE"
                else f"using {key} = ")
        start = text.index(head)
        end = text.index(";", start)
        text = text[:start] + head + value + text[end:]
    path = os.path.join(BUILD, f"{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def clock_phase(torch, lib, out):
    """The SM clock under a spin of 20 M cycles on every SM."""
    fn = lib.spin_run
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    check_rc(fn(1000, sms, stream))
    ghz = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        check_rc(fn(20_000_000, sms, stream))
        b.record()
        torch.cuda.synchronize()
        ghz.append(20_000_000 / (a.elapsed_time(b) * 1e6))
    emit(out, "clock", sm_clock_ghz=ghz)
    return statistics.median(ghz)


def sass_phase(lib_path, out):
    """Instruction mix of the committed K2's kernels (cuobjdump -sass)."""
    cuobjdump = os.path.join(os.path.dirname(_nvcc_cmd("x", "y")[0]),
                             "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path],
                          capture_output=True, text=True).stdout
    with open(os.path.join(BUILD, "k2_sass.txt"), "w") as f:
        f.write(sass)
    kernels, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            kernels[name] = {}
        elif name and "/*" in line and ";" in line:
            body = line.split("*/", 1)[1].strip()
            if body.startswith("@"):
                body = body.split(None, 1)[1]
            op = body.split()[0].rstrip(";").split(".")[0]
            kernels[name][op] = kernels[name].get(op, 0) + 1
    emit(out, "sass", kernels={k: dict(sorted(v.items(),
                                              key=lambda kv: -kv[1])[:14])
                               for k, v in kernels.items()})


def variant_sass(libs_paths, out):
    """Per variant: the instruction count of its Wide f32 fused kernel
    and the ones that matter here (local memory means spilled
    registers)."""
    cuobjdump = os.path.join(os.path.dirname(_nvcc_cmd("x", "y")[0]),
                             "cuobjdump")
    rows = {}
    for name, path in libs_paths.items():
        sass = subprocess.run([cuobjdump, "-sass", path],
                              capture_output=True, text=True).stdout
        blocks = sass.split("Function :")
        for block in blocks[1:]:
            head = block.splitlines()[0]
            if "Lb1E" not in head or "Tile" not in head or "13__nv" in head:
                continue
            ops = [ln.split("*/", 1)[1].strip() for ln in block.splitlines()
                   if "/*" in ln and ";" in ln and "*/" in ln]
            ops = [o.split(None, 1)[1] if o.startswith("@") else o
                   for o in ops]
            names = [o.split()[0].split(".")[0] for o in ops if o]
            tile = head.split("TileI")[1].split("EE")[0]
            rows.setdefault(name, {})[tile] = dict(
                total=len(names),
                **{op: names.count(op) for op in (
                    "FMUL", "FADD", "LDS", "LDL", "STL", "BAR", "LDGSTS")})
    emit(out, "variant_sass", kernels=rows)


def smem_phase(torch, lib, out):
    fn = lib.smem_rate_run
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sink = torch.zeros(1024, dtype=torch.int32, device="cuda")
    cycles = torch.zeros(sms, dtype=torch.int64, device="cuda")
    iters = 2000
    rows = []
    for warps in (16,):
        for width in (4, 8, 16):
            for pattern, pname in enumerate(PATTERNS):
                stream = torch.cuda.current_stream().cuda_stream
                args = (width, pattern, sms, warps, iters, sink.data_ptr(),
                        cycles.data_ptr(), stream)
                check_rc(fn(*args))
                torch.cuda.synchronize()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                check_rc(fn(*args))
                b.record()
                torch.cuda.synchronize()
                cyc = statistics.median(cycles.tolist())
                loads = iters * 16 * warps
                rows.append(dict(
                    warps_per_sm=warps, bytes_per_lane=width, pattern=pname,
                    cycles_per_warp_load=cyc / loads,
                    bytes_per_cycle_per_sm=loads * 32 * width / cyc,
                    sm_clock_ghz=cyc / (a.elapsed_time(b) * 1e6)))
    emit(out, "smem_rate", iters=iters, loads_per_iter=16, blocks=sms,
         note="cycles between two barriers of one block per SM, median "
              "over SMs; sm_clock_ghz = those cycles over the launch's "
              "event time (an upper bound on the time, so a lower bound "
              "on the clock)", rows=rows)


def check_rc(rc):
    if rc != 0:
        raise RuntimeError(f"CUDA error {rc}")


def k2_phase(torch, libs, out):
    import chip_smoke as cs
    from repro_torch.configs import CONFIG
    from repro_torch.kernels import fc_lif_scan as k2
    p = CONFIG.lif
    t, b = CONFIG.time_bins, 8
    g = torch.Generator().manual_seed(7)
    flush = torch.ones(cs.FLUSH_BYTES // 4, device="cuda")

    def fn(lib, dtype):
        f = getattr(lib, "fc_lif_scan_" + ("f32" if dtype == torch.float32
                                           else "bf16"))
        f.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
        f.restype = ctypes.c_int
        return f

    def caller(lib, s, w, v0):
        f = fn(lib, s.dtype)
        o = torch.empty(t, b, w.shape[1], dtype=s.dtype, device="cuda")
        vf = torch.empty(b, w.shape[1], dtype=s.dtype, device="cuda")

        def run():
            check_rc(f(s.data_ptr(), w.data_ptr(), v0.data_ptr(),
                       o.data_ptr(), vf.data_ptr(), t, b, s.shape[-1],
                       w.shape[1], p.alpha, p.v_th,
                       torch.cuda.current_stream().cuda_stream))
            return o, vf
        return run

    def inputs(k, n, levels):
        s = ((torch.rand(t, b, k, levels, generator=g) < 0.2).sum(-1)
             .float() / levels).to("cuda")
        w = (torch.randn(k, n, generator=g) * (2.0 / k) ** 0.5).to("cuda")
        return s, w, torch.zeros(b, n, device="cuda")

    cases = {"fc1": (inputs(CONFIG.flat_dim, CONFIG.hidden, 4), WIDE),
             "fc1_K128": (inputs(128, CONFIG.hidden, 4), WIDE),
             "fc2": (inputs(CONFIG.hidden, CONFIG.num_classes, 1), NARROW)}
    rows = []
    x1 = torch.zeros(1, device="cuda")
    rows.append(dict(case="noop", variant="x.add_(1) on one element",
                     ms=cs._device_ms(torch, lambda: x1.add_(1), flush),
                     warm_l2_ms=cs._warm_ms(torch, lambda: x1.add_(1))))
    for case, ((s, w, v0), variants) in cases.items():
        dtypes = ((torch.float32, torch.bfloat16) if case == "fc1"
                  else (torch.float32,))
        for dtype in dtypes:
            sd = s.to(dtype)
            want = k2.fc_lif_scan_plain(sd, w, p, v0)
            for name in variants:
                if dtype == torch.bfloat16 and name not in BF16:
                    continue
                run = caller(libs[name], sd, w, v0)
                got = run()
                torch.cuda.synchronize()
                same = all(bool(torch.equal(x, y)) for x, y in zip(want, got))
                rows.append(dict(
                    case=case, variant=name, subs=variants[name],
                    spikes=str(dtype), shape=[t, b, s.shape[-1], w.shape[1]],
                    bitwise=same,
                    ms=cs._device_ms(torch, run, flush),
                    warm_l2_ms=cs._warm_ms(torch, run)))
                print(json.dumps(rows[-1]), flush=True)
        lib_ms = cs._device_ms(
            torch, lambda: torch.matmul(s.reshape(t * b, -1), w), flush)
        rows.append(dict(case=case, variant="torch.matmul", ms=lib_ms))
    emit(out, "k2_tiles", unit="ms of device time per call (chip_smoke's "
         "_device_ms from a cold L2, _warm_ms warm)", rows=rows)
    bad = [r for r in rows if r.get("bitwise") is False]
    if bad:
        raise AssertionError(f"variants that differ from the plain "
                             f"version: {bad}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k2_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = []
    emit(out, "device", nvidia_smi=smi.strip(), torch=torch.__version__)
    os.makedirs(BUILD, exist_ok=True)
    sources = {"smem_rate": os.path.join(TOOLS, "smem_rate.cu")}
    for name, subs in {**WIDE, **NARROW}.items():
        if subs or name == "wide_committed":
            sources[name] = variant_source(name, subs)
    libs = build(sources)
    libs["narrow_committed"] = libs["wide_committed"]
    sass_phase(os.path.join(BUILD, "libwide_committed.so"), out)
    variant_sass({n: os.path.join(BUILD, f"lib{n}.so")
                  for n in sources if n != "smem_rate"}, out)
    clock_phase(torch, libs["smem_rate"], out)
    smem_phase(torch, libs["smem_rate"], out)
    k2_phase(torch, libs, out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
