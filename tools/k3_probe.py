#!/usr/bin/env python3
"""Measurements behind K3's design (``src/repro_torch/csrc/ternary_matmul.cu``)
on one NVIDIA H100. Run from the root of a checkout:

    python3 tools/k3_probe.py [--out k3_probe.json] [--extra NAME=PATH]

Prints one JSON line per phase (and writes them all to ``--out``):

  1. ``ptxas``: registers, shared memory and spills of every kernel
     instance of the committed source (``nvcc -Xptxas -v``);
  2. with ``--sass PATH``, the committed build's SASS listing
     (``cuobjdump -sass``) in that file;
  3. ``k3_variants``: K3 at the frame fc1 (M = 8 and 1, K = 2048, N = 512,
     f32 x on the 1/4 grid) and at the rwkv6-7b products (M = 4 decode and
     M = 32 prompt rows, bf16 x; K x N = 4096 x 4096, 4096 x 14,336 and
     14,336 x 4096) with the committed source and launch plan
     (``ternary_matmul.plan``), with other plans (rows R a thread,
     segments G a warp) and with sources whose ``XAHEAD``, ``NSTAGE`` or
     ``MAX_WARPS`` line is replaced, and at one chunk of 64 k (a call's
     fixed cost) beside an add on one element. Each variant
     is first held bit for bit against ``ternary_matmul_plain``, then
     timed from a cold and a warm L2 as ``chip_smoke.py`` times it, beside
     ``torch.matmul`` of x with the unpacked weights in x's dtype;
  4. ``k3_paths``: the split path against the serial path (each as
     ``plan(..., path=...)`` lays it out) at the rwkv6-7b products for
     M = 32 to 8,192 rows (8,192 = B 4 x S 2,048, a prefill), bf16 x: the
     two outputs bit for bit against each other and, on their first and
     last 8 rows, against ``ternary_matmul_plain``; warm-L2 device time
     of each, cold-L2 time up to M = 512, and which path ``plan`` picks;
  5. ``k3_host``: host time a call at the decode products (M = 4, bf16),
     200 calls queued without a synchronisation: ``models.layers.dense``
     with a packed weight (what a decode step calls), the wrapper
     ``ternary_matmul_cuda``, the library's entry called through ctypes
     with every argument ready (the committed build, and each ``--extra``
     build of a source with the same C entry points), and
     ``models.layers.dense`` with the bf16 weight (``torch.matmul``);
     then each build's entry called at two products in turn (K x N =
     4096 x 4096 and 14,336 x 4096, one kernel instance whose blocks take
     different shared memory), as a decode step calls it.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD = os.path.join(ROOT, "src", "repro_torch", "_build", "probe")

# Source variants: constexpr lines of the committed source replaced.
SOURCES = {"committed": {}, "xahead8": {"XAHEAD": "8"},
           "nstage3": {"NSTAGE": "3"}, "maxwarps32": {"MAX_WARPS": "32"}}
# (M, K, N, x dtype, plans other than the committed one:
# (rows R a thread, segments G a warp)).
SHAPES = [
    (8, 2048, 512, "float32", []),
    (1, 2048, 512, "float32", []),
    (4, 4096, 4096, "bfloat16", [(2, 1)]),
    (4, 4096, 14336, "bfloat16", []),
    (4, 14336, 4096, "bfloat16", [(4, 1)]),
    (32, 4096, 4096, "bfloat16", []),
    (32, 4096, 14336, "bfloat16", [(8, 1)]),
    (32, 14336, 4096, "bfloat16", [(8, 4)]),
    # One chunk of 64 k: the fixed cost of a call (serial path).
    (8, 64, 512, "float32", []),
    (4, 64, 4096, "bfloat16", []),
]
# Source variants are timed at these shapes, with every plan listed.
SOURCE_SHAPES = {(8, 2048, 512), (4, 4096, 4096), (4, 4096, 14336),
                 (4, 14336, 4096)}


def emit(out, phase, **fields):
    line = json.dumps({"phase": phase, **fields})
    print(line, flush=True)
    out.append(line)


def variant_source(name, subs):
    with open(os.path.join(ROOT, "src", "repro_torch", "csrc",
                           "ternary_matmul.cu")) as f:
        text = f.read()
    for key, value in subs.items():
        head = re.search(rf"constexpr \w+ {key} = ", text)
        end = text.index(";", head.end())
        text = text[:head.end()] + value + text[end:]
    os.makedirs(BUILD, exist_ok=True)
    path = os.path.join(BUILD, f"k3_{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def build(sources):
    """Build {name: .cu path} with one nvcc each, all at once; returns the
    loaded libraries and the committed build's ptxas report."""
    from repro_torch.kernels import _build
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        lib = os.path.join(BUILD, f"libk3_{name}.so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               lib, src]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs, report = {}, ""
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        if name == "committed":
            report = log
        libs[name] = ctypes.CDLL(lib)
    return libs, report


def _entry(lib, dtype):
    """The ctypes entry point of a K3 build for x of ``dtype``."""
    import ctypes
    fn = getattr(lib, "ternary_matmul_" + (
        "f32" if str(dtype) == "torch.float32" else "bf16"))
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def k3_phase(torch, libs, out):
    import chip_smoke as cs
    from repro_torch.core.ternary import unpack2bit
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_matmul as k3
    g = torch.Generator().manual_seed(16)
    flush = torch.ones(cs.FLUSH_BYTES // 4, device="cuda")
    committed_plan, committed_fn = k3.plan, k3._fn
    rows = []
    try:
        for m, k, n, dt, plans in SHAPES:
            dtype = getattr(torch, dt)
            wp, scale = ops.pack_ternary_weights(torch.randn(k, n,
                                                             generator=g))
            wp, scale = wp.to("cuda"), scale.to("cuda")
            if dtype == torch.float32:
                x = (torch.randint(-4, 5, (m, k), generator=g) / 4.0)
            else:
                x = torch.randn(m, k, generator=g)
            x = x.to(dtype).to("cuda")
            want = k3.ternary_matmul_plain(x, wp, scale)
            wq = unpack2bit(wp.t(), out_dtype=dtype).t().contiguous()
            lib_ms = cs._device_ms(torch, lambda: torch.matmul(x, wq), flush)
            run = lambda: k3.ternary_matmul_cuda(x, wp, scale)
            sources = (SOURCES if (m, k, n) in SOURCE_SHAPES
                       else ["committed"])
            variants = [(src, p) for src in sources
                        for p in [None] + plans]
            for src, forced in variants:
                k3._fn = lambda d, lib=libs[src]: _entry(lib, d)
                if forced is None:
                    k3.plan = committed_plan
                else:
                    k3.plan = lambda *a, fixed=k3.launch_plan(
                        m, k, n, *forced): fixed
                try:
                    got = run()
                except RuntimeError as e:   # e.g. over 48 KB of shared
                    rows.append(dict(shape=[m, k, n], x=dt, source=src,
                                     plan=k3.plan(m, k, n)._asdict(),
                                     error=str(e), bitwise=True))
                    continue
                again = run()
                torch.cuda.synchronize()
                rows.append(dict(
                    shape=[m, k, n], x=dt, source=src,
                    plan=k3.plan(m, k, n)._asdict(),
                    bitwise=bool(torch.equal(want, got)
                                 and torch.equal(want, again)),
                    ms=cs._device_ms(torch, run, flush),
                    warm_l2_ms=cs._warm_ms(torch, run), library_ms=lib_ms))
                rows[-1]["vs_library"] = rows[-1]["ms"] / lib_ms
                print(json.dumps(rows[-1]), flush=True)
    finally:
        k3.plan, k3._fn = committed_plan, committed_fn
    x1 = torch.zeros(1, device="cuda")
    rows.append(dict(shape=[], source="x.add_(1) on one element",
                     ms=cs._device_ms(torch, lambda: x1.add_(1), flush),
                     warm_l2_ms=cs._warm_ms(torch, lambda: x1.add_(1)),
                     bitwise=True))
    emit(out, "k3_variants", unit="ms of device time per call (chip_smoke's "
         "_device_ms from a cold L2, _warm_ms warm); library_ms: "
         "torch.matmul of x with the unpacked weights in x's dtype",
         rows=rows)
    bad = [r for r in rows if not r["bitwise"]]
    if bad:
        raise AssertionError(f"variants that differ from the plain "
                             f"version: {bad}")


# (K, N) of the rwkv6-7b products and the rows of the split-vs-serial
# sweep: prompts of 8 and 32 tokens at B = 4, then longer prefills.
PATH_PRODUCTS = [(4096, 4096), (4096, 14336), (14336, 4096)]
PATH_ROWS = [32, 48, 64, 96, 128, 512, 2048, 8192]


def paths_phase(torch, out):
    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_matmul as k3
    g = torch.Generator().manual_seed(17)
    flush = torch.ones(cs.FLUSH_BYTES // 4, device="cuda")
    committed_plan = k3.plan
    rows = []
    try:
        for k, n in PATH_PRODUCTS:
            wp, scale = ops.pack_ternary_weights(torch.randn(k, n,
                                                             generator=g))
            wp, scale = wp.to("cuda"), scale.to("cuda")
            for m in PATH_ROWS:
                x = torch.randn(m, k, generator=g).to(torch.bfloat16)
                x = x.to("cuda")
                ends = torch.cat([x[:8], x[-8:]])
                want = k3.ternary_matmul_plain(ends, wp, scale)
                row = dict(shape=[m, k, n],
                           picked=committed_plan(m, k, n).path)
                outs = {}
                for path in ("split", "serial"):
                    fixed = committed_plan(m, k, n, path=path)
                    k3.plan = lambda *a, fixed=fixed: fixed
                    run = lambda: k3.ternary_matmul_cuda(x, wp, scale)
                    got = outs[path] = run()
                    torch.cuda.synchronize()
                    t0 = cs._warm_ms(torch, run, reps=2)
                    reps = max(2, min(20, int(50 / max(t0, 1e-3))))
                    row[path] = dict(
                        plan=fixed._asdict(),
                        plain_bitwise=bool(torch.equal(
                            want, torch.cat([got[:8], got[-8:]]))),
                        warm_l2_ms=cs._warm_ms(torch, run, reps=reps))
                    if m <= 512:
                        row[path]["ms"] = cs._device_ms(torch, run, flush)
                row["split_equals_serial"] = bool(torch.equal(
                    outs["split"], outs["serial"]))
                row["serial_over_split"] = (row["serial"]["warm_l2_ms"]
                                            / row["split"]["warm_l2_ms"])
                rows.append(row)
                print(json.dumps(row), flush=True)
                del x, outs, got
    finally:
        k3.plan = committed_plan
    emit(out, "k3_paths", unit="ms of device time per call; warm_l2_ms: "
         "calls in one CUDA graph, inputs left in L2 by the call before; "
         "ms: one call from a cold L2 (chip_smoke's _device_ms)", rows=rows)
    bad = [r for r in rows if not r["split_equals_serial"]
           or not r["split"]["plain_bitwise"]
           or not r["serial"]["plain_bitwise"]]
    if bad:
        raise AssertionError(f"paths that differ: {bad}")


def host_phase(torch, libs, out):
    from chip_smoke import _host_us
    from repro_torch.core.ternary import unpack2bit
    from repro_torch.kernels import ops
    from repro_torch.kernels import ternary_matmul as k3
    from repro_torch.models.layers import dense
    g = torch.Generator().manual_seed(18)
    bf16 = torch.bfloat16
    rows, launches = [], {}
    for k, n in PATH_PRODUCTS:
        wp, scale = ops.pack_ternary_weights(torch.randn(k, n, generator=g))
        wp, scale = wp.to("cuda"), scale.to("cuda")
        wq = unpack2bit(wp.t(), out_dtype=bf16).t().contiguous()
        x = torch.randn(4, 1, k, generator=g).to(bf16).to("cuda")
        x2 = x.reshape(4, k)
        packed = {"packed": wp, "scale": scale}
        p = k3.plan(4, k, n)
        o = torch.empty((4, n), dtype=bf16, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        row = dict(shape=[4, k, n], plan=p._asdict(), host_us={
            "dense_packed": _host_us(torch, lambda: dense(x, packed)),
            "ternary_matmul_cuda": _host_us(
                torch, lambda: k3.ternary_matmul_cuda(x2, wp, scale))})
        for name, lib in libs.items():
            fn = _entry(lib, bf16)
            args = (x2.data_ptr(), wp.data_ptr(), scale.data_ptr(),
                    o.data_ptr(), 4, k, n, p.rows, p.group, stream)
            if fn(*args) != 0:
                raise RuntimeError(f"{name}: launch failed")
            row["host_us"][f"ctypes_{name}"] = _host_us(
                torch, lambda: fn(*args))
        row["host_us"]["dense_bf16"] = _host_us(torch, lambda: dense(x, wq))
        rows.append(row)
        print(json.dumps(row), flush=True)
        launches[(k, n)] = (x2, wp, scale, o, p)
    # Two products of one kernel instance (<bf16, 4>) whose blocks take
    # different shared memory, launched in turn, as a decode step does.
    turns = {}
    for name, lib in libs.items():
        fn = _entry(lib, bf16)
        calls = [(x2.data_ptr(), wp.data_ptr(), scale.data_ptr(),
                  o.data_ptr(), 4, x2.shape[1], wp.shape[1], p.rows,
                  p.group, torch.cuda.current_stream().cuda_stream)
                 for x2, wp, scale, o, p in (launches[(4096, 4096)],
                                             launches[(14336, 4096)])]
        turns[f"ctypes_{name}"] = _host_us(
            torch, lambda: (fn(*calls[0]), fn(*calls[1]))) / 2
    emit(out, "k3_host", unit="host microseconds a call, 200 calls queued "
         "without a synchronisation, median of 5", rows=rows,
         alternating_4096x4096_14336x4096=turns)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--sass", default=None,
                    help="write the committed build's SASS listing here")
    ap.add_argument("--extra", action="append", default=[],
                    metavar="NAME=PATH",
                    help="also build this K3 source (same C entry points) "
                         "and time its bare launch in k3_host")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k3_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import repro_torch  # noqa: F401
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = []
    emit(out, "device", nvidia_smi=smi.strip(), torch=torch.__version__)
    sources = {name: variant_source(name, subs)
               for name, subs in SOURCES.items()}
    extra = dict(e.split("=", 1) for e in args.extra)
    libs, report = build({**sources, **extra})
    emit(out, "ptxas", report=[line for line in report.splitlines()
                               if "registers" in line or "spill" in line
                               or "Compiling" in line])
    if args.sass:
        from repro_torch.kernels import _build
        tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
        with open(args.sass, "w") as f:
            subprocess.run([tool, "-sass", os.path.join(
                BUILD, "libk3_committed.so")], stdout=f, check=True)
    k3_phase(torch, {name: libs[name] for name in SOURCES}, out)
    paths_phase(torch, out)
    host_phase(torch, {name: libs[name] for name in ["committed", *extra]},
               out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
