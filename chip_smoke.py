#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, one JSON line each; any failed check raises, so the script exits
non-zero:

  1. device and build: the card (as nvidia-smi reports it), the torch and
     CUDA versions, and the time to build kernels K1 and K2 with nvcc;
  2. each kernel against its plain PyTorch version on the card, at the
     main path's shapes (full Table II width, B=8), bit for bit: K1 at
     conv1/conv2 in f32 and bf16 with v0 above threshold and chaining, K2
     at fc1/fc2, and B=1 rows against the rows of B=8;
  3. the slice: a full-width StreamEngine built as a user builds it
     (EngineConfig(fuse_fc=True, pipeline_depth=1), no kernel arguments)
     serves 8 streams (4 stateful) x 3 windows of ~60k events; launch
     counters prove the kernels ran; results are held against the port's
     own CPU run; one ClosedLoopPipeline window (B=1);
  4. times from CUDA events: each kernel, its plain version, its bound and
     the library yardstick, each call read from a cold L2 cache; windows/s
     end to end at B=1 and B=8 over 20 samples of 16 engine steps each;
     a profiler trace of 64 steady-state B=8 steps;
  5. the ``kernels`` line, then the card line, then the ``ok`` line.

Weights are random from a numpy seed. For the served comparison they are
rounded to multiples of 2**-8: every conv and fc current is then exact in
f32 whatever the summation order, so the card and the CPU must agree bit
for bit unless an algorithm rounds inside the sum (a Winograd or FFT
convolution would). A run with the unrounded He-init weights is reported
beside it, as is cuDNN's batch invariance.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12           # fp32 outside the tensor cores
REPS = 20
FLUSH_BYTES = 512 << 20           # read between timed calls: 10x the L2
E2E_SAMPLES = 20                  # end-to-end samples per batch size
E2E_STEPS = 16                    # engine steps per sample
PROFILE_STEPS = 64


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))

    import repro_torch  # noqa: F401  (sets the precision policy)
    from repro_torch.kernels import _build
    from repro_torch.kernels import fc_lif_scan as k2
    from repro_torch.kernels import lif_scan as k1

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build_all([k1.KERNEL, k2.KERNEL])
    build_s = time.perf_counter() - t0
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=build_s,
         tf32=[torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32])

    err = kernel_checks(torch, dev, k1, k2)
    served = slice_run(torch, dev, k1, k2)
    times = timings(torch, dev, k1, k2)

    kernels = [
        dict(name="lif_scan", route="cuda",
             source="src/repro_torch/csrc/lif_scan.cu",
             replaces="src/repro/kernels/lif_scan.py:111",
             launches=served["launches"]["lif_scan"],
             max_abs_err=err["lif_scan"], **times["lif_scan"]),
        dict(name="fc_lif_scan", route="cuda",
             source="src/repro_torch/csrc/fc_lif_scan.cu",
             replaces="src/repro/kernels/fc_lif_scan.py:131",
             launches=served["launches"]["fc_lif_scan"],
             max_abs_err=err["fc_lif_scan"], **times["fc_lif_scan"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ----------------------------------------------------------------------
# Phase 2: kernels against their plain versions.
# ----------------------------------------------------------------------

def _max_err(want, got):
    return max(float((a.float() - b.float()).abs().max()) if a.numel()
               else 0.0 for a, b in zip(want, got))


def _bitwise(torch, want, got):
    return all(bool(torch.equal(a, b)) for a, b in zip(want, got))


def kernel_checks(torch, dev, k1, k2):
    from repro_torch.configs import CONFIG
    p = CONFIG.lif
    g = torch.Generator().manual_seed(SEED)
    t, b = CONFIG.time_bins, 8
    h0, w0 = CONFIG.post_pool0
    k1_shapes = {"conv1": (h0, w0, CONFIG.conv1_features),
                 "conv2": (h0 // 2, w0 // 2, CONFIG.conv2_features)}
    errs = {"lif_scan": 0.0, "fc_lif_scan": 0.0}
    rows = []
    for layer, feat in k1_shapes.items():
        for dtype in (torch.float32, torch.bfloat16):
            cur = (torch.randn(t, b, *feat, generator=g) * 0.6 + 0.3).to(
                dtype).to(dev)
            v0 = (torch.rand(b, *feat, generator=g) * 1.4 - 0.2).to(dev)
            want = k1.lif_scan_plain(cur, p, v0)
            got = k1.lif_scan_cuda(cur, p, v0)
            half = t // 2
            s_a, v_a = k1.lif_scan_cuda(cur[:half].contiguous(), p, v0)
            s_b, v_b = k1.lif_scan_cuda(cur[half:].contiguous(), p, v_a)
            one = k1.lif_scan_cuda(cur[:, 5:6].contiguous(), p, v0[5:6])
            torch.cuda.synchronize()
            ok = dict(
                plain=_bitwise(torch, want, got),
                b1_rows=bool(torch.equal(one[0][:, 0], got[0][:, 5])
                             and torch.equal(one[1][0], got[1][5])))
            if dtype == torch.float32:
                # v_final comes back in the input dtype, so only an f32
                # carry chains exactly (a bf16 one is rounded by contract).
                ok["chained"] = bool(
                    torch.equal(torch.cat([s_a, s_b]), got[0])
                    and torch.equal(v_b, got[1]))
            errs["lif_scan"] = max(errs["lif_scan"], _max_err(want, got))
            rows.append(dict(kernel="lif_scan", layer=layer,
                             shape=list(cur.shape), dtype=str(dtype), **ok))
            check(all(ok.values()), f"K1 {layer} {dtype}: {ok}")
    fc = {"fc1": (CONFIG.flat_dim, CONFIG.hidden, 4),
          "fc2": (CONFIG.hidden, CONFIG.num_classes, 1)}
    for layer, (k, n, levels) in fc.items():
        # fc1 takes a 2x2 average pool of spikes (multiples of 1/4),
        # fc2 takes spikes.
        s = (torch.randint(0, levels + 1, (t, b, k), generator=g).float()
             / levels)
        s = torch.where(torch.rand(t, b, k, generator=g) < 0.7,
                        torch.zeros_like(s), s).to(dev)
        w = (torch.randn(k, n, generator=g) * 2.0 * (2.0 / k) ** 0.5).to(dev)
        v0 = torch.rand(b, n, generator=g).to(dev)
        want = k2.fc_lif_scan_plain(s, w, p, v0)
        got = k2.fc_lif_scan_cuda(s, w, p, v0)
        one = k2.fc_lif_scan_cuda(s[:, 2:3].contiguous(), w, p, v0[2:3])
        torch.cuda.synchronize()
        ok = dict(plain=_bitwise(torch, want, got),
                  b1_rows=bool(torch.equal(one[0][:, 0], got[0][:, 2])
                               and torch.equal(one[1][0], got[1][2])),
                  spiking=float(got[0].float().mean()))
        errs["fc_lif_scan"] = max(errs["fc_lif_scan"], _max_err(want, got))
        rows.append(dict(kernel="fc_lif_scan", layer=layer,
                         shape=[t, b, k, n], **ok))
        check(ok["plain"] and ok["b1_rows"], f"K2 {layer}: {ok}")
    emit("kernels_vs_plain", tolerance="bitwise", checks=rows,
         max_abs_err=errs)
    return errs


# ----------------------------------------------------------------------
# Phase 3: the slice, served end to end.
# ----------------------------------------------------------------------

def _np_params(cfg, dyadic):
    """He-init weights in the JAX package's layout (HWIO convs), from a
    numpy seed; ``dyadic`` rounds them to multiples of 2**-8."""
    rng = np.random.default_rng(SEED)

    def he(shape, fan_in):
        w = rng.normal(size=shape) * cfg.init_gain * np.sqrt(2.0 / fan_in)
        if dyadic:
            w = np.round(w * 256.0) / 256.0
        return w.astype(np.float32)

    return {
        "conv1": {"w": he((3, 3, cfg.in_channels, cfg.conv1_features),
                          9 * cfg.in_channels)},
        "conv2": {"w": he((3, 3, cfg.conv1_features, cfg.conv2_features),
                          9 * cfg.conv1_features)},
        "fc1": {"w": he((cfg.flat_dim, cfg.hidden), cfg.flat_dim)},
        "fc2": {"w": he((cfg.hidden, cfg.num_classes), cfg.hidden)},
    }


def _windows(n_streams, n_windows, seed):
    from repro_torch.core.events import synthetic_gesture_events
    rng = np.random.default_rng(seed)
    return [[synthetic_gesture_events(rng, (s + 3 * k) % 11,
                                      mean_events=60_000,
                                      duration_us=300_000)
             for k in range(n_windows)] for s in range(n_streams)]


def _engine(params, cfg, device, slots):
    from repro_torch.core._api import EngineConfig
    from repro_torch.serving import StreamEngine
    return StreamEngine(params, cfg, EngineConfig(
        max_streams=slots, fuse_fc=True, pipeline_depth=1), device=device)


def _serve(params, cfg, streams, device, slots=8, stateful=(0, 2, 4, 6)):
    eng = _engine(params, cfg, device, slots)
    handles = [eng.open(stream_id=i, stateful=i in stateful)
               for i in range(len(streams))]
    for k in range(len(streams[0])):
        for h, ws in zip(handles, streams):
            h.submit(ws[k])
    return eng


def _by_key(results):
    return {(r.stream_id, r.seq): r.result for r in results}


def _compare(gpu, cpu):
    keys = sorted(gpu)
    lg = np.concatenate([gpu[k].logits for k in keys])
    lc = np.concatenate([cpu[k].logits for k in keys])
    pg = np.concatenate([gpu[k].pwm for k in keys])
    pc = np.concatenate([cpu[k].pwm for k in keys])
    labels = np.array([int(gpu[k].label_pred[0]) == int(cpu[k].label_pred[0])
                       for k in keys])
    return dict(label_equal_fraction=float(labels.mean()),
                logits_bitwise_fraction=float(np.mean(lg == lc)),
                pwm_bitwise_fraction=float(np.mean(pg == pc)),
                logits_max_abs_diff=float(np.abs(lg - lc).max()),
                pwm_max_abs_diff=float(np.abs(pg - pc).max()))


# Given equal spikes, logits (spike counts x 10 / T) are exact and PWM
# differs only by the f32 rounding of exp and the softmax sum.
LOGITS_ATOL = 0.0
PWM_ATOL = 1e-6


def slice_run(torch, dev, k1, k2):
    from repro_torch.configs import CONFIG
    from repro_torch.convert import snn_params_from_numpy
    from repro_torch.core import snn as snn_mod
    from repro_torch.core.pipeline import ClosedLoopPipeline

    streams = _windows(8, 3, SEED + 1)
    n_events = [w.num_events for ws in streams for w in ws]
    params = snn_params_from_numpy(_np_params(CONFIG, dyadic=True))
    eng = _serve(params, CONFIG, streams, dev)
    key = (8, 65_536, 300_000)
    eng.warmup([key])
    torch.cuda.synchronize()
    k1.launches = 0
    k2.launches = 0
    out = eng.run()
    torch.cuda.synchronize()
    launches = {"lif_scan": k1.launches, "fc_lif_scan": k2.launches}
    dispatches = 3                      # 24 windows over 8 slots
    check(len(out) == 24, f"served {len(out)} of 24 windows")
    check(eng.compiled_shapes() == {key},
          f"shape keys {eng.compiled_shapes()} != {{{key}}}")
    for name, n in launches.items():
        check(n == 2 * dispatches,
              f"{name} launched {n} times in {dispatches} engine steps, "
              f"expected 2 per step")
    logits = np.concatenate([r.result.logits for r in out])
    pwm = np.concatenate([r.result.pwm for r in out])
    check(logits.shape == (24, CONFIG.num_classes), "logit shape")
    check(bool(np.isfinite(logits).all()), "non-finite logits")
    check(bool(((pwm >= 0) & (pwm <= 1)).all()), "pwm outside [0, 1]")
    rates = {k: float(np.mean([r.result.breakdown["firing_rates"][k]
                               for r in out]))
             for k in snn_mod.SNN_STATE_LAYERS}

    cpu = _by_key(_serve(params, CONFIG, streams, "cpu").run())
    gpu = _by_key(out)
    cmp = _compare(gpu, cpu)
    emit("slice", config="CONFIG (Table II, full width)", slots=8,
         windows=len(out), stateful_streams=4, fuse_fc=True,
         pipeline_depth=1, events_min=min(n_events), events_max=max(n_events),
         shape_key=list(key), launches=launches, engine_steps=dispatches,
         mean_firing_rates=rates,
         labels=[int(gpu[k].label_pred[0]) for k in sorted(gpu)],
         vs_cpu=cmp, tolerance=dict(label="equal", logits_atol=LOGITS_ATOL,
                                    pwm_atol=PWM_ATOL))
    check(cmp["label_equal_fraction"] == 1.0, f"labels differ: {cmp}")
    check(cmp["logits_max_abs_diff"] <= LOGITS_ATOL, f"logits: {cmp}")
    check(cmp["pwm_max_abs_diff"] <= PWM_ATOL, f"pwm: {cmp}")

    # One window through the paper's B=1 loop: stream 1 is stateless, so
    # its first window must match what the B=8 engine served.
    pipe = ClosedLoopPipeline(params, CONFIG, device=dev)
    one = pipe(streams[1][0])
    served = gpu[(1, 0)]
    b1 = dict(label_pred=int(one.label_pred[0]),
              equal_label=int(one.label_pred[0]) == int(served.label_pred[0]),
              logits_bitwise=bool(np.array_equal(one.logits, served.logits)),
              pwm_max_abs_diff=float(np.abs(one.pwm - served.pwm).max()),
              energy_mj=one.energy_mj, latency_ms=one.latency_ms)
    emit("pipeline_b1", **b1)
    check(b1["equal_label"], f"B=1 pipeline disagrees with B=8: {b1}")
    check(b1["pwm_max_abs_diff"] <= PWM_ATOL, f"B=1 pwm: {b1}")

    # Reported, not gated: unrounded He-init weights (order-dependent
    # conv sums) on the card against the CPU, and cuDNN's conv rows at
    # B=1 against B=8.
    he = snn_params_from_numpy(_np_params(CONFIG, dyadic=False))
    he_gpu = _by_key(_serve(he, CONFIG, streams, dev).run())
    he_cpu = _by_key(_serve(he, CONFIG, streams, "cpu").run())
    x = (torch.rand(CONFIG.time_bins * 8, 32, 32, 2,
                    generator=torch.Generator().manual_seed(SEED))
         < 0.3).float().to(dev)
    w1 = he["conv1"]["w"].to(dev)
    big = snn_mod._conv(x, w1)
    rows = CONFIG.time_bins
    small = snn_mod._conv(x[:rows].contiguous(), w1)
    emit("reported", he_init_vs_cpu=_compare(he_gpu, he_cpu),
         conv1_rows_b1_vs_b8_bitwise_fraction=float(
             (small == big[:rows]).float().mean()))
    return {"launches": launches}


# ----------------------------------------------------------------------
# Phase 4: times.
# ----------------------------------------------------------------------

def _graph(torch, fn, calls=1):
    """``calls`` calls of ``fn`` captured in one CUDA graph (after a warm
    call on a side stream), so a replay costs one host launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def _device_ms(torch, fn, flush, reps=REPS):
    """Device time of one call of ``fn`` from a cold L2 cache, as the HBM
    bound assumes: before each timed replay of the call's CUDA graph the
    device reads ``flush`` (10x the L2), which leaves clean lines behind
    and keeps the device busy while the host queues the replay between
    two CUDA events. Median of ``reps``."""
    graph = _graph(torch, fn)
    marks = []
    for _ in range(reps):
        flush.sum()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in marks)


def _warm_ms(torch, fn, reps=REPS):
    """Device time of one call of ``fn`` with its inputs left in L2 by the
    call before: ``reps`` calls in one CUDA graph between two CUDA events.
    Median over 5 replays."""
    graph = _graph(torch, fn, calls=reps)
    samples = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / reps)
    return statistics.median(samples)


def _call_ms(torch, fn, reps=REPS):
    """Time of one call from the host's side: CUDA events around a single
    call on an idle device, so the host's launch work is included.
    Median of ``reps``."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b))
    return statistics.median(samples)


def _bound_ms(nbytes, flops):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def timings(torch, dev, k1, k2):
    from repro_torch.configs import CONFIG
    from repro_torch.convert import snn_params_from_numpy
    p = CONFIG.lif
    t, b = CONFIG.time_bins, 8
    h0, w0 = CONFIG.post_pool0
    g = torch.Generator().manual_seed(SEED + 2)
    flush = torch.ones(FLUSH_BYTES // 4, device=dev)
    out = {}
    rows = []

    # K1 at conv1 and conv2, one engine step = both launches.
    k1_shapes = [(h0, w0, CONFIG.conv1_features),
                 (h0 // 2, w0 // 2, CONFIG.conv2_features)]
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
    for feat in k1_shapes:
        cur = (torch.randn(t, b, *feat, generator=g) * 0.6 + 0.3).to(dev)
        v0 = torch.zeros(b, *feat, device=dev)
        n = cur[0].numel()
        run = lambda: k1.lif_scan_cuda(cur, p, v0)
        ms = _device_ms(torch, run, flush)
        warm = _warm_ms(torch, run)
        call = _call_ms(torch, run)
        plain = _device_ms(torch, lambda: k1.lif_scan_plain(cur, p, v0),
                           flush)
        # currents read + spikes written + v0 read + v_final written;
        # per neuron-step: two multiplies and one add.
        bound, by = _bound_ms(4 * (2 * t * n + 2 * n), 3 * t * n)
        rows.append(dict(kernel="lif_scan", shape=list(cur.shape), ms=ms,
                         warm_l2_ms=warm, call_ms=call, plain_ms=plain,
                         bound_ms=bound, bound_by=by))
        tot["ms"] += ms
        tot["plain_ms"] += plain
        tot["bound_ms"] += bound
    out["lif_scan"] = dict(tot, bound_by="bytes", library_ms=None)

    # K2 at fc1 and fc2.
    fc = [(CONFIG.flat_dim, CONFIG.hidden), (CONFIG.hidden,
                                             CONFIG.num_classes)]
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0)
    t_ops_all = t_bytes_all = 0.0
    for k, n in fc:
        s = (torch.rand(t, b, k, generator=g) < 0.2).float().to(dev)
        w = (torch.randn(k, n, generator=g) * (2.0 / k) ** 0.5).to(dev)
        v0 = torch.zeros(b, n, device=dev)
        run = lambda: k2.fc_lif_scan_cuda(s, w, p, v0)
        ms = _device_ms(torch, run, flush)
        warm = _warm_ms(torch, run)
        call = _call_ms(torch, run)
        plain = _device_ms(torch, lambda: k2.fc_lif_scan_plain(s, w, p, v0),
                           flush, reps=5)
        s2 = s.reshape(t * b, k)
        lib = _device_ms(torch, lambda: torch.matmul(s2, w), flush)
        # Every product and add of the dense sum (the kernel skips no
        # zero), plus the LIF update; bytes: spikes, W and v0 read once,
        # output spikes and v_final written once.
        flops = 2 * t * b * k * n + 3 * t * b * n
        nbytes = 4 * (t * b * k + k * n + b * n + t * b * n + b * n)
        bound, by = _bound_ms(nbytes, flops)
        t_ops_all += flops / H100_FP32_FLOPS
        t_bytes_all += nbytes / H100_BYTES_PER_S
        rows.append(dict(kernel="fc_lif_scan", shape=[t, b, k, n], ms=ms,
                         warm_l2_ms=warm, call_ms=call, plain_ms=plain,
                         bound_ms=bound, bound_by=by, library_ms=lib))
        for key, v in (("ms", ms), ("plain_ms", plain), ("bound_ms", bound),
                       ("library_ms", lib)):
            tot[key] += v
    out["fc_lif_scan"] = dict(
        tot, bound_by="operations" if t_ops_all >= t_bytes_all else "bytes")
    del flush
    emit("kernel_times",
         unit="ms of device time per call from a cold L2 (CUDA graph of "
              "one call, CUDA events, median); warm_l2_ms: inputs left in "
              "L2 by the call before; call_ms: one call timed from the host",
         reps=REPS, flush_mb=FLUSH_BYTES >> 20, per_shape=rows,
         per_engine_step={k: v for k, v in out.items()},
         library_note="torch.matmul of the fc currents alone: computes "
                      "less than K2 (no LIF, currents stored)")

    params = snn_params_from_numpy(_np_params(CONFIG, dyadic=True))
    pool = [w for ws in _windows(8, 4, SEED + 3) for w in ws]
    e2e = {f"B{slots}": throughput(torch, dev, params, slots, pool)
           for slots in (1, 8)}
    emit("end_to_end", metric="windows/s through StreamEngine.run, host "
         "clock ending in torch.cuda.synchronize", samples=E2E_SAMPLES,
         steps_per_sample=E2E_STEPS, **e2e)
    profile_run(torch, dev, params, pool,
                e2e["B8"]["step_ms_median"])
    return out


def _submit_steps(handles, pool, steps, start):
    """Queue ``steps`` windows on each stream, drawn in turn from
    ``pool``; returns the next draw position."""
    i = start
    for _ in range(steps):
        for h in handles:
            h.submit(pool[i % len(pool)])
            i += 1
    return i


def throughput(torch, dev, params, slots, pool):
    """Windows/s of one warmed B=``slots`` engine with ``slots`` stateless
    streams: ``E2E_SAMPLES`` runs of ``E2E_STEPS`` full engine steps."""
    from repro_torch.configs import CONFIG
    eng = _engine(params, CONFIG, dev, slots)
    handles = [eng.open(stream_id=i) for i in range(slots)]
    eng.warmup([(slots, 65_536, 300_000)])
    pos = _submit_steps(handles, pool, 2, 0)
    eng.run()
    rates, step_ms, total_w, total_s = [], [], 0, 0.0
    for _ in range(E2E_SAMPLES):
        pos = _submit_steps(handles, pool, E2E_STEPS, pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        # Every stream holds a slot throughout, so each engine step
        # serves one window per slot.
        check(len(res) == slots * E2E_STEPS,
              f"B={slots}: {len(res)} of {slots * E2E_STEPS} windows")
        rates.append(len(res) / dt)
        step_ms.append(dt * 1e3 / E2E_STEPS)
        total_w += len(res)
        total_s += dt
    return dict(windows_per_s_median=statistics.median(rates),
                windows_per_s_min=min(rates), windows_per_s_max=max(rates),
                windows_per_s_all=total_w / total_s,
                step_ms_median=statistics.median(step_ms),
                windows=total_w, steps=E2E_SAMPLES * E2E_STEPS)


def profile_run(torch, dev, params, pool, step_ms_untraced):
    """Where the time of ``PROFILE_STEPS`` steady-state B=8 steps goes:
    device busy time and the largest kernels and host ops, from
    torch.profiler. Tracing slows the host, so the traced wall time is
    longer than untraced; the busy share is also given against the
    untraced step time of the end_to_end phase."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import CONFIG
    eng = _engine(params, CONFIG, dev, 8)
    handles = [eng.open(stream_id=i) for i in range(8)]
    eng.warmup([(8, 65_536, 300_000)])
    pos = _submit_steps(handles, pool, 4, 0)
    eng.run()                               # reach the steady state
    _submit_steps(handles, pool, PROFILE_STEPS, pos)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = eng.run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    steps = PROFILE_STEPS
    check(len(res) == 8 * steps,
          f"profiled {len(res)} of {8 * steps} windows")
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    check(len(kernels) > 0, "the trace shows no device work")
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    host = sorted(prof.key_averages(), key=lambda a: a.self_cpu_time_total,
                  reverse=True)[:8]
    emit("profile", windows=len(res), steps=steps, wall_ms=wall_us / 1e3,
         device_busy_ms=busy_us / 1e3,
         device_busy_share_traced=busy_us / wall_us,
         device_busy_ms_per_step=busy_us / 1e3 / steps,
         device_busy_share_untraced=busy_us / 1e3 / steps / step_ms_untraced,
         device_ops_per_step=len(kernels) / steps,
         top_device_ms_per_step={k[:60]: v / 1e3 / steps for k, v in sorted(
             by_name.items(), key=lambda kv: -kv[1])[:8]},
         top_host_self_ms_per_step={
             a.key[:60]: a.self_cpu_time_total / 1e3 / steps for a in host})


if __name__ == "__main__":
    sys.exit(main())
