#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, one JSON line each; any failed check raises, so the script exits
non-zero:

  1. device and build: the card (as nvidia-smi reports it), the torch and
     CUDA versions, and the time to build kernels K1, K2, K3 and K4 with
     nvcc (one nvcc per source, all started together);
  2. each kernel against its plain PyTorch version on the card, at the
     main paths' shapes, bit for bit: K1 at conv1/conv2 in f32 and bf16,
     from rest and from v0 above threshold, chained at T//2 + 3 (inside a
     time chunk), at ragged rows (n % 4, n % 8, narrower than a block),
     T = 1, T = 17 and misaligned storage; K2 at fc1/fc2 and at ragged
     shapes (B in {1, 3, 8, 13}, T in {5, 16, 17}, K=100, N in {11, 40},
     plus shapes that take its wide tiles, odd K and several T chunks) in
     f32 and bf16, with v0 absent and above threshold, chained in two T
     halves; K2's currents entry at the frame wing's fc2 and ragged
     shapes; K3 at the frame wing's fc1 (M in {1, 8}, K=2048, N=512) on
     the 1/4 grid, at random f32 and bf16 and at ragged shapes, and at
     the LM's widths on both of its launch paths (split, up to 64 rows:
     decode M=4 and prompt M=32; serial: M=128 and M=4096), with a
     short last 512-k segment (K=1300) and with bytes that hold the
     unused field 3, each called twice; B=1 rows against the batch's;
  3. the event slice: a full-width StreamEngine built as a user builds it
     (EngineConfig(fuse_fc=True, pipeline_depth=1), no kernel arguments;
     on the card every engine step is a replay of its shape key's CUDA
     graph, captured by ``warmup``)
     serves 8 streams (4 stateful) x 3 windows of ~60k events; launch
     counters prove K1 and K2 ran; results are held against the port's
     own CPU run; one ClosedLoopPipeline window (B=1); reported, not
     gated: He-init weights against the CPU and cuDNN's batch invariance
     for the currents K1 reads (conv1 and conv2 rows at B=1..7 against
     B=8);
  4. the frame and fusion slice: a heterogeneous StreamEngine (one event
     and one frame lane, 8 slots each, pipeline_depth=1) serves
     8 FusionSessions x 3 ticks and 4 stand-alone frame streams; launch
     counters prove K1, K2, K3 and K2's currents entry (frame fc2, one
     launch per frame-lane step) ran; labels are held against the port's
     CPU run, logits and PWM within a stated tolerance; frame-lane rows at
     B=1 against B=8; ternary activations that flip between the card and
     the CPU; cuDNN's B=1-vs-B=8 rows for both TCN convs;
  5. times from CUDA events: each kernel, its plain version, its bound and
     the library yardstick, each call read from a cold L2 cache (K1 also
     warm, beside an empty call timed the same way, with the host time a
     call of ``ops.lif_scan`` and of its wrapper); windows/s
     end to end at B=1 and B=8 over 10 samples of 16 engine steps each;
     a profiler trace of 64 steady-state B=8 steps; frame-lane windows/s
     and fused ticks/s at B=8 over 10 samples of 16 steps, with the
     cross-wing megastep off and on, and a profile of 16 fused steps of
     each; then the ``graphs`` phase: capture ms, pool bytes and launch
     tally per shape key; replays against eager calls of the same step
     bit for bit (event wing over three chained stateful windows, frame
     wing); 8 stateful FusionSessions x 3 ticks through the megastep,
     pipelined, with launch counts asserted, against the megastep off (bit
     for bit) and the CPU; and the rates and per-step device ops, host
     launches and busy share of the end-to-end phases side by side;
  6. the serving surface (``serving_surface``), at full width with 8 + 8
     slots and graphs on, every gate bit for bit: checkpoint -> restore
     into a fresh engine -> continue against the uninterrupted run (4
     stateful streams and 2 FusionSessions, depths 0 and 1) and against
     the port's CPU run; resize_lane 8 -> 4 -> 8 mid-stream (the new key
     captured inside resize_lane, repeated cycles adding no graph); a
     scripted step fault under recovery (retried), a NaN-poisoned window
     (quarantined, its stream then the clean run without it; rollback
     carries never in graph or staging memory) and a fault in a fused
     megastep (served through the per-lane graphs); abort_lane +
     replace_lane_engine + restore (the megastep's graphs dropped, memory
     allocated falls); DeadlinePolicy against FairQuantumPolicy over 8
     fused sessions, pairing kept. Reported: host us a stream of
     checkpoint and restore, capture ms and pool bytes after the resize
     cycles, memory allocated around replace_lane_engine, the ms of a
     retried step; K1, K2, K3 and the currents entry must launch;
  7. the fleet control plane (``fleet``), at full width with graphs on,
     every gate bit for bit: a live migration through a CheckpointStore
     from a 2-slot to a 4-slot engine at depths 0 and 1 (rows from before
     the move, from the lane drain and from the target against the
     uninterrupted run), and a stream moved back and forth 10 times; a
     FleetRebalancer over a hot and a cold engine against the static
     fleet (tests/test_fleet_soak.py at full width: it migrates, misses
     fewer deadlines, persistent streams bitwise, telemetry reads never
     synchronize); a LaneAutoscaler growing an event lane 2 -> 4 -> 8 ->
     16 and shrinking it back, twice (rows against the unresized run, the
     graph keys exactly those visited, the second cycle capturing nothing
     and reserving no more bytes); a LaneSupervisor rebuilding a killed
     event lane three times beside a frame lane (each restore within 2
     ticks, successful windows bitwise and reported once, frame rows
     unchanged, memory allocated after the third rebuild within 1 MiB of
     that after the first). Reported: migration ms by part with and
     without a step in flight, each resize's ms, capture ms and pool
     bytes, each recovery's ms by part, memory after each kill, and the
     host us of the autoscaler's and the rebalancer's ``observe()``;
  7b. slot sharding (``sharded``), at full width (Table II's SCNN,
     CUTIE's TCN, 8 slots a lane) over a mesh of every visible card when
     there are 2 or more, else logical meshes of 2 and 4 shards on
     cuda:0 (``sharded_meshes`` says which): K1, K2, K3 and the currents
     entry at a shard's shapes against their plain versions; event
     streams (10 over 8 slots, every other one stateful) beside 10 frame
     streams at depths 0 and 1, every row (label, PWM, logits) and every
     exported carry bit for bit the unsharded engine's on the same card,
     launches n x the unsharded count, the lane's state on the mesh; 4
     stateful FusionSessions bit for bit; a checkpoint taken on the
     largest mesh continued on an unsharded engine against the
     uninterrupted run. Reported: graphs, keys, pool bytes and capture ms
     a shard, windows/s sharded and unsharded (3 samples in turns; on one
     card a logical mesh replays n graphs a step, so no gain is claimed);
  7c. the port's examples (``examples``): the six serving examples
     (quickstart, closed_loop_control, multi_stream_control,
     hetero_control, fusion_control, fault_tolerant_control) and
     serve_ternary_lm through their ``main`` at --smoke on the card and
     on the CPU in this process: every decision's label equal and PWM
     within 1e-6, the migration and the supervised recoveries bit for
     bit, serve_ternary_lm's quantization and greedy tokens equal (both
     untrained, --steps 0); K1, K2, K3 and the currents entry must
     launch. Reported: multi-stream and hetero windows/s, the batched
     speedup, fusion_control's fused/separate ratio (a reading here: the
     example gates on it when run as a script) and serve_ternary_lm's
     tokens/s after its 8 smoke training steps;
  8. STBP training (``train``), the Table II network at full width as
     ``examples/torch_train_dvs_gesture.py`` trains it
     (``training.stbp_step``: ``snn_loss`` under autograd, AdamW;
     step-atomic checkpoints, B=16 windows of ~60k events from
     ``dvs_gesture_batch``): K1, K2 and K2's currents entry on the
     inputs a B=16 batch gives them, against their plain versions; the
     card against the port's CPU run in both modes (2**-8 weights, B=4:
     loss, logits, spikes and rates bit for bit, gradients within 1e-5
     of their largest magnitudes); layer_serial against time_serial on
     the card with the launch tallies of a step asserted; every layer's
     gradient nonzero at step 1; a step under
     ``torch.cuda.set_sync_debug_mode("error")``; 2k steps against k +
     checkpoint + restore + k, bit for bit. Reported: 30 steps' loss and
     accuracy a mode, step ms by part, step-only samples/s and the
     example loop's (data included), busy share, peak memory, a batch's
     host ms, save/restore ms;
  9. the LM slice (``lm_slice``): K4 against its plain version on the
     card bit for bit (prefill and decode calls, T=4, ragged T, chaining
     inside a time chunk, hd=32 and hd=16, unaligned inputs, B=1 rows);
     the rwkv6-7b widths at a depth of 1 layer in f32 on the card
     against the port's CPU run (forward logits, stepped decode, greedy
     tokens, ternary greedy tokens, and the card must pack the CPU's
     ternary bytes); the full rwkv6-7b (32 layers, bf16)
     served through BatchScheduler, generate and the prefill step with
     K4's launch counts asserted (32 per decode step and per prefill), then
     ternary-quantized and served with K3's counted (8 per layer per
     step); then K4's and K3's
     times at the LM shapes (K3 at M=4 decode and M=32 prompt rows, and
     at M=8,192 prefill rows on its serial path),
     decode and prefill tokens/s (3 samples each way: timing only), and
     a profile of bf16 decode steps (busy share); the sub-phases' seconds
     (``lm_slice_seconds``);
  10. the transformer families (``transformer``), after the LM slice has
     freed rwkv6's weights: (a) K3 against its plain version bit for bit
     at the products this slice serves -- llama3.2-1b's gate/up (K 2048,
     N 8192) and down (K 8192, N 2048), qwen2-vl-2b's down (K 8960) and
     deepseek-moe-16b's shared-expert down (K 2816), the last two ending
     in a short 512-k segment -- each at decode rows (split path) and
     prefill rows (M = 8,192, serial path), with their times beside
     torch.matmul and the bound; (b) llama3.2-1b, deepseek-moe-16b and
     qwen2-vl-2b at full width cut to 2 layers in f32, the card against
     the port's CPU run: logits within 1e-3, llama's stepped decode,
     greedy and ternary greedy tokens equal (the card packs the CPU's
     bytes), deepseek's chosen experts and dropped (token, choice) pairs
     equal, qwen2-vl with patch embeddings; (c) llama3.2-1b at full
     width and depth in bf16, served by BatchScheduler, then ternary
     through generate with K3 counted (48 launches a decode step, 48 a
     prefill), no host sync inside a bf16 or ternary decode step
     (``torch.cuda.set_sync_debug_mode("error")``), decode tokens/s with
     bf16 and ternary samples in turn, prefill tokens/s at B=4, S=2048,
     profiles of decode steps and memory; (d) deepseek-moe-16b (depth
     cut to 4 of 28 layers) and qwen2-vl-2b (full depth) at full width:
     decode tokens/s at B=4 with no host sync, ternary decode steps with
     K3 counted, one prefill at B=4, S=2048;
  11. the hybrid and enc-dec families (``hybrid``), after the
     transformer phase: (a) K3 against its plain version bit for bit at
     zamba2-1.2b's in_proj (K 2048, N 8384) and out_proj (K 4096, N 2048)
     at decode and prefill rows, and seamless-m4t-medium's MLP (1024 ->
     4096 -> 1024) and frontend_proj (1024 x 1024) at decode rows, timed
     beside torch.matmul and the bound; (b) zamba2 at full width cut to
     7 layers (two shared-block invocations, the second after a 1-layer
     stage) and seamless cut to 2 + 2 layers, in f32, the card against
     the port's CPU run: logits within 1e-3, decode (seamless over the
     cross K/V of encoded frames), greedy and ternary greedy tokens equal
     (the card packs the CPU's bytes, K3 counted); the SMOKE zamba2
     decoding 40 steps into its 16-slot ring against the CPU;
     ``mamba2_chunked`` at full width (H, P, N = 64, S = 2048, B=4)
     against its stepwise form on the card; (c) zamba2-1.2b at full width
     and depth in bf16: BatchScheduler, the ternary model through
     generate with K3 counted (97 launches a decode step, 97 a prefill;
     the card's packed bytes equal the CPU's on the first and last
     layers and the shared MLP), no host sync inside a bf16 or ternary
     decode step, decode tokens/s with bf16 and ternary samples in turn
     from a 512-slot cache, prefill tokens/s at B=4, S=2048, profiles;
     (d) seamless-m4t-medium at full width and depth: encode B=4 x 512
     frames, the cross K/V into a 512-slot cache, 32 greedy decode steps
     over them, no host sync in a bf16 or ternary step, decode tokens/s,
     one prefill of 2,048 frames and 2,048 tokens at B=4, and the ternary
     model served by BatchScheduler with K3 counted (24 a decode step);
  12. LM training (``lm_train``): (a) ``ops.wkv6_scan``'s gradients at
     rwkv6-7b's heads (H 64, hd 64, B 2, T 256; bf16 and f32) on the
     card against the CPU, K4 once a forward and never in the backward;
     (b) one ``make_train_step`` step a family in f32 at full width
     (llama3.2-1b, qwen2-vl-2b, rwkv6-7b at 2 layers, deepseek-moe-16b at
     1, zamba2-1.2b at 7, seamless at 2 + 2) against the CPU: loss, every
     leaf's first moment, the updated params, deepseek's routing; (c)
     llama3.2-1b at full width and 4 of 16 layers in bf16 through
     ``Trainer``, 20
     steps, a RuntimeError at step 10 and a restart from the checkpoints
     (every 10 steps, under checkpoints/; the uninterrupted run writes
     none) bit for bit against the uninterrupted run, the loss below half
     its first value; step ms,
     tokens/s, peak memory, a profile; (d) its gradient with remat on and
     off bit for bit, both peaks; (e) rwkv6-7b at full width and 4
     layers, bf16: K4 4 launches a step, 8 with remat, the loss falling,
     the WKV backward's share of a step; (f) ``compress_grads`` at 0.05
     on llama3.2-1b's gradients: top-k with ties, exact residuals, ms;
  12b. LM training over a mesh (``lm_train_sharded``): the one-device
     references (llama3.2-1b at full width and 4 of 16 layers, bf16,
     B=4, S=1024, remat, 2 steps; rwkv6-7b at full width and 2 layers,
     B=2, 2 steps; deepseek-moe-16b at full width and 2 layers, B=4,
     S=1024, remat, 2 steps; qwen2-vl-2b at 4 layers with 256 patch
     rows, zamba2-1.2b at 7 layers and seamless-m4t-medium at 2 + 2
     layers with 1,024 frames, each at full width, bf16, B=4, S=1024,
     remat, 2 steps), then four ranks (``distributed.runtime.spawn``;
     four gloo ranks on cuda:0 at (2, 2), or NCCL one rank a card with
     four cards)
     train the same through ``Trainer(shardings=...)``, FSDP over data
     and TP over model (deepseek's experts, zamba2's SSD heads over
     model), and llama3.2-1b again over a (pod=2, data=2, model=1) mesh
     (pod pure data parallelism: gradients all-reduced over it, each
     rank's batch rows its (pod, data) block): each first step
     against the one-device step (loss, gradient norm, first moments; per
     leaf, per head and per (layer, expert)) with gates set between the
     bf16 noise floor and a planted fault, deepseek's routing the same
     bits on every model rank, the collectives a rank issues a step and
     the bytes of its FSDP gathers and pod all-reduces against the count
     from the specs (every run but rwkv6-7b), each rank's batch rows,
     K4 launches on every rank (8: 2 layers x 2 steps x 2 with remat, on
     32 of the 64 heads) and K4 against its plain version on a rank's
     recorded inputs bit for bit, a SMOKE crash and restart over the mesh
     bit for bit. Reported: step ms, tokens/s,
     each rank's peak, collectives and their bytes a step, deepseek's
     routings that differ from the one-device step per layer (and in the
     noise floor) and its experts that got no token;
  12c. LM decode over a mesh (``lm_decode_sharded``): one-device
     references on the card (a 64-token prompt prefilled by stepping the
     decoder, then 8 greedy serve steps at B=8) for llama3.2-1b at full
     width and depth (bf16 and ternary; f32 at 4 layers),
     h2o-danube-1.8b at full width and 2 layers with a ring of 64 slots
     (every step wraps it), rwkv6-7b at full width and 4 layers (bf16
     and ternary), qwen2-vl-2b at 4 layers (bf16 and ternary),
     deepseek-moe-16b at 2 (bf16), zamba2-1.2b at 6 (one shared-block
     invocation on a ring of 64 slots; bf16 and ternary) and
     seamless-m4t-medium at 2 decoder layers (bf16; the cross K/V of 128
     frames); then four ranks (gloo on cuda:0 at (2, 2), or NCCL
     one rank a card) run ``launch.steps.make_serve_step`` in serve mode
     on their blocks of the same params and prefilled caches (llama3.2-1b
     bf16 also over (2, 2, 1)), fed the one-device tokens: f32 logits
     within 1e-4, bf16 and ternary logits' relative L2 under a gate that
     must sit between the measured noise floor (one device, bf16 against
     f32) and a planted fault (rank 0's block of layer 0's output
     projection zeroed), greedy tokens equal where the one-device top-2
     gap is sure, each rank's collectives and bytes a step equal to the
     count from the specs, K3 (3 a layer a step, 8 for rwkv6, 15 for
     zamba2 at 6 layers) and K4 (1 a layer a step) launches on every
     rank, each kernel bit for bit
     with its plain version on a rank's first call's inputs; step ms a
     rank beside the one-device step. Context parallelism, in the
     same spawn: B=1 over (2, 2) for llama3.2-1b at full depth (an
     8,192-slot cache over ("data", "model") filled by one forward over a
     4,096-token prompt), h2o-danube-1.8b at 2 layers on its real
     4,096-slot ring (a 4,092-token prompt: the steps wrap it), rwkv6-7b
     at 4 layers, bf16 and ternary (the state's dk over 'data', 32 rows a
     rank through K4's stripe entry, 4 a step on every rank, bit for bit
     with its plain version and, combined over 'data', with the
     whole-state K4), zamba2-1.2b at 6 layers on its 4,096-slot window
     (the SSM head dim over 'data'); llama3.2-1b at B=2 over (2, 2, 1)
     (rows over 'pod', whole over 'data') and at B=8 over (2, 2) with a
     73-slot cache (the KV heads over 'model'); the stripe entry's device
     ms at that call beside its bound and the whole-state K4's;
  13. the dry run (``dryrun``; ``launch.dryrun``'s fake trace of a step
     held against the same step on the card): llama3.2-1b at full width
     and depth, bf16, B=4, S=1024 with remat, the trace's FLOPs equal to
     ``FlopCounterMode`` over a real train step, param and AdamW bytes
     equal to the real trees', fits, the predicted peak over the measured
     one and the step's TFLOP/s; decode steps at B=4 from a 512-slot cache
     (rwkv6-7b bf16 and ternary, during the LM slice; ternary llama3.2-1b
     here) with the trace's K3 and K4 shape-only calls equal to the launch
     counters' deltas of the real step; the shape-only outputs' shapes and
     dtypes against the kernels'; the host time of a K3 call through
     ``ternary_matmul_fwd`` beside ``ternary_matmul_cuda``; the dry run's
     collectives (``launch.collective_analysis``): one rank's step of
     ``lm_train_sharded``'s pod run traced on fake tensors over a fake
     (2, 2, 1) process group, its tallies and bytes a step equal to
     those every gloo rank of that run measured; and one rank's decode
     step of ``lm_decode_sharded``'s llama3.2-1b run over a fake (2, 2)
     group, equal to every rank's tallies of that run;
  14. each phase's seconds (``phase_seconds``), the ``kernels`` line,
     then the card line, then the ``ok`` line.

Cut to keep the run inside its time (every gate kept): decode-rate
samples 3 a side and end-to-end samples 10 (timing only); lm_vs_cpu's
tokens (``LM_CUT_*``); the sharded restart on SMOKE llama3.2-1b;
lm_train's llama3.2-1b checkpoints every 10 steps in the restarted run
and none in the uninterrupted one (``LT_CKPT_EVERY``: the saves at 5 and
15 were deleted unread, the uninterrupted run's final save never read);
the sharded phase's reference blocks copied to shared memory in one
segment a rank; lm_train's f32 step of deepseek-moe-16b against the CPU
at 1 layer (``LT_MOE_CPU_LAYERS``; the transformer phase holds its
forward at 2); lm_train's restarted llama3.2-1b run at 4 of 16 layers
(``LT_TRAINER_LAYERS``; its checkpoint I/O was half of it);
lm_decode_sharded's f32 llama3.2-1b run at 4 of 16 layers
(``LD_F32_LAYERS``; the bf16 and ternary runs keep the full depth).

Weights are random from a numpy seed. For the event wing's served
comparison they are rounded to multiples of 2**-8: every conv and fc
current is then exact in f32 whatever the summation order, so the card
and the CPU must agree bit for bit unless an algorithm rounds inside the
sum (a Winograd or FFT convolution would). A run with the unrounded
He-init weights is reported beside it, as is cuDNN's batch invariance.
The frame wing's convs sum normalized pixels, which no weight grid makes
exact, so a few of its ternary activations may flip between devices;
the phase counts them and bounds their effect on the logits.
"""
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
# fp32 outside the tensor cores, each multiply and each add one
# instruction: the kernels are built with -fmad=false, so the data sheet's
# 67 TFLOP/s (an FMA counted as two operations) is out of their reach.
H100_FP32_OPS = 33.5e12
H100_BF16_FLOPS = 989e12          # bf16 on the tensor cores, dense
REPS = 20
# Rows K3 gets from a prompt of 8 tokens at B=4 (generate's prefill).
LM_PROMPT_ROWS = 32
FLUSH_BYTES = 512 << 20           # read between timed calls: 10x the L2
E2E_SAMPLES = 10                  # end-to-end samples per batch size
E2E_STEPS = 16                    # engine steps per sample
PROFILE_STEPS = 64
HOST_CALLS = 200                  # calls queued a sample of host time


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
    from repro_torch.kernels import ternary_matmul as k3
    from repro_torch.kernels import wkv6_scan as k4

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build_all([k1.KERNEL, k2.KERNEL, k3.KERNEL, k4.KERNEL])
    build_s = time.perf_counter() - t0
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=build_s,
         tf32=[torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32])

    seconds = {"build": build_s}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    err = timed("kernel_checks", kernel_checks, torch, dev, k1, k2)
    err["ternary_matmul"] = timed("k3_checks", k3_checks, torch, dev, k3)
    served = timed("slice", slice_run, torch, dev, k1, k2)
    fused = timed("frame_slice", frame_slice, torch, dev, k1, k2, k3)
    times = timed("timings", timings, torch, dev, k1, k2)
    times["ternary_matmul"] = timed("k3_timings", k3_timings, torch, dev, k3)
    fe = timed("frame_end_to_end", frame_end_to_end, torch, dev)
    timed("graphs", graphs_phase, torch, dev, k1, k2, k3, smi,
          times["end_to_end"], fe)
    surface = timed("serving_surface", serving_surface, torch, dev, k1, k2,
                    k3, smi)
    fleet = timed("fleet", fleet_phase, torch, dev, k1, k2, k3, smi)
    sharded = timed("sharded", sharded_phase, torch, dev, k1, k2, k3, smi)
    ex = timed("examples", examples_phase, torch, dev, k1, k2, k3, smi)
    train = timed("train", train_phase, torch, dev, k1, k2, smi)
    lm = timed("lm_slice", lm_slice, torch, dev, k3, k4)
    tf = timed("transformer", transformer_phase, torch, dev, k3)
    hy = timed("hybrid", hybrid_phase, torch, dev, k3)
    lt = timed("lm_train", lm_train_phase, torch, dev, k4, smi)
    ls = timed("lm_train_sharded", lm_train_sharded_phase, torch, dev, k4,
               smi)
    ld = timed("lm_decode_sharded", lm_decode_sharded_phase, torch, dev, k3,
               k4, smi)
    dr = timed("dryrun", dryrun_phase, torch, dev, k3, k4, smi, lm["dryrun"],
               ls["pod"], ld["llama"])
    emit("phase_seconds", total=time.perf_counter() - t0, **seconds)

    kernels = [
        dict(name="lif_scan", route="cuda",
             source="src/repro_torch/csrc/lif_scan.cu",
             replaces="src/repro/kernels/lif_scan.py:111",
             launches=served["launches"]["lif_scan"],
             serving_surface_launches=surface["lif_scan"],
             fleet_launches=fleet["lif_scan"],
             sharded_launches=sharded["launches"]["lif_scan"],
             examples_launches=ex["launches"]["lif_scan"],
             train_launches=train["launches"]["lif_scan"],
             max_abs_err=max(err["lif_scan"],
                             train["max_abs_err"]["lif_scan"],
                             sharded["max_abs_err"]["lif_scan"]),
             **times["lif_scan"]),
        dict(name="fc_lif_scan", route="cuda",
             source="src/repro_torch/csrc/fc_lif_scan.cu",
             replaces="src/repro/kernels/fc_lif_scan.py:131",
             launches=served["launches"]["fc_lif_scan"],
             serving_surface_launches=surface["fc_lif_scan"],
             fleet_launches=fleet["fc_lif_scan"],
             sharded_launches=sharded["launches"]["fc_lif_scan"],
             examples_launches=ex["launches"]["fc_lif_scan"],
             train_launches=train["launches"]["fc_lif_scan"],
             max_abs_err=max(err["fc_lif_scan"],
                             train["max_abs_err"]["fc_lif_scan"],
                             sharded["max_abs_err"]["fc_lif_scan"]),
             **times["fc_lif_scan"]),
        dict(name="fc_currents", entry_of="fc_lif_scan", route="cuda",
             source="src/repro_torch/csrc/fc_lif_scan.cu",
             replaces="src/repro/core/tcn.py:196",
             note="no TPU kernel: the JAX package leaves s3 @ w to XLA",
             launches=fused["launches"]["fc_currents"],
             serving_surface_launches=surface["fc_currents"],
             fleet_launches=fleet["fc_currents"],
             sharded_launches=sharded["launches"]["fc_currents"],
             examples_launches=ex["launches"]["fc_currents"],
             train_launches=train["launches"]["fc_currents"],
             max_abs_err=max(err["fc_currents"],
                             train["max_abs_err"]["fc_currents"],
                             sharded["max_abs_err"]["fc_currents"]),
             **times["fc_currents"]),
        dict(name="ternary_matmul", route="cuda",
             source="src/repro_torch/csrc/ternary_matmul.cu",
             replaces="src/repro/kernels/ternary_matmul.py:92",
             launches=(fused["launches"]["ternary_matmul"]
                       + lm["launches"]["ternary_matmul"]
                       + tf["launches"] + hy["launches"]
                       + ld["launches"]["ternary_matmul"]),
             transformer_launches=tf["launches"],
             sharded_decode_launches=ld["launches"]["ternary_matmul"],
             hybrid_launches=hy["launches"],
             serving_surface_launches=surface["ternary_matmul"],
             fleet_launches=fleet["ternary_matmul"],
             sharded_launches=sharded["launches"]["ternary_matmul"],
             examples_launches=ex["launches"]["ternary_matmul"],
             max_abs_err=max(err["ternary_matmul"],
                             sharded["max_abs_err"]["ternary_matmul"],
                             lm["max_abs_err"]["ternary_matmul"],
                             tf["max_abs_err"], hy["max_abs_err"],
                             ld["max_abs_err"]["ternary_matmul"]),
             transformer_times=tf["times"],
             hybrid_times=hy["times"],
             dryrun=dr["ternary_matmul"],
             **times["ternary_matmul"]),
        dict(name="wkv6_scan", route="cuda",
             source="src/repro_torch/csrc/wkv6_scan.cu",
             replaces="src/repro/kernels/wkv6_scan.py:69",
             launches=lm["launches"]["wkv6_scan"],
             train_launches=lt["launches"],
             train_grad_rel_err=lt["max_abs_err"],
             sharded_train_launches=ls["launches"],
             sharded_train_max_abs_err=ls["max_abs_err"],
             sharded_decode_launches=ld["launches"]["wkv6_scan"],
             dryrun=dr["wkv6_scan"],
             max_abs_err=max(lm["max_abs_err"]["wkv6_scan"],
                             ls["max_abs_err"],
                             ld["max_abs_err"]["wkv6_scan"]),
             **lm["times"]["wkv6_scan"]),
        dict(name="wkv6_stripe", entry_of="wkv6_scan", route="cuda",
             source="src/repro_torch/csrc/wkv6_scan.cu",
             replaces="src/repro/kernels/wkv6_scan.py:69",
             note="K4 on a stripe of the state's dk rows (the state's dk "
                  "over 'data' at B=1); rwkv6-7b's decode on the ranks of "
                  "lm_decode_sharded",
             launches=ld["launches"]["wkv6_stripe"],
             max_abs_err=max(ld["max_abs_err"]["wkv6_stripe"],
                             ld["stripe"]["max_abs_err"]),
             **{k: ld["stripe"][k] for k in (
                 "ms", "warm_l2_ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "whole_state", "shape")}),
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
            for v0_kind in ("none", "above_threshold"):
                cur = (torch.randn(t, b, *feat, generator=g) * 0.6 + 0.3).to(
                    dtype).to(dev)
                v0 = None if v0_kind == "none" else (
                    torch.rand(b, *feat, generator=g) * 1.4 - 0.2).to(dev)
                ok, err = _k1_case(torch, k1, p, cur, v0, row=5)
                errs["lif_scan"] = max(errs["lif_scan"], err)
                rows.append(dict(kernel="lif_scan", layer=layer,
                                 shape=list(cur.shape), dtype=str(dtype),
                                 v0=v0_kind, **ok))
                check(all(ok.values()), f"K1 {layer} {dtype} {v0_kind}: {ok}")
    failed, cases = [], 0
    for shape, misaligned in K1_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for v0_kind in ("none", "above_threshold"):
                cur = (torch.randn(*shape, generator=g) * 0.6 + 0.3).to(
                    dtype).to(dev)
                v0 = None if v0_kind == "none" else (
                    torch.rand(*shape[1:], generator=g) * 1.4 - 0.2).to(dev)
                if misaligned:
                    cur = _misaligned(torch, cur)
                    v0 = None if v0 is None else _misaligned(torch, v0)
                ok, err = _k1_case(torch, k1, p, cur, v0, row=shape[1] - 1)
                cases += 1
                errs["lif_scan"] = max(errs["lif_scan"], err)
                if not all(ok.values()):
                    failed.append(dict(shape=list(shape), dtype=str(dtype),
                                       v0=v0_kind, misaligned=misaligned,
                                       **ok))
    rows.append(dict(kernel="lif_scan", layer="ragged", shapes=len(K1_SHAPES),
                     cases=cases, failed=failed))
    check(not failed, f"K1 at ragged shapes: {failed}")
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
        ok, err = _k2_case(torch, k2, p, s, w, v0, row=2)
        ok["spiking"] = float(k2.fc_lif_scan_cuda(s, w, p, v0)[0].mean())
        errs["fc_lif_scan"] = max(errs["fc_lif_scan"], err)
        rows.append(dict(kernel="fc_lif_scan", layer=layer,
                         shape=[t, b, k, n], **ok))
        check(ok["plain"] and ok["b1_rows"] and ok["chained"],
              f"K2 {layer}: {ok}")
    ragged = [dict(b=bb, t=tt, k=100, n=nn) for bb in (1, 3, 8, 13)
              for tt in (5, 16, 17) for nn in (11, 40)]
    ragged += K2_TILE_SHAPES
    failed = []
    for shape in ragged:
        for dtype in (torch.float32, torch.bfloat16):
            for v0_kind in ("none", "above_threshold"):
                bt, bb, kk, nn = shape["t"], shape["b"], shape["k"], \
                    shape["n"]
                s = torch.randn(bt, bb, kk, generator=g).to(dtype).to(dev)
                w = (torch.randn(kk, nn, generator=g) * kk ** -0.5).to(dev)
                v0 = None if v0_kind == "none" else (
                    torch.rand(bb, nn, generator=g) * 1.4 - 0.2).to(dev)
                ok, err = _k2_case(torch, k2, p, s, w, v0, row=bb - 1)
                errs["fc_lif_scan"] = max(errs["fc_lif_scan"], err)
                if not all(ok.values()):
                    failed.append(dict(shape, dtype=str(dtype), v0=v0_kind,
                                       **ok))
    rows.append(dict(kernel="fc_lif_scan", layer="ragged",
                     shapes=len(ragged), cases=4 * len(ragged),
                     failed=failed))
    check(not failed, f"K2 at ragged shapes: {failed}")
    errs["fc_currents"] = currents_checks(torch, dev, k2, g, rows)
    emit("kernels_vs_plain", tolerance="bitwise", checks=rows,
         max_abs_err=errs)
    return errs


# K1 beyond the main path's shapes, (T, B, n) with a flag for storage
# one element past a 16-byte boundary: ragged rows (n % 4, n % 8), rows
# narrower than one block, one step, a chunk and a step (T = 17), a
# window of two and a half chunks, and misaligned currents and v0.
K1_SHAPES = [((17, 3, 37), False), ((16, 1, 5), False), ((1, 8, 1000), False),
             ((17, 2, 64), False), ((5, 3, 12), False), ((40, 2, 96), False),
             ((16, 8, 8192), True), ((17, 3, 40), True)]


def _k1_case(torch, k1, p, cur, v0, row):
    """K1 against its plain version on one (T, B, ...) input: the whole
    call, batch row ``row`` alone, and (f32 only: a bf16 v_final is
    rounded by contract) chained through v_final at step T//2 + 3, which
    splits a time chunk. Returns (checks, max error)."""
    t = cur.shape[0]
    want = k1.lif_scan_plain(cur, p, v0)
    got = k1.lif_scan_cuda(cur, p, v0)
    one = k1.lif_scan_cuda(cur[:, row:row + 1].contiguous(), p,
                           None if v0 is None else v0[row:row + 1])
    ok = dict(plain=_bitwise(torch, want, got),
              b1_rows=bool(torch.equal(one[0][:, 0], got[0][:, row])
                           and torch.equal(one[1][0], got[1][row])))
    cut = t // 2 + 3
    if cur.dtype == torch.float32 and cut < t:
        s_a, v_a = k1.lif_scan_cuda(cur[:cut], p, v0)
        s_b, v_b = k1.lif_scan_cuda(cur[cut:], p, v_a)
        ok["chained"] = bool(torch.equal(torch.cat([s_a, s_b]), got[0])
                             and torch.equal(v_b, got[1]))
    torch.cuda.synchronize()
    return ok, _max_err(want, got)


# Shapes beyond the ragged grid that take K2's other code paths: its wide
# tiles (>= 32,768 outputs) with ragged edges, several T chunks, and an
# odd K (element copies of the spike rows).
K2_TILE_SHAPES = [dict(b=13, t=17, k=100, n=520), dict(b=8, t=5, k=37, n=1000),
                  dict(b=4, t=40, k=64, n=300), dict(b=3, t=16, k=37, n=40)]


def _k2_case(torch, k2, p, s, w, v0, row):
    """K2 against its plain version on one input: the whole call, batch row
    ``row`` alone, and (f32 only: a bf16 v_final is rounded by contract)
    two T halves chained through v_final. Returns (checks, max error)."""
    want = k2.fc_lif_scan_plain(s, w, p, v0)
    got = k2.fc_lif_scan_cuda(s, w, p, v0)
    one = k2.fc_lif_scan_cuda(s[:, row:row + 1].contiguous(), w, p,
                              None if v0 is None else v0[row:row + 1])
    ok = dict(plain=_bitwise(torch, want, got),
              b1_rows=bool(torch.equal(one[0][:, 0], got[0][:, row])
                           and torch.equal(one[1][0], got[1][row])))
    if s.dtype == torch.float32:
        half = s.shape[0] // 2
        o_a, v_a = k2.fc_lif_scan_cuda(s[:half].contiguous(), w, p, v0)
        o_b, v_b = k2.fc_lif_scan_cuda(s[half:].contiguous(), w, p, v_a)
        ok["chained"] = bool(torch.equal(torch.cat([o_a, o_b]), got[0])
                             and torch.equal(v_b, got[1]))
    torch.cuda.synchronize()
    return ok, _max_err(want, got)


def currents_checks(torch, dev, k2, g, rows):
    """K2's currents entry (through the ``fc_currents`` dispatcher, as the
    frame wing calls it) against the ascending-k loop: the frame wing's
    fc2 (8 ternary rows, K=512, N=11) with each row alone, a (T, B, K)
    input, and ragged and wide shapes (the entry takes f32)."""
    from repro_torch.configs import TCN_CONFIG
    k, n = TCN_CONFIG.hidden, TCN_CONFIG.num_classes
    x = torch.randint(-1, 2, (8, k), generator=g).float().to(dev)
    w = torch.randn(k, n, generator=g).to(dev)
    got = k2.fc_currents(x, w)
    torch.cuda.synchronize()
    ok = dict(plain=bool(torch.equal(got, k2.fc_currents_plain(x, w))),
              b1_rows=all(bool(torch.equal(k2.fc_currents(x[r:r + 1], w)[0],
                                           got[r])) for r in range(8)))
    err = _max_err([k2.fc_currents_plain(x, w)], [got])
    cases = [(8, k, n, torch.float32), (1, 2048, 512, torch.float32)]
    cases += [(m, kk, nn, torch.float32) for m in (1, 13, 300)
              for kk, nn in ((37, 11), (100, 40), (512, 520))]
    failed = []
    for m, kk, nn, dt in cases:
        xs = torch.randn(m, kk, generator=g).to(dt).to(dev)
        ws = (torch.randn(kk, nn, generator=g) * kk ** -0.5).to(dev)
        want, have = k2.fc_currents_plain(xs, ws), k2.fc_currents(xs, ws)
        torch.cuda.synchronize()
        err = max(err, _max_err([want], [have]))
        if not torch.equal(want, have):
            failed.append(dict(m=m, k=kk, n=nn, dtype=str(dt)))
    x3 = torch.randn(16, 8, 512, generator=g).to(dev)
    w3 = torch.randn(512, 40, generator=g).to(dev)
    ok["tbk_input"] = bool(torch.equal(k2.fc_currents(x3, w3),
                                       k2.fc_currents_plain(x3, w3)))
    ok["ragged"] = not failed
    rows.append(dict(kernel="fc_currents", layer="frame fc2",
                     shape=[8, k, n], ragged_cases=len(cases),
                     failed=failed, **ok))
    check(all(ok.values()), f"K2 currents entry: {ok}, failed {failed}")
    return err


def k3_checks(torch, dev, k3):
    """K3 against its plain version: the frame wing's fc1 (K=2048, N=512)
    at M=8 and M=1 on the 1/4 grid its input lies on (where the library
    matmul of the unpacked weights is exact too), at random f32 and bf16,
    and at ragged shapes; then both launch paths at the LM's widths --
    the split path (decode, M=4 at K=4096 and K=14,336; M=32 prompts),
    the serial path (M=128 at K=N=4096; M=4096) -- and a short
    last segment (K=1300), on random bytes that hold the unused field 3
    (+2) where ``fields3``. Each case is called twice (the same bits)
    and its last row alone."""
    from repro_torch.configs import TCN_CONFIG
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import ternary_matmul_ref
    g = torch.Generator().manual_seed(SEED + 4)
    k, n = TCN_CONFIG.flat_dim, TCN_CONFIG.hidden
    f32, bf16 = torch.float32, torch.bfloat16
    # (M, K, N, x dtype, x on the 1/4 grid, random bytes with field 3)
    cases = [(8, k, n, f32, True, False), (1, k, n, f32, True, False),
             (8, k, n, f32, False, False), (8, k, n, bf16, False, False),
             (5, 260, 130, f32, False, False),
             (129, 512, 1000, f32, False, False),
             (64, 260, 130, bf16, False, False),
             (4, 4096, 4096, bf16, False, False),
             (4, 14336, 4096, bf16, False, False),
             (4, 4096, 14336, bf16, False, True),
             (32, 4096, 4096, bf16, False, True),
             (32, 4096, 14336, bf16, False, False),
             (128, 4096, 4096, bf16, False, True),
             (4, 1300, 130, f32, False, True),
             (33, 1300, 1000, bf16, False, True),
             (4096, 1024, 256, f32, False, True)]
    err, rows = 0.0, []
    for m, kk, nn, dtype, grid, fields3 in cases:
        x = (torch.randint(-4, 5, (m, kk), generator=g) / 4.0 if grid
             else torch.randn(m, kk, generator=g)).to(dtype).to(dev)
        if fields3:
            wp = torch.randint(0, 256, (kk // 4, nn), generator=g,
                               dtype=torch.uint8)
            scale = torch.rand(nn, generator=g) + 0.1
        else:
            wp, scale = ops.pack_ternary_weights(
                torch.randn(kk, nn, generator=g))
        wp, scale = wp.to(dev), scale.to(dev)
        want = k3.ternary_matmul_plain(x, wp, scale)
        got = k3.ternary_matmul_cuda(x, wp, scale)
        again = k3.ternary_matmul_cuda(x, wp, scale)
        one = k3.ternary_matmul_cuda(x[m - 1:].contiguous(), wp, scale)
        torch.cuda.synchronize()
        ok = dict(plain=bool(torch.equal(want, got)),
                  repeat=bool(torch.equal(again, got)),
                  b1_rows=bool(torch.equal(one[0], got[m - 1])))
        if grid:
            ok["library_bitwise"] = bool(torch.equal(
                ternary_matmul_ref(x, wp, scale), got))
        err = max(err, _max_err([want], [got]))
        rows.append(dict(kernel="ternary_matmul", shape=[m, kk, nn],
                         dtype=str(dtype), x="quarter_grid" if grid
                         else "normal", field3_bytes=fields3,
                         segments=-(-kk // k3.KS),
                         **_k3_path(k3, m, kk, nn), **ok))
        check(all(ok.values()), f"K3 {m}x{kk}x{nn} {dtype}: {ok}")
    check({r["path"] for r in rows} == {"split", "serial"},
          "K3's checks must reach both launch paths")
    emit("k3_vs_plain", tolerance="bitwise", segment=k3.KS, checks=rows,
         max_abs_err=err)
    return err


# ----------------------------------------------------------------------
# Phase 3: the event slice, served end to end.
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
                pwm_max_abs_diff=float(np.abs(pg - pc).max()),
                energy_equal_fraction=float(np.mean(
                    [gpu[k].energy_mj == cpu[k].energy_mj for k in keys])))


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
    # conv sums) on the card against the CPU, and cuDNN's batch
    # invariance for the currents K1 reads: each conv's rows of a B=b call
    # (T*b images) against the same rows of the B=8 call, b = 1..7.
    he = snn_params_from_numpy(_np_params(CONFIG, dyadic=False))
    he_gpu = _by_key(_serve(he, CONFIG, streams, dev).run())
    he_cpu = _by_key(_serve(he, CONFIG, streams, "cpu").run())
    gen = torch.Generator().manual_seed(SEED)
    h0, w0 = CONFIG.post_pool0
    rows = CONFIG.time_bins
    inputs = {
        # conv1 reads pooled input spikes, conv2 a 2x2 pool of conv1's
        # spikes (multiples of 1/4).
        "conv1": (torch.rand(rows * 8, h0, w0, CONFIG.in_channels,
                             generator=gen) < 0.3).float(),
        "conv2": torch.randint(0, 5, (rows * 8, h0 // 2, w0 // 2,
                                      CONFIG.conv1_features),
                               generator=gen) / 4.0}
    invariance = {}
    for name, x in inputs.items():
        x = x.to(dev)
        w = he[name]["w"].to(dev)
        big = snn_mod._conv(x, w)
        invariance[name] = {
            f"B{bb}": float((snn_mod._conv(x[:rows * bb].contiguous(), w)
                             == big[:rows * bb]).float().mean())
            for bb in range(1, 8)}
    emit("reported", he_init_vs_cpu=_compare(he_gpu, he_cpu),
         conv_rows_vs_b8_bitwise_fraction=invariance,
         conv1_rows_b1_vs_b8_bitwise_fraction=invariance["conv1"]["B1"])
    return {"launches": launches}


# ----------------------------------------------------------------------
# Phase 4: the frame and fusion slice.
# ----------------------------------------------------------------------

def _np_tcn_params(cfg):
    """He-init float TCN weights in the JAX package's layout (HWIO convs),
    from a numpy seed; the frame engine ternarizes and packs them."""
    rng = np.random.default_rng(SEED + 5)

    def he(shape, fan_in):
        return (rng.normal(size=shape) * cfg.init_gain
                * np.sqrt(2.0 / fan_in)).astype(np.float32)

    return {
        "conv1": {"w": he((3, 3, cfg.in_channels, cfg.conv1_features),
                          9 * cfg.in_channels)},
        "conv2": {"w": he((3, 3, cfg.conv1_features, cfg.conv2_features),
                          9 * cfg.conv1_features)},
        "fc1": {"w": he((cfg.flat_dim, cfg.hidden), cfg.flat_dim)},
        "fc2": {"w": he((cfg.hidden, cfg.num_classes), cfg.hidden)},
    }


def _frames(n_streams, n_frames, seed):
    from repro_torch.core.frames import synthetic_gesture_frames
    rng = np.random.default_rng(seed)
    return [[synthetic_gesture_frames(rng, (s + 5 * k) % 11)
             for k in range(n_frames)] for s in range(n_streams)]


def _hetero(params, tparams, device, slots=8, megastep=False):
    """The heterogeneous engine as a user builds it: one event and one
    frame lane, ``slots`` slots each, pipelined one step deep, with or
    without the cross-wing megastep."""
    from repro_torch.configs import CONFIG, TCN_CONFIG
    from repro_torch.core._api import EngineConfig
    from repro_torch.core.engine import FrameTCNEngine
    from repro_torch.core.pipeline import BatchedClosedLoop
    from repro_torch.serving import StreamEngine
    return StreamEngine(
        engines=[BatchedClosedLoop(params, CONFIG, device=device),
                 FrameTCNEngine(tparams, TCN_CONFIG, device=device)],
        config=EngineConfig(max_streams={"event": slots, "frame": slots},
                            pipeline_depth=1, megastep=megastep))


def _open_fused(eng, n_sessions, n_solo, stateful=False):
    from repro_torch.serving import FusionSession
    return ([FusionSession(eng, session_id=f"s{i}", stateful=stateful)
             for i in range(n_sessions)],
            [eng.open(modality="frame", stream_id=f"cam{i}")
             for i in range(n_solo)])


def _step_fused(eng, sessions, n_ticks, n_rows):
    """Step ``eng`` until ``n_ticks`` fused ticks and ``n_rows`` other
    rows are out, routing each step's rows through every session; returns
    ({(session, seq): result}, {(stream, seq): result})."""
    fused, other = {}, {}
    for _ in range(100 * (n_ticks + n_rows) + 10):
        if len(fused) >= n_ticks and len(other) >= n_rows:
            break
        rows = eng.step()
        for s in sessions:
            rows = s.absorb(rows)
            fused.update({(r.stream_id, r.seq): r.result
                          for r in s.drain()})
        other.update({(r.stream_id, r.seq): r.result for r in rows})
    check(len(fused) == n_ticks and len(other) == n_rows,
          f"fused {len(fused)}/{n_ticks} ticks, {len(other)}/{n_rows} rows")
    return fused, other


def _serve_fused(eng, sessions, solo, stateful=False):
    """8 FusionSessions over ``sessions`` (event windows, frames) and one
    frame stream per list in ``solo``, every tick queued up front."""
    sess, cams = _open_fused(eng, len(sessions), len(solo), stateful)
    ticks = len(sessions[0][0])
    for k in range(ticks):
        for s, (evs, frs) in zip(sess, sessions):
            s.submit(evs[k], frs[k])
        for h, frs in zip(cams, solo):
            h.submit(frs[k])
    return _step_fused(eng, sess, len(sess) * ticks, len(cams) * ticks)


def frame_slice(torch, dev, k1, k2, k3):
    from repro_torch.configs import CONFIG, TCN_CONFIG
    from repro_torch.convert import snn_params_from_numpy, \
        tcn_params_from_numpy
    from repro_torch.core import tcn as tcn_mod
    from repro_torch.core.frames import normalize_frames, pad_frame_windows

    params = snn_params_from_numpy(_np_params(CONFIG, dyadic=True))
    tparams = tcn_params_from_numpy(_np_tcn_params(TCN_CONFIG))
    frames = _frames(12, 3, SEED + 7)
    sessions = list(zip(_windows(8, 3, SEED + 6), frames[:8]))
    solo = frames[8:]
    eng = _hetero(params, tparams, dev)
    eng.warmup([(8, 65_536, 300_000)], modality="event")
    eng.warmup([(8, 128, 128, 300_000)], modality="frame")
    torch.cuda.synchronize()
    k1.launches = k2.launches = k3.launches = k2.currents_launches = 0
    fused, cams = _serve_fused(eng, sessions, solo)
    torch.cuda.synchronize()
    launches = {"lif_scan": k1.launches, "fc_lif_scan": k2.launches,
                "ternary_matmul": k3.launches,
                "fc_currents": k2.currents_launches}
    steps = eng.stats["steps"]
    # 8 sessions over 8 event slots: 3 event-lane steps of 2 K1 and 2 K2
    # launches each. 36 frames over 8 frame slots: at least 5 frame-lane
    # steps, one K3 launch (fc1) and one of K2's currents entry (fc2) each.
    check(launches["lif_scan"] == launches["fc_lif_scan"] == 6,
          f"event lane launches {launches}, expected 6 of K1 and K2")
    check(5 <= launches["ternary_matmul"] <= steps,
          f"K3 launched {launches['ternary_matmul']} times in {steps} "
          f"engine steps")
    check(launches["fc_currents"] == launches["ternary_matmul"],
          f"frame fc2 launches {launches}: expected one per frame-lane "
          f"step, as K3")
    check(eng.compiled_shapes("frame") == {(8, 128, 128, 300_000)},
          f"frame shape keys {eng.compiled_shapes('frame')}")
    ticks = [fused[k] for k in sorted(fused)]
    logits = np.concatenate([t.logits for t in ticks])
    pwm = np.concatenate([t.pwm for t in ticks])
    check(logits.shape == (24, CONFIG.num_classes), "fused logit shape")
    check(bool(np.isfinite(logits).all()), "non-finite fused logits")
    check(bool(((pwm >= 0) & (pwm <= 1)).all()), "fused pwm outside [0, 1]")
    paired = [eng.stream_stats[f"s{i}:{m}"].paired_tick_rate
              for i in range(8) for m in ("event", "frame")]

    cpu_eng = _hetero(params, tparams, "cpu")
    cpu_fused, cpu_cams = _serve_fused(cpu_eng, sessions, solo)
    vs_fused, vs_frame = _compare(fused, cpu_fused), _compare(cams, cpu_cams)
    # The event wing is exact (2**-8 weights). cuDNN and the CPU's conv
    # differ by ulps, which the ternary threshold absorbs: no activation may
    # flip. Given equal activations the frame logits (fc2's ascending-k sum
    # of exact products), the fused logits (an elementwise 0.5/0.5 mix) and
    # the energy are exact, and PWM differs only by the rounding of exp and
    # the softmax sum, as on the event wing.
    tol = dict(label="equal", flipped_activations=0.0,
               logits_atol=LOGITS_ATOL, energy="equal", pwm_atol=PWM_ATOL)

    # Ternary activations that flip between the card and the CPU, on the
    # first tick's 8 session frames at B=8.
    batch = pad_frame_windows([frs[0] for _, frs in sessions])
    px = torch.from_numpy(batch.pixels)
    on_card = tcn_mod.tcn_apply(eng.engines["frame"].packed,
                                normalize_frames(px.to(dev)), TCN_CONFIG)
    on_cpu = tcn_mod.tcn_apply(cpu_eng.engines["frame"].packed,
                               normalize_frames(px), TCN_CONFIG)
    flipped = {k: float((on_card["activations"][k].cpu()
                         != on_cpu["activations"][k]).float().mean())
               for k in on_cpu["activations"]}

    # Frame-lane rows at B=1 against B=8 on the card, through the engine.
    fe = eng.engines["frame"]
    first = [frs[0] for _, frs in sessions]
    r8 = fe.infer_frames(first)
    r1 = [fe.infer_frames([f])[0] for f in first]
    rows_b1 = dict(
        logits_bitwise=all(np.array_equal(a.logits, b.logits)
                           for a, b in zip(r1, r8)),
        pwm_bitwise=all(np.array_equal(a.pwm, b.pwm)
                        for a, b in zip(r1, r8)),
        energy_equal=all(a.energy_mj == b.energy_mj
                         for a, b in zip(r1, r8)))

    # cuDNN's rows at B=1 against B=8 for both ternary convs.
    x0 = tcn_mod._avg_pool(normalize_frames(px.to(dev)), TCN_CONFIG.pool0)
    x1 = tcn_mod._avg_pool(on_card["activations"]["conv1"], 2)
    conv_rows = {}
    for name, x in (("conv1", x0), ("conv2", x1)):
        layer = fe.packed[name]
        big = tcn_mod._ternary_conv(x, layer)
        same = [(tcn_mod._ternary_conv(x[b:b + 1].contiguous(), layer)[0]
                 == big[b]).float().mean() for b in range(x.shape[0])]
        conv_rows[name] = float(torch.stack(same).mean())

    emit("frame_slice", config="CONFIG + TCN_CONFIG (full width)",
         slots={"event": 8, "frame": 8}, sessions=8, ticks=3,
         solo_frame_streams=4, pipeline_depth=1, engine_steps=steps,
         launches=launches, fused_ticks=len(fused), solo_frames=len(cams),
         paired_tick_rate_min=min(paired),
         labels=[int(t.label_pred[0]) for t in ticks],
         fused_vs_cpu=vs_fused, solo_frames_vs_cpu=vs_frame, tolerance=tol,
         flipped_activation_fraction=flipped,
         frame_rows_b1_vs_b8=rows_b1,
         cudnn_rows_b1_vs_b8_bitwise_fraction=conv_rows)
    check(max(flipped.values()) == 0.0,
          f"ternary activations flipped between card and CPU: {flipped}")
    for name, cmp in (("fused", vs_fused), ("frame", vs_frame)):
        check(cmp["label_equal_fraction"] == 1.0, f"{name} labels: {cmp}")
        check(cmp["logits_max_abs_diff"] <= LOGITS_ATOL,
              f"{name} logits: {cmp}")
        check(cmp["energy_equal_fraction"] == 1.0, f"{name} energy: {cmp}")
        check(cmp["pwm_max_abs_diff"] <= PWM_ATOL, f"{name} pwm: {cmp}")
    check(all(rows_b1.values()), f"frame rows B=1 vs B=8: {rows_b1}")
    check(min(paired) == 1.0, f"paired tick rate {min(paired)} < 1")
    return {"launches": launches}


# ----------------------------------------------------------------------
# Phase 5: times.
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


def _host_us(torch, fn, calls=HOST_CALLS, samples=5):
    """Host microseconds a call of ``fn``: ``calls`` calls queued with no
    synchronisation between them, median of ``samples``."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def _bound_ms(nbytes, flops, peak=H100_FP32_OPS):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def timings(torch, dev, k1, k2):
    from repro_torch.configs import CONFIG, TCN_CONFIG
    from repro_torch.convert import snn_params_from_numpy
    p = CONFIG.lif
    t, b = CONFIG.time_bins, 8
    h0, w0 = CONFIG.post_pool0
    g = torch.Generator().manual_seed(SEED + 2)
    flush = torch.ones(FLUSH_BYTES // 4, device=dev)
    out = {}
    rows = []

    # K1 at conv1 and conv2, one engine step = both launches, beside an
    # empty call timed the same way (the harness's fixed cost) and the
    # host time a call of what the engine calls.
    from repro_torch.kernels import ops
    k1_shapes = [(h0, w0, CONFIG.conv1_features),
                 (h0 // 2, w0 // 2, CONFIG.conv2_features)]
    tot = dict(ms=0.0, warm_l2_ms=0.0, plain_ms=0.0, bound_ms=0.0)
    host = {}
    for layer, feat in zip(("conv1", "conv2"), k1_shapes):
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

        def engine_call():
            with torch.no_grad():
                return ops.lif_scan(cur, p, v0)
        host[layer] = dict(ops_lif_scan_no_grad=_host_us(torch, engine_call),
                           lif_scan_cuda=_host_us(torch, run))
        rows.append(dict(kernel="lif_scan", layer=layer,
                         shape=list(cur.shape), ms=ms,
                         warm_l2_ms=warm, call_ms=call, plain_ms=plain,
                         bound_ms=bound, bound_by=by, host_us=host[layer]))
        for key, val in (("ms", ms), ("warm_l2_ms", warm),
                         ("plain_ms", plain), ("bound_ms", bound)):
            tot[key] += val
    one = torch.zeros(1, device=dev)
    empty = dict(ms=_device_ms(torch, lambda: one.add_(1), flush),
                 warm_l2_ms=_warm_ms(torch, lambda: one.add_(1)))
    out["lif_scan"] = dict(tot, bound_by="bytes", library_ms=None,
                           empty_call_ms=empty["ms"],
                           empty_call_warm_l2_ms=empty["warm_l2_ms"],
                           host_us=host)

    # K2 at fc1 and fc2, one engine step = both launches. fc1 takes a 2x2
    # average pool of spikes (multiples of 1/4), fc2 takes spikes. Beside
    # the B=8 step: fc1 on a dense input (no zero) and the B=1 step, the
    # latency of one sensor's window.
    fc1 = (CONFIG.flat_dim, CONFIG.hidden)
    fc2 = (CONFIG.hidden, CONFIG.num_classes)
    pooled = lambda b_, k: ((torch.rand(t, b_, k, 4, generator=g) < 0.2)
                            .sum(-1).float() / 4.0)
    spikes = lambda b_, k: (torch.rand(t, b_, k, generator=g) < 0.2).float()
    dense = lambda b_, k: torch.randint(1, 5, (t, b_, k), generator=g) / 4.0
    k2_rows = {}
    for name, b_, make, (k, n) in (
            ("fc1", b, pooled, fc1), ("fc2", b, spikes, fc2),
            ("fc1_dense", b, dense, fc1), ("fc1_B1", 1, pooled, fc1),
            ("fc2_B1", 1, spikes, fc2)):
        s = make(b_, k).to(dev)
        w = (torch.randn(k, n, generator=g) * (2.0 / k) ** 0.5).to(dev)
        v0 = torch.zeros(b_, n, device=dev)
        run = lambda: k2.fc_lif_scan_cuda(s, w, p, v0)
        s2 = s.reshape(t * b_, k)
        # Every product and add of the dense sum (the kernel skips no
        # zero), plus the LIF update; bytes: spikes, W and v0 read once,
        # output spikes and v_final written once.
        bound, by = _bound_ms(
            4 * (t * b_ * k + k * n + b_ * n + t * b_ * n + b_ * n),
            2 * t * b_ * k * n + 3 * t * b_ * n)
        k2_rows[name] = dict(
            shape=[t, b_, k, n], nonzero=float((s != 0).float().mean()),
            ms=_device_ms(torch, run, flush), warm_l2_ms=_warm_ms(torch, run),
            call_ms=_call_ms(torch, run),
            plain_ms=_device_ms(torch, lambda: k2.fc_lif_scan_plain(
                s, w, p, v0), flush, reps=5),
            library_ms=_device_ms(torch, lambda: torch.matmul(s2, w), flush),
            bound_ms=bound, bound_by=by)
    step = {key: k2_rows["fc1"][key] + k2_rows["fc2"][key]
            for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
    out["fc_lif_scan"] = dict(step, bound_by=k2_rows["fc1"]["bound_by"])
    step_b1 = {key: k2_rows["fc1_B1"][key] + k2_rows["fc2_B1"][key]
               for key in ("ms", "bound_ms", "library_ms")}

    # K2's currents entry at the frame wing's fc2: 8 ternary rows.
    k, n = TCN_CONFIG.hidden, TCN_CONFIG.num_classes
    x = torch.randint(-1, 2, (b, k), generator=g).float().to(dev)
    w = torch.randn(k, n, generator=g).to(dev)
    run = lambda: k2.fc_currents_cuda(x, w)
    bound, by = _bound_ms(4 * (b * k + k * n + b * n), 2 * b * k * n)
    out["fc_currents"] = dict(
        ms=_device_ms(torch, run, flush),
        plain_ms=_device_ms(torch, lambda: k2.fc_currents_plain(x, w), flush,
                            reps=5),
        library_ms=_device_ms(torch, lambda: torch.matmul(x, w), flush),
        bound_ms=bound, bound_by=by)
    del flush
    emit("kernel_times",
         unit="ms of device time per call from a cold L2 (CUDA graph of "
              "one call, CUDA events, median); warm_l2_ms: inputs left in "
              "L2 by the call before; call_ms: one call timed from the host",
         reps=REPS, flush_mb=FLUSH_BYTES >> 20, k1_per_shape=rows,
         empty_call=dict(empty, what="x.add_(1) on one element"),
         host_unit=f"host microseconds a call, {HOST_CALLS} calls queued "
                   f"without a synchronisation, median of 5",
         k2_per_shape=k2_rows,
         per_engine_step={k: v for k, v in out.items()},
         k2_per_engine_step_B1=step_b1,
         fc_currents_frame_fc2=dict(out["fc_currents"], shape=[b, k, n]),
         library_note="torch.matmul of the fc currents alone: computes "
                      "less than K2 (no LIF, currents stored)")

    params = snn_params_from_numpy(_np_params(CONFIG, dyadic=True))
    pool = [w for ws in _windows(8, 4, SEED + 3) for w in ws]
    e2e = {f"B{slots}": throughput(torch, dev, params, slots, pool)
           for slots in (1, 8)}
    emit("end_to_end", metric="windows/s through StreamEngine.run, host "
         "clock ending in torch.cuda.synchronize", samples=E2E_SAMPLES,
         steps_per_sample=E2E_STEPS, **e2e)
    out["end_to_end"] = dict(e2e, profile_B8=profile_run(
        torch, dev, params, pool, e2e["B8"]["step_ms_median"]))
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


def _rate(torch, eng, handles, pool):
    """Windows/s of a warmed engine whose ``handles`` fill every slot:
    ``E2E_SAMPLES`` runs of ``E2E_STEPS`` full engine steps."""
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
        check(len(res) == len(handles) * E2E_STEPS,
              f"B={len(handles)}: {len(res)} of "
              f"{len(handles) * E2E_STEPS} windows")
        rates.append(len(res) / dt)
        step_ms.append(dt * 1e3 / E2E_STEPS)
        total_w += len(res)
        total_s += dt
    return dict(windows_per_s_median=statistics.median(rates),
                windows_per_s_min=min(rates), windows_per_s_max=max(rates),
                windows_per_s_all=total_w / total_s,
                step_ms_median=statistics.median(step_ms),
                windows=total_w, steps=E2E_SAMPLES * E2E_STEPS)


def throughput(torch, dev, params, slots, pool):
    """Windows/s of one warmed B=``slots`` event engine with ``slots``
    stateless streams."""
    from repro_torch.configs import CONFIG
    eng = _engine(params, CONFIG, dev, slots)
    eng.warmup([(slots, 65_536, 300_000)])
    return _rate(torch, eng, [eng.open(stream_id=i) for i in range(slots)],
                 pool)


def _trace(torch, run):
    """``run()`` under torch.profiler: (its result, wall ms, device busy
    ms by kernel name, the host ops with the most self time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    spans = []
    api = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
            spans.append((e.time_range.start, e.time_range.end))
        elif e.name.startswith("cuda"):
            api[e.name] = api.get(e.name, 0) + 1
    n_ops = len(spans)
    check(n_ops > 0, "the trace shows no device work")
    host = sorted(prof.key_averages(), key=lambda a: a.self_cpu_time_total,
                  reverse=True)[:8]
    return (res, wall_ms, by_name, n_ops, host, _gaps_us(sorted(spans)),
            api)


def _gaps_us(spans):
    """Idle gaps (us) between consecutive device operations of a trace:
    where the device waited for the host."""
    gaps, end = [], spans[0][1]
    for a, b in spans[1:]:
        if a > end:
            gaps.append(a - end)
        end = max(end, b)
    return gaps


def _trace_fields(wall_ms, by_name, n_ops, host, gaps, api, steps,
                  step_ms_untraced):
    """A trace's numbers a step. Kernels that a CUDA graph replay runs
    count as device ops like any other; the host's CUDA runtime calls
    (``cudaLaunchKernel`` a kernel launched from the host,
    ``cudaGraphLaunch`` a replay) say what the host queued."""
    busy = sum(by_name.values())
    launches = sum(n for name, n in api.items()
                   if name.startswith("cudaLaunchKernel"))
    return dict(
        host_kernel_launches_per_step=launches / steps,
        host_graph_launches_per_step=api.get("cudaGraphLaunch", 0) / steps,
        host_cuda_calls_per_step={k[:40]: n / steps for k, n in sorted(
            api.items(), key=lambda kv: -kv[1])[:6]},
        steps=steps, wall_ms=wall_ms, device_busy_ms=busy,
        device_idle_gaps_per_step=len(gaps) / steps,
        device_idle_gap_ms_per_step=sum(gaps) / 1e3 / steps,
        device_idle_gaps_over_100us_per_step=sum(
            g > 100 for g in gaps) / steps,
        largest_device_idle_gaps_us=sorted(gaps, reverse=True)[:5],
        device_busy_share_traced=busy / wall_ms,
        device_busy_ms_per_step=busy / steps,
        device_busy_share_untraced=busy / steps / step_ms_untraced,
        device_ops_per_step=n_ops / steps,
        top_device_ms_per_step={k[:60]: v / steps for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:8]},
        top_host_self_ms_per_step={
            a.key[:60]: a.self_cpu_time_total / 1e3 / steps for a in host})


def profile_run(torch, dev, params, pool, step_ms_untraced):
    """Where the time of ``PROFILE_STEPS`` steady-state B=8 steps goes:
    device busy time and the largest kernels and host ops, from
    torch.profiler. Tracing slows the host, so the traced wall time is
    longer than untraced; the busy share is also given against the
    untraced step time of the end_to_end phase."""
    from repro_torch.configs import CONFIG
    eng = _engine(params, CONFIG, dev, 8)
    handles = [eng.open(stream_id=i) for i in range(8)]
    eng.warmup([(8, 65_536, 300_000)])
    pos = _submit_steps(handles, pool, 4, 0)
    eng.run()                               # reach the steady state
    _submit_steps(handles, pool, PROFILE_STEPS, pos)
    res, *trace = _trace(torch, eng.run)
    check(len(res) == 8 * PROFILE_STEPS,
          f"profiled {len(res)} of {8 * PROFILE_STEPS} windows")
    fields = _trace_fields(*trace, PROFILE_STEPS, step_ms_untraced)
    emit("profile", windows=len(res), **fields)
    return fields


# ----------------------------------------------------------------------
# Phase 5 (frame wing): K3's times, frame-lane and fused throughput.
# ----------------------------------------------------------------------

def k3_timings(torch, dev, k3):
    """K3 at the frame wing's fc1, one launch per frame-lane step: M=8
    slots (and M=1, and M=32 rows as the LM's prompts give K3), K=2048,
    N=512, x on the 1/4 grid. ``vs_library`` is ms / library_ms."""
    from repro_torch.configs import TCN_CONFIG
    from repro_torch.core.ternary import unpack2bit
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(SEED + 8)
    k, n = TCN_CONFIG.flat_dim, TCN_CONFIG.hidden
    wp, scale = ops.pack_ternary_weights(torch.randn(k, n, generator=g))
    wp, scale = wp.to(dev), scale.to(dev)
    wq = unpack2bit(wp.t(), out_dtype=torch.float32).t().contiguous()
    flush = torch.ones(FLUSH_BYTES // 4, device=dev)
    rows = {}
    for m in (8, 1, LM_PROMPT_ROWS):
        x = (torch.randint(-4, 5, (m, k), generator=g) / 4.0).to(dev)
        run = lambda: k3.ternary_matmul_cuda(x, wp, scale)
        # x, the packed weights and the scale read once, out written once;
        # one add per term of the (M, K) x (K, N) product: a ternary weight
        # only chooses the sign of x (the product is exact), so x * q needs
        # no multiply.
        bound, by = _bound_ms(4 * m * k + k // 4 * n + 4 * n + 4 * m * n,
                              m * k * n)
        rows[f"M{m}"] = dict(
            ms=_device_ms(torch, run, flush), warm_l2_ms=_warm_ms(torch, run),
            call_ms=_call_ms(torch, run),
            plain_ms=_device_ms(torch, lambda: k3.ternary_matmul_plain(
                x, wp, scale), flush, reps=5),
            library_ms=_device_ms(torch, lambda: torch.matmul(x, wq), flush),
            bound_ms=bound, bound_by=by, path=_k3_path(k3, m, k, n))
        rows[f"M{m}"]["vs_library"] = (rows[f"M{m}"]["ms"]
                                       / rows[f"M{m}"]["library_ms"])
    del flush
    emit("k3_times", shape={"M": [8, 1, LM_PROMPT_ROWS], "K": k, "N": n},
         unit="ms of device time per call from a cold L2 (CUDA graph of "
              "one call, CUDA events, median); warm_l2_ms: inputs left in "
              "L2 by the call before; call_ms: one call timed from the host",
         library_note="torch.matmul of x with the unpacked f32 weights "
                      "(no scale): the yardstick, called nowhere in the port",
         **rows)
    r = rows["M8"]
    return {key: r[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}


def _k3_path(k3, m, k, n):
    """K3's launch plan for an (M, K) x (K, N) product, as a dict."""
    p = k3.plan(m, k, n)
    return dict(path=p.path, rows_a_thread=p.rows, segments_a_warp=p.group,
                warps_a_block=p.warps, blocks=p.blocks)


def _fused_rates(torch, dev, params, tparams, events, frames, megastep):
    """Fused ticks/s of 8 FusionSessions on a warmed heterogeneous engine
    over ``E2E_SAMPLES`` samples of ``E2E_STEPS`` steps (host clock,
    ending in torch.cuda.synchronize), then a profile of ``E2E_STEPS``
    fused steps; the megastep on or off."""
    ev_key, fr_key = (8, 65_536, 300_000), (8, 128, 128, 300_000)
    eng = _hetero(params, tparams, dev, megastep=megastep)
    if megastep:
        eng.warmup_megastep([(ev_key, fr_key)])
    else:
        eng.warmup([ev_key], modality="event")
        eng.warmup([fr_key], modality="frame")
    sess, _ = _open_fused(eng, 8, 0)
    pos = [0]

    def queue(steps):
        for _ in range(steps):
            for s in sess:
                s.submit(events[pos[0] % len(events)],
                         frames[pos[0] % len(frames)])
                pos[0] += 1

    def drain(steps):
        return _step_fused(eng, sess, len(sess) * steps, 0)[0]

    queue(2)
    drain(2)
    rates, step_ms, total_t, total_s = [], [], 0, 0.0
    for _ in range(E2E_SAMPLES):
        queue(E2E_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = len(drain(E2E_STEPS))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rates.append(n / dt)
        step_ms.append(dt * 1e3 / E2E_STEPS)
        total_t += n
        total_s += dt
    fused = dict(ticks_per_s_median=statistics.median(rates),
                 ticks_per_s_min=min(rates), ticks_per_s_max=max(rates),
                 ticks_per_s_all=total_t / total_s, ticks=total_t,
                 step_ms_median=statistics.median(step_ms))
    queue(E2E_STEPS)
    _, *trace = _trace(torch, lambda: drain(E2E_STEPS))
    check(eng.compiled_megastep_keys() == ({(ev_key, fr_key)} if megastep
                                           else set()),
          f"megastep keys {eng.compiled_megastep_keys()}")
    return fused, _trace_fields(*trace, E2E_STEPS, fused["step_ms_median"])


def frame_end_to_end(torch, dev):
    """Frame-lane windows/s at B=8 (a frame-only StreamEngine) and fused
    ticks/s of 8 FusionSessions on the heterogeneous engine, with the
    megastep off and on, each over ``E2E_SAMPLES`` samples of
    ``E2E_STEPS`` steps (host clock, ending in torch.cuda.synchronize);
    then a profile of ``E2E_STEPS`` fused steps of each."""
    from repro_torch.configs import CONFIG, TCN_CONFIG
    from repro_torch.convert import snn_params_from_numpy, \
        tcn_params_from_numpy
    from repro_torch.core._api import EngineConfig
    from repro_torch.core.engine import FrameTCNEngine
    from repro_torch.serving import StreamEngine
    params = snn_params_from_numpy(_np_params(CONFIG, dyadic=True))
    tparams = tcn_params_from_numpy(_np_tcn_params(TCN_CONFIG))
    frames = [f for fs in _frames(8, 4, SEED + 9) for f in fs]
    events = [w for ws in _windows(8, 4, SEED + 3) for w in ws]

    fr_eng = StreamEngine(engines=[FrameTCNEngine(tparams, TCN_CONFIG)],
                          config=EngineConfig(max_streams=8,
                                              pipeline_depth=1))
    fr_eng.warmup([(8, 128, 128, 300_000)])
    frame_lane = _rate(
        torch, fr_eng, [fr_eng.open(stream_id=i) for i in range(8)], frames)
    fused, profile = _fused_rates(torch, dev, params, tparams, events,
                                  frames, megastep=False)
    mega, mega_profile = _fused_rates(torch, dev, params, tparams, events,
                                      frames, megastep=True)
    out = dict(frame_lane_B8=frame_lane, fused_B8=fused,
               fused_profile=profile, fused_B8_megastep=mega,
               fused_megastep_profile=mega_profile)
    emit("frame_end_to_end", samples=E2E_SAMPLES, steps_per_sample=E2E_STEPS,
         metric="host clock ending in torch.cuda.synchronize; a fused tick "
                "is one event window and one frame of one session",
         **out)
    return out


# ----------------------------------------------------------------------
# Phase 5 (graphs): captured steps, the megastep, and what they changed.
# ----------------------------------------------------------------------

def _capture_stats(steps):
    """Capture ms, pool bytes and launch tally of each captured step."""
    return {str(k): dict(capture_ms=st.capture_ms, pool_bytes=st.pool_bytes,
                         launch_tally=list(st.tally))
            for k, st in steps.items()}


def _eager_args(engine, batch, state):
    args = engine._mega_args(batch, state)
    return (args[0].to(engine.device), *args[1:])


def graphs_phase(torch, dev, k1, k2, k3, smi, e2e, fe):
    """One CUDA graph per shape key and the cross-wing megastep at full
    width: capture ms and pool bytes per key; replays against eager calls
    of the same run function, bit for bit (the event wing over three
    chained stateful windows at B=8, the frame wing at B=8); 8 stateful
    FusionSessions x 3 ticks through the megastep, pipelined, against the
    megastep off (bit for bit) and the CPU; then the rates and profiles
    of the end-to-end phases side by side."""
    from repro_torch.configs import CONFIG, TCN_CONFIG
    from repro_torch.convert import snn_params_from_numpy, \
        tcn_params_from_numpy
    from repro_torch.core.engine import FrameTCNEngine
    from repro_torch.core.pipeline import BatchedClosedLoop

    params = snn_params_from_numpy(_np_params(CONFIG, dyadic=True))
    tparams = tcn_params_from_numpy(_np_tcn_params(TCN_CONFIG))
    loop = BatchedClosedLoop(params, CONFIG, device=dev)
    loop.warmup([(8, 65_536, 300_000), (1, 65_536, 300_000)])
    fe_eng = FrameTCNEngine(tparams, TCN_CONFIG, device=dev,
                            duration_us=300_000)
    fe_eng.warmup([(8, 128, 128, 300_000)])

    # Replays against eager calls of the same run function.
    streams = _windows(8, 3, SEED + 11)
    state_g, state_e = loop.init_state(8), loop.init_state(8)
    event_equal = []
    for k in range(3):
        batch = loop.prepare([ws[k] for ws in streams], batch_size=8)
        key = loop.shape_key(batch)
        (_, got), state_g = loop.infer_dispatch(batch, state_g)
        want = loop._build_run(key)(_eager_args(loop, batch, state_e))
        state_e = dict(zip(state_g, want[1:]))
        event_equal.append(bool(torch.equal(got, want[0])) and all(
            bool(torch.equal(state_g[n], state_e[n])) for n in state_g))
    fbatch = fe_eng.prepare([fs[0] for fs in _frames(8, 1, SEED + 12)],
                            batch_size=8)
    _, fgot = fe_eng.infer_dispatch(fbatch)
    fwant = fe_eng._build_run()(_eager_args(fe_eng, fbatch, None))
    frame_equal = bool(torch.equal(fgot, fwant[0]))
    check(loop.compiled_shape_keys() == {(8, 65_536, 300_000),
                                         (1, 65_536, 300_000)},
          f"event keys {loop.compiled_shape_keys()}")

    # The megastep: 8 stateful sessions x 3 ticks, pipelined.
    frames = _frames(8, 3, SEED + 13)
    sessions = list(zip(_windows(8, 3, SEED + 14), frames))
    pair = ((8, 65_536, 300_000), (8, 128, 128, 300_000))
    mega = _hetero(params, tparams, dev, megastep=True)
    mega.warmup_megastep([pair])
    torch.cuda.synchronize()
    k1.launches = k2.launches = k3.launches = k2.currents_launches = 0
    on, _ = _serve_fused(mega, sessions, [], stateful=True)
    torch.cuda.synchronize()
    launches = {"lif_scan": k1.launches, "fc_lif_scan": k2.launches,
                "ternary_matmul": k3.launches,
                "fc_currents": k2.currents_launches}
    steps = mega.stats["steps"]
    # 8 sessions over 8 slots a lane: 3 fused dispatches (the pipelined
    # engine's last step() only collects), each one replay of 2 K1, 2 K2,
    # 1 K3 and 1 currents-entry launches.
    check(launches == {"lif_scan": 6, "fc_lif_scan": 6,
                       "ternary_matmul": 3, "fc_currents": 3},
          f"megastep: {launches} launches in {steps} steps, expected 2 K1, "
          f"2 K2, 1 K3 and 1 currents entry a dispatch over 3 dispatches")
    check(mega.compiled_megastep_keys() == {pair}
          and all(e.compiled_shape_keys() == set()
                  for e in mega.engines.values()),
          f"megastep keys {mega.compiled_megastep_keys()}")
    off, _ = _serve_fused(_hetero(params, tparams, dev), sessions, [],
                          stateful=True)
    cpu, _ = _serve_fused(_hetero(params, tparams, "cpu", megastep=True),
                          sessions, [], stateful=True)
    on_vs_off = _compare(on, off)
    on_vs_cpu = _compare(on, cpu)

    def rates(d, key):
        return {k: d[key][k] for k in d[key] if "per_s" in k or "ms" in k}

    def ops(p):
        return {k: p[k] for k in (
            "device_ops_per_step", "device_busy_ms_per_step",
            "device_busy_share_untraced", "host_kernel_launches_per_step",
            "host_graph_launches_per_step", "host_cuda_calls_per_step",
            "top_host_self_ms_per_step")}

    emit("graphs", nvidia_smi=smi,
         captures={"event": _capture_stats(loop._graphs.steps),
                   "frame": _capture_stats(fe_eng._graphs.steps),
                   "megastep": _capture_stats(mega._mega_graphs.steps)},
         replay_vs_eager_bitwise=dict(event_chained_B8=event_equal,
                                      frame_B8=frame_equal),
         megastep=dict(sessions=8, ticks=3, stateful=True, pipeline_depth=1,
                       engine_steps=steps, launches=launches,
                       vs_megastep_off=on_vs_off, vs_cpu=on_vs_cpu),
         rates=dict(event_B1=rates(e2e, "B1"), event_B8=rates(e2e, "B8"),
                    frame_B8=rates(fe, "frame_lane_B8"),
                    fused_B8=rates(fe, "fused_B8"),
                    fused_B8_megastep=rates(fe, "fused_B8_megastep")),
         per_step=dict(event_B8=ops(e2e["profile_B8"]),
                       fused_B8=ops(fe["fused_profile"]),
                       fused_B8_megastep=ops(fe["fused_megastep_profile"])))
    check(all(event_equal) and frame_equal,
          f"replays differ from eager calls: event {event_equal}, frame "
          f"{frame_equal}")
    for what, cmp in (("megastep off", on_vs_off), ("the CPU", on_vs_cpu)):
        check(cmp["label_equal_fraction"] == 1.0, f"vs {what}: {cmp}")
        check(cmp["logits_max_abs_diff"] <= LOGITS_ATOL, f"vs {what}: {cmp}")
        check(cmp["energy_equal_fraction"] == 1.0, f"vs {what}: {cmp}")
        check(cmp["pwm_max_abs_diff"] <= PWM_ATOL, f"vs {what}: {cmp}")
    check(on_vs_off["logits_bitwise_fraction"] == 1.0
          and on_vs_off["pwm_bitwise_fraction"] == 1.0,
          f"megastep on differs from off: {on_vs_off}")


# ----------------------------------------------------------------------
# Phase 6: the serving surface -- checkpoint/restore, lane control, fault
# recovery and deadlines through the engines' graphs.
# ----------------------------------------------------------------------

def _surface_full():
    """What ``serving_surface`` serves at Table II width: the event
    slice's 2**-8 weights, the frame slice's TCN, ~60k-event windows and
    128x128 frames, and the shape keys at b slots."""
    from repro_torch.configs import CONFIG, TCN_CONFIG
    from repro_torch.convert import snn_params_from_numpy, \
        tcn_params_from_numpy
    return dict(cfg=CONFIG, tcfg=TCN_CONFIG,
                params=snn_params_from_numpy(_np_params(CONFIG, dyadic=True)),
                tparams=tcn_params_from_numpy(_np_tcn_params(TCN_CONFIG)),
                windows=_windows, frames=_frames,
                ev_key=lambda b: (b, 65_536, 300_000),
                fr_key=lambda b: (b, 128, 128, 300_000))


def _surface_engine(sf, device, *, lanes=("event", "frame"), wrap=None,
                    slots=8, **config):
    """A StreamEngine as a user builds it, one lane per entry of
    ``lanes`` with ``slots`` slots each, its keys prepared (on the card,
    captured) before serving."""
    from repro_torch.core._api import EngineConfig
    from repro_torch.core.engine import FrameTCNEngine
    from repro_torch.core.pipeline import BatchedClosedLoop
    from repro_torch.serving import StreamEngine
    make = {"event": lambda: BatchedClosedLoop(sf["params"], sf["cfg"],
                                               device=device),
            "frame": lambda: FrameTCNEngine(sf["tparams"], sf["tcfg"],
                                            device=device)}
    engines = [make[m]() for m in lanes]
    if wrap is not None:
        engines = [wrap(e) for e in engines]
    eng = StreamEngine(engines=engines, config=EngineConfig(
        max_streams=slots, duration_us=300_000, **config))
    if config.get("megastep"):
        eng.warmup_megastep([(sf["ev_key"](slots), sf["fr_key"](slots))])
    else:
        for m in lanes:
            eng.warmup([sf["ev_key" if m == "event" else "fr_key"](slots)],
                       modality=m)
    return eng


def _drain(eng, sessions=(), steps=None):
    """Run ``eng`` dry; {(stream or session, seq): StreamResult}, fused
    ticks filed by session. With ``steps``, also fill steps[(stream, seq)]
    with the number of the step() call that returned each window."""
    if steps is None:
        rows = eng.run()
    else:
        rows, n = [], 0
        while eng.pending() or eng.in_flight:
            got = eng.step()
            steps.update({(r.stream_id, r.seq): n for r in got})
            rows.extend(got)
            n += 1
    out = {}
    for s in sessions:
        rows = s.absorb(rows)
        out.update({(r.stream_id, r.seq): r for r in s.drain()})
    out.update({(r.stream_id, r.seq): r for r in rows})
    return out


def _results(rows):
    check(all(r.ok for r in rows.values()),
          f"failed rows: {[k for k, r in rows.items() if not r.ok]}")
    return {k: r.result for k, r in rows.items()}


def _same_bits(cmp):
    return (cmp["label_equal_fraction"] == 1.0
            and cmp["logits_bitwise_fraction"] == 1.0
            and cmp["pwm_bitwise_fraction"] == 1.0
            and cmp["energy_equal_fraction"] == 1.0)


def _surface_migrate(torch, sf, device, depth, n=4, cut=2):
    """(a): 4 stateful event streams and 2 stateful FusionSessions on one
    engine. Windows [0, cut) served, window ``cut`` queued, every stream
    and session checkpointed (through pickle), restored into a fresh
    engine and served on. Returns (rows, checkpoints, host us a stream of
    checkpoint and restore)."""
    import pickle

    from repro_torch.serving import FusionSession
    evs = sf["windows"](6, n, SEED + 20)
    frs = sf["frames"](2, n, SEED + 21)

    def submit(hs, sess, k):
        for i, h in enumerate(hs):
            h.submit(evs[i][k])
        for j, s in enumerate(sess):
            s.submit(evs[4 + j][k], frs[j][k])

    eng_a = _surface_engine(sf, device, pipeline_depth=depth)
    hs = [eng_a.open("event", stream_id=f"e{i}", stateful=True)
          for i in range(4)]
    sess = [FusionSession(eng_a, session_id=f"f{j}", stateful=True)
            for j in range(2)]
    for k in range(cut):
        submit(hs, sess, k)
    rows = _drain(eng_a, sess)
    submit(hs, sess, cut)
    ckpts = pickle.loads(pickle.dumps(
        ({h.stream_id: h.checkpoint() for h in hs},
         {s.session_id: s.checkpoint() for s in sess})))
    eng_b = _surface_engine(sf, device, pipeline_depth=depth)
    hb = [eng_b.restore(ckpts[0][h.stream_id]) for h in hs]
    sb = [FusionSession.restore(eng_b, ckpts[1][s.session_id])
          for s in sess]
    for k in range(cut + 1, n):
        submit(hb, sb, k)
    rows.update(_drain(eng_b, sb))
    # Host time of one stream's checkpoint (its carry a row of the lane's
    # state: one device-to-host copy) and of its restore into a fresh
    # handle (one host-to-device copy a layer), median of 20 each.
    ck_us, rs_us = [], []
    for _ in range(20):
        t0 = time.perf_counter()
        ck = hb[0].checkpoint()
        ck_us.append((time.perf_counter() - t0) * 1e6)
    scratch = _surface_engine(sf, device, lanes=("event",))
    for i in range(20):
        t0 = time.perf_counter()
        scratch.restore(ck, stream_id=f"r{i}")
        if device != "cpu":
            torch.cuda.synchronize()
        rs_us.append((time.perf_counter() - t0) * 1e6)
    return rows, ckpts, dict(
        checkpoint_us_per_stream=statistics.median(ck_us),
        restore_us_per_stream=statistics.median(rs_us),
        carry_bytes_per_stream=sum(a.nbytes for a in ck.state.values()))


def _surface_whole(sf, device, n=4):
    """(a)'s streams and sessions served uninterrupted."""
    from repro_torch.serving import FusionSession
    evs = sf["windows"](6, n, SEED + 20)
    frs = sf["frames"](2, n, SEED + 21)
    eng = _surface_engine(sf, device)
    hs = [eng.open("event", stream_id=f"e{i}", stateful=True)
          for i in range(4)]
    sess = [FusionSession(eng, session_id=f"f{j}", stateful=True)
            for j in range(2)]
    for k in range(n):
        for i, h in enumerate(hs):
            h.submit(evs[i][k])
        for j, s in enumerate(sess):
            s.submit(evs[4 + j][k], frs[j][k])
    return _drain(eng, sess)


def _surface_resize(torch, sf, device, windows, resize=True, cycles=3):
    """(b): 8 stateful streams over 8 slots, resized 8 -> 4 -> 8 between
    steps (pipelined), then ``cycles`` more 4/8 cycles without serving."""
    eng = _surface_engine(sf, device, lanes=("event",), pipeline_depth=1)
    hs = [eng.open(stream_id=f"r{i}", stateful=True) for i in range(8)]
    for k in range(len(windows[0])):
        for h, ws in zip(hs, windows):
            h.submit(ws[k])
    info = {}
    rows = {(r.stream_id, r.seq): r for r in eng.step()}
    if resize:
        loop = eng.loop
        t0 = time.perf_counter()
        evicted = eng.resize_lane(slots=4)
        info["resize_8_to_4_ms"] = (time.perf_counter() - t0) * 1e3
        info["evicted"] = evicted
        info["keys_after_shrink"] = sorted(loop.compiled_shape_keys())
        check(sf["ev_key"](4) in loop.compiled_shape_keys(),
              f"resize_lane did not prepare {sf['ev_key'](4)}: "
              f"{loop.compiled_shape_keys()}")
        for _ in range(2):
            rows.update({(r.stream_id, r.seq): r for r in eng.step()})
        eng.resize_lane(slots=8)
    rows.update(_drain(eng))
    if resize and device != "cpu":
        steps = loop._graphs.steps
        info["capture_ms"] = {str(k): st.capture_ms
                              for k, st in steps.items()}
        torch.cuda.synchronize()
        info["reserved_bytes_after_first_cycle"] = \
            torch.cuda.memory_reserved()
        for _ in range(cycles):
            eng.resize_lane(slots=4)
            eng.resize_lane(slots=8)
        torch.cuda.synchronize()
        info["reserved_bytes_after_cycles"] = torch.cuda.memory_reserved()
        info["graph_keys_after_cycles"] = len(steps)
        info["pool_bytes_after_cycles"] = sum(st.pool_bytes
                                              for st in steps.values())
        check(len(steps) == 2 and info["reserved_bytes_after_cycles"]
              <= info["reserved_bytes_after_first_cycle"],
              f"resize cycles grew the graphs: {info}")
    return rows, info


def _tensors(tree):
    """The tensors of a tree of tuples, lists and dicts."""
    if hasattr(tree, "untyped_storage"):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    return [t for sub in tree for t in _tensors(sub)]


def _forbidden_storages(engine):
    """Storages of a card engine's graphs (static inputs, outputs, the flat
    output buffer) and its pinned staging buffers."""
    ptrs = set()
    for st in engine._graphs.steps.values():
        for t in _tensors((st.inputs, st.outputs, st.flat)):
            ptrs.add(t.untyped_storage().data_ptr())
    for stage in engine._graphs._staging.values():
        ptrs.update(b.untyped_storage().data_ptr() for b in stage._bufs)
    return ptrs


def _carries_before(lane):
    """Clones of the carry each stateful stream of ``lane`` would be
    dispatched from now: its row of the lane's state, else its parked
    carry, else the zero state (as ``_lane_state_in`` picks them)."""
    from repro_torch.serving.stream import _FREE
    if lane.state is None:
        zero = lane.engine.init_state(1)
        return {sid: {k: a[0].clone() for k, a in zero.items()}
                for sid in lane.stateful}
    pos = {o: j for j, o in enumerate(lane.state_streams) if o is not _FREE}
    out = {}
    for sid in lane.stateful:
        if sid in pos:
            src = {k: a[pos[sid]] for k, a in lane.state.items()}
        else:
            src = lane.parked.get(sid) or {
                k: a[0] for k, a in lane.zero_state.items()}
        out[sid] = {k: t.clone() for k, t in src.items()}
    return out


def _surface_fault(torch, sf, device, windows, fault, skip=None):
    """(c): 8 stateful streams (pipelined, recovery on, engine wrapped by a
    FaultInjector), a scripted ``fault`` ("error" or "nan") armed after
    the first step; ``skip`` = (stream, window index) leaves one window
    out (the clean run without a quarantined window). Returns (rows, per
    step() wall ms, fault log, dead letters, rollback carries checked)."""
    from repro_torch.core._api import RecoveryConfig
    from repro_torch.fleet import FaultInjector
    inj = FaultInjector()
    eng = _surface_engine(sf, device, lanes=("event",), wrap=inj.wrap,
                          pipeline_depth=1,
                          recovery=RecoveryConfig(backoff_steps=0))
    hs = [eng.open(stream_id=f"q{i}", stateful=True) for i in range(8)]
    for k in range(len(windows[0])):
        for i, (h, ws) in enumerate(zip(hs, windows)):
            if skip != (i, k):
                h.submit(ws[k])
    lane = eng._lanes["event"]
    step_ms, rows, held, seen = [], {}, [], set()
    while eng.pending() or eng.in_flight:
        before = _carries_before(lane)
        t0 = time.perf_counter()
        got = eng.step()
        if device != "cpu":
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        rows.update({(r.stream_id, r.seq): r for r in got})
        if len(step_ms) == 1 and fault:
            inj.fail_next(kind=fault)
        # Every rollback carry this step dispatched: none may lie in a
        # graph's or a staging buffer's memory, and each must still hold
        # the carry cloned before the step (the replay that read it wrote
        # nothing into it) when the run is over.
        bad = (_forbidden_storages(eng.engines["event"])
               if device != "cpu" else set())
        for step_recs in eng._inflight:
            for rec in step_recs:
                if id(rec) in seen:
                    continue
                seen.add(id(rec))
                for sid, carry in (rec.prev_carry or {}).items():
                    for k, t in carry.items():
                        check(t.untyped_storage().data_ptr() not in bad,
                              "a rollback carry aliases graph or "
                              "staging memory")
                        held.append((t, before[sid][k]))
    changed = sum(not torch.equal(t, c) for t, c in held)
    check(changed == 0, f"{changed} rollback carries differ from the "
          f"carries cloned before their dispatch")
    return (rows, step_ms, list(eng.fault_log),
            [(d.stream_id, d.seq) for d in eng.dead_letters()], len(held))


def _surface_mega_fault(sf, device, fault):
    """(c) under the megastep: 4 stateful sessions (sync, recovery on, both
    engines wrapped), one scripted step fault on the event wing before the
    first step."""
    from repro_torch.core._api import RecoveryConfig
    from repro_torch.fleet import FaultInjector
    from repro_torch.serving import FusionSession
    evs = sf["windows"](4, 2, SEED + 30)
    frs = sf["frames"](4, 2, SEED + 31)
    inj = FaultInjector()
    eng = _surface_engine(sf, device, wrap=inj.wrap, megastep=True,
                          recovery=RecoveryConfig(backoff_steps=0))
    sess = [FusionSession(eng, session_id=f"m{j}", stateful=True)
            for j in range(4)]
    for k in range(2):
        for j, s in enumerate(sess):
            s.submit(evs[j][k], frs[j][k])
    if fault:
        inj.fail_next("event", kind="error")
    rows = _drain(eng, sess)
    return rows, list(eng.fault_log), {
        m: sorted(e.compiled_shape_keys()) for m, e in eng.engines.items()}


def _surface_replace(torch, sf, device, abort=True, n=4):
    """(d): 4 stateful event streams and 4 frame streams under the
    megastep, pipelined; after two windows the event streams are
    checkpointed, window 2 is dispatched, the event lane is aborted with
    it in flight, a rebuilt engine installed, the checkpoints restored
    into fresh handles, and the rest served."""
    from repro_torch.core.pipeline import BatchedClosedLoop
    evs = sf["windows"](4, n, SEED + 40)
    frs = sf["frames"](4, n, SEED + 41)
    eng = _surface_engine(sf, device, megastep=True, pipeline_depth=1)
    hs = [eng.open("event", stream_id=f"d{i}", stateful=True)
          for i in range(4)]
    cams = [eng.open("frame", stream_id=f"c{i}") for i in range(4)]

    def submit(hs, k):
        for i, h in enumerate(hs):
            h.submit(evs[i][k])
        for i, c in enumerate(cams):
            c.submit(frs[i][k])

    info = {}
    for k in range(2):
        submit(hs, k)
    rows = _drain(eng)
    if not abort:
        for k in range(2, n):
            submit(hs, k)
        rows.update(_drain(eng))
        return rows, info
    ckpts = {h.stream_id: h.checkpoint() for h in hs}
    submit(hs, 2)
    rows.update({(r.stream_id, r.seq): r for r in eng.step()})
    info["requeued"] = eng.abort_lane("event")
    info["megastep_keys_before"] = len(eng.compiled_megastep_keys())
    if device != "cpu":
        gc.collect()
        torch.cuda.synchronize()
        info["allocated_bytes_before_replace"] = \
            torch.cuda.memory_allocated()
    new = BatchedClosedLoop(sf["params"], sf["cfg"], device=device)
    eng.replace_lane_engine("event", engine=new)
    if device != "cpu":
        gc.collect()
        info["allocated_bytes_after_replace"] = \
            torch.cuda.memory_allocated()
        info["new_engine_param_bytes"] = sum(
            t.nbytes for layer in new.params.values()
            for t in layer.values())
    del new
    info["megastep_keys_after"] = len(eng.compiled_megastep_keys())
    for h in hs:
        h.close()
        r = eng.restore(ckpts[h.stream_id])
        for k in range(2, n):
            r.submit(evs[int(h.stream_id[1:])][k])
    for i, c in enumerate(cams):
        c.submit(frs[i][3])
    rows.update(_drain(eng))
    info["megastep_keys_at_end"] = len(eng.compiled_megastep_keys())
    return rows, info


def _surface_deadline(sf, device, policy, ticks=3):
    """(e): 8 fused sessions with deadlines 7..0 (the last opened most
    urgent) and, on each lane, 4 more urgent stand-alone streams, over
    8 + 8 slots (pipelined): the sessions contend for 4 slots a lane, and
    DeadlinePolicy seats them in the reverse of FairQuantumPolicy's
    order. Returns (rows, the least paired-tick rate of a session wing,
    {(stream, seq): number of the step() call that returned it}); at
    depth 1 a window returns one call after its dispatch, so the calls
    order the dispatches."""
    from repro_torch.serving import FusionSession
    evs = sf["windows"](12, ticks, SEED + 50)
    frs = sf["frames"](12, ticks, SEED + 51)
    eng = _surface_engine(sf, device, pipeline_depth=1, policy=policy)
    sess = [FusionSession(eng, session_id=f"s{j}", stateful=True,
                          deadline=float(7 - j)) for j in range(8)]
    solo = [(eng.open("event", stream_id=f"ue{i}", deadline=-1.0),
             eng.open("frame", stream_id=f"uf{i}", deadline=-1.0))
            for i in range(4)]
    for k in range(ticks):
        for i, (he, hf) in enumerate(solo):
            he.submit(evs[8 + i][k])
            hf.submit(frs[8 + i][k])
        for j, s in enumerate(sess):
            s.submit(evs[j][k], frs[j][k])
    steps = {}
    rows = _drain(eng, sess, steps)
    paired = min(eng.stream_stats[f"s{j}:{m}"].paired_tick_rate
                 for j in range(8) for m in ("event", "frame"))
    return rows, paired, steps


def serving_surface(torch, dev, k1, k2, k3, smi):
    """The serving surface at Table II width (8 + 8 slots, graphs on),
    gated bit for bit: (a) checkpoint -> restore into a fresh engine ->
    continue equals the uninterrupted run (4 stateful streams and 2
    FusionSessions, depths 0 and 1); (b) resize_lane 8 -> 4 -> 8
    mid-stream equals it, the new key prepared inside resize_lane and
    repeated cycles adding no graph; (c) a scripted step fault under
    recovery equals the clean run after the retry, a NaN-poisoned window
    is quarantined and its stream equals the clean run without it (both
    pipelined, rollback carries held apart from graph memory), and a
    fault in a synchronous fused megastep falls back to the per-lane
    graphs; (d) abort_lane + replace_lane_engine + restore equals the
    uninterrupted run and drops the megastep's graphs; (e) DeadlinePolicy
    over 8 fused sessions gives FairQuantumPolicy's bits with the pairing
    kept, and serves the urgent streams and the last-opened sessions
    first where the fair run serves the first-opened ones first; (f) the card equals the port's CPU run for (a). Reported: host
    us a stream of checkpoint and restore, capture ms and pool bytes
    after the resize cycles, memory allocated around
    replace_lane_engine, and the ms of a retried step."""
    from repro_torch.serving import DeadlinePolicy, FairQuantumPolicy
    sf = _surface_full()
    on_card = dev != "cpu" and torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    k1.launches = k2.launches = k3.launches = k2.currents_launches = 0
    t_phase = time.perf_counter()
    gates, report = {}, {"nvidia_smi": smi}

    # (a) and (f).
    whole = _results(_surface_whole(sf, dev))
    migrated = {}
    for depth in (0, 1):
        rows, ckpts, times = _surface_migrate(torch, sf, dev, depth)
        migrated[depth] = (_results(rows), ckpts)
        gates[f"a_restore_vs_uninterrupted_depth{depth}"] = _same_bits(
            _compare(whole, migrated[depth][0]))
        if depth == 0:
            report["checkpoint_restore"] = times
    cpu_rows, cpu_ckpts, _ = _surface_migrate(torch, sf, "cpu", 0)
    vs_cpu = _compare(migrated[0][0], _results(cpu_rows))
    carries_equal = all(
        np.array_equal(migrated[0][1][0][sid].state[k],
                       cpu_ckpts[0][sid].state[k])
        for sid in cpu_ckpts[0] for k in cpu_ckpts[0][sid].state)
    gates["f_card_vs_cpu"] = (
        vs_cpu["label_equal_fraction"] == 1.0
        and vs_cpu["logits_max_abs_diff"] <= LOGITS_ATOL
        and vs_cpu["energy_equal_fraction"] == 1.0
        and vs_cpu["pwm_max_abs_diff"] <= PWM_ATOL and carries_equal)
    report["a_vs_cpu"] = vs_cpu

    # (b).
    rwin = sf["windows"](8, 4, SEED + 22)
    resized, rinfo = _surface_resize(torch, sf, dev, rwin)
    plain, _ = _surface_resize(torch, sf, dev, rwin, resize=False)
    gates["b_resize_vs_uninterrupted"] = (
        rinfo["evicted"] == ["r4", "r5", "r6", "r7"]
        and _same_bits(_compare(_results(plain), _results(resized))))
    report["resize"] = rinfo

    # (c).
    fwin = sf["windows"](8, 3, SEED + 23)
    clean, clean_ms, _, _, _ = _surface_fault(torch, sf, dev, fwin, None)
    clean = _results(clean)
    retried, retry_ms, log, _, _ = _surface_fault(torch, sf, dev, fwin,
                                                  "error")
    at = next(f["step"] for f in log if f["kind"] == "retry")
    gates["c_retry_vs_clean"] = (
        sum(f["kind"] == "retry" for f in log) == 8
        and _same_bits(_compare(clean, _results(retried))))
    report["retry"] = dict(
        step_ms=retry_ms, failed_collect_step=at,
        failed_step_ms=retry_ms[at], retried_step_ms=retry_ms[at + 1],
        clean_step_ms=clean_ms,
        fault_kinds=[f["kind"] for f in log])
    poisoned, _, plog, letters, n_held = _surface_fault(
        torch, sf, dev, fwin, "nan")
    (sid, seq), = letters
    i = int(sid[1:])
    no_window, _, _, _, _ = _surface_fault(torch, sf, dev, fwin, None,
                                           skip=(i, seq))
    survivors = {k: r for k, r in poisoned.items() if r.ok}
    mine = sorted((k for k in survivors if k[0] == sid),
                  key=lambda k: k[1])
    want = sorted((k for k in no_window if k[0] == sid), key=lambda k: k[1])
    others = {k: r.result for k, r in survivors.items() if k[0] != sid}
    gates["c_quarantine_vs_clean_without_window"] = (
        poisoned[(sid, seq)].status == "failed"
        and len(mine) == len(want) == len(fwin[i]) - 1
        and _same_bits(_compare({k: survivors[k].result for k in mine},
                              {m: no_window[w].result
                               for m, w in zip(mine, want)}))
        and _same_bits(_compare(others, {k: clean[k] for k in others})))
    report["quarantine"] = dict(
        dead_letter=[sid, seq],
        fault_kinds=[f["kind"] for f in plog],
        rollback_carries_checked=n_held)
    mclean, _, _ = _surface_mega_fault(sf, dev, False)
    mrows, mlog, mkeys = _surface_mega_fault(sf, dev, True)
    gates["c_megastep_fault_vs_clean"] = (
        mlog == [] and all(mkeys.values())
        and _same_bits(_compare(_results(mclean), _results(mrows))))
    report["megastep_fault"] = dict(
        fault_log=mlog, per_lane_keys_after_fallback={
            m: [list(k) for k in v] for m, v in mkeys.items()})

    # (d).
    replaced, dinfo = _surface_replace(torch, sf, dev)
    unbroken, _ = _surface_replace(torch, sf, dev, abort=False)
    gates["d_replace_vs_uninterrupted"] = (
        dinfo["requeued"] == 4 and dinfo["megastep_keys_before"] == 1
        and dinfo["megastep_keys_after"] == 0
        and _same_bits(_compare(_results(unbroken), _results(replaced))))
    if on_card:
        gates["d_memory_falls"] = (dinfo["allocated_bytes_after_replace"]
                                   < dinfo["allocated_bytes_before_replace"])
    report["replace"] = dinfo

    # (e).
    edf, paired, edf_at = _surface_deadline(sf, dev, DeadlinePolicy())
    fair, _, fair_at = _surface_deadline(sf, dev, FairQuantumPolicy())
    gates["e_deadline_vs_fair"] = (
        paired == 1.0 and _same_bits(_compare(_results(fair), _results(edf))))
    # Which step() returned each window, by group: the stand-alone urgent
    # streams, the sessions opened last (deadlines 3..0) and first (7..4).
    # EDF serves the urgent streams and the last-opened sessions before
    # any window of the first-opened ones; the fair run does the reverse
    # for the sessions.
    groups = {"urgent": lambda s: s[0] == "u",
              "last_opened": lambda s: s[0] == "s" and int(s[1]) >= 4,
              "first_opened": lambda s: s[0] == "s" and int(s[1]) < 4}
    at = {run: {g: sorted(n for (sid, _), n in steps.items() if f(sid))
                for g, f in groups.items()}
          for run, steps in (("deadline", edf_at), ("fair", fair_at))}
    gates["e_deadline_order_vs_fair"] = (
        max(at["deadline"]["urgent"] + at["deadline"]["last_opened"])
        < min(at["deadline"]["first_opened"])
        and max(at["fair"]["first_opened"]) < min(at["fair"]["last_opened"]))
    report["deadline_paired_tick_rate_min"] = paired
    report["deadline_return_steps"] = at

    if on_card:
        torch.cuda.synchronize()
    launches = {"lif_scan": k1.launches, "fc_lif_scan": k2.launches,
                "ternary_matmul": k3.launches,
                "fc_currents": k2.currents_launches}
    emit("serving_surface", config="CONFIG + TCN_CONFIG (full width)",
         slots={"event": 8, "frame": 8},
         launches=launches, gates=gates,
         phase_s=time.perf_counter() - t_phase, **report)
    if on_card:
        check(all(n > 0 for n in launches.values()),
              f"serving_surface: a kernel of the path never ran: "
              f"{launches}")
    failed = [g for g, ok in gates.items() if not ok]
    check(not failed, f"serving_surface gates failed: {failed}")
    return launches


# ----------------------------------------------------------------------
# Phase 7: the fleet control plane -- live migration, rebalancing,
# autoscaling and supervised recovery, driving the engines' graphs.
# ----------------------------------------------------------------------

def _event_engine(sf, device, slots, depth=0, **config):
    """A one-lane event engine of ``slots`` slots, its key captured."""
    return _surface_engine(sf, device, lanes=("event",), slots=slots,
                           pipeline_depth=depth, **config)


def _fleet_rows(rows):
    """{(stream, seq): StreamResult} of a list of rows; a (stream, seq)
    reported twice fails the run."""
    out = {}
    for r in rows:
        check((r.stream_id, r.seq) not in out,
              f"({r.stream_id!r}, {r.seq}) reported twice")
        out[(r.stream_id, r.seq)] = r
    return out


def _fleet_diff(want, got):
    """What differs between two {(stream, seq): result} maps: missing and
    extra keys, ``_compare`` over the common ones, and up to 8 windows
    whose label, logits, PWM or energy differ."""
    common = sorted(set(want) & set(got))
    bad = []
    for k in common:
        fields = [f for f in ("label_pred", "logits", "pwm")
                  if not np.array_equal(getattr(want[k], f),
                                        getattr(got[k], f))]
        if want[k].energy_mj != got[k].energy_mj:
            fields.append("energy_mj")
        if fields:
            bad.append([str(k[0]), int(k[1]), fields])
    return dict(missing=len(set(want) - set(got)),
                extra=len(set(got) - set(want)),
                compare=_compare({k: want[k] for k in common},
                                 {k: got[k] for k in common})
                if common else None,
                differing=len(bad), first_differing=bad[:8])


def _bits_equal(want, got):
    """Two {(stream, seq): result} maps hold the same windows, bit for
    bit (labels, logits, PWM, energy)."""
    d = _fleet_diff(want, got)
    return d["missing"] == d["extra"] == d["differing"] == 0


def _fleet_alone(sf, device, streams, slots=2):
    """The uninterrupted run: every stream of ``streams`` ({id: windows})
    opened stateful on one engine and served to the end."""
    eng = _event_engine(sf, device, slots)
    for sid, ws in streams.items():
        h = eng.open(stream_id=sid, stateful=True)
        for w in ws:
            h.submit(w)
    return _results(_drain(eng))


def _fleet_migrate(sf, device, depth, n=4):
    """(a): streams "mig" and "stay" (stateful) on a 2-slot hot engine;
    two steps served, then "mig" moved to a 4-slot cold engine through a
    CheckpointStore (at depth 1 with its next window in flight), and both
    engines run dry. Returns ({origin: rows}, the streams' windows, the
    record's migration_ms)."""
    from repro_torch.fleet import CheckpointStore, migrate_stream
    streams = dict(zip(("mig", "stay"), sf["windows"](2, n, SEED + 60)))
    hot = _event_engine(sf, device, 2, depth)
    cold = _event_engine(sf, device, 4, depth)
    hs = {sid: hot.open(stream_id=sid, stateful=True) for sid in streams}
    for k in range(n):
        for sid, ws in streams.items():
            hs[sid].submit(ws[k])
    before = hot.step() + hot.step()
    record = migrate_stream(hs["mig"], cold, store=CheckpointStore())
    rows = dict(before=before, displaced=list(record.displaced),
                hot_after=hot.run(), cold=cold.run())
    return {k: _fleet_rows(v) for k, v in rows.items()}, streams, \
        record.migration_ms


def _timed_move(torch, handle, target, store, on_card):
    """migrate_stream's steps one by one, each timed on the host (the
    restore until its copies have run): ms of drain, checkpoint (with
    the source's close), store put, restore, total; the new handle and
    the displaced rows."""
    t = [time.perf_counter()]
    displaced = handle.engine.drain_lane(handle.modality)
    t.append(time.perf_counter())
    ckpt = handle.checkpoint()
    handle.close()
    t.append(time.perf_counter())
    cid = store.put(ckpt)
    t.append(time.perf_counter())
    blob_bytes = len(store._blobs[cid])
    new = store.restore_into(target, cid)
    if on_card:
        torch.cuda.synchronize()
    t.append(time.perf_counter())
    ms = dict(zip(("drain", "checkpoint", "put", "restore"),
                  (float(x) * 1e3 for x in np.diff(t))))
    ms["total"] = (t[-1] - t[0]) * 1e3
    ms["blob_bytes"] = blob_bytes
    return new, displaced, ms


def _fleet_pingpong(torch, sf, device, depth, on_card, reps=10):
    """One stateful stream moved back and forth between a 2-slot and a
    4-slot engine ``reps`` times, one step served on the source before
    each move (at depth 1 still in flight when the move starts). Returns
    (rows, the stream's windows, ms of each move by part)."""
    from repro_torch.fleet import CheckpointStore
    ws = sf["windows"](1, 2 * reps + 2, SEED + 61)[0]
    src = _event_engine(sf, device, 2, depth)
    dst = _event_engine(sf, device, 4, depth)
    store = CheckpointStore()
    h = src.open(stream_id="pp", stateful=True)
    rows, moves = [], []
    for i in range(reps):
        h.submit(ws[2 * i])
        h.submit(ws[2 * i + 1])
        rows += src.step()
        h, displaced, ms = _timed_move(torch, h, dst, store, on_card)
        rows += displaced
        ms["displaced"] = len(displaced)
        moves.append(ms)
        src, dst = dst, src
    for w in ws[2 * reps:]:
        h.submit(w)
    rows += src.run() + dst.run()
    return _fleet_rows(rows), {"pp": ws}, moves


def _fleet_soak(torch, sf, device, depth, rebalance, on_card, n_win=6):
    """(b): ``tests/test_fleet_soak.py`` at full width. A 2-slot hot engine
    holds 4 deadlined stateful streams with every window queued up front,
    plus ephemeral churn on both engines; a 4-slot cold engine idles;
    both read the serving loop's tick as their deadline clock. Returns a dict:
    the persistent streams' rows and windows, the fleet's deadline-miss
    rate, ms of each migration, host us of each observe() that moved
    nothing, telemetry reads that synchronized, rounds."""
    from repro_torch.fleet import (CheckpointStore, FleetConfig,
                                   FleetRebalancer)
    from repro_torch.serving import DeadlinePolicy
    persistent = dict(zip((f"p{i}" for i in range(4)),
                          sf["windows"](4, n_win, SEED + 62)))
    hot, cold = (_event_engine(sf, device, b, depth,
                               policy=DeadlinePolicy(fair_quantum=2))
                 for b in (2, 4))
    tick = [0]
    for eng in (hot, cold):
        eng.deadline_clock = lambda: float(tick[0])
    for sid, ws in persistent.items():
        h = hot.open(stream_id=sid, stateful=True)
        for k, w in enumerate(ws):
            h.submit(w, deadline=3.0 + 1.2 * k)
    reb = FleetRebalancer(
        {"hot": hot, "cold": cold}, store=CheckpointStore(),
        config=FleetConfig(imbalance=1.0, cooldown=1, miss_weight=10.0),
    ) if rebalance else None
    churn = sf["windows"](4, 1, SEED + 63)
    rows, ephemerals, n_eph, rounds, hold_us, syncs = [], {}, 0, 0, [], 0
    while (hot.pending() or cold.pending() or hot.in_flight
           or cold.in_flight or ephemerals):
        rounds += 1
        check(rounds < 300, "fleet soak failed to drain")
        rows += hot.step() + cold.step()
        tick[0] += 1
        if rounds % 2 == 1 and rounds < 20:
            for eng, slack in ((hot, 50.0), (cold, 2.0)):
                eph = eng.open(stream_id=f"e{n_eph}")
                eph.submit(churn[n_eph % len(churn)][0],
                           deadline=tick[0] + slack)
                ephemerals[f"e{n_eph}"] = eph
                n_eph += 1
        for sid in [s for s in ephemerals
                    if any(r.stream_id == s for r in rows)]:
            ephemerals.pop(sid).close()
        if reb is None:
            continue
        if on_card:
            # A telemetry read must not wait for the device: in "error"
            # mode torch raises on any synchronizing call.
            torch.cuda.set_sync_debug_mode("error")
            try:
                reb.loads()
            except RuntimeError:
                syncs += 1
            finally:
                torch.cuda.set_sync_debug_mode(0)
        t0 = time.perf_counter()
        report = reb.observe()
        if not report.migrated:
            hold_us.append((time.perf_counter() - t0) * 1e6)
        rows += report.displaced
    dated = missed = 0
    for eng in (hot, cold):
        for st in eng.stream_stats.values():
            dated += st.deadline_windows
            missed += st.deadline_missed
    mine = _fleet_rows([r for r in rows if r.stream_id in persistent])
    return dict(rows=mine, streams=persistent, miss_rate=missed / dated,
                migrations=[m.migration_ms for m in reb.migrations]
                if reb else [], observe_us=hold_us, syncs=syncs,
                rounds=rounds)


def _fleet_autoscale(torch, sf, device, on_card, cycles=3, n_streams=16,
                     n_win=4):
    """(c): a pipelined event lane of 2 slots under a LaneAutoscaler
    (FleetConfig(min_slots=2, max_slots=16)). Each cycle opens
    ``n_streams`` stateful streams with every window queued (the backlog
    grows the lane 2 -> 4 -> 8 -> 16), serves them, closes them, and
    idles until the lane is back at 2 slots. Returns (rows, windows, one
    dict a cycle: decisions, ms of each resize_lane, host us of the
    holding observe() calls, graph keys, reserved bytes)."""
    from repro_torch.fleet import FleetConfig, LaneAutoscaler
    gc.collect()                     # earlier gates' dead engines
    eng = _event_engine(sf, device, 2, depth=1)
    loop = eng.loop
    asc = LaneAutoscaler(eng, config=FleetConfig(min_slots=2, max_slots=16))
    resize_ms = []
    resize_lane = eng.resize_lane

    def timed_resize(*args, **kw):
        t0 = time.perf_counter()
        out = resize_lane(*args, **kw)
        resize_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    eng.resize_lane = timed_resize
    rows, streams, info = [], {}, []
    for c in range(cycles):
        ws = sf["windows"](n_streams, n_win, SEED + 64 + c)
        hs = []
        for i, w in enumerate(ws):
            hs.append(eng.open(stream_id=f"c{c}s{i}", stateful=True))
            streams[hs[-1].stream_id] = w
        for k in range(n_win):
            for h, w in zip(hs, ws):
                h.submit(w[k])
        decisions, hold_us, idle = [], [], 0
        del resize_ms[:]
        while eng.pending() or eng.in_flight or eng.telemetry().slots > 2:
            idle += not (eng.pending() or eng.in_flight)
            check(idle < 40, "the autoscaler did not shrink the lane")
            rows += eng.step()
            if not (eng.pending() or eng.in_flight):
                for h in hs:
                    h.close()
                hs = []
            t0 = time.perf_counter()
            d = asc.observe()
            if not d.resized:
                hold_us.append((time.perf_counter() - t0) * 1e6)
            decisions.append(d)
        entry = dict(
            decisions=[(d.action, d.old_slots, d.new_slots, list(d.evicted))
                       for d in decisions if d.resized],
            resize_ms=list(resize_ms), observe_us=hold_us,
            keys=sorted(loop.compiled_shape_keys()))
        if on_card:
            torch.cuda.synchronize()
            steps = loop._graphs.steps
            entry["graphs"] = len(steps)
            entry["allocated_bytes"] = torch.cuda.memory_allocated()
            entry["reserved_bytes"] = torch.cuda.memory_reserved()
            # What the lane holds, without the blocks the allocator keeps
            # cached for reuse (graph pools are never released here).
            torch.cuda.empty_cache()
            entry["reserved_bytes_held"] = torch.cuda.memory_reserved()
            entry["capture_ms"] = {str(k): st.capture_ms
                                   for k, st in steps.items()}
            entry["pool_bytes"] = {str(k): st.pool_bytes
                                   for k, st in steps.items()}
        info.append(entry)
    return _fleet_rows(rows), streams, info


def _fleet_supervised(torch, sf, device, on_card, kills=(2, 5, 8), n=11):
    """(d): a two-lane engine (4 event + 4 frame slots, recovery on,
    both engines wrapped by a FaultInjector): 4 stateful event streams
    under a LaneSupervisor that checkpoints every 2 ticks, 2 frame
    streams beside them. The event lane is killed at each tick of
    ``kills`` and revived after the next; the supervisor rebuilds the
    lane (a fresh engine, captured at its first dispatch), restores and
    replays. Returns the rows, the windows and what was measured."""
    from repro_torch.core._api import RecoveryConfig
    from repro_torch.core.pipeline import BatchedClosedLoop
    from repro_torch.fleet import (CheckpointStore, FaultInjector,
                                   LaneSupervisor)
    evs = sf["windows"](4, n, SEED + 66)
    frs = sf["frames"](2, n, SEED + 67)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    # Dead engines of the earlier gates are cyclic garbage: free them, so
    # that the readings below see only what the rebuilds leave.
    gc.collect()
    inj = FaultInjector()
    eng = _surface_engine(sf, device, wrap=inj.wrap, slots=4,
                          recovery=RecoveryConfig(
                              max_retries=0, backoff_steps=0, dead_after=1,
                              checkpoint_every=2))
    calls = []                       # (name, start, ms) of each timed call

    def timed(name, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            sync()
            calls.append((name, t0, (time.perf_counter() - t0) * 1e3))
            return out
        return call

    def rebuild(modality):
        return inj.wrap(BatchedClosedLoop(sf["params"], sf["cfg"],
                                          device=device))

    store = CheckpointStore(capacity=8)
    sup = LaneSupervisor(eng, store=store,
                         rebuild=timed("rebuild", rebuild))
    # Each step of a recovery, timed where the supervisor calls it; the
    # replay is what the recovery took besides them.
    eng.abort_lane = timed("abort", eng.abort_lane)
    eng.replace_lane_engine = timed("replace", eng.replace_lane_engine)
    store.restore_into = timed("restore", store.restore_into)
    sup.checkpoint_now = timed("checkpoint", sup.checkpoint_now)
    sup.recover = timed("recover", sup.recover)
    hs = [sup.watch(eng.open("event", stream_id=f"v{i}", stateful=True))
          for i in range(4)]
    cams = [eng.open("frame", stream_id=f"w{i}") for i in range(2)]
    rows, recoveries, memory, ok_ticks = [], [], [], []
    for k in range(n):
        for i, h in enumerate(hs):
            sup.submit(h.stream_id, evs[i][k])
        for i, c in enumerate(cams):
            c.submit(frs[i][k])
        if k in kills:
            inj.kill("event")
        t0 = time.perf_counter()
        got = eng.step()
        sync()
        if recoveries and "first_step_ms" not in recoveries[-1]:
            # The rebuilt engine's first dispatch: its graph's capture.
            recoveries[-1]["first_step_ms"] = \
                (time.perf_counter() - t0) * 1e3
            if on_card:
                recoveries[-1]["capture_ms"] = [
                    st.capture_ms for st in
                    eng.engines["event"].inner._graphs.steps.values()]
        start = len(calls)
        out = sup.tick(got)
        rows += out
        if any(r.ok and r.stream_id.startswith("v") for r in out):
            ok_ticks.append(k)
        for name, t_rec, ms in calls[start:]:
            if name != "recover":
                continue
            inside = [(c, m) for c, t, m in calls[start:]
                      if c != "recover" and t_rec <= t <= t_rec + ms / 1e3]
            r = {c: sum(m for x, m in inside if x == c)
                 for c in ("abort", "replace", "rebuild", "restore",
                           "checkpoint")}
            r["recover"] = ms
            r["restores"] = sum(c == "restore" for c, _ in inside)
            r["replay"] = ms - sum(m for _, m in inside)
            r["tick"] = k
            recoveries.append(r)
        if k - 1 in kills:
            inj.revive("event")
        if on_card and k - 2 in kills:
            # The lane has served a step on its last rebuilt engine: the
            # engines it replaced must be gone (no gc pass forced). The
            # device tensors Python still holds are counted beside it.
            sync()
            with warnings.catch_warnings():
                # isinstance() on every object wakes deprecated aliases.
                warnings.simplefilter("ignore")
                live = [o for o in gc.get_objects()
                        if isinstance(o, torch.Tensor) and o.is_cuda]
            mem = dict(tick=k, allocated=torch.cuda.memory_allocated(),
                       reserved=torch.cuda.memory_reserved(),
                       live_tensors=len(live),
                       live_tensor_bytes=sum(t.untyped_storage().nbytes()
                                             for t in live))
            del live
            gc.collect()
            mem["allocated_after_gc"] = torch.cuda.memory_allocated()
            memory.append(mem)
    for _ in range(8):
        rows += sup.tick(eng.step())
    return dict(rows=rows, evs=evs, frs=frs, recoveries=recoveries,
                memory=memory, stats=dict(sup.stats),
                to_restore=[min(r["tick"] for r in recoveries
                                if r["tick"] >= at) - at for at in kills],
                to_next_ok=[min(t for t in ok_ticks if t > at) - at
                            for at in kills])


def _fleet_unfaulted(sf, device, evs, frs):
    """(d)'s windows served by the same two-lane engine, never faulted."""
    eng = _surface_engine(sf, device, slots=4)
    hs = [eng.open("event", stream_id=f"v{i}", stateful=True)
          for i in range(4)]
    cams = [eng.open("frame", stream_id=f"w{i}") for i in range(2)]
    for k in range(len(evs[0])):
        for i, h in enumerate(hs):
            h.submit(evs[i][k])
        for i, c in enumerate(cams):
            c.submit(frs[i][k])
    return _results(_drain(eng))


def _spread(xs):
    return dict(median=statistics.median(xs), min=min(xs), max=max(xs),
                n=len(xs)) if xs else None


def fleet_phase(torch, dev, k1, k2, k3, smi):
    """The fleet control plane at Table II width, graphs on, every gate
    bit for bit: (a) a live migration through a CheckpointStore from a
    2-slot to a 4-slot engine, at depths 0 and 1: the stream's rows from
    before the move, from the drain and from the cold engine equal one
    uninterrupted run, and so do its lane-mate's; (b) a rebalanced
    two-engine fleet against a static one (tests/test_fleet_soak.py at
    full width): the rebalancer migrates, misses fewer deadlines, and
    every persistent stream equals its uninterrupted run; (c) a
    LaneAutoscaler grows an event lane 2 -> 4 -> 8 -> 16 under backlog
    and shrinks it back when idle, twice: the rows equal the unresized
    run, the graph cache holds exactly the keys visited, and the second
    cycle captures nothing and reserves no more bytes; (d) a
    LaneSupervisor rebuilds a killed event lane three times, each within
    2 ticks: every window reported successful equals the uninterrupted
    run once, the frame lane's rows are unchanged, and memory allocated
    after the third rebuild is within 1 MiB of that after the first.
    Reported: migration ms by part with and without a step in flight,
    each resize's capture ms, resize_lane ms and pool bytes, each
    recovery's ms by part, memory after each kill, observe() host us of
    the autoscaler and the rebalancer, and the kernel launches."""
    sf = _surface_full()
    on_card = dev != "cpu" and torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    k1.launches = k2.launches = k3.launches = k2.currents_launches = 0
    t_phase = time.perf_counter()
    gates, report = {}, {"nvidia_smi": smi}

    # (a).
    moves = {}
    for depth in (0, 1):
        rows, streams, ms = _fleet_migrate(sf, dev, depth)
        whole = _fleet_alone(sf, dev, streams)
        merged = {}
        for part in rows.values():
            merged.update(part)
        mig = {part: sorted(s for (sid, s) in got if sid == "mig")
               for part, got in rows.items()}
        gates[f"a_migration_vs_uninterrupted_depth{depth}"] = (
            len(merged) == sum(len(p) for p in rows.values())
            and _bits_equal(whole, {k: r.result for k, r in merged.items()})
            and bool(mig["before"]) and bool(mig["cold"])
            and bool(mig["displaced"]) == (depth == 1)
            and sorted(mig["before"] + mig["displaced"] + mig["cold"])
            == list(range(4)))
        pp_rows, pp_streams, pp_ms = _fleet_pingpong(torch, sf, dev, depth,
                                                     on_card)
        gates[f"a_repeated_moves_vs_uninterrupted_depth{depth}"] = (
            _bits_equal(_fleet_alone(sf, dev, pp_streams),
                        {k: r.result for k, r in pp_rows.items()})
            and all((m["displaced"] > 0) == (depth == 1) for m in pp_ms))
        moves["in_flight" if depth else "nothing_in_flight"] = dict(
            gate_migration_ms=ms,
            blob_bytes=pp_ms[0]["blob_bytes"],
            **{p: _spread([m[p] for m in pp_ms])
               for p in ("drain", "checkpoint", "put", "restore", "total")})
    report["migration_ms"] = moves

    # (b).
    soak = {}
    for depth in (0, 1):
        static = _fleet_soak(torch, sf, dev, depth, False, on_card)
        moved = _fleet_soak(torch, sf, dev, depth, True, on_card)
        whole = _fleet_alone(sf, dev, static["streams"], slots=4)
        gates[f"b_rebalanced_beats_static_depth{depth}"] = (
            len(moved["migrations"]) >= 1 and moved["syncs"] == 0
            and moved["miss_rate"] < static["miss_rate"]
            and all(_bits_equal(whole, {k: r.result
                                        for k, r in run["rows"].items()})
                    for run in (static, moved)))
        soak[f"depth{depth}"] = dict(
            miss_rate_static=static["miss_rate"],
            miss_rate_rebalanced=moved["miss_rate"],
            migrations=len(moved["migrations"]),
            migration_ms=moved["migrations"],
            rounds_static=static["rounds"], rounds_rebalanced=moved["rounds"],
            observe_us=_spread(moved["observe_us"]),
            telemetry_syncs=moved["syncs"])
    report["rebalance"] = soak

    # (c).
    rows, streams, cycles = _fleet_autoscale(torch, sf, dev, on_card)
    plain = _fleet_alone(sf, dev, streams)
    visited = (2, 4, 8, 16)
    path = ([("grow", a, b, []) for a, b in zip(visited, visited[1:])]
            + [("shrink", b, a, []) for a, b in zip(visited, visited[1:])
               ][::-1])
    keys = set(map(tuple, cycles[0]["keys"]))
    tails = {k[1:] for k in keys}
    served = {k: r.result for k, r in rows.items()}
    gates["c_autoscale_vs_unresized"] = (
        all(c["decisions"] == path for c in cycles)
        and _bits_equal(plain, served)
        and keys == {(b,) + t for b in visited for t in tails}
        and all(set(map(tuple, c["keys"])) == keys for c in cycles))
    if on_card:
        gates["c_later_cycles_capture_nothing"] = all(
            c["graphs"] == len(keys)
            and c["reserved_bytes_held"] <= cycles[0]["reserved_bytes_held"]
            for c in cycles)
    first = {sid: ws for sid, ws in streams.items() if sid.startswith("c0")}
    report["autoscale"] = [dict(c, keys=[list(k) for k in c["keys"]],
                                observe_us=_spread(c["observe_us"]))
                           for c in cycles]
    report["autoscale_vs_unresized"] = _fleet_diff(plain, served)
    # The rows' batch invariance the resizes rest on: the first cycle's
    # streams at each fixed slot count against 2 slots.
    first_rows = {k: v for k, v in plain.items() if k[0] in first}
    fixed = {b: _fleet_alone(sf, dev, first, slots=b) for b in visited[1:]}
    gates["c_fixed_slots_vs_2"] = all(_bits_equal(first_rows, rows)
                                      for rows in fixed.values())
    report["fixed_slots_vs_2"] = {b: _fleet_diff(first_rows, rows)
                                  for b, rows in fixed.items()}

    # (d).
    sv = _fleet_supervised(torch, sf, dev, on_card)
    clean = _fleet_unfaulted(sf, dev, sv["evs"], sv["frs"])
    ok = _fleet_rows([r for r in sv["rows"] if r.ok])
    events = {k: r.result for k, r in ok.items() if k[0].startswith("v")}
    frames = {k: r.result for k, r in ok.items() if k[0].startswith("w")}
    gates["d_supervised_kills_vs_uninterrupted"] = (
        all(t <= 2 for t in sv["to_restore"])
        and _bits_equal({k: v for k, v in clean.items()
                         if k[0].startswith("v")}, events)
        and not any(r.stream_id.startswith("w") and not r.ok
                    for r in sv["rows"])
        and _bits_equal({k: v for k, v in clean.items()
                         if k[0].startswith("w")}, frames))
    if on_card:
        first, last = sv["memory"][0], sv["memory"][-1]
        gates["d_no_leak_across_rebuilds"] = (
            len(sv["memory"]) == 3
            and abs(last["allocated"] - first["allocated"]) <= 1 << 20
            and last["live_tensor_bytes"] <= first["live_tensor_bytes"])
    report["supervisor"] = dict(
        stats=sv["stats"], ticks_kill_to_restore=sv["to_restore"],
        ticks_kill_to_next_ok=sv["to_next_ok"],
        recoveries_ms=sv["recoveries"], memory_after_kills=sv["memory"])

    if on_card:
        torch.cuda.synchronize()
    launches = {"lif_scan": k1.launches, "fc_lif_scan": k2.launches,
                "ternary_matmul": k3.launches,
                "fc_currents": k2.currents_launches}
    # The timing wrappers set on engines above are reference cycles:
    # free those engines' graphs before the next phase.
    gc.collect()
    emit("fleet", config="CONFIG + TCN_CONFIG (full width)",
         launches=launches, gates=gates,
         phase_s=time.perf_counter() - t_phase, **report)
    if on_card:
        check(all(n > 0 for n in launches.values()),
              f"fleet: a kernel of the path never ran: {launches}")
    failed = [g for g, ok in gates.items() if not ok]
    check(not failed, f"fleet gates failed: {failed}")
    return launches


# ----------------------------------------------------------------------
# Phase 7b: slot sharding over a device mesh -- EngineConfig(mesh=...) at
# full width, every row and carry held against the unsharded engine.
# ----------------------------------------------------------------------

SHARD_SLOTS = 8                 # slots a lane, as the event and frame lanes
SHARD_EVENT_STREAMS = 10        # more streams than slots: parking runs
SHARD_FRAME_STREAMS = 10
SHARD_WINDOWS = 2               # windows a stream in the gated runs
SHARD_SESSIONS = 4              # FusionSessions, stateful
SHARD_RATE_WINDOWS = 8          # windows a stream in a timed run
SHARD_RATE_SAMPLES = 3          # timed runs a mesh, in turns with unsharded
SHARD_EVENT_KEY = (SHARD_SLOTS, 65_536, 300_000)
SHARD_FRAME_KEY = (SHARD_SLOTS, 128, 128, 300_000)


def _shard_meshes(torch):
    """The phase's meshes: every visible card when there are 2 or more
    (real placement), else logical meshes of 2 and 4 shards on cuda:0."""
    from repro_torch.distributed import make_mesh
    if torch.cuda.device_count() >= 2:
        return "real", [make_mesh()]
    card = torch.device("cuda", 0)
    return "logical", [make_mesh(n, devices=[card] * n) for n in (2, 4)]


def _shard_engine(params, tparams, dev, mesh, depth, lanes=("event",
                                                             "frame")):
    """A StreamEngine as a user builds it, over the event and/or frame
    lane (8 slots each), sharded over ``mesh`` (None: unsharded)."""
    from repro_torch.configs import CONFIG, TCN_CONFIG
    from repro_torch.core._api import EngineConfig
    from repro_torch.core.engine import FrameTCNEngine
    from repro_torch.core.pipeline import BatchedClosedLoop
    from repro_torch.serving import StreamEngine
    engines = []
    if "event" in lanes:
        engines.append(BatchedClosedLoop(params, CONFIG, device=dev))
    if "frame" in lanes:
        engines.append(FrameTCNEngine(tparams, TCN_CONFIG, device=dev))
    return StreamEngine(engines=engines, config=EngineConfig(
        max_streams=SHARD_SLOTS, pipeline_depth=depth, mesh=mesh))


def _shard_serve(eng, events, frames, stateful):
    """Event streams (every index in ``stateful`` carries state) and frame
    streams, their windows queued up front, served to the end: rows by
    (stream, seq) as (label, pwm, logits), and each stateful stream's
    exported carry."""
    hs = [(eng.open("event", stream_id=f"e{i}", stateful=i in stateful),
           ws) for i, ws in enumerate(events)]
    hs += [(eng.open("frame", stream_id=f"f{i}"), fs)
           for i, fs in enumerate(frames)]
    for k in range(max(len(ws) for _, ws in hs)):
        for h, ws in hs:
            if k < len(ws):
                h.submit(ws[k])
    rows = {(r.stream_id, r.seq): (r.result.label_pred, r.result.pwm,
                                   r.result.logits) for r in eng.run()}
    carries = {h.stream_id: h.checkpoint().state for h, _ in hs
               if h.stateful}
    for h, _ in hs:
        h.close()
    return rows, carries


def _same_rows(want, got):
    """Whether two {key: tuple of arrays} (or {key: {name: array}}) maps
    are equal bit for bit."""
    if set(want) != set(got):
        return False
    for key in want:
        a, b = want[key], got[key]
        if isinstance(a, dict):
            a, b = [a[k] for k in sorted(a)], [b[k] for k in sorted(b)]
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            return False
    return True


def _counts(k1, k2, k3):
    return {"lif_scan": k1.launches, "fc_lif_scan": k2.launches,
            "ternary_matmul": k3.launches,
            "fc_currents": k2.currents_launches}


def _zero_counts(k1, k2, k3):
    k1.launches = k2.launches = k3.launches = k2.currents_launches = 0


def _shard_graphs(eng):
    """Per lane, per shard: graphs held, their pool bytes and capture ms."""
    out = {}
    for m, e in eng.engines.items():
        out[m] = [dict(device=str(sh.device), graphs=len(sh.graphs.steps),
                       keys=sorted(map(list, sh.graphs.steps)),
                       pool_bytes=sum(s.pool_bytes
                                      for s in sh.graphs.steps.values()),
                       capture_ms=sum(s.capture_ms
                                      for s in sh.graphs.steps.values()))
                  for sh in e._shards]
    return out


def _shard_kernel_checks(torch, dev, k1, k2, k3, params, rows, windows):
    """K1, K2 and the currents entry on the inputs a shard's event step of
    ``rows`` slots hands them, and K3 and the currents entry at a shard's
    frame rows (fc1: rows x 2048 x 512 on the 1/4 grid; fc2: ternary
    activations x 512 x 11), each against its plain version, bit for
    bit. Returns {kernel: max error}."""
    from repro_torch.configs import CONFIG, TCN_CONFIG
    from repro_torch.core import events as ev
    from repro_torch.kernels import ops
    batch = ev.pad_event_windows(list(windows[:rows]), max_events=65_536)
    arrays = [torch.from_numpy(np.asarray(a)).to(dev) for a in
              (batch.x, batch.y, batch.t, batch.p)]
    vox = ev.voxelize_batch(
        *arrays, torch.from_numpy(batch.valid).to(dev),
        duration_us=batch.duration_us, time_bins=CONFIG.time_bins,
        height=CONFIG.height, width=CONFIG.width)
    _, err = _train_kernel_checks(torch, k1, k2, params, vox, CONFIG)
    g = torch.Generator().manual_seed(SEED + 27)
    k, n = TCN_CONFIG.flat_dim, TCN_CONFIG.hidden
    x = (torch.randint(-4, 5, (rows, k), generator=g) / 4.0).to(dev)
    wp, scale = ops.pack_ternary_weights(torch.randn(k, n, generator=g))
    wp, scale = wp.to(dev), scale.to(dev)
    want = k3.ternary_matmul_plain(x, wp, scale)
    got = k3.ternary_matmul_cuda(x, wp, scale)
    check(bool(torch.equal(want, got)),
          f"sharded: K3 at a shard's {rows} frame rows differs from its "
          f"plain version")
    err["ternary_matmul"] = _max_err([want], [got])
    act = torch.randint(-1, 2, (rows, n), generator=g).float().to(dev)
    w = torch.randn(n, TCN_CONFIG.num_classes, generator=g).to(dev)
    want, got = k2.fc_currents_plain(act, w), k2.fc_currents_cuda(act, w)
    check(bool(torch.equal(want, got)),
          f"sharded: currents entry at a shard's {rows} frame rows differs "
          f"from its plain version")
    err["fc_currents"] = max(err["fc_currents"], _max_err([want], [got]))
    torch.cuda.synchronize()
    return err


def _shard_rate(torch, eng, windows):
    """Windows/s of one timed run: every stream's windows queued, served
    to the end (host clock ending in a synchronize)."""
    hs = [eng.open("event", stream_id=f"r{i}") for i in range(len(windows))]
    for k in range(len(windows[0])):
        for h, ws in zip(hs, windows):
            h.submit(ws[k])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = len(eng.run())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for h in hs:
        h.close()
    return n / dt


def sharded_phase(torch, dev, k1, k2, k3, smi):
    """Slot sharding at full width (Table II's SCNN, CUTIE's TCN, 8 slots a
    lane): every row and carry of a sharded StreamEngine against the
    unsharded one on the same card, bit for bit -- event streams stateful
    and stateless at depths 0 and 1 beside the frame lane, 4 stateful
    FusionSessions, a checkpoint taken on the 4-shard engine continued on
    an unsharded one; launches n x the unsharded count; the kernels at a
    shard's shapes against their plain versions; graphs and pool bytes a
    shard; windows/s sharded and unsharded (no gain is claimed: a logical
    mesh replays n graphs a step on one card). Returns the launches and
    errors the kernels line needs."""
    from repro_torch.configs import CONFIG, TCN_CONFIG
    from repro_torch.convert import snn_params_from_numpy, \
        tcn_params_from_numpy
    from repro_torch.distributed import ShardedTensor
    mode, meshes = _shard_meshes(torch)
    sizes = [m.size for m in meshes]
    emit("sharded_meshes", mode=mode, shards=sizes,
         devices=[[str(d) for d in m.device_list] for m in meshes])
    params = snn_params_from_numpy(_np_params(CONFIG, dyadic=True))
    tparams = tcn_params_from_numpy(_np_tcn_params(TCN_CONFIG))
    events = _windows(SHARD_EVENT_STREAMS, SHARD_WINDOWS, SEED + 31)
    frames = _frames(SHARD_FRAME_STREAMS, SHARD_WINDOWS, SEED + 32)
    stateful = set(range(0, SHARD_EVENT_STREAMS, 2))

    err = dict(lif_scan=0.0, fc_lif_scan=0.0, fc_currents=0.0,
               ternary_matmul=0.0)
    dev_params = {k: {n: t.to(dev) for n, t in v.items()}
                  for k, v in params.items()}
    for n in sorted(set(sizes)):
        for name, e in _shard_kernel_checks(
                torch, dev, k1, k2, k3, dev_params, SHARD_SLOTS // n,
                [ws[0] for ws in events]).items():
            err[name] = max(err[name], e)

    launches = {k: 0 for k in err}
    runs, graphs = [], {}
    for depth in (0, 1):
        counted = {}
        for mesh in [None] + meshes:
            eng = _shard_engine(params, tparams, dev, mesh, depth)
            eng.warmup([SHARD_EVENT_KEY], modality="event")
            eng.warmup([SHARD_FRAME_KEY], modality="frame")
            torch.cuda.synchronize()
            _zero_counts(k1, k2, k3)
            rows, carries = _shard_serve(eng, events, frames, stateful)
            torch.cuda.synchronize()
            counted[mesh] = _counts(k1, k2, k3)
            check(eng.compiled_shapes("event") == {SHARD_EVENT_KEY}
                  and eng.compiled_shapes("frame") == {SHARD_FRAME_KEY},
                  f"sharded: a served window took a key that was not "
                  f"warmed ({eng.compiled_shapes('event')})")
            if mesh is None:
                want = (rows, carries)
                continue
            n = mesh.size
            state = eng._lanes["event"].state
            same = dict(rows=_same_rows(want[0], rows),
                        carries=_same_rows(want[1], carries),
                        launches_n_times={k: v == n * counted[None][k]
                                          for k, v in counted[mesh].items()},
                        state_on_mesh=all(
                            isinstance(a, ShardedTensor)
                            and len(a.blocks) == n for a in state.values()))
            runs.append(dict(depth=depth, shards=n, served=len(rows),
                             launches=counted[mesh],
                             unsharded_launches=counted[None], **same))
            check(same["rows"] and same["carries"],
                  f"sharded ({n} shards, depth {depth}): rows or carries "
                  f"differ from the unsharded engine's")
            check(all(same["launches_n_times"].values()),
                  f"sharded ({n} shards, depth {depth}): launches "
                  f"{counted[mesh]} != {n} x {counted[None]}")
            check(same["state_on_mesh"], "sharded state not on the mesh")
            for k, v in counted[mesh].items():
                launches[k] += v
            graphs[f"{n}_shards"] = _shard_graphs(eng)
            del eng
        base = counted[None]
        check(base["lif_scan"] == base["fc_lif_scan"] > 0
              and base["ternary_matmul"] == base["fc_currents"] > 0,
              f"unsharded launches {base}")
    emit("sharded_serving", slots=SHARD_SLOTS,
         event_streams=SHARD_EVENT_STREAMS,
         frame_streams=SHARD_FRAME_STREAMS, windows=SHARD_WINDOWS,
         stateful_streams=len(stateful), runs=runs, graphs=graphs,
         tolerance="bitwise: label, pwm, logits, exported carries",
         kernels_at_shard_shapes=err)

    sessions = list(zip(_windows(SHARD_SESSIONS, 2, SEED + 33),
                        _frames(SHARD_SESSIONS, 2, SEED + 34)))

    def fused(mesh):
        eng = _shard_engine(params, tparams, dev, mesh, 1)
        ticks, _ = _serve_fused(eng, sessions, [], stateful=True)
        return {k: (r.label_pred, r.pwm, r.logits)
                for k, r in ticks.items()}

    want = fused(None)
    fusion = {}
    for mesh in meshes:
        fusion[f"{mesh.size}_shards"] = _same_rows(want, fused(mesh))
        check(fusion[f"{mesh.size}_shards"],
              f"sharded FusionSessions ({mesh.size} shards) differ")

    big = max(meshes, key=lambda m: m.size)
    ws = _windows(1, 4, SEED + 35)[0]

    def stream(eng, windows, ckpt=None):
        h = eng.open("event", stream_id="c", stateful=True)
        if ckpt is not None:
            h.restore(ckpt)
        for w in windows:
            h.submit(w)
        rows = {r.seq: (r.result.label_pred, r.result.pwm, r.result.logits)
                for r in eng.run()}
        return rows, h

    whole, _ = stream(_shard_engine(params, tparams, dev, None, 0,
                                    ("event",)), ws)
    got, h = stream(_shard_engine(params, tparams, dev, big, 0,
                                  ("event",)), ws[:2])
    t0 = time.perf_counter()
    ckpt = h.checkpoint()
    ckpt_us = (time.perf_counter() - t0) * 1e6
    rest, _ = stream(_shard_engine(params, tparams, dev, None, 0,
                                   ("event",)), ws[2:], ckpt)
    got.update(rest)
    check(_same_rows(whole, got),
          f"a checkpoint from the {big.size}-shard engine continued on an "
          f"unsharded one differs from the uninterrupted run")

    rate_ws = _windows(SHARD_SLOTS, SHARD_RATE_WINDOWS, SEED + 36)
    rates = {}
    engines = {"unsharded": _shard_engine(params, tparams, dev, None, 1,
                                          ("event",))}
    for mesh in meshes:
        engines[f"{mesh.size}_shards"] = _shard_engine(
            params, tparams, dev, mesh, 1, ("event",))
    for eng in engines.values():
        eng.warmup([SHARD_EVENT_KEY])
        _shard_rate(torch, eng, rate_ws[:1])
    for _ in range(SHARD_RATE_SAMPLES):
        for name, eng in list(engines.items()) + list(engines.items())[::-1]:
            rates.setdefault(name, []).append(
                _shard_rate(torch, eng, rate_ws))
    rate = {name: dict(windows_per_s_median=statistics.median(r),
                       samples=r) for name, r in rates.items()}
    for name in rate:
        rate[name]["vs_unsharded"] = (
            rate[name]["windows_per_s_median"]
            / rate["unsharded"]["windows_per_s_median"])
    emit("sharded", mode=mode, shards=sizes, fusion_sessions=SHARD_SESSIONS,
         fusion_bitwise=fusion,
         checkpoint=dict(shards=big.size, continued_on="unsharded",
                         bitwise=True, checkpoint_us=ckpt_us),
         rates=rate, rate_streams=SHARD_SLOTS,
         rate_windows=SHARD_RATE_WINDOWS, pipeline_depth=1,
         rate_note="host clock ending in torch.cuda.synchronize; one "
                   "host thread queues every shard's replay, staging and "
                   "output copy, and the step is host-bound, so no gain "
                   "is claimed (on one card a logical mesh also shares "
                   "its device)",
         nvidia_smi=smi)
    return {"launches": launches, "max_abs_err": err}


# ----------------------------------------------------------------------
# Phase 7c: the port's examples (examples/torch_*.py) on the card, each
# held against the same example run on the CPU in this process.
# ----------------------------------------------------------------------

# The examples run here, at --smoke, and what each gate holds (serve's
# pair at --steps 0: the same untrained params on both devices).
EX_NAMES = ("torch_quickstart", "torch_closed_loop_control",
            "torch_multi_stream_control", "torch_hetero_control",
            "torch_fusion_control", "torch_fault_tolerant_control",
            "torch_serve_ternary_lm")


def _ex_modules():
    import importlib
    path = os.path.join(ROOT, "examples")
    if path not in sys.path:
        sys.path.insert(0, path)
    return {name: importlib.import_module(name) for name in EX_NAMES}


def _ex_run(mods, name, device, *extra):
    """``main`` of example ``name`` at --smoke on ``device``, its printout
    kept out of this script's output; returns (figures, seconds)."""
    import contextlib
    import io
    argv = ["--device", str(device), "--smoke", *extra]
    kw = {"ratio_gate": False} if name == "torch_fusion_control" else {}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = mods[name].main(argv, **kw)
    return out, time.perf_counter() - t0


def _ex_decisions(name, out):
    """The (key -> (label, PWM)) decisions of an example's figures."""
    if name == "torch_quickstart":
        return {None: (out["label"], out["pwm"])}
    if name == "torch_closed_loop_control":
        return {i: (lab, pwm) for i, (lab, pwm) in
                enumerate(zip(out["labels"], out["pwm"]))}
    if name in ("torch_multi_stream_control", "torch_hetero_control"):
        return {(r["stream"], r["seq"]): (r["label"], r["pwm"])
                for r in out["rows"]}
    if name == "torch_fusion_control":
        return {t["seq"]: (t["label"], t["pwm"]) for t in out["ticks"]}
    return {}


def _ex_compare(name, gpu, cpu):
    """The card's figures of one example against the CPU's: labels equal
    and PWM within ``PWM_ATOL`` (decision rows), the fault-tolerant
    acts' statuses, labels and supervisor counts equal, serve's quant
    stats and greedy tokens equal; returns (report, ok)."""
    rep = {}
    a, b = _ex_decisions(name, gpu), _ex_decisions(name, cpu)
    ok = sorted(a, key=str) == sorted(b, key=str)
    if a:
        keys = [k for k in a if k in b]
        rep["decisions"] = len(a)
        rep["labels_equal"] = all(a[k][0] == b[k][0] for k in keys)
        rep["pwm_max_abs_diff"] = max(
            float(np.max(np.abs(np.asarray(a[k][1]) - np.asarray(b[k][1]))))
            for k in keys)
        ok = ok and rep["labels_equal"] and \
            rep["pwm_max_abs_diff"] <= PWM_ATOL
    if name == "torch_multi_stream_control":
        rep["fc1_rates_equal"] = gpu["fc1_rates"] == cpu["fc1_rates"]
        ok = ok and rep["fc1_rates_equal"]
    if name == "torch_fusion_control":
        rep["migration_bitwise"] = [gpu["migration_bitwise"],
                                    cpu["migration_bitwise"]]
        ok = ok and all(rep["migration_bitwise"])
    if name == "torch_fault_tolerant_control":
        for act in ("act1", "act2"):
            keys = ("statuses", "labels", "ticks_fused", "ticks_degraded") \
                if act == "act1" else ("ok", "failed", "labels",
                                       "supervisor")
            rep[act] = {k: gpu[act][k] == cpu[act][k] for k in keys}
            ok = ok and all(rep[act].values())
        rep["bitwise"] = [gpu["act1"]["fused_bitwise"],
                          gpu["act2"]["recovered_bitwise"]]
        ok = ok and all(rep["bitwise"])
    if name == "torch_serve_ternary_lm":
        rep["quant_stats_equal"] = gpu["quant_stats"] == cpu["quant_stats"]
        rep["tokens_fp_equal"] = gpu["tokens_fp"] == cpu["tokens_fp"]
        rep["tokens_ternary_equal"] = \
            gpu["tokens_ternary"] == cpu["tokens_ternary"]
        ok = ok and all(rep.values())
    return rep, ok


def examples_phase(torch, dev, k1, k2, k3, smi):
    """Phase 7c: the six serving examples and ``torch_serve_ternary_lm``
    (``examples/torch_*.py``) through their ``main`` at --smoke, on the
    card and on the CPU in this process: every decision's label equal and
    its PWM within 1e-6, fusion_control's migration and
    fault_tolerant_control's fused and recovered windows bit for bit
    (their own checks) with the same statuses and supervisor counts,
    serve_ternary_lm's quantization and fp and ternary greedy tokens
    equal (both at --steps 0: the same params). Kernel launches of the
    card runs are counted. Reported, not gated: the card's multi-stream
    windows/s and batched speedup, hetero windows/s, fusion_control's
    fused/separate ratio and serve_ternary_lm's tokens/s after its smoke
    training (8 steps)."""
    t0 = time.perf_counter()
    mods = _ex_modules()
    _zero_counts(k1, k2, k3)
    gpu, seconds = {}, {}
    for name in EX_NAMES:
        extra = ("--steps", "0") if name == "torch_serve_ternary_lm" else ()
        gpu[name], seconds[name] = _ex_run(mods, name, dev, *extra)
    trained, seconds["torch_serve_ternary_lm_trained"] = _ex_run(
        mods, "torch_serve_ternary_lm", dev)
    _sync(torch, dev)
    launches = _counts(k1, k2, k3)
    rows, failed = {}, []
    for name in EX_NAMES:
        extra = ("--steps", "0") if name == "torch_serve_ternary_lm" else ()
        cpu, cpu_s = _ex_run(mods, name, "cpu", *extra)
        rows[name], ok = _ex_compare(name, gpu[name], cpu)
        rows[name].update(card_s=seconds[name], cpu_s=cpu_s)
        if not ok:
            failed.append(name)
    ms, he = gpu["torch_multi_stream_control"], gpu["torch_hetero_control"]
    fu = gpu["torch_fusion_control"]
    readings = dict(
        multi_stream_windows_per_s=ms["windows_per_s"],
        multi_stream_looped_windows_per_s=ms["looped_windows_per_s"],
        multi_stream_batched_speedup=ms["batched_speedup"],
        hetero_windows_per_s=he["windows_per_s"],
        fusion_fused_vs_separate=fu["ratio"],
        fusion_fused_ticks_per_s=fu["fused_ticks_per_s"],
        fusion_separate_ticks_per_s=fu["separate_ticks_per_s"],
        serve_trained_steps=trained["steps"],
        serve_losses=trained["losses"],
        serve_fp_tokens_per_s=trained["fp_tokens_per_s"],
        serve_ternary_tokens_per_s=trained["ternary_tokens_per_s"],
        serve_agreement=trained["agreement"],
        quickstart_modelled_kraken=dict(
            latency_ms=gpu["torch_quickstart"]["latency_ms"],
            energy_mj=gpu["torch_quickstart"]["energy_mj"]))
    print(f"fusion_control fused/separate ratio on the card: "
          f"{fu['ratio']:.4f}", flush=True)
    emit("examples", nvidia_smi=smi, size="--smoke", pwm_atol=PWM_ATOL,
         launches=launches, checks=rows, readings=readings,
         seconds=time.perf_counter() - t0)
    check(not failed, f"examples differ between the card and the CPU: "
                      f"{failed}")
    check(all(launches[k] > 0 for k in launches),
          f"the examples did not launch every serving kernel: {launches}")
    return {"launches": launches}


# ----------------------------------------------------------------------
# Phase 8: STBP training of the Table II SCNN -- snn_loss under autograd
# in both modes, AdamW and step-atomic checkpoints.
# ----------------------------------------------------------------------

TRAIN_BATCH = 16                # examples/torch_train_dvs_gesture.py's
TRAIN_GATE_BATCH = 4            # gates (a) and (b)
TRAIN_STEPS = 30                # the reported run, each mode
TRAIN_TIMED_STEPS = 20
TRAIN_PROFILE_STEPS = 3
TRAIN_LOOP_STEPS = 5            # the example's loop, batches made inline
TRAIN_RESTART_K = 3             # gate (e): 2k uninterrupted vs k + k
# Weight gradients on the card against the CPU, and between the modes:
# the same formulas with their sums in other orders (cuDNN's and
# cuBLAS's against the CPU's; per-step products against one over T).
# The H100 read at most 9.8e-7 (card vs CPU) and 1.7e-6 (mode vs mode)
# of a gradient's largest magnitude; a backward whose recomputed
# membrane flips a few surrogate windows moves it by more than that,
# so the limit sits ~6x above the largest reading.
TRAIN_GRAD_RTOL = 1e-5
TRAIN_MODES = ("time_serial", "layer_serial")


def _train_full():
    """What ``train_phase`` trains: the Table II network on the example's
    ~60k-event 128x128 windows."""
    from repro_torch.configs import CONFIG
    return dict(cfg=CONFIG, data=dict(
        height=CONFIG.height, width=CONFIG.width,
        time_bins=CONFIG.time_bins, mean_events=60_000,
        num_classes=CONFIG.num_classes))


def _grad_rel(torch, want, got):
    """Largest |got - want| over want's largest magnitude, a layer."""
    return {k: float((got[k]["w"].cpu() - want[k]["w"].cpu()).abs().max()
                     / want[k]["w"].abs().max().cpu()) for k in want}


def _same_tree(torch, a, b):
    from repro_torch.training.optimizer import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu())
        for x, y in zip(la, lb))


def _train_kernel_checks(torch, k1, k2, params, vox, cfg):
    """K1, K2 and K2's currents entry on the inputs a B=16 training batch
    gives them, each against its plain version on the card, bit for bit:
    the conv1/conv2 currents and the fc1/fc2 spikes that a layer_serial
    forward hands ``ops.lif_scan`` and ``ops.fc_lif_scan`` (recorded from
    that forward), and the currents entry on fc1's and fc2's spikes as
    time_serial gives them (one step's B rows) and as the backward's
    recomputation does (T*B rows). Returns (shapes, {kernel: max error})."""
    from repro_torch.core.snn import snn_apply
    from repro_torch.kernels import ops
    seen = {"lif_scan": [], "fc_lif_scan": []}
    real = {name: getattr(ops, name) for name in seen}

    def recorder(name):
        def call(*args):
            seen[name].append(args)
            return real[name](*args)
        return call

    try:
        for name in seen:
            setattr(ops, name, recorder(name))
        with torch.no_grad():
            snn_apply(params, vox, cfg, mode="layer_serial")
    finally:
        for name, fn in real.items():
            setattr(ops, name, fn)
    check(len(seen["lif_scan"]) == 2 and len(seen["fc_lif_scan"]) == 2,
          f"train: recorded {[len(v) for v in seen.values()]} kernel calls")
    err = dict(lif_scan=0.0, fc_lif_scan=0.0, fc_currents=0.0)
    shapes = []
    for layer, (cur, p, v0) in zip(("conv1", "conv2"), seen["lif_scan"]):
        want = k1.lif_scan_plain(cur, p, v0)
        got = k1.lif_scan_cuda(cur, p, v0)
        check(_bitwise(torch, want, got),
              f"train: K1 on {layer}'s {tuple(cur.shape)} currents differs "
              f"from its plain version")
        err["lif_scan"] = max(err["lif_scan"], _max_err(want, got))
        shapes.append(dict(kernel="lif_scan", layer=layer,
                           shape=list(cur.shape)))
    for layer, (sp, w, p, v0) in zip(("fc1", "fc2"), seen["fc_lif_scan"]):
        want = k2.fc_lif_scan_plain(sp, w, p, v0)
        got = k2.fc_lif_scan_cuda(sp, w, p, v0)
        check(_bitwise(torch, want, got),
              f"train: K2 on {layer}'s {tuple(sp.shape)} spikes differs "
              f"from its plain version")
        err["fc_lif_scan"] = max(err["fc_lif_scan"], _max_err(want, got))
        for rows in (sp[0], sp.reshape(-1, sp.shape[-1])):
            rows = rows.float().contiguous()
            want = k2.fc_currents_plain(rows, w)
            got = k2.fc_currents_cuda(rows, w)
            check(torch.equal(got, want),
                  f"train: currents entry on {layer}'s {tuple(rows.shape)} "
                  f"spikes differs from its plain version")
            err["fc_currents"] = max(err["fc_currents"],
                                     _max_err([want], [got]))
        shapes.append(dict(kernel="fc_lif_scan", layer=layer,
                           shape=list(sp.shape) + [w.shape[1]]))
    torch.cuda.synchronize()
    return shapes, err


def train_phase(torch, dev, k1, k2, smi):
    """STBP training of the Table II SCNN, as
    ``examples/torch_train_dvs_gesture.py`` runs it: ``snn_loss`` under
    autograd, AdamW, step-atomic checkpoints, on ``dvs_gesture_batch``
    windows. Gates, each raising: (a) the card against the port's CPU
    run, both modes, 2**-8 weights, B=4: loss, logits, output spikes and
    per-layer rates bit for bit, the four weight gradients within
    ``TRAIN_GRAD_RTOL`` of their largest magnitudes; (b) on the card,
    layer_serial against time_serial (He init): loss and spikes bit for
    bit, gradients within the tolerance, and the launch tallies exactly
    (a time_serial step: 2*T of the currents entry forward, none
    backward; a layer_serial step: K1 2, K2 2 forward, the currents
    entry 2 backward, its recomputation of fc1 and fc2); (c) every
    weight gradient of step 1 finite and nonzero; (d) a full step under
    ``torch.cuda.set_sync_debug_mode("error")``; (e) 2k AdamW steps at
    B=16 from ``init_snn`` against k steps, ``save_checkpoint``,
    ``restore_latest`` into fresh tensors and k more: parameters and
    optimizer state bit for bit; and K1, K2 and the currents entry on
    the inputs the first B=16 batch gives them, against their plain
    versions bit for bit. Reported: the loss and accuracy of
    ``TRAIN_STEPS`` steps at B=16 in each mode, step ms by part (median
    of ``TRAIN_TIMED_STEPS``, CUDA events), step-only samples/s (batches
    made beforehand) and the example loop's samples/s (each batch made
    inline), the device busy share from a profile, peak memory
    allocated, the host ms of a ``dvs_gesture_batch``, and
    ``save_checkpoint``/``restore_latest`` ms. Returns the main path's
    launches (the reported runs) and each kernel's largest error."""
    import shutil
    from repro_torch.convert import snn_params_from_numpy
    from repro_torch.core.snn import SNN_STATE_LAYERS, init_snn, snn_apply
    from repro_torch.data import dvs_gesture_batch
    from repro_torch.training import (AdamWConfig, adamw_init,
                                      restore_latest, save_checkpoint,
                                      snn_grads, stbp_step)
    full = _train_full()
    cfg, data = full["cfg"], full["data"]
    on_card = torch.device(dev).type == "cuda"
    cpu = torch.device("cpu")
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    # The example's AdamW at its default 300 steps.
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=300,
                       weight_decay=1e-4)
    t_phase = time.perf_counter()
    gates, report = {}, {"nvidia_smi": smi}
    tally = lambda: (k1.launches, k2.launches, k2.currents_launches)

    err = dict(lif_scan=0.0, fc_lif_scan=0.0, fc_currents=0.0)

    # (a) the card against the CPU, 2**-8 weights.
    p_cpu = snn_params_from_numpy(_np_params(cfg, dyadic=True))
    p_dev = {k: {"w": v["w"].to(dev)} for k, v in p_cpu.items()}
    b4 = dvs_gesture_batch(TRAIN_GATE_BATCH, 0, device=dev, **data)
    b4_cpu = dvs_gesture_batch(TRAIN_GATE_BATCH, 0, device=cpu, **data)
    gates["a_batch_equal"] = bool(
        torch.equal(b4.vox.cpu(), b4_cpu.vox)
        and torch.equal(b4.labels.cpu(), b4_cpu.labels))
    a_rel = {}
    for mode in TRAIN_MODES:
        got = snn_grads(p_dev, b4.vox, b4.labels, cfg, mode=mode)
        want = snn_grads(p_cpu, b4_cpu.vox, b4_cpu.labels, cfg, mode=mode)
        with torch.no_grad():
            s_dev = snn_apply(p_dev, b4.vox, cfg, mode=mode)
            s_cpu = snn_apply(p_cpu, b4_cpu.vox, cfg, mode=mode)
        gates[f"a_{mode}_loss"] = bool(torch.equal(got[0].cpu(), want[0]))
        gates[f"a_{mode}_logits"] = bool(torch.equal(
            got[1]["logits"].cpu(), want[1]["logits"]))
        gates[f"a_{mode}_spikes"] = bool(torch.equal(
            s_dev["out_spikes"].cpu(), s_cpu["out_spikes"]))
        gates[f"a_{mode}_rates"] = all(
            torch.equal(got[1]["firing_rates"][k].cpu(),
                        want[1]["firing_rates"][k])
            and torch.equal(s_dev["firing_rates_per_stream"][k].cpu(),
                            s_cpu["firing_rates_per_stream"][k])
            for k in SNN_STATE_LAYERS)
        a_rel[mode] = _grad_rel(torch, want[2], got[2])
        gates[f"a_{mode}_grads"] = max(a_rel[mode].values()) \
            <= TRAIN_GRAD_RTOL
        report[f"a_{mode}_loss"] = float(want[0])
    report["a_grad_rel_err"] = a_rel
    del p_cpu, p_dev, b4_cpu

    # (b) the modes on the card, He init; the launch tallies.
    params0 = init_snn(SEED, cfg, device=dev)
    gates["b_init_same_as_cpu"] = all(
        torch.equal(params0[k]["w"].cpu(), v["w"])
        for k, v in init_snn(SEED, cfg, device=cpu).items())
    runs, counts = {}, {}
    for mode in TRAIN_MODES:
        sync()
        before = tally()
        runs[mode] = snn_grads(params0, b4.vox, b4.labels, cfg, mode=mode)
        sync()
        counts[mode] = tuple(a - b for a, b in zip(tally(), before))
        with torch.no_grad():
            runs[mode] += (snn_apply(params0, b4.vox, cfg,
                                     mode=mode)["out_spikes"],)
    ts, ls = runs["time_serial"], runs["layer_serial"]
    gates["b_loss"] = bool(torch.equal(ts[0], ls[0]))
    gates["b_spikes"] = bool(torch.equal(ts[3], ls[3]))
    b_rel = _grad_rel(torch, ts[2], ls[2])
    gates["b_grads"] = max(b_rel.values()) <= TRAIN_GRAD_RTOL
    report["b_grad_rel_err"] = b_rel
    expect = {"time_serial": (0, 0, 2 * cfg.time_bins),
              "layer_serial": (2, 2, 2)}
    report["b_step_launches"] = counts
    if on_card:
        gates["b_launches"] = counts == expect
    del runs, ts, ls

    # The batches of the B=16 runs, made as the example makes them.
    batches, data_ms = [], []
    for s in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        batches.append(dvs_gesture_batch(TRAIN_BATCH, s, device=dev, **data))
        sync()
        data_ms.append((time.perf_counter() - t0) * 1e3)
    report["data_batch_ms"] = dict(median=statistics.median(data_ms),
                                   min=min(data_ms), max=max(data_ms))
    # Of which numpy's event synthesis: the batch's windows drawn again
    # from its seed, nothing voxelized or copied.
    from repro_torch.core.events import synthetic_gesture_events
    synth_ms = []
    for s in range(5):
        t0 = time.perf_counter()
        rng = np.random.default_rng(999 + s)
        for lab in rng.integers(0, cfg.num_classes, size=TRAIN_BATCH):
            synthetic_gesture_events(
                rng, int(lab), mean_events=data["mean_events"],
                height=data["height"], width=data["width"],
                num_classes=cfg.num_classes)
        synth_ms.append((time.perf_counter() - t0) * 1e3)
    report["data_numpy_synthesis_ms"] = statistics.median(synth_ms)
    report["events_per_batch"] = [int(b.num_events.sum())
                                  for b in batches[:3]]
    # K1, K2 and the currents entry on what the first B=16 batch gives
    # them (the main path's grids), against their plain versions.
    if on_card:
        report["kernel_check_shapes"], err = _train_kernel_checks(
            torch, k1, k2, params0, batches[0].vox, cfg)

    # (c) step 1's gradients reach every layer; (d) no synchronisation.
    for mode in TRAIN_MODES:
        _, _, g1 = snn_grads(params0, batches[0].vox, batches[0].labels,
                             cfg, mode=mode)
        gates[f"c_{mode}_every_layer_learns"] = all(
            bool(torch.isfinite(g["w"]).all()) and float(g["w"].abs().max())
            > 0 for g in g1.values())
        if on_card:
            opt0 = adamw_init(params0)
            stbp_step(params0, opt0, batches[0].vox, batches[0].labels,
                      cfg, ocfg, mode=mode)
            sync()
            try:
                torch.cuda.set_sync_debug_mode("error")
                stbp_step(params0, opt0, batches[1].vox, batches[1].labels,
                          cfg, ocfg, mode=mode)
                gates[f"d_{mode}_no_sync"] = True
            except RuntimeError as e:
                report[f"d_{mode}_error"] = str(e)[:300]
                gates[f"d_{mode}_no_sync"] = False
            finally:
                torch.cuda.set_sync_debug_mode(0)
            sync()

    # (e) restart is bit-identical; save/restore ms.
    ckdir = os.path.join(ROOT, "checkpoints", "chip_smoke_train")
    shutil.rmtree(ckdir, ignore_errors=True)
    k = TRAIN_RESTART_K
    save_ms, restore_ms = [], []

    def steps(params, opt, lo, hi, mode):
        for s in range(lo, hi):
            params, opt, _, _ = stbp_step(
                params, opt, batches[s].vox, batches[s].labels, cfg, ocfg,
                mode=mode)
        return params, opt

    for mode in TRAIN_MODES:
        whole = steps(params0, adamw_init(params0), 0, 2 * k, mode)
        again = steps(params0, adamw_init(params0), 0, 2 * k, mode)
        report[f"e_{mode}_rerun_bitwise"] = _same_tree(
            torch, {"p": whole[0], "o": whole[1]},
            {"p": again[0], "o": again[1]})
        half = steps(params0, adamw_init(params0), 0, k, mode)
        sync()
        t0 = time.perf_counter()
        path = save_checkpoint(ckdir, k, {"params": half[0],
                                          "opt": half[1]})
        save_ms.append((time.perf_counter() - t0) * 1e3)
        report["checkpoint_bytes"] = sum(f.stat().st_size
                                         for f in path.iterdir())
        fresh = init_snn(SEED + 1, cfg, device=dev)
        sync()
        t0 = time.perf_counter()
        step, state, _ = restore_latest(
            ckdir, {"params": fresh, "opt": adamw_init(fresh)})
        sync()
        restore_ms.append((time.perf_counter() - t0) * 1e3)
        resumed = steps(state["params"], state["opt"], k, 2 * k, mode)
        gates[f"e_{mode}_restart_bitwise"] = step == k and _same_tree(
            torch, {"p": whole[0], "o": whole[1]},
            {"p": resumed[0], "o": resumed[1]})
        shutil.rmtree(ckdir, ignore_errors=True)
    report["save_checkpoint_ms"] = save_ms
    report["restore_latest_ms"] = restore_ms

    # Reported: TRAIN_STEPS steps a mode from He init (the main path, its
    # launches counted), then timed steps and a profile.
    sync()
    k1.launches = k2.launches = k2.currents_launches = 0
    curves = {}
    for mode in TRAIN_MODES:
        params, opt = params0, adamw_init(params0)
        losses, accs = [], []
        for b in batches:
            params, opt, loss, aux = stbp_step(
                params, opt, b.vox, b.labels, cfg, ocfg, mode=mode)
            losses.append(loss)
            accs.append(aux["accuracy"])
        curves[mode] = dict(loss=[float(x) for x in losses],
                            accuracy=[float(x) for x in accs])
    sync()
    launches = {"lif_scan": k1.launches, "fc_lif_scan": k2.launches,
                "fc_currents": k2.currents_launches}
    n = TRAIN_STEPS
    if on_card:
        gates["train_launches"] = launches == {
            "lif_scan": 2 * n, "fc_lif_scan": 2 * n,
            "fc_currents": n * (2 * cfg.time_bins) + n * 2}
    report["curves"] = curves

    timing = {}
    if on_card:
        for mode in TRAIN_MODES:
            params, opt = params0, adamw_init(params0)
            for b in batches[:3]:
                params, opt, _, _ = stbp_step(
                    params, opt, b.vox, b.labels, cfg, ocfg, mode=mode)
            sync()

            def timed(det):
                """Step ms by part (medians), wall ms a step and the
                peak bytes above what is held, over TRAIN_TIMED_STEPS."""
                nonlocal params, opt
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                marks = []
                t0 = time.perf_counter()
                for i in range(TRAIN_TIMED_STEPS):
                    ev4 = [torch.cuda.Event(enable_timing=True)
                           for _ in range(4)]
                    b = batches[i % len(batches)]
                    params, opt, _, _ = stbp_step(
                        params, opt, b.vox, b.labels, cfg, ocfg, mode=mode,
                        deterministic=det,
                        mark=lambda i, ev4=ev4: ev4[i].record())
                    marks.append(ev4)
                sync()
                wall = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED_STEPS
                part = lambda i, j: statistics.median(
                    m[i].elapsed_time(m[j]) for m in marks)
                return dict(step_ms=part(0, 3), forward_ms=part(0, 1),
                            backward_ms=part(1, 2), optimizer_ms=part(2, 3),
                            wall_ms_per_step=wall,
                            step_only_samples_per_s=TRAIN_BATCH / wall * 1e3,
                            peak_memory_allocated_bytes=(
                                torch.cuda.max_memory_allocated()),
                            step_peak_bytes_above_held=(
                                torch.cuda.max_memory_allocated() - held))

            # Deterministic (the gated steps), free, deterministic again:
            # the context's cost read within one call, in turns.
            runs = [timed(True), timed(False), timed(True)]
            row = dict(runs[0])
            row["step_ms_deterministic_runs"] = [runs[0]["step_ms"],
                                                 runs[2]["step_ms"]]
            row["nondeterministic"] = runs[1]

            # The example's loop as a user runs it: each batch made
            # inline (numpy synthesis, voxelize), then the step, then the
            # accuracy read back; the rate with the data included.
            p, o = params, opt
            t0 = time.perf_counter()
            for s in range(TRAIN_LOOP_STEPS):
                b = dvs_gesture_batch(TRAIN_BATCH, 100 + s, device=dev,
                                      **data)
                p, o, _, aux = stbp_step(p, o, b.vox, b.labels, cfg, ocfg,
                                         mode=mode)
                float(aux["accuracy"])
            sync()
            loop = (time.perf_counter() - t0) * 1e3 / TRAIN_LOOP_STEPS
            row["example_loop_ms_per_step"] = loop
            row["example_loop_samples_per_s"] = TRAIN_BATCH / loop * 1e3

            def run_profiled():
                p, o = params, opt
                for b in batches[:TRAIN_PROFILE_STEPS]:
                    p, o, _, _ = stbp_step(p, o, b.vox, b.labels, cfg,
                                           ocfg, mode=mode)
                return p

            _, wall_ms, by_name, n_ops, host, gaps, api = _trace(
                torch, run_profiled)
            row["profile"] = _trace_fields(
                wall_ms, by_name, n_ops, host, gaps, api,
                TRAIN_PROFILE_STEPS, row["wall_ms_per_step"])
            timing[mode] = row
    report["timing"] = timing
    del batches, params0
    if on_card:
        torch.cuda.empty_cache()
    emit("train", config="CONFIG (full width), B=16 (gates a, b: B=4)",
         launches=launches, gates=gates, max_abs_err=err,
         phase_s=time.perf_counter() - t_phase, **report)
    failed = [g for g, ok in gates.items() if not ok]
    check(not failed, f"train gates failed: {failed}")
    return dict(launches=launches, max_abs_err=err)


# ----------------------------------------------------------------------
# Phase 9: the LM slice -- RWKV-6 serving through K4 (and K3 on the
# ternary path).
# ----------------------------------------------------------------------

# Depth of the f32 comparison with the CPU (2 layers took 89.9 s of the
# slice on the H100, most of it the CPU's; at 1 layer rwkv6-7b's two
# stacked layers are held in f32 against the CPU by lm_train's (b)).
LM_CUT_LAYERS = 1
# Tokens of that comparison, cut to keep chip_smoke inside its limit (the
# CPU reference took 160.6-166.0 s at B=2, S=64, an 8-token prompt and 8
# new tokens, 4 + 6 ternary): B=2, S=32 logits, decode stepped over a
# 4-token prompt, 4 new tokens, 2 + 3 ternary. Widths stay full.
LM_CUT_SEQ, LM_CUT_PROMPT, LM_CUT_NEW = 32, 4, 4
LM_CUT_QPROMPT, LM_CUT_QNEW = 2, 3
# f32 logits (std ~1) on the card against the CPU: cuBLAS and the CPU's
# BLAS sum the d=4096 and d_ff=14336 products in other orders, and exp
# rounds differently, so ~1e-5 is expected; 1e-3 leaves room and still
# catches any real fault (a wrong term moves logits by O(0.1)).
LM_LOGITS_ATOL = 1e-3
# The bf16 lm_head product with an f32 output against the f32 product of
# the casts: the same exact terms summed in another order (f32 ulps of
# O(1) logits); a bf16-rounded output would miss it by ~1e-2.
LM_HEAD_ATOL = 1e-4
LM_SERVE_REQUESTS, LM_PROMPT, LM_NEW = 6, 8, 16     # as launch/serve.py
LM_BATCH = 4
LM_PREFILL_S = 2048
# Decode tokens/s at B=4, bf16 and ternary samples in turn (timing only:
# the rates belong in a benchmark, so chip_smoke takes few samples).
DECODE_SAMPLES, DECODE_STEPS = 3, 16


def _lm_params(torch, model, seed, dev):
    """Parameters of ``model`` drawn by ``model.init`` from a seeded
    generator on ``dev``, with nonzero ``u``, ``mu``, ``mu_k`` and ``mu_r``
    from a numpy seed (zero at init: the bonus term and the ddlerp would
    never be exercised)."""
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    tm, cm = params["layers"]["tm"], params["layers"]["cm"]
    for tree, key, a in _mix_values(np.random.default_rng(seed), tm, cm):
        tree[key] = tree[key].new_tensor(a)
    return params


def _mix_values(rng, tm, cm):
    """(tree, key, f32 array) for u ~ N(0, 0.25) and mu, mu_k, mu_r ~
    U(0, 1), shaped like the leaves of ``tm``/``cm``."""
    shape = lambda x: tuple(x.shape)
    return [(tm, "u", (rng.normal(size=shape(tm["u"])) * 0.5).astype(
                np.float32))] + [
        (tree, key, rng.uniform(0.0, 1.0, shape(tree[key])).astype(
            np.float32))
        for tree, key in ((tm, "mu"), (cm, "mu_k"), (cm, "mu_r"))]


def _wkv_inputs(torch, g, dev, b, t, h, hd, dtype, state=False):
    """r, k, v, logw (f32, clamped to >= -4 as the model does), u and an
    optional nonzero state0, on ``dev``."""
    r, k, v = (torch.randn(b, t, h, hd, generator=g) for _ in range(3))
    logw = torch.clamp(-torch.exp(torch.randn(b, t, h, hd, generator=g)
                                  * 0.5 - 0.5), min=-4.0)
    u = torch.randn(h, hd, generator=g) * 0.5
    s0 = (torch.randn(b, h, hd, hd, generator=g) * 0.1).to(dev) if state \
        else None
    return ([x.to(dtype).to(dev) for x in (r, k, v)]
            + [logw.to(dev), u.to(dtype).to(dev), s0])


def _rows(x, lo, hi):
    return None if x is None else x[lo:hi].contiguous()


def _misaligned(torch, x):
    """A contiguous copy of ``x`` starting one element past a 16-byte
    boundary (K4 then stages by element loads, not cp.async)."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    return out


def k4_checks(torch, dev, k4):
    """K4 against its plain version on the card, bit for bit: the LM
    widths (H=64, hd=64) at T=256 and at T=2048 (the length
    make_prefill_step hands K4) in bf16 (f32 logw), at T=256 in f32, the
    decode call (T=1 from a nonzero state) and T=4 (the kernel's
    short-call instance), T not a multiple of the kernel's time chunk (37,
    and 17 = one chunk and one step), hd=32 and
    SMOKE's hd=16, and inputs off a 16-byte boundary; two halves chained
    through state0 (split inside a time chunk) against one unbroken scan;
    B=1 rows against B=4."""
    g = torch.Generator().manual_seed(SEED + 10)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [("prefill_bf16", 4, 256, 64, 64, bf16, False),
             ("prefill_bf16_T2048", 4, LM_PREFILL_S, 64, 64, bf16, False),
             ("prefill_f32", 4, 256, 64, 64, f32, False),
             ("decode_bf16", 4, 1, 64, 64, bf16, True),
             ("short_T4_bf16", 4, 4, 64, 64, bf16, True),
             ("ragged_T37_bf16", 4, 37, 64, 64, bf16, True),
             ("chunk_plus_one_T17_f32", 4, 17, 64, 64, f32, False),
             ("hd32_T37_bf16", 4, 37, 8, 32, bf16, False),
             ("smoke_hd16", 4, 256, 4, 16, f32, False),
             ("unaligned_T37_bf16", 4, 37, 64, 64, bf16, True)]
    rows, err = [], 0.0
    for name, b, t, h, hd, dtype, state in cases:
        r, k, v, lw, u, s0 = _wkv_inputs(torch, g, dev, b, t, h, hd, dtype,
                                         state)
        if name.startswith("unaligned"):
            r, k, v, lw = (_misaligned(torch, x) for x in (r, k, v, lw))
        seq = (r, k, v, lw)
        want = k4.wkv6_scan_plain(r, k, v, lw, u, s0)
        got = k4.wkv6_scan_cuda(r, k, v, lw, u, s0)
        one = k4.wkv6_scan_cuda(*[_rows(x, b - 1, b) for x in seq], u,
                                _rows(s0, b - 1, b))
        ok = dict(plain=_bitwise(torch, want, got),
                  b1_rows=bool(torch.equal(one[0][0], got[0][b - 1])
                               and torch.equal(one[1][0], got[1][b - 1])))
        if t > 1:
            half = t // 2 + (3 if t >= 8 else 0)
            a = k4.wkv6_scan_cuda(
                *[x[:, :half].contiguous() for x in seq], u, s0)
            z = k4.wkv6_scan_cuda(
                *[x[:, half:].contiguous() for x in seq], u, a[1])
            ok["chained"] = bool(
                torch.equal(torch.cat([a[0], z[0]], dim=1), got[0])
                and torch.equal(z[1], got[1]))
        torch.cuda.synchronize()
        err = max(err, _max_err(want, got))
        rows.append(dict(kernel="wkv6_scan", case=name, shape=[b, t, h, hd],
                         dtype=str(dtype), logw="torch.float32",
                         state0=state, chained_at=half if t > 1 else None,
                         **ok))
        check(all(ok.values()), f"K4 {name}: {ok}")
    geometry = {hd: k4.geometry(hd) for hd in k4.HEAD_DIMS}
    emit("k4_vs_plain", tolerance="bitwise", checks=rows, max_abs_err=err,
         geometry=geometry)
    return err


def _greedy_gaps(torch, model, params, prompts, tokens, dev):
    """The smallest top-2 logit gap over the generating steps, replaying
    decode over prompt + generated tokens."""
    seq = torch.from_numpy(np.concatenate([prompts, tokens], 1)).to(dev)
    cache = model.init_cache(seq.shape[0], seq.shape[1], device=dev)
    gaps = []
    for i in range(seq.shape[1] - 1):
        logits, cache = model.decode(params, cache, seq[:, i:i + 1])
        if i >= prompts.shape[1] - 1:
            top2 = torch.topk(logits[:, -1], 2).values
            gaps.append(float((top2[:, 0] - top2[:, 1]).min()))
    return min(gaps)


def lm_depth_cut(torch, dev, k3):
    """rwkv6-7b widths at LM_CUT_LAYERS layers in f32, params from a numpy
    seed: the card against the port's CPU run -- Model.apply logits at
    B=2, S=LM_CUT_SEQ, decode stepped over an LM_CUT_PROMPT-token prompt,
    greedy generate (LM_CUT_NEW new tokens), and the same model
    ternary-quantized on each device (greedy tokens equal, K3
    counted)."""
    import dataclasses
    from repro_torch.configs.rwkv6_7b import CONFIG
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_map
    from repro_torch.serving import (ServeConfig, generate,
                                     quantize_for_serving)
    cfg = dataclasses.replace(CONFIG, num_layers=LM_CUT_LAYERS,
                              dtype="float32")
    model = build_model(cfg)
    cpu = _lm_params(torch, model, SEED + 11, "cpu")
    gpu = tree_map(lambda x: x.to(dev), cpu)
    rng = np.random.default_rng(SEED + 12)
    toks = rng.integers(0, cfg.vocab_size, (2, LM_CUT_SEQ))
    lg = model.apply(gpu, {"tokens": torch.from_numpy(toks).to(dev)})[0]
    lc = model.apply(cpu, {"tokens": torch.from_numpy(toks)})[0]
    apply_diff = float((lg.cpu() - lc).abs().max())
    logit_std = float(lc.std())

    prompt = toks[:, :LM_CUT_PROMPT]
    cg = model.init_cache(2, LM_CUT_PROMPT, device=dev)
    cc = model.init_cache(2, LM_CUT_PROMPT, device="cpu")
    dec_diff = 0.0
    for i in range(prompt.shape[1]):
        t = torch.from_numpy(prompt[:, i:i + 1])
        a, cg = model.decode(gpu, cg, t.to(dev))
        b, cc = model.decode(cpu, cc, t)
        dec_diff = max(dec_diff, float((a.cpu() - b).abs().max()))
    state_diff = float((cg["state"].cpu() - cc["state"]).abs().max())

    sc = ServeConfig(max_new_tokens=LM_CUT_NEW)
    tg, _ = generate(model, gpu, prompt, sc, device=dev)
    tc, _ = generate(model, cpu, prompt, sc, device="cpu")
    gap = _greedy_gaps(torch, model, gpu, prompt, tg, dev)

    qg, stats_g = quantize_for_serving(gpu)
    qc, stats_c = quantize_for_serving(cpu)
    packed = [(qg["layers"][grp][n]["packed"].cpu(),
               qc["layers"][grp][n]["packed"])
              for grp, names in (("tm", ("wr", "wk", "wv", "wg", "wo")),
                                 ("cm", ("wk", "wv", "wr")))
              for n in names]
    same_bytes = sum(int((a == b).sum()) for a, b in packed) / sum(
        b.numel() for _, b in packed)
    qprompt = prompt[:, :LM_CUT_QPROMPT]
    qsc = ServeConfig(max_new_tokens=LM_CUT_QNEW)
    k3.launches = 0
    qtg, _ = generate(model, qg, qprompt, qsc, device=dev)
    torch.cuda.synchronize()
    k3_launches = k3.launches
    qtc, _ = generate(model, qc, qprompt, qsc, device="cpu")
    qsteps = qprompt.shape[1] + qsc.max_new_tokens
    out = dict(
        config=f"rwkv6-7b widths, num_layers={LM_CUT_LAYERS}, float32",
        apply_shape=[2, LM_CUT_SEQ], apply_logits_max_abs_diff=apply_diff,
        logits_std=logit_std, decode_logits_max_abs_diff=dec_diff,
        decode_state_max_abs_diff=state_diff,
        greedy_tokens_equal=bool(np.array_equal(tg, tc)),
        greedy_min_top2_gap=gap, tokens_card=tg.tolist(),
        ternary_stats_equal=stats_g == stats_c, ternary_stats=stats_g,
        ternary_packed_equal_fraction=same_bytes,
        ternary_tokens_equal=bool(np.array_equal(qtg, qtc)),
        ternary_k3_launches=k3_launches, ternary_decode_steps=qsteps,
        tolerance=dict(logits_atol=LM_LOGITS_ATOL, tokens="equal"))
    emit("lm_vs_cpu", **out)
    check(apply_diff <= LM_LOGITS_ATOL, f"apply logits: {apply_diff}")
    check(dec_diff <= LM_LOGITS_ATOL, f"decode logits: {dec_diff}")
    check(out["greedy_tokens_equal"], f"greedy tokens {tg} vs {tc}")
    check(out["ternary_tokens_equal"], f"ternary tokens {qtg} vs {qtc}")
    check(same_bytes == 1.0, f"the card packed {same_bytes} of the bytes "
          f"the CPU packs (ternarize's means are fixed-order sums)")
    check(k3_launches == 8 * LM_CUT_LAYERS * qsteps,
          f"K3 launched {k3_launches} times in {qsteps} 2-layer steps")


def _lm_head_diff(torch, dev, params, cfg):
    """The decode step's lm_head product (bf16 operands, f32 output) at
    B=4 against the f32 product of the casts."""
    from repro_torch.models import rwkv6
    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    h = torch.randn(LM_BATCH, 1, cfg.d_model, generator=g, device=dev).to(
        torch.bfloat16)
    got = rwkv6._unembed(params, h, cfg)
    hn = rwkv6.L.layer_norm(h, params["ln_f_s"], params["ln_f_b"],
                            cfg.norm_eps)
    want = torch.matmul(hn.float(), params["lm_head"].float())
    diff = float((got - want).abs().max())
    check(got.dtype == torch.float32 and diff <= LM_HEAD_ATOL,
          f"lm_head product: {got.dtype}, max abs diff {diff}")
    return diff


def lm_serve(torch, dev, k4, model, params):
    """The full rwkv6-7b served as a user serves it: BatchScheduler over
    requests built as launch/serve.py builds them, generate at B=4 and the
    prefill step at B=4, S=2048. K4's counter must show one launch per
    layer per decode step and per prefill call."""
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.serving import (BatchScheduler, Request, ServeConfig,
                                     generate)
    cfg = model.cfg
    nl, vocab = cfg.num_layers, cfg.vocab_size
    rng = np.random.default_rng(0)
    reqs = [Request(id=i, prompt=rng.integers(
                2, vocab, size=rng.integers(2, LM_PROMPT + 1)),
                max_new_tokens=LM_NEW) for i in range(LM_SERVE_REQUESTS)]
    sched = BatchScheduler(model, params, max_batch=LM_BATCH,
                           cache_len=LM_PROMPT + LM_NEW + 1, device=dev)
    k4.launches = 0
    done = sched.run(reqs)
    torch.cuda.synchronize()
    sched_launches = k4.launches
    steps = sched.stats["decode_steps"]
    outs = [t for r in done for t in r.output]
    check(all(len(r.output) == LM_NEW for r in done), "short outputs")
    check(all(0 <= t < vocab for t in outs), "token out of range")
    check(sched_launches == nl * steps,
          f"K4 launched {sched_launches} times in {steps} decode steps")

    prompts = rng.integers(2, vocab, (LM_BATCH, 32))
    k4.launches = 0
    toks, gstats = generate(model, params, prompts,
                            ServeConfig(max_new_tokens=32), device=dev)
    gen_launches = k4.launches
    check(gen_launches == nl * (32 + 32),
          f"K4 launched {gen_launches} times in generate's 64 steps")
    check(toks.shape == (LM_BATCH, 32) and bool(((toks >= 0)
                                                 & (toks < vocab)).all()),
          "generate tokens")
    step_logits, _ = model.decode(
        params, model.init_cache(LM_BATCH, 1, device=dev),
        torch.from_numpy(toks[:, :1]).to(dev))
    check(bool(torch.isfinite(step_logits).all()), "decode logits")
    head_diff = _lm_head_diff(torch, dev, params, cfg)

    prefill = make_prefill_step(cfg)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, vocab, (LM_BATCH, LM_PREFILL_S))).to(dev)}
    k4.launches = 0
    last = prefill(params, batch)
    torch.cuda.synchronize()
    pre_launches = k4.launches
    check(pre_launches == nl, f"K4 launched {pre_launches} times in one "
          f"prefill call of {nl} layers")
    check(tuple(last.shape) == (LM_BATCH, vocab)
          and bool(torch.isfinite(last).all()), "prefill logits")
    emit("lm_serve", config="rwkv6-7b CONFIG (32 layers, d=4096, bf16)",
         requests=len(done), batches=sched.stats["batches"],
         decode_steps=steps, k4_launches=dict(
             scheduler=sched_launches, generate=gen_launches,
             prefill=pre_launches, per_decode_step=sched_launches / steps),
         first_outputs=[r.output[:8] for r in done[:2]],
         lm_head_f32_out_vs_f32_cast=dict(max_abs_diff=head_diff,
                                          atol=LM_HEAD_ATOL),
         generate=dict(batch=LM_BATCH, prompt=32, new=32,
                       tokens_per_s_host=gstats.tokens_per_s,
                       prefill_s=gstats.prefill_s),
         prefill=dict(batch=LM_BATCH, seq=LM_PREFILL_S,
                      logits_abs_max=float(last.abs().max())))
    return sched_launches + gen_launches + pre_launches


def lm_ternary(torch, dev, k3, k4, model, params):
    """The full rwkv6-7b ternary-quantized on the card and served by
    generate at B=4 (prompt 8, 8 new tokens): K3 counted 8 launches per
    layer per decode step, K4 one."""
    from repro_torch.serving import (ServeConfig, generate,
                                     quantize_for_serving)
    t0 = time.perf_counter()
    q, stats = quantize_for_serving(params)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    nl, vocab = model.cfg.num_layers, model.cfg.vocab_size
    prompts = np.random.default_rng(SEED + 14).integers(2, vocab,
                                                        (LM_BATCH, 8))
    k3.launches = k4.launches = 0
    toks, gstats = generate(model, q, prompts, ServeConfig(max_new_tokens=8),
                            device=dev)
    launches = {"ternary_matmul": k3.launches, "wkv6_scan": k4.launches}
    steps = 8 + 8
    check(launches["ternary_matmul"] == 8 * nl * steps,
          f"K3 launched {launches['ternary_matmul']} times in {steps} "
          f"steps of {nl} layers")
    check(launches["wkv6_scan"] == nl * steps, f"K4 in ternary: {launches}")
    check(bool(((toks >= 0) & (toks < vocab)).all()), "ternary tokens")
    emit("lm_ternary", stats=stats, quantize_s=quant_s, launches=launches,
         decode_steps=steps, tokens=toks.tolist(),
         tokens_per_s_host=gstats.tokens_per_s,
         step_ms_host=gstats.decode_s * 1e3 / 8)
    return q, launches


def _k4_cost(b, t, h, hd, state):
    """Bytes (bf16 r/k/v/u and o, f32 logw, f32 state0/state out) and f32
    operations of one K4 call. Per (b, h, t) the recurrence needs
    5 hd^2 + 6 hd of them: r.S (2 hd^2), the state update w*S + k v^T
    (3 hd^2), and, since the bonus term diag(u) k v^T is rank one, the
    dot (r*u).k and its v-scaled add (5 hd) and exp(logw) (hd)."""
    n = b * t * h * hd
    nbytes = 2 * 3 * n + 4 * n + 2 * h * hd + 2 * n + 4 * b * h * hd * hd * (
        2 if state else 1)
    return nbytes, b * h * t * (5 * hd * hd + 6 * hd)


def _decode_rates(torch, serve_step, model, plist, dev, cache_len,
                  samples=DECODE_SAMPLES, steps=DECODE_STEPS,
                  batch=LM_BATCH):
    """Decode tokens/s of each weight set in ``plist`` through
    ``serve_step`` from a ``cache_len`` cache at ``batch``, whose samples
    are taken in turn, so that a drift of the host's speed during the run
    falls on each alike. Returns the rows and each set's (params, cache,
    token) after the run."""
    vocab = model.cfg.vocab_size
    states = []
    for p in plist:
        cache = model.init_cache(batch, cache_len, device=dev)
        tok = torch.ones((batch, 1), dtype=torch.long, device=dev)
        for _ in range(3):
            tok, cache = serve_step(p, cache, tok)
        states.append([p, cache, tok])
    rates = [[] for _ in plist]
    step_ms = [[] for _ in plist]
    for _ in range(samples):
        for st, rate, ms in zip(states, rates, step_ms):
            p, cache, tok = st
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                tok, cache = serve_step(p, cache, tok)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            st[1:] = cache, tok
            rate.append(batch * steps / dt)
            ms.append(dt * 1e3 / steps)
    for _, _, tok in states:
        check(bool(((tok >= 0) & (tok < vocab)).all()), "decode tokens")
    return [dict(tokens_per_s_median=statistics.median(rate),
                 tokens_per_s_min=min(rate), tokens_per_s_max=max(rate),
                 step_ms_median=statistics.median(ms), samples=samples,
                 steps_per_sample=steps, tokens_per_s_samples=rate)
            for rate, ms in zip(rates, step_ms)], [tuple(st)
                                                   for st in states]


def _decode_profile(torch, serve_step, st, step_ms):
    """Four decode steps from ``st`` = (params, cache, token) under the
    profiler, with K3's device ms a step."""
    p, cache, tok = st
    box = [cache, tok]

    def steps4():
        for _ in range(4):
            box[1], box[0] = serve_step(p, box[0], box[1])
    _, *trace = _trace(torch, steps4)
    fields = _trace_fields(*trace, 4, step_ms)
    fields["k3_device_ms_per_step"] = sum(
        ms for name, ms in trace[1].items()
        if "ternary_matmul" in name) / 4
    return fields


def _prefill_s(torch, prefill, params, batch, reps=3):
    """Seconds of a prefill call after a warm one (median of ``reps``, host
    clock ending in a synchronize), every sample, and the peak bytes
    allocated during one more call."""
    prefill(params, batch)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    prefill(params, batch)
    return statistics.median(times), times, torch.cuda.max_memory_allocated()


def lm_times(torch, dev, k3, k4, model, params, qparams):
    """K4 at the prefill (T=2048), T=256 and decode (T=1) calls and K3 at
    the LM's decode products, from a cold L2; decode and prefill tokens/s
    of the full model; a profile of decode steps."""
    from repro_torch.core.ternary import unpack2bit
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    g = torch.Generator().manual_seed(SEED + 13)
    flush = torch.ones(FLUSH_BYTES // 4, device=dev)
    bf16 = torch.bfloat16
    k4_rows = {}
    for name, t, state in (("prefill_T2048", LM_PREFILL_S, False),
                           ("T256", 256, False), ("decode_T1", 1, True)):
        r, k, v, lw, u, s0 = _wkv_inputs(torch, g, dev, LM_BATCH, t, 64, 64,
                                         bf16, state)
        run = lambda: k4.wkv6_scan_cuda(r, k, v, lw, u, s0)
        bound, by = _bound_ms(*_k4_cost(LM_BATCH, t, 64, 64, state))
        row = dict(ms=_device_ms(torch, run, flush),
                   warm_l2_ms=_warm_ms(torch, run),
                   call_ms=_call_ms(torch, run), bound_ms=bound,
                   bound_by=by, library_ms=None)
        if t <= 256:
            row["plain_ms"] = _device_ms(
                torch, lambda: k4.wkv6_scan_plain(r, k, v, lw, u, s0),
                flush, reps=3)
        k4_rows[name] = row
        del r, k, v, lw, u, s0
    # The fixed cost of any call under this harness, beside which K4's
    # decode call (bytes bound 2.57 us) is read.
    x1 = torch.zeros(1, device=dev)
    empty_call = dict(ms=_device_ms(torch, lambda: x1.add_(1), flush),
                      warm_l2_ms=_warm_ms(torch, lambda: x1.add_(1)),
                      what="x.add_(1) on one element")

    k3_rows, k3_prompt_rows, k3_err = {}, {}, 0.0
    for k, n in ((4096, 4096), (4096, 14336), (14336, 4096)):
        wp, scale = ops.pack_ternary_weights(torch.randn(k, n, generator=g))
        wp, scale = wp.to(dev), scale.to(dev)
        wq = unpack2bit(wp.t(), out_dtype=bf16).t().contiguous()
        for m, table in ((LM_BATCH, k3_rows), (LM_PROMPT_ROWS,
                                               k3_prompt_rows)):
            x = torch.randn(m, k, generator=g).to(bf16).to(dev)
            run = lambda: k3.ternary_matmul_cuda(x, wp, scale)
            want, got = k3.ternary_matmul_plain(x, wp, scale), run()
            check(bool(torch.equal(want, got)), f"K3 at M={m}, K={k}, "
                  f"N={n} differs from its plain version")
            k3_err = max(k3_err, _max_err([want], [got]))
            # bf16 x times ternary weights (exact in bf16) is a bf16
            # tensor-core product.
            bound, by = _bound_ms(2 * m * k + k // 4 * n + 4 * n
                                  + 2 * m * n, 2 * m * k * n,
                                  peak=H100_BF16_FLOPS)
            row = table[f"K{k}_N{n}"] = dict(
                ms=_device_ms(torch, run, flush),
                call_ms=_call_ms(torch, run),
                plain_ms=_device_ms(torch, lambda: k3.ternary_matmul_plain(
                    x, wp, scale), flush, reps=3),
                library_ms=_device_ms(torch, lambda: torch.matmul(x, wq),
                                      flush),
                bound_ms=bound, bound_by=by, path=_k3_path(k3, m, k, n))
            row["vs_library"] = row["ms"] / row["library_ms"]
    # The serial path at the rows of a prefill (B=4, S=2048), where the
    # plan takes it. The plain version (seconds a call here) is held
    # against the first and last 8 rows and not timed.
    m, k, n = LM_BATCH * LM_PREFILL_S, 14336, 4096
    wp, scale = ops.pack_ternary_weights(torch.randn(k, n, generator=g))
    wp, scale = wp.to(dev), scale.to(dev)
    wq = unpack2bit(wp.t(), out_dtype=bf16).t().contiguous()
    x = torch.randn(m, k, generator=g).to(bf16).to(dev)
    run = lambda: k3.ternary_matmul_cuda(x, wp, scale)
    got = run()
    want = k3.ternary_matmul_plain(torch.cat([x[:8], x[-8:]]), wp, scale)
    check(bool(torch.equal(want, torch.cat([got[:8], got[-8:]]))),
          f"K3 at M={m}, K={k}, N={n} differs from its plain version")
    bound, by = _bound_ms(2 * m * k + k // 4 * n + 4 * n + 2 * m * n,
                          2 * m * k * n, peak=H100_BF16_FLOPS)
    k3_prefill = dict(
        shape=[m, k, n], ms=_device_ms(torch, run, flush, reps=5),
        call_ms=_call_ms(torch, run, reps=5),
        library_ms=_device_ms(torch, lambda: torch.matmul(x, wq), flush,
                              reps=5),
        bound_ms=bound, bound_by=by, path=_k3_path(k3, m, k, n),
        plain="held against the first and last 8 rows, not timed")
    k3_prefill["vs_library"] = k3_prefill["ms"] / k3_prefill["library_ms"]
    check(k3_prefill["path"]["path"] == "serial",
          f"K3's prefill rows took {k3_prefill['path']}")
    del flush, x, got, wq
    emit("lm_kernel_times", batch=LM_BATCH, heads=64, head_dim=64,
         k4_dtypes="bf16 r/k/v/u/o, f32 logw, f32 state",
         unit="ms of device time per call from a cold L2 (CUDA graph of "
              "one call, CUDA events, median); warm_l2_ms: inputs left in "
              "L2 by the call before; call_ms: one call timed from the host",
         k4=k4_rows, k4_library="none (no single call)",
         empty_call=empty_call,
         k3_decode_M4_bf16=k3_rows, k3_prompt_M32_bf16=k3_prompt_rows,
         k3_prefill_bf16=k3_prefill,
         k3_vs_plain="bitwise",
         k3_max_abs_err=k3_err,
         k3_library_note="torch.matmul of bf16 x with the unpacked bf16 "
                         "weights (no scale): the yardstick only; "
                         "vs_library = ms / library_ms")

    serve_step = make_serve_step(model.cfg)
    vocab = model.cfg.vocab_size

    (fp, tern), (state, _) = _decode_rates(
        torch, serve_step, model, [params, qparams], dev, 64)

    prefill = make_prefill_step(model.cfg)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(
        SEED + 15).integers(0, vocab, (LM_BATCH, LM_PREFILL_S))).to(dev)}
    pre_s, times, peak = _prefill_s(torch, prefill, params, batch)

    emit("lm_end_to_end", batch=LM_BATCH,
         metric="host clock ending in torch.cuda.synchronize",
         decode_bf16=fp, decode_ternary=tern,
         ternary_vs_bf16_tokens_per_s=(tern["tokens_per_s_median"]
                                       / fp["tokens_per_s_median"]),
         ternary_vs_bf16_paired_median=statistics.median(
             t / f for t, f in zip(tern["tokens_per_s_samples"],
                                   fp["tokens_per_s_samples"])),
         prefill=dict(seq=LM_PREFILL_S, s_median=pre_s, s_all=times,
                      tokens_per_s=LM_BATCH * LM_PREFILL_S / pre_s,
                      peak_memory_gb=peak / 1e9),
         decode_profile=_decode_profile(torch, serve_step, state,
                                        fp["step_ms_median"]))
    return k4_rows, k3_err


def lm_slice(torch, dev, k3, k4):
    """Phase 7 end to end; returns the launches, errors and times the
    ``kernels`` line needs."""
    from repro_torch.configs.rwkv6_7b import CONFIG
    from repro_torch.models import build_model
    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    err = timed("k4_checks", k4_checks, torch, dev, k4)
    timed("lm_vs_cpu", lm_depth_cut, torch, dev, k3)
    torch.cuda.empty_cache()

    model = build_model(CONFIG)
    t0 = time.perf_counter()
    params = _lm_params(torch, model, SEED + 16, dev)
    torch.cuda.synchronize()
    emit("lm_params", config="rwkv6-7b CONFIG", params=model.num_params(),
         analytic=CONFIG.param_count(), init_s=time.perf_counter() - t0,
         memory_gb=torch.cuda.memory_allocated() / 1e9)
    k4_launches = timed("lm_serve", lm_serve, torch, dev, k4, model, params)
    qparams, tern = timed("lm_ternary", lm_ternary, torch, dev, k3, k4,
                          model, params)
    k4_rows, k3_err = timed("lm_times", lm_times, torch, dev, k3, k4, model,
                            params, qparams)
    dryrun = timed("dryrun_decode", dryrun_decode, torch, dev, k3, k4, model,
                   {"bf16": params, "ternary": qparams})
    dryrun_s = seconds["dryrun_decode"]
    emit("lm_slice_seconds", **seconds)
    del params, qparams
    torch.cuda.empty_cache()
    dec = k4_rows["decode_T1"]
    return {"launches": {"wkv6_scan": k4_launches,
                         "ternary_matmul": tern["ternary_matmul"]},
            "max_abs_err": {"wkv6_scan": err, "ternary_matmul": k3_err},
            "dryrun": {"steps": dryrun, "seconds": dryrun_s},
            "times": {"wkv6_scan": {key: dec[key] for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}}}


# ----------------------------------------------------------------------
# Phase 10: the transformer families -- llama3.2-1b served in bf16 and in
# ternary weights (K3 on its MLP projections), deepseek-moe-16b and
# qwen2-vl-2b.
# ----------------------------------------------------------------------

TF_CUT_LAYERS = 2            # depth of the f32 comparisons with the CPU
TF_MOE_LAYERS = 4            # deepseek-moe-16b in (d): 2.77 B parameters
# f32 logits on the card against the CPU, as LM_LOGITS_ATOL: cuBLAS and
# the CPU's BLAS sum the products in other orders, and exp, cos and sin
# round differently (~1e-5 expected); a wrong term moves logits by O(0.1).
TF_LOGITS_ATOL = 1e-3
TF_CPU_SEQ = 64              # tokens of the f32 forward on both devices
TF_DECODE_CACHE = 512        # a decode-rate run stays inside its cache
TF_SYNC_STEPS = 4            # decode steps under the sync debug mode
TF_DECODE_SAMPLES = 3        # llama3.2-1b's decode-rate pairs (bf16, K3)
# K3 at the products the slice serves: (name, K, N); each at decode rows
# (M = LM_BATCH, the split path) and prefill rows (M = LM_BATCH *
# LM_PREFILL_S, the serial path). K = 8960 and 2816 end in a short
# 512-k segment.
TF_K3_SHAPES = (("llama3.2-1b_gate_up", 2048, 8192),
                ("llama3.2-1b_down", 8192, 2048),
                ("qwen2-vl-2b_down", 8960, 1536),
                ("deepseek-moe-16b_shared_down", 2816, 2048))


def _tf_full():
    """What ``transformer_phase`` serves: llama3.2-1b at full width and
    depth, deepseek-moe-16b at full width and TF_MOE_LAYERS layers,
    qwen2-vl-2b at full width and depth; B=4, prefill S=2048."""
    import dataclasses
    from repro_torch.configs import get_config
    return dict(
        llama=get_config("llama3.2-1b"),
        moe=dataclasses.replace(get_config("deepseek-moe-16b"),
                                num_layers=TF_MOE_LAYERS),
        vlm=get_config("qwen2-vl-2b"), batch=LM_BATCH, seq=LM_PREFILL_S,
        cpu_seq=TF_CPU_SEQ, cache=TF_DECODE_CACHE,
        decode=(TF_DECODE_SAMPLES, DECODE_STEPS),
        k3_shapes=TF_K3_SHAPES)


def _tf_batch(torch, cfg, b, s, seed, dev):
    """Prefill inputs: tokens, and for the VLM patch embeddings in the
    first quarter of the sequence (as the JAX package's input_specs)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                   (b, s))).to(dev)}
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.from_numpy(rng.normal(
            size=(b, max(s // 4, 16), cfg.d_model)).astype(
                np.float32)).to(dev)
    return out


def _no_sync(torch, fn, on_card):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``: None
    if it ran without a host sync, else the error's text."""
    if not on_card:
        fn()
        return None
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        fn()
        return None
    except RuntimeError as e:
        return str(e)[:300]
    finally:
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()


def tf_k3_checks(torch, dev, k3, full, phase="tf_k3_vs_plain",
                 seed=SEED + 20):
    """(a) K3 against its plain version on the card, bit for bit, at the
    products of this slice: llama3.2-1b's gate/up (K 2048, N 8192) and
    down (K 8192, N 2048), qwen2-vl-2b's down (K 8960) and
    deepseek-moe-16b's shared-expert down (K 2816), each at decode rows
    (split path) and prefill rows (serial path), called twice and its
    last row alone. Times each from a cold L2 beside torch.matmul of the
    unpacked bf16 weights and the bound; the plain version is timed at
    decode rows only (seconds a call at prefill rows). A shape given as
    (name, K, N, rows) runs at those rows only; a shape run at more than
    one row count must take both paths."""
    from repro_torch.core.ternary import unpack2bit
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(seed)
    flush = torch.ones(FLUSH_BYTES // 4, device=dev)
    bf16 = torch.bfloat16
    rows, times, err = [], {}, 0.0
    for name, k, n, *counts in full["k3_shapes"]:
        counts = (counts[0] if counts
                  else (full["batch"], full["batch"] * full["seq"]))
        wp, scale = ops.pack_ternary_weights(torch.randn(k, n, generator=g))
        wp, scale = wp.to(dev), scale.to(dev)
        wq = unpack2bit(wp.t(), out_dtype=bf16).t().contiguous()
        for m in counts:
            x = torch.randn(m, k, generator=g).to(bf16).to(dev)
            want = k3.ternary_matmul_plain(x, wp, scale)
            got = k3.ternary_matmul_cuda(x, wp, scale)
            again = k3.ternary_matmul_cuda(x, wp, scale)
            one = k3.ternary_matmul_cuda(x[m - 1:].contiguous(), wp, scale)
            torch.cuda.synchronize()
            ok = dict(plain=bool(torch.equal(want, got)),
                      repeat=bool(torch.equal(again, got)),
                      b1_rows=bool(torch.equal(one[0], got[m - 1])))
            err = max(err, _max_err([want], [got]))
            path = _k3_path(k3, m, k, n)
            rows.append(dict(name=name, shape=[m, k, n],
                             segments=k / k3.KS, **path, **ok))
            check(all(ok.values()), f"K3 {name} at M={m}: {ok}")
            del want, again, one
            run = lambda: k3.ternary_matmul_cuda(x, wp, scale)
            reps = REPS if m <= LM_PROMPT_ROWS else 5
            bound, by = _bound_ms(2 * m * k + k // 4 * n + 4 * n + 2 * m * n,
                                  2 * m * k * n, peak=H100_BF16_FLOPS)
            row = times[f"{name}_M{m}"] = dict(
                shape=[m, k, n], path=path["path"],
                ms=_device_ms(torch, run, flush, reps=reps),
                library_ms=_device_ms(torch, lambda: torch.matmul(x, wq),
                                      flush, reps=reps),
                bound_ms=bound, bound_by=by)
            if m <= LM_PROMPT_ROWS:
                row["plain_ms"] = _device_ms(
                    torch, lambda: k3.ternary_matmul_plain(x, wp, scale),
                    flush, reps=3)
            row["vs_library"] = row["ms"] / row["library_ms"]
            del x, got
        check(len(counts) == 1 or {r["path"] for r in rows if r["name"] == name}
              == {"split", "serial"}, f"K3 {name} must take both paths")
    del flush
    emit(phase, tolerance="bitwise", segment=k3.KS,
         checks=rows, max_abs_err=err, times=times,
         unit="ms of device time a call from a cold L2 (median); "
              "library: torch.matmul of bf16 x with the unpacked bf16 "
              "weights; bound: bf16 tensor-core rate or HBM bytes")
    return err, times


def _tf_pair(torch, model, seed, dev):
    """f32 parameters drawn on ``dev`` from a seeded generator, and the
    same values on the CPU."""
    from repro_torch.models.params import tree_map
    gpu = model.init(torch.Generator(device=dev).manual_seed(seed),
                     device=dev)
    return gpu, tree_map(lambda x: x.cpu(), gpu)


def tf_vs_cpu(torch, dev, k3, full):
    """(b) Each family at full width, cut to TF_CUT_LAYERS layers, in f32:
    the card against the port's CPU run. llama3.2-1b: Model.apply logits
    (B=2, S=TF_CPU_SEQ), decode stepped over an 8-token prompt, greedy
    generate (8 new tokens), and the ternary model (the card packs the
    CPU's bytes; greedy tokens equal; K3 counted, 3 a layer a step);
    deepseek-moe-16b: logits, and every layer's chosen experts and kept
    (token, choice) pairs equal; qwen2-vl-2b with patch embeddings:
    logits."""
    import dataclasses
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.serving import (ServeConfig, generate,
                                     quantize_for_serving)
    cut, out, cpu_seq = TF_CUT_LAYERS, {}, full["cpu_seq"]
    for fam in ("llama", "moe", "vlm"):
        cfg = dataclasses.replace(full[fam], num_layers=cut,
                                  dtype="float32")
        model = build_model(cfg)
        gpu, cpu = _tf_pair(torch, model, SEED + 21, dev)
        nb = _tf_batch(torch, cfg, 2, cpu_seq, SEED + 22, "cpu")
        routes = []
        real_route = L.moe_route

        def recorder(*args, **kw):
            r = real_route(*args, **kw)
            routes.append({key: r[key].cpu() for key in (
                "gate_idx", "keep", "probs")})
            return r
        L.moe_route = recorder
        try:
            lg = model.apply(gpu, {k: v.to(dev) for k, v in nb.items()})[0]
            lc = model.apply(cpu, nb)[0]
        finally:
            L.moe_route = real_route
        row = dict(config=f"{cfg.name} widths, num_layers={cut}, float32",
                   apply_shape=[2, cpu_seq],
                   apply_logits_max_abs_diff=float(
                       (lg.cpu() - lc).abs().max()),
                   logits_std=float(lc.std()))
        check(row["apply_logits_max_abs_diff"] <= TF_LOGITS_ATOL,
              f"{fam} apply logits: {row['apply_logits_max_abs_diff']}")
        del lg, lc
        if fam == "moe":
            card, host = routes[:cut], routes[cut:]
            row["gate_idx_equal"] = all(torch.equal(a["gate_idx"],
                                                    b["gate_idx"])
                                        for a, b in zip(card, host))
            row["keep_equal"] = all(torch.equal(a["keep"], b["keep"])
                                    for a, b in zip(card, host))
            top = [torch.sort(r["probs"], dim=-1, descending=True).values
                   for r in host]
            row["min_kth_gap"] = min(float(
                (t[..., cfg.top_k - 1] - t[..., cfg.top_k]).min())
                for t in top)
            row["kept_fraction"] = [float(r["keep"].float().mean())
                                    for r in host]
            check(row["gate_idx_equal"] and row["keep_equal"],
                  f"moe routing differs: {row}")
        if fam == "llama":
            prompt = nb["tokens"][:, :8].numpy()
            cg = model.init_cache(2, 16, device=dev)
            cc = model.init_cache(2, 16, device="cpu")
            dec = 0.0
            for i in range(prompt.shape[1]):
                t = torch.from_numpy(prompt[:, i:i + 1])
                a, cg = model.decode(gpu, cg, t.to(dev))
                b, cc = model.decode(cpu, cc, t)
                dec = max(dec, float((a.cpu() - b).abs().max()))
            row["decode_logits_max_abs_diff"] = dec
            check(dec <= TF_LOGITS_ATOL, f"llama decode logits: {dec}")
            sc = ServeConfig(max_new_tokens=8)
            tg, _ = generate(model, gpu, prompt, sc, device=dev)
            tc, _ = generate(model, cpu, prompt, sc, device="cpu")
            row.update(greedy_tokens_equal=bool(np.array_equal(tg, tc)),
                       greedy_min_top2_gap=_greedy_gaps(
                           torch, model, gpu, prompt, tg, dev),
                       tokens_card=tg.tolist())
            check(row["greedy_tokens_equal"], f"greedy {tg} vs {tc}")
            qg, stats_g = quantize_for_serving(gpu)
            qc, stats_c = quantize_for_serving(cpu)
            names = ("w_gate", "w_up", "w_down")
            same = sum(int((qg["layers"]["mlp"][n]["packed"].cpu()
                            == qc["layers"]["mlp"][n]["packed"]).sum())
                       for n in names) / sum(
                qc["layers"]["mlp"][n]["packed"].numel() for n in names)
            qprompt, qsc = prompt[:, :4], ServeConfig(max_new_tokens=6)
            k3.launches = 0
            qtg, _ = generate(model, qg, qprompt, qsc, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            launches = k3.launches
            qtc, _ = generate(model, qc, qprompt, qsc, device="cpu")
            steps = qprompt.shape[1] + qsc.max_new_tokens
            row.update(ternary_stats_equal=stats_g == stats_c,
                       ternary_stats=stats_g,
                       ternary_packed_equal_fraction=same,
                       ternary_tokens_equal=bool(np.array_equal(qtg, qtc)),
                       ternary_k3_launches=launches,
                       ternary_decode_steps=steps)
            check(stats_g == stats_c and stats_g["quantized"] == 3,
                  f"ternary stats {stats_g} vs {stats_c}")
            check(same == 1.0, f"the card packed {same} of the CPU's bytes")
            check(row["ternary_tokens_equal"], f"ternary {qtg} vs {qtc}")
            if dev.type == "cuda":
                check(launches == 3 * cut * steps,
                      f"K3 launched {launches} times in {steps} steps")
            del qg, qc
        out[fam] = row
        del gpu, cpu
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    emit("tf_vs_cpu", tolerance=dict(logits_atol=TF_LOGITS_ATOL,
                                     tokens="equal", routing="equal"),
         **out)


def _tf_params(torch, model, seed, dev):
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return params


def tf_llama(torch, dev, k3, full):
    """(c) llama3.2-1b at full width and depth in bf16, as a user serves
    it: BatchScheduler over requests built as launch/serve.py builds them
    (B=4), then the ternary model through generate with K3 counted (3
    launches a layer a decode step, 48 in all) and one ternary prefill
    (48 launches); no host sync inside a bf16 or ternary decode step;
    decode tokens/s with bf16 and ternary samples in turn; prefill
    tokens/s at B=4, S=2048 in each; a profile of decode steps (busy
    share, host launches); memory. Returns K3's launches in this run."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import build_model
    from repro_torch.serving import (BatchScheduler, Request, ServeConfig,
                                     generate, quantize_for_serving)
    cfg = full["llama"]
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    nl, vocab, b = cfg.num_layers, cfg.vocab_size, full["batch"]
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = _tf_params(torch, model, SEED + 23, dev)
    report = dict(config=f"{cfg.name} CONFIG ({nl} layers, d={cfg.d_model}, "
                         f"{cfg.dtype})", params=model.num_params(),
                  analytic=cfg.param_count(),
                  init_s=time.perf_counter() - t0)
    if on_card:
        report["params_gb"] = torch.cuda.memory_allocated() / 1e9

    rng = np.random.default_rng(0)
    reqs = [Request(id=i, prompt=rng.integers(
                2, vocab, size=rng.integers(2, LM_PROMPT + 1)),
                max_new_tokens=LM_NEW) for i in range(LM_SERVE_REQUESTS)]
    sched = BatchScheduler(model, params, max_batch=b,
                           cache_len=LM_PROMPT + LM_NEW + 1, device=dev)
    done = sched.run(reqs)
    check(all(len(r.output) == LM_NEW and all(0 <= t < vocab
                                              for t in r.output)
              for r in done), "scheduler outputs")
    report["scheduler"] = dict(requests=len(done),
                               batches=sched.stats["batches"],
                               decode_steps=sched.stats["decode_steps"],
                               first_outputs=[r.output[:8]
                                              for r in done[:2]])

    t0 = time.perf_counter()
    q, stats = quantize_for_serving(params)
    sync()
    report["ternary"] = dict(stats=stats, quantize_s=time.perf_counter() - t0)
    check(stats["quantized"] == 3, f"ternary stats {stats}")
    prompts = np.random.default_rng(SEED + 24).integers(2, vocab, (b, 8))
    k3.launches = 0
    toks, gstats = generate(model, q, prompts, ServeConfig(max_new_tokens=8),
                            device=dev)
    sync()
    gen_launches, steps = k3.launches, 8 + 8
    report["ternary"].update(generate_k3_launches=gen_launches,
                             decode_steps=steps,
                             per_decode_step=gen_launches / steps,
                             tokens=toks.tolist())
    check(not on_card or gen_launches == 3 * nl * steps,
          f"K3 launched {gen_launches} times in {steps} ternary steps")

    serve_step = make_serve_step(cfg)
    sync_errors = {}
    for name, p in (("bf16", params), ("ternary", q)):
        cache = model.init_cache(b, full["cache"], device=dev)
        tok = torch.ones((b, 1), dtype=torch.long, device=dev)
        tok, cache = serve_step(p, cache, tok)
        box = [tok, cache]

        def steps_fn():
            for _ in range(TF_SYNC_STEPS):
                box[0], box[1] = serve_step(p, box[1], box[0])
        sync_errors[name] = _no_sync(torch, steps_fn, on_card)
    report["decode_no_host_sync"] = sync_errors
    check(all(e is None for e in sync_errors.values()),
          f"a decode step synchronized: {sync_errors}")

    prefill = make_prefill_step(cfg)
    batch = _tf_batch(torch, cfg, b, full["seq"], SEED + 25, dev)
    k3.launches = 0
    last = prefill(q, batch)
    sync()
    pre_launches = k3.launches
    check(not on_card or pre_launches == 3 * nl,
          f"K3 launched {pre_launches} times in a ternary prefill")
    check(tuple(last.shape) == (b, vocab)
          and bool(torch.isfinite(last).all()), "ternary prefill logits")
    report["ternary"]["prefill_k3_launches"] = pre_launches
    launches = gen_launches + pre_launches
    if not on_card:
        emit("tf_llama", **report)
        return launches

    (fp, tern), (state, tstate) = _decode_rates(
        torch, serve_step, model, [params, q], dev, full["cache"],
        *full["decode"], batch=b)
    pre = {}
    for name, p in (("bf16", params), ("ternary", q)):
        s_med, s_all, peak = _prefill_s(torch, prefill, p, batch)
        pre[name] = dict(s_median=s_med, s_all=s_all,
                         tokens_per_s=b * full["seq"] / s_med,
                         peak_memory_gb=peak / 1e9)
    torch.cuda.reset_peak_memory_stats()
    serve_step(params, state[1], state[2])
    torch.cuda.synchronize()
    report.update(
        decode_bf16=fp, decode_ternary=tern,
        ternary_vs_bf16_paired_median=statistics.median(
            t / f for t, f in zip(tern["tokens_per_s_samples"],
                                  fp["tokens_per_s_samples"])),
        decode_cache_len=full["cache"],
        decode_step_peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        prefill=dict(batch=b, seq=full["seq"], **pre),
        decode_profile=_decode_profile(torch, serve_step, state,
                                       fp["step_ms_median"]),
        decode_ternary_profile=_decode_profile(torch, serve_step, tstate,
                                               tern["step_ms_median"]))
    emit("tf_llama", metric="host clock ending in torch.cuda.synchronize",
         **report)
    return launches


def tf_others(torch, dev, k3, full):
    """(d) deepseek-moe-16b (TF_MOE_LAYERS layers) and qwen2-vl-2b (full
    depth) at full width in bf16: decode at B=4 (tokens/s, no host
    sync), one prefill at B=4, S=2048 (with patch embeddings for the
    VLM), and a few ternary decode steps with K3 counted (3 a layer a
    step: the MoE's shared experts, the VLM's MLP). Returns K3's
    launches."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import build_model
    from repro_torch.serving import quantize_for_serving
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    b, out, launches = full["batch"], {}, 0
    for fam, cut in (("moe", f"depth cut to {TF_MOE_LAYERS} of 28 layers"),
                     ("vlm", "full depth")):
        cfg = full[fam]
        nl = cfg.num_layers
        model = build_model(cfg)
        params = _tf_params(torch, model, SEED + 26, dev)
        row = dict(config=f"{cfg.name} ({nl} layers, d={cfg.d_model}, "
                          f"{cfg.dtype}; {cut})",
                   params=model.num_params())
        if on_card:
            row["params_gb"] = torch.cuda.memory_allocated() / 1e9
        serve_step = make_serve_step(cfg)
        cache = model.init_cache(b, full["cache"], device=dev)
        tok = torch.ones((b, 1), dtype=torch.long, device=dev)
        tok, cache = serve_step(params, cache, tok)
        box = [tok, cache]

        def steps_fn():
            for _ in range(TF_SYNC_STEPS):
                box[0], box[1] = serve_step(params, box[1], box[0])
        row["decode_no_host_sync"] = _no_sync(torch, steps_fn, on_card)
        check(row["decode_no_host_sync"] is None,
              f"{cfg.name} decode synchronized: {row}")
        q, stats = quantize_for_serving(params)
        k3.launches = 0
        qcache = model.init_cache(b, full["cache"], device=dev)
        qtok = torch.ones((b, 1), dtype=torch.long, device=dev)
        for _ in range(TF_SYNC_STEPS):
            qtok, qcache = serve_step(q, qcache, qtok)
        sync()
        row["ternary"] = dict(stats=stats, k3_launches=k3.launches,
                              decode_steps=TF_SYNC_STEPS)
        check(stats["quantized"] == 3, f"{cfg.name} ternary stats {stats}")
        check(not on_card or k3.launches == 3 * nl * TF_SYNC_STEPS,
              f"{cfg.name}: K3 launched {k3.launches} times")
        launches += k3.launches
        del q, qcache
        prefill = make_prefill_step(cfg)
        batch = _tf_batch(torch, cfg, b, full["seq"], SEED + 27, dev)
        last = prefill(params, batch)
        check(tuple(last.shape) == (b, cfg.vocab_size)
              and bool(torch.isfinite(last).all()), f"{cfg.name} prefill")
        if on_card:
            samples, steps = full["decode"]
            (rate,), _ = _decode_rates(torch, serve_step, model, [params],
                                       dev, full["cache"], samples // 2,
                                       steps, batch=b)
            s_med, s_all, peak = _prefill_s(torch, prefill, params, batch,
                                            reps=1)
            row.update(decode=rate, prefill=dict(
                batch=b, seq=full["seq"], s=s_med,
                tokens_per_s=b * full["seq"] / s_med,
                peak_memory_gb=peak / 1e9))
        out[fam] = row
        del params, batch, last, cache, box
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    emit("tf_others", **out)
    return launches


def transformer_phase(torch, dev, k3):
    """Phase 10 end to end: (a) K3 at this slice's products, (b) each
    family on the card against the CPU, (c) llama3.2-1b served, (d)
    deepseek-moe-16b and qwen2-vl-2b served. Returns the launches,
    errors and times the ``kernels`` line needs."""
    full = _tf_full()
    seconds = {}
    t0 = time.perf_counter()
    err, times = tf_k3_checks(torch, dev, k3, full)
    seconds["a_k3"] = time.perf_counter() - t0
    tf_vs_cpu(torch, dev, k3, full)
    seconds["b_vs_cpu"] = time.perf_counter() - t0 - sum(seconds.values())
    launches = tf_llama(torch, dev, k3, full)
    torch.cuda.empty_cache()
    seconds["c_llama"] = time.perf_counter() - t0 - sum(seconds.values())
    launches += tf_others(torch, dev, k3, full)
    seconds["d_others"] = time.perf_counter() - t0 - sum(seconds.values())
    emit("tf_phase", seconds=time.perf_counter() - t0, by_part=seconds,
         k3_launches=launches)
    return {"launches": launches, "max_abs_err": err, "times": times}



# ----------------------------------------------------------------------
# Phase 11: the hybrid and enc-dec families -- zamba2-1.2b (Mamba-2 layers
# and one weight-shared attention block) and seamless-m4t-medium, served
# in bf16 and in ternary weights (K3 on their projections).
# ----------------------------------------------------------------------

HY_ZAMBA_CUT = 7             # stages (0, 6) and (6, 7): two shared-block
#                              invocations, the second after one layer
HY_ENCDEC_CUT = 2            # encoder and decoder layers of the f32 check
HY_CPU_SEQ = 128             # two 64-token SSD chunks; <= one kv_chunk
# The chunked SSD scan against its stepwise form on the card: the JAX
# package's own tolerance for that check (tests/test_models.py): f32
# exp/cumsum and the sums of two algorithms an ulp apart.
HY_SSD_TOL = 1e-4
HY_RING_STEPS = 40           # SMOKE zamba2 decode steps into its 16-slot ring
HY_ENC_FRAMES = 512          # encoder frames of seamless's served requests
HY_GREEDY_STEPS = 32
# K3 at this slice's products: (name, K, N[, rows]); zamba2's at decode
# rows (split path) and prefill rows (serial path), seamless's at decode
# rows (its prefill's encoder takes float weights, as in the JAX package).
HY_K3_SHAPES = (("zamba2-1.2b_in_proj", 2048, 8384),
                ("zamba2-1.2b_out_proj", 4096, 2048),
                ("seamless-m4t-medium_w_up", 1024, 4096, (LM_BATCH,)),
                ("seamless-m4t-medium_w_down", 4096, 1024, (LM_BATCH,)),
                ("seamless-m4t-medium_frontend_proj", 1024, 1024,
                 (LM_BATCH,)))


def _hy_full():
    """What ``hybrid_phase`` serves: zamba2-1.2b and seamless-m4t-medium
    at full width and depth; B=4, prefill S=2048."""
    from repro_torch.configs import get_config
    return dict(
        zamba=get_config("zamba2-1.2b"),
        zamba_smoke=get_config("zamba2-1.2b", smoke=True),
        seamless=get_config("seamless-m4t-medium"), batch=LM_BATCH,
        seq=LM_PREFILL_S, cpu_seq=HY_CPU_SEQ, cache=TF_DECODE_CACHE,
        decode=(TF_DECODE_SAMPLES, DECODE_STEPS), k3_shapes=HY_K3_SHAPES,
        zamba_cut=HY_ZAMBA_CUT, encdec_cut=HY_ENCDEC_CUT,
        enc_frames=HY_ENC_FRAMES, greedy=HY_GREEDY_STEPS,
        ring_steps=HY_RING_STEPS)


def _hy_zamba_params(torch, model, seed, dev):
    """zamba2 parameters drawn on ``dev`` by ``model.init``, with the
    per-head ``a_log``, ``dt_bias``, ``d_skip`` and the conv bias drawn
    from a numpy seed (their inits are constants)."""
    params = model.init(torch.Generator(device=dev).manual_seed(seed),
                        device=dev)
    rng = np.random.default_rng(seed)
    layers = params["layers"]
    for name, scale in (("a_log", 0.5), ("dt_bias", 0.5), ("d_skip", 1.0),
                        ("conv_b", 0.1)):
        t = layers[name]
        layers[name] = torch.from_numpy(
            (rng.normal(size=tuple(t.shape)) * scale).astype(
                np.float32)).to(dtype=t.dtype, device=dev)
    return params


def _hy_k3_per_step(cfg):
    """K3 launches a ternary decode step (and a ternary prefill): two a
    Mamba-2 layer and three a shared-block invocation (zamba2), two a
    decoder layer (enc-dec)."""
    from repro_torch.models import zamba2
    if cfg.family == "zamba2":
        return 2 * cfg.num_layers + 3 * len(zamba2._stage_bounds(cfg))
    return 2 * cfg.decoder_layers


def _packed_equal(torch, qa, qb, paths):
    """The fraction of equal packed bytes over the leaves at ``paths``."""
    same = total = 0
    for path in paths:
        a, b = qa, qb
        for key in path:
            a, b = a[key], b[key]
        same += int((a["packed"].cpu() == b["packed"].cpu()).sum())
        total += a["packed"].numel()
    return same / total


def hy_ssd(torch, dev, full):
    """``mamba2_chunked`` on the card at zamba2-1.2b's widths (H, P, N =
    64, S = 2048 at B=4, the model's chunk of 64) against the port's
    stepwise form (``_mamba_step``) on the same inputs, on the card; and
    the chunked call's time."""
    from repro_torch.models import zamba2 as Z
    cfg = full["zamba"]
    b, s = full["batch"], full["seq"]
    h, p, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    rng = np.random.default_rng(SEED + 30)

    def arr(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    x = arr(rng.normal(size=(b, s, h, p)))
    dt = arr(np.log1p(np.exp(rng.normal(size=(b, s, h)))))
    a = arr(-np.exp(rng.normal(size=(h,)) * 0.3))
    b_in, c_in = arr(rng.normal(size=(b, s, n))), arr(rng.normal(
        size=(b, s, n)))
    chunk = min(cfg.chunk_size * 2, s)
    y, st = Z.mamba2_chunked(x, dt, a, b_in, c_in, chunk=chunk)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=dev)
    ys = []
    for t in range(s):
        yt, state = Z._mamba_step(x[:, t], dt[:, t], a, b_in[:, t],
                                  c_in[:, t], state)
        ys.append(yt)
    y_step = torch.stack(ys, 1)
    row = dict(shape=dict(b=b, s=s, h=h, p=p, n=n, chunk=chunk),
               y_max_abs_diff=float((y - y_step).abs().max()),
               state_max_abs_diff=float((st - state).abs().max()),
               y_max_abs=float(y_step.abs().max()),
               state_max_abs=float(state.abs().max()))
    ok = (bool(((y - y_step).abs() <= HY_SSD_TOL * (1 + y_step.abs()))
               .all())
          and bool(((st - state).abs() <= HY_SSD_TOL * (1 + state.abs()))
                   .all()))
    check(ok, f"SSD chunked vs stepwise: {row}")
    if dev.type == "cuda":
        row["chunked_ms"] = _call_ms(
            torch, lambda: Z.mamba2_chunked(x, dt, a, b_in, c_in,
                                            chunk=chunk), reps=5)
    emit("hy_ssd", tolerance=dict(rtol=HY_SSD_TOL, atol=HY_SSD_TOL), **row)


def _hy_decode_diff(torch, model, gpu, cpu, cg, cc, tokens, dev):
    """Steps both caches over ``tokens`` (B, T); the largest logit
    difference."""
    worst = 0.0
    for i in range(tokens.shape[1]):
        t = torch.from_numpy(tokens[:, i:i + 1])
        a, cg = model.decode(gpu, cg, t.to(dev))
        b, cc = model.decode(cpu, cc, t)
        worst = max(worst, float((a.cpu() - b).abs().max()))
    return worst


def _hy_greedy_and_ternary(torch, dev, k3, model, gpu, cpu, prompt, row,
                           paths, ternary_tokens):
    """Greedy tokens of the card and the CPU (8 new), then the ternary
    model: the card packs the CPU's bytes at ``paths``, greedy tokens
    equal over ``ternary_tokens`` = (prompt, new) tokens, K3 counted on
    the card. (K3's plain version on the CPU walks every k of every
    product: a ternary zamba2 step at 7 layers takes seconds there.)"""
    from repro_torch.serving import (ServeConfig, generate,
                                     quantize_for_serving)
    cfg = model.cfg
    sc = ServeConfig(max_new_tokens=8)
    tg, _ = generate(model, gpu, prompt, sc, device=dev)
    tc, _ = generate(model, cpu, prompt, sc, device="cpu")
    row.update(greedy_tokens_equal=bool(np.array_equal(tg, tc)),
               greedy_min_top2_gap=_greedy_gaps(torch, model, gpu, prompt,
                                                tg, dev),
               tokens_card=tg.tolist())
    check(row["greedy_tokens_equal"], f"{cfg.name} greedy {tg} vs {tc}")
    qg, stats_g = quantize_for_serving(gpu)
    qc, stats_c = quantize_for_serving(cpu)
    same = _packed_equal(torch, qg, qc, paths)
    qprompt = prompt[:, :ternary_tokens[0]]
    qsc = ServeConfig(max_new_tokens=ternary_tokens[1])
    k3.launches = 0
    qtg, _ = generate(model, qg, qprompt, qsc, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = k3.launches
    qtc, _ = generate(model, qc, qprompt, qsc, device="cpu")
    steps = qprompt.shape[1] + qsc.max_new_tokens
    row.update(ternary_stats=stats_g, ternary_packed_equal_fraction=same,
               ternary_tokens_equal=bool(np.array_equal(qtg, qtc)),
               ternary_k3_launches=launches, ternary_decode_steps=steps)
    check(stats_g == stats_c and stats_g["quantized"] == len(paths),
          f"{cfg.name} ternary stats {stats_g} vs {stats_c}")
    check(same == 1.0, f"the card packed {same} of the CPU's bytes")
    check(row["ternary_tokens_equal"], f"ternary {qtg} vs {qtc}")
    if dev.type == "cuda":
        check(launches == _hy_k3_per_step(cfg) * steps,
              f"K3 launched {launches} times in {steps} steps")
    return launches


_HY_ZAMBA_PACKED = (("layers", "in_proj"), ("layers", "out_proj"),
                    ("shared", "mlp", "w_gate"), ("shared", "mlp", "w_up"),
                    ("shared", "mlp", "w_down"))
_HY_ENCDEC_PACKED = (("encoder", "mlp", "w_up"), ("encoder", "mlp", "w_down"),
                     ("decoder", "mlp", "w_up"), ("decoder", "mlp", "w_down"),
                     ("frontend_proj",))


def hy_vs_cpu(torch, dev, k3, full):
    """(b) Each family at full width, cut in depth, in f32: the card
    against the port's CPU run. zamba2 at HY_ZAMBA_CUT layers: logits
    (B=2, S=HY_CPU_SEQ: two SSD chunks), decode stepped over an 8-token
    prompt, greedy tokens, ternary greedy tokens over 1 + 1 tokens (the
    card packs the CPU's bytes; K3 counted); the SMOKE zamba2 decoding
    HY_RING_STEPS steps into its ring; seamless at HY_ENCDEC_CUT +
    HY_ENCDEC_CUT layers: logits (HY_CPU_SEQ frames and tokens), encode,
    the cross K/V, decode over them, greedy tokens, ternary greedy tokens
    over 3 + 3 tokens. Returns K3's launches."""
    import dataclasses
    from repro_torch.models import build_model
    from repro_torch.models import encdec, zamba2
    from repro_torch.models.params import tree_map
    out, launches, seq = {}, 0, full["cpu_seq"]
    rng = np.random.default_rng(SEED + 32)
    t0 = time.perf_counter()

    # zamba2, HY_ZAMBA_CUT layers
    cfg = dataclasses.replace(full["zamba"], num_layers=full["zamba_cut"],
                              dtype="float32")
    model = build_model(cfg)
    gpu = _hy_zamba_params(torch, model, SEED + 31, dev)
    cpu = tree_map(lambda x: x.cpu(), gpu)
    toks = rng.integers(0, cfg.vocab_size, (2, seq))
    lg = model.apply(gpu, {"tokens": torch.from_numpy(toks).to(dev)})[0]
    lc = model.apply(cpu, {"tokens": torch.from_numpy(toks)})[0]
    row = dict(config=f"{cfg.name} widths, num_layers={cfg.num_layers}, "
                      f"float32", apply_shape=[2, seq],
               stages=[list(b) for b in zamba2._stage_bounds(cfg)],
               apply_logits_max_abs_diff=float((lg.cpu() - lc).abs().max()),
               logits_std=float(lc.std()))
    del lg, lc
    check(row["apply_logits_max_abs_diff"] <= TF_LOGITS_ATOL,
          f"zamba2 apply logits: {row['apply_logits_max_abs_diff']}")
    prompt = toks[:, :8]
    row["decode_logits_max_abs_diff"] = _hy_decode_diff(
        torch, model, gpu, cpu, model.init_cache(2, 16, device=dev),
        model.init_cache(2, 16, device="cpu"), prompt, dev)
    check(row["decode_logits_max_abs_diff"] <= TF_LOGITS_ATOL,
          f"zamba2 decode logits: {row}")
    launches += _hy_greedy_and_ternary(torch, dev, k3, model, gpu, cpu,
                                       prompt, row, _HY_ZAMBA_PACKED, (1, 1))
    del gpu, cpu
    row["seconds"] = time.perf_counter() - t0
    out["zamba2"] = row

    # the SMOKE zamba2 across its ring
    cfg = full["zamba_smoke"]
    model = build_model(cfg)
    gpu = _hy_zamba_params(torch, model, SEED + 33, dev)
    cpu = tree_map(lambda x: x.cpu(), gpu)
    n = full["ring_steps"]
    cg = model.init_cache(2, 4 * cfg.long_context_window, device=dev)
    ring = cg["attn_k"].shape[2]
    check(ring == cfg.long_context_window < n, "the cache must be a ring")
    out["zamba2_smoke_ring"] = dict(
        window=ring, steps=n, decode_logits_max_abs_diff=_hy_decode_diff(
            torch, model, gpu, cpu, cg,
            model.init_cache(2, 4 * cfg.long_context_window, device="cpu"),
            rng.integers(0, cfg.vocab_size, (2, n)), dev))
    check(out["zamba2_smoke_ring"]["decode_logits_max_abs_diff"]
          <= TF_LOGITS_ATOL, f"ring decode: {out['zamba2_smoke_ring']}")
    del gpu, cpu

    # seamless, HY_ENCDEC_CUT + HY_ENCDEC_CUT layers
    cut = full["encdec_cut"]
    cfg = dataclasses.replace(full["seamless"], num_layers=cut,
                              encoder_layers=cut, decoder_layers=cut,
                              dtype="float32")
    model = build_model(cfg)
    gpu, cpu = _tf_pair(torch, model, SEED + 34, dev)
    frames = torch.from_numpy(rng.normal(
        size=(2, seq, cfg.frontend_dim)).astype(np.float32))
    toks = rng.integers(0, cfg.vocab_size, (2, seq))
    batch = {"frames": frames, "tokens": torch.from_numpy(toks)}
    lg = model.apply(gpu, {k: v.to(dev) for k, v in batch.items()})[0]
    lc = model.apply(cpu, batch)[0]
    row = dict(config=f"{cfg.name} widths, {cut} + {cut} layers, float32",
               apply_shape=[2, seq],
               apply_logits_max_abs_diff=float((lg.cpu() - lc).abs().max()),
               logits_std=float(lc.std()))
    del lg, lc
    eg = encdec.encode(gpu, frames.to(dev), cfg)
    ec = encdec.encode(cpu, frames, cfg)
    kg, kc = (encdec.prefill_cross_kv(gpu, eg, cfg),
              encdec.prefill_cross_kv(cpu, ec, cfg))
    row.update(encode_max_abs_diff=float((eg.cpu() - ec).abs().max()),
               cross_kv_max_abs_diff=max(
                   float((a.cpu() - b).abs().max()) for a, b in zip(kg, kc)))
    cg = {**model.init_cache(2, 16, device=dev), "ck": kg[0], "cv": kg[1]}
    cc = {**model.init_cache(2, 16, device="cpu"), "ck": kc[0], "cv": kc[1]}
    row["decode_logits_max_abs_diff"] = _hy_decode_diff(
        torch, model, gpu, cpu, cg, cc, toks[:, :8], dev)
    check(max(row["apply_logits_max_abs_diff"], row["encode_max_abs_diff"],
              row["cross_kv_max_abs_diff"],
              row["decode_logits_max_abs_diff"]) <= TF_LOGITS_ATOL,
          f"seamless vs CPU: {row}")
    launches += _hy_greedy_and_ternary(torch, dev, k3, model, gpu, cpu,
                                       toks[:, :8], row, _HY_ENCDEC_PACKED,
                                       (3, 3))
    row["seconds"] = time.perf_counter() - t0 - out["zamba2"]["seconds"]
    out["seamless"] = row
    del gpu, cpu, eg, ec, kg, kc, cg, cc
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    emit("hy_vs_cpu", tolerance=dict(logits_atol=TF_LOGITS_ATOL,
                                     tokens="equal", packed="equal"), **out)
    return launches


def _hy_no_sync_steps(torch, serve_step, params, model, b, cache_len, dev,
                      cache=None):
    """TF_SYNC_STEPS decode steps under the sync debug mode, after one
    outside it; None if no step synchronized."""
    cache = cache or model.init_cache(b, cache_len, device=dev)
    tok = torch.ones((b, 1), dtype=torch.long, device=dev)
    tok, cache = serve_step(params, cache, tok)
    box = [tok, cache]

    def steps_fn():
        for _ in range(TF_SYNC_STEPS):
            box[0], box[1] = serve_step(params, box[1], box[0])
    return _no_sync(torch, steps_fn, dev.type == "cuda")


def hy_zamba(torch, dev, k3, full):
    """(c) zamba2-1.2b at full width and depth in bf16, as a user serves
    it: BatchScheduler over requests built as launch/serve.py builds them
    (B=4); the ternary model (the card packs the CPU's bytes on the first
    and last layers' projections and the shared MLP) through generate
    with K3 counted (2 a Mamba-2 layer + 3 a shared-block invocation a
    decode step, 97 in all) and one ternary prefill (97); no host sync
    inside a bf16 or ternary decode step; decode tokens/s with bf16 and
    ternary samples in turn from a 512-slot cache; prefill tokens/s at
    B=4, S=2048 in each; profiles of decode steps; memory. Returns K3's
    launches."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import build_model, zamba2
    from repro_torch.serving import (BatchScheduler, Request, ServeConfig,
                                     generate, quantize_for_serving)
    cfg = full["zamba"]
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    nl, vocab, b = cfg.num_layers, cfg.vocab_size, full["batch"]
    per_step = _hy_k3_per_step(cfg)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = _hy_zamba_params(torch, model, SEED + 35, dev)
    sync()
    report = dict(config=f"{cfg.name} CONFIG ({nl} Mamba-2 layers, "
                         f"d={cfg.d_model}, the shared block "
                         f"{len(zamba2._stage_bounds(cfg))} times, "
                         f"{cfg.dtype})", params=model.num_params(),
                  init_s=time.perf_counter() - t0)
    if on_card:
        report["params_gb"] = torch.cuda.memory_allocated() / 1e9

    rng = np.random.default_rng(0)
    reqs = [Request(id=i, prompt=rng.integers(
                2, vocab, size=rng.integers(2, LM_PROMPT + 1)),
                max_new_tokens=LM_NEW) for i in range(LM_SERVE_REQUESTS)]
    sched = BatchScheduler(model, params, max_batch=b,
                           cache_len=LM_PROMPT + LM_NEW + 1, device=dev)
    done = sched.run(reqs)
    check(all(len(r.output) == LM_NEW and all(0 <= t < vocab
                                              for t in r.output)
              for r in done), "zamba2 scheduler outputs")
    report["scheduler"] = dict(requests=len(done),
                               batches=sched.stats["batches"],
                               decode_steps=sched.stats["decode_steps"],
                               first_outputs=[r.output[:8]
                                              for r in done[:2]])

    t0 = time.perf_counter()
    q, stats = quantize_for_serving(params)
    sync()
    report["ternary"] = dict(stats=stats, quantize_s=time.perf_counter() - t0)
    check(stats["quantized"] == len(_HY_ZAMBA_PACKED),
          f"ternary stats {stats}")
    picks = [0, nl - 1]
    same = total = 0
    for path in _HY_ZAMBA_PACKED:
        w, pk = params, q
        for key in path:
            w, pk = w[key], pk[key]
        ws = w[picks] if path[0] == "layers" else w[None]
        pks = pk["packed"][picks] if path[0] == "layers" else pk["packed"][
            None]
        for wi, pi in zip(ws, pks):
            cpu_packed, _ = ops.pack_ternary_weights(wi.cpu().float())
            same += int((cpu_packed == pi.cpu()).sum())
            total += cpu_packed.numel()
    report["ternary"]["packed_equal_fraction_vs_cpu"] = same / total
    report["ternary"]["packed_compared"] = (
        f"layers {picks} of in_proj and out_proj, the shared MLP")
    check(same == total, f"the card packed {same}/{total} of the CPU's "
                         f"bytes")
    prompts = np.random.default_rng(SEED + 36).integers(2, vocab, (b, 8))
    k3.launches = 0
    toks, _ = generate(model, q, prompts, ServeConfig(max_new_tokens=8),
                       device=dev)
    sync()
    gen_launches, steps = k3.launches, 8 + 8
    report["ternary"].update(generate_k3_launches=gen_launches,
                             decode_steps=steps,
                             per_decode_step=gen_launches / steps,
                             tokens=toks.tolist())
    check(not on_card or gen_launches == per_step * steps,
          f"K3 launched {gen_launches} times in {steps} ternary steps")

    serve_step = make_serve_step(cfg)
    sync_errors = {name: _hy_no_sync_steps(torch, serve_step, p, model, b,
                                           full["cache"], dev)
                   for name, p in (("bf16", params), ("ternary", q))}
    report["decode_no_host_sync"] = sync_errors
    check(all(e is None for e in sync_errors.values()),
          f"a zamba2 decode step synchronized: {sync_errors}")

    prefill = make_prefill_step(cfg)
    batch = _tf_batch(torch, cfg, b, full["seq"], SEED + 37, dev)
    k3.launches = 0
    last = prefill(q, batch)
    sync()
    pre_launches = k3.launches
    check(not on_card or pre_launches == per_step,
          f"K3 launched {pre_launches} times in a ternary prefill")
    check(tuple(last.shape) == (b, vocab)
          and bool(torch.isfinite(last).all()), "ternary prefill logits")
    report["ternary"]["prefill_k3_launches"] = pre_launches
    launches = gen_launches + pre_launches
    if not on_card:
        emit("hy_zamba", **report)
        return launches

    (fp, tern), (state, tstate) = _decode_rates(
        torch, serve_step, model, [params, q], dev, full["cache"],
        *full["decode"], batch=b)
    pre = {}
    for name, p in (("bf16", params), ("ternary", q)):
        s_med, s_all, peak = _prefill_s(torch, prefill, p, batch,
                                        reps=3 if name == "bf16" else 1)
        pre[name] = dict(s_median=s_med, s_all=s_all,
                         tokens_per_s=b * full["seq"] / s_med,
                         peak_memory_gb=peak / 1e9)
    torch.cuda.reset_peak_memory_stats()
    serve_step(params, state[1], state[2])
    torch.cuda.synchronize()
    report.update(
        decode_bf16=fp, decode_ternary=tern,
        ternary_vs_bf16_paired_median=statistics.median(
            t / f for t, f in zip(tern["tokens_per_s_samples"],
                                  fp["tokens_per_s_samples"])),
        decode_cache_len=full["cache"],
        decode_step_peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        prefill=dict(batch=b, seq=full["seq"], **pre),
        decode_profile=_decode_profile(torch, serve_step, state,
                                       fp["step_ms_median"]),
        decode_ternary_profile=_decode_profile(torch, serve_step, tstate,
                                               tern["step_ms_median"]))
    emit("hy_zamba", metric="host clock ending in torch.cuda.synchronize",
         **report)
    return launches


def hy_seamless(torch, dev, k3, full):
    """(d) seamless-m4t-medium at full width and depth in bf16: encode
    B=4 x HY_ENC_FRAMES frames, project the cross K/V into a 512-slot
    cache and decode HY_GREEDY_STEPS greedy steps over them (no host sync
    in a step); decode tokens/s at B=4 and a profile of decode steps; one
    prefill (B=4, 2,048 frames
    and 2,048 tokens: 8.4 GB of f32 logits); the ternary model served by
    BatchScheduler with K3 counted (2 a decoder layer a step, 24 in
    all). Returns K3's launches."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.models import build_model
    from repro_torch.models import encdec
    from repro_torch.serving import (BatchScheduler, Request,
                                     quantize_for_serving)
    cfg = full["seamless"]
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    b, vocab, nd = full["batch"], cfg.vocab_size, cfg.decoder_layers
    per_step = _hy_k3_per_step(cfg)
    model = build_model(cfg)
    params = _tf_params(torch, model, SEED + 38, dev)
    row = dict(config=f"{cfg.name} CONFIG ({cfg.encoder_layers} + {nd} "
                      f"layers, d={cfg.d_model}, vocab {vocab}, "
                      f"{cfg.dtype})", params=model.num_params())
    if on_card:
        row["params_gb"] = torch.cuda.memory_allocated() / 1e9
    rng = np.random.default_rng(SEED + 39)
    frames = torch.from_numpy(rng.normal(
        size=(b, full["enc_frames"], cfg.frontend_dim)).astype(
            np.float32)).to(dev)
    serve_step = make_serve_step(cfg)
    sync()
    t0 = time.perf_counter()
    enc = encdec.encode(params, frames, cfg)
    ck, cv = encdec.prefill_cross_kv(params, enc, cfg)
    sync()
    row["encode_and_cross_kv_s"] = time.perf_counter() - t0
    cache = {**model.init_cache(b, full["cache"], device=dev),
             "ck": ck, "cv": cv}
    tok = torch.ones((b, 1), dtype=torch.long, device=dev)
    out = []
    sync()
    t0 = time.perf_counter()
    for _ in range(full["greedy"]):
        tok, cache = serve_step(params, cache, tok)
        out.append(tok)
    sync()
    greedy_s = time.perf_counter() - t0
    toks = torch.cat(out, 1)
    check(bool(((toks >= 0) & (toks < vocab)).all()), "seamless tokens")
    row["encoded_decode"] = dict(
        frames=full["enc_frames"], cache_len=full["cache"],
        steps=full["greedy"], step_ms=greedy_s * 1e3 / full["greedy"],
        first_tokens=toks[:2, :8].tolist())
    row["decode_no_host_sync"] = _hy_no_sync_steps(
        torch, serve_step, params, model, b, full["cache"], dev,
        cache={**model.init_cache(b, full["cache"], device=dev),
               "ck": ck, "cv": cv})
    check(row["decode_no_host_sync"] is None,
          f"a seamless decode step synchronized: {row}")
    del enc, ck, cv, cache

    q, stats = quantize_for_serving(params)
    check(stats["quantized"] == len(_HY_ENCDEC_PACKED),
          f"seamless ternary stats {stats}")
    rq = np.random.default_rng(1)
    reqs = [Request(id=i, prompt=rq.integers(
                2, vocab, size=rq.integers(2, LM_PROMPT + 1)),
                max_new_tokens=LM_NEW) for i in range(b)]
    k3.launches = 0
    sched = BatchScheduler(model, q, max_batch=b,
                           cache_len=LM_PROMPT + LM_NEW + 1, device=dev)
    done = sched.run(reqs)
    sync()
    steps = sched.stats["decode_steps"]
    row["ternary"] = dict(stats=stats, k3_launches=k3.launches,
                          decode_steps=steps,
                          per_decode_step=k3.launches / steps,
                          first_outputs=[r.output[:8] for r in done[:2]])
    check(all(len(r.output) == LM_NEW for r in done),
          "seamless ternary scheduler outputs")
    check(not on_card or k3.launches == per_step * steps,
          f"seamless: K3 launched {k3.launches} times in {steps} steps")
    launches = k3.launches
    row["ternary_decode_no_host_sync"] = _hy_no_sync_steps(
        torch, serve_step, q, model, b, full["cache"], dev)
    check(row["ternary_decode_no_host_sync"] is None,
          f"a ternary seamless decode step synchronized: {row}")
    del q

    prefill = make_prefill_step(cfg)
    batch = {"frames": torch.from_numpy(rng.normal(
                 size=(b, full["seq"], cfg.frontend_dim)).astype(
                     np.float32)).to(dev),
             "tokens": torch.from_numpy(rng.integers(
                 0, vocab, (b, full["seq"]))).to(dev)}
    last = prefill(params, batch)
    check(tuple(last.shape) == (b, vocab)
          and bool(torch.isfinite(last).all()), "seamless prefill")
    del last
    if on_card:
        samples, dsteps = full["decode"]
        (rate,), (state,) = _decode_rates(torch, serve_step, model,
                                          [params], dev, full["cache"],
                                          samples // 2, dsteps, batch=b)
        row["decode_profile"] = _decode_profile(torch, serve_step, state,
                                                rate["step_ms_median"])
        del state
        s_med, s_all, peak = _prefill_s(torch, prefill, params, batch,
                                        reps=1)
        row.update(decode=rate, prefill=dict(
            batch=b, frames=full["seq"], tokens=full["seq"], s=s_med,
            tokens_per_s=b * full["seq"] / s_med,
            peak_memory_gb=peak / 1e9,
            logits_gb=b * full["seq"] * vocab * 4 / 1e9))
    del params, batch
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    emit("hy_seamless", **row)
    return launches


def hybrid_phase(torch, dev, k3):
    """Phase 11 end to end: (a) K3 at this slice's products, (b) each
    family on the card against the CPU (and the SSD scan against its
    stepwise form), (c) zamba2-1.2b served, (d) seamless-m4t-medium
    served. Returns the launches, errors and times the ``kernels`` line
    needs."""
    full = _hy_full()
    seconds = {}
    t0 = time.perf_counter()
    err, times = tf_k3_checks(torch, dev, k3, full, phase="hy_k3_vs_plain",
                              seed=SEED + 40)
    seconds["a_k3"] = time.perf_counter() - t0
    launches = hy_vs_cpu(torch, dev, k3, full)
    hy_ssd(torch, dev, full)
    seconds["b_vs_cpu"] = time.perf_counter() - t0 - sum(seconds.values())
    launches += hy_zamba(torch, dev, k3, full)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    seconds["c_zamba2"] = time.perf_counter() - t0 - sum(seconds.values())
    launches += hy_seamless(torch, dev, k3, full)
    seconds["d_seamless"] = time.perf_counter() - t0 - sum(seconds.values())
    emit("hy_phase", seconds=time.perf_counter() - t0, by_part=seconds,
         k3_launches=launches)
    return {"launches": launches, "max_abs_err": err, "times": times}



# ----------------------------------------------------------------------
# Phase 12: LM training -- Model.loss under autograd, K4 forward with the
# chunked form's gradient, remat, the fault-tolerant Trainer with bf16
# checkpoints, gradient compression; llama3.2-1b at full width and depth.
# ----------------------------------------------------------------------

# (a) ops.wkv6_scan's gradients on the card against the CPU's (the plain
# K4 and the chunked backward in f32), as a share of each input's largest
# |gradient|: f32 differs by summation order only (~1e-6 expected); bf16
# gradients are the f32 ones rounded to bf16 (2**-9 of a value) plus that.
LT_WKV_SHAPE = (2, 256, 64, 64)             # rwkv6-7b's heads, B 2, T 256
LT_WKV_TOL = {"torch.float32": 1e-4, "torch.bfloat16": 1e-2}
# (b) one make_train_step step a family in f32 at full width, the card
# against the CPU: the loss (relative), each leaf's first moment (the
# clipped gradient times 1 - b1) as a share of its largest entry, and the
# updated params where the gradient is well above its own error (|m| at
# least 1e-3 of the leaf's largest and above (1 - b1) 1e-6): AdamW's
# first update is lr g / (|g| + eps), whose ratio moves by dg eps / g^2
# for a gradient error dg. Elsewhere the update only is bounded, by
# 2 lr (1 + wd |p|).
# B=2, S=32 and the enc-dec's 32 frames. The CPU steps are bound by the
# weights, not the tokens: at S=16 b_vs_cpu took 117.1 s, at S=32 113.5.
LT_CPU_BATCH, LT_CPU_SEQ, LT_CPU_ENC = 2, 32, 32
# deepseek-moe-16b's layers in (b): every layer is an MoE layer (the
# uniform stack), and its f32 CPU step is bound by the 0.55 B weights a
# layer (39.4 s at 2 layers on the H100 machine's host); the transformer
# phase's (b) holds its forward and routing at 2 layers.
LT_MOE_CPU_LAYERS = 1
LT_LOSS_RTOL = 1e-5
LT_GRAD_TOL = 1e-3
LT_PARAM_TOL = 1e-2                          # times lr
LT_LR = 1e-3
# (c) llama3.2-1b at full width, bf16, the "repeat" task over
# its first 64 token ids (the logits stay 128,256-way). A batch holds 4
# tokens; over the whole vocabulary each step's are new, and copying an
# unseen token is not learned in 20 steps at any lr tried on the H100
# (1e-4, 3e-4: flat at ~12; 1e-3, 3e-3: rising; PERF.md section 6),
# while over 64 ids tokens recur and the loss halves (12.28 -> 2.99 at
# 3e-4).
LT_BATCH, LT_SEQ, LT_TASK_VOCAB = 4, 1024, 64
# Checkpoints every 10 steps, at the crash's step: with keep_last=1 the
# restart reads only the newest, so a save between (12.4 GB, ~19 s at
# full depth) would be deleted unread. The uninterrupted run saves
# nothing: the gate compares its state in memory.
LT_STEPS, LT_CRASH_AT, LT_CKPT_EVERY = 20, 10, 10
# (c)'s depth: its two saves and a restore of 12.4 GB took ~60 s of a
# ~114 s run at 16 layers; 4 layers (as lm_train_sharded's llama3.2-1b)
# keep the restart, the loss and the profile gates. (d), (f) and the
# dryrun phase run the full depth.
LT_TRAINER_LAYERS = 4
LT_TRAIN_LR = 3e-4
LT_PROFILE_STEPS = 2
# (e) rwkv6-7b at full width, 4 of 32 layers (AdamW for all 32 needs
# ~91 GB), bf16, one batch of the whole-vocabulary "repeat" task.
LT_RWKV_LAYERS, LT_RWKV_BATCH, LT_RWKV_STEPS = 4, 2, 5
LT_RWKV_LR = 3e-3
# (f) gradient compression
LT_RATIO = 0.05


def _lt_full():
    """What ``lm_train_phase`` trains: (a) K4 at rwkv6-7b's heads, (b) each
    family at full width cut to 2 layers (deepseek-moe-16b to
    ``LT_MOE_CPU_LAYERS``; zamba2 to 7, two shared-block invocations;
    seamless to 2 + 2) in f32, (c) llama3.2-1b at full width and
    ``LT_TRAINER_LAYERS`` layers, (d) and (f) at full width and depth, in
    bf16, B=4, S=1024 ((c) over a 64-token
    task), (e) rwkv6-7b at full width and 4 layers, bf16, B=2, S=1024."""
    import dataclasses
    from repro_torch.configs import get_config

    def cut(arch, n, **kw):
        return dataclasses.replace(get_config(arch), num_layers=n,
                                   dtype="float32", **kw)
    return dict(
        wkv=LT_WKV_SHAPE,
        cpu=dict(llama=cut("llama3.2-1b", 2),
                 moe=cut("deepseek-moe-16b", LT_MOE_CPU_LAYERS),
                 vlm=cut("qwen2-vl-2b", 2),
                 rwkv=cut("rwkv6-7b", 2),
                 zamba=cut("zamba2-1.2b", HY_ZAMBA_CUT),
                 encdec=cut("seamless-m4t-medium", 2, encoder_layers=2,
                            decoder_layers=2)),
        cpu_batch=LT_CPU_BATCH, cpu_seq=LT_CPU_SEQ, cpu_enc=LT_CPU_ENC,
        llama=get_config("llama3.2-1b"),
        trainer_llama=dataclasses.replace(get_config("llama3.2-1b"),
                                          num_layers=LT_TRAINER_LAYERS),
        batch=LT_BATCH, seq=LT_SEQ,
        task_vocab=LT_TASK_VOCAB, steps=LT_STEPS, crash_at=LT_CRASH_AT,
        ckpt_every=LT_CKPT_EVERY, profile_steps=LT_PROFILE_STEPS,
        rwkv=dataclasses.replace(get_config("rwkv6-7b"),
                                 num_layers=LT_RWKV_LAYERS),
        rwkv_batch=LT_RWKV_BATCH, rwkv_steps=LT_RWKV_STEPS,
        ckpt_root=os.path.join(ROOT, "checkpoints", "chip_smoke_lm_train"))


def _sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def _free(torch, dev):
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def lt_wkv_grad(torch, dev, k4, full):
    """(a) ``ops.wkv6_scan``'s gradients for r, k, v, logw, u and state0
    on the card (K4 forward, the chunked form's backward) against the
    same call on the CPU in f32 from the same values, for bf16 (f32 logw)
    and f32 inputs; K4 launches once in the forward and never in the
    backward."""
    from repro_torch.kernels import ops
    b, t, h, hd = full["wkv"]
    g = torch.Generator().manual_seed(SEED + 50)
    names = ("r", "k", "v", "logw", "u", "state0")
    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        base = _wkv_inputs(torch, g, "cpu", b, t, h, hd, torch.float32,
                           state=True)
        g_o = torch.randn(b, t, h, hd, generator=g).to(dtype)
        g_s = torch.randn(b, h, hd, hd, generator=g)
        card = [x.to(dtype) if i in (0, 1, 2, 4) else x
                for i, x in enumerate(base)]
        card = [x.to(dev).requires_grad_() for x in card]
        host = [x.detach().cpu().float().requires_grad_() for x in card]
        k4.launches = 0
        o, st = ops.wkv6_scan(*card)
        fwd = k4.launches
        got = torch.autograd.grad((o, st), card, (g_o.to(dev), g_s.to(dev)))
        _sync(torch, dev)
        bwd = k4.launches - fwd
        oc, sc = ops.wkv6_scan(*host)
        want = torch.autograd.grad((oc, sc), host, (g_o.float(), g_s))
        rel = {n: float((a.float().cpu() - w).abs().max()
                        / w.abs().max().clamp(min=1e-30))
               for n, a, w in zip(names, got, want)}
        key = str(dtype)
        row = dict(shape=[b, t, h, hd], rel_err=rel,
                   grad_dtype=str(got[0].dtype), k4_forward_launches=fwd,
                   k4_backward_launches=bwd, tolerance=LT_WKV_TOL[key])
        if torch.device(dev).type == "cuda":
            def fwd_bwd():
                oo, ss = ops.wkv6_scan(*card)
                torch.autograd.grad((oo, ss), card,
                                    (g_o.to(dev), g_s.to(dev)))
            row["forward_backward_ms"] = _call_ms(torch, fwd_bwd, reps=5)
            row["forward_ms"] = _call_ms(
                torch, lambda: ops.wkv6_scan(*card), reps=5)
        rows[key] = row
        check(max(rel.values()) <= LT_WKV_TOL[key],
              f"WKV gradient {key} vs the CPU: {rel}")
        check(all(tuple(a.shape) == tuple(x.shape) and a.dtype == x.dtype
                  for a, x in zip(got, card)), "WKV gradient shapes/dtypes")
        check(torch.device(dev).type != "cuda" or (fwd == 1 and bwd == 0),
              f"K4 launched {fwd} times forward, {bwd} backward")
    emit("lt_wkv_grad", **rows)
    return max(max(r["rel_err"].values()) for r in rows.values())


def _lt_params(torch, model, cfg, seed, dev):
    """f32 parameters of a family drawn on ``dev`` (rwkv6's ``u``/``mu``
    and zamba2's per-head constants set from a numpy seed, as the serving
    phases do), and a copy on the CPU."""
    from repro_torch.models.params import tree_map
    if cfg.family == "rwkv6":
        gpu = _lm_params(torch, model, seed, dev)
    elif cfg.family == "zamba2":
        gpu = _hy_zamba_params(torch, model, seed, dev)
    else:
        gpu = model.init(torch.Generator(device=dev).manual_seed(seed),
                         device=dev)
    return gpu, tree_map(lambda x: x.cpu(), gpu)


def _lt_batch(torch, cfg, full, seed):
    """A numpy-seeded CPU batch: tokens, targets with ~20% masked, the
    enc-dec's frames and the VLM's patch embeddings."""
    rng = np.random.default_rng(seed)
    b, s = full["cpu_batch"], full["cpu_seq"]
    tokens = rng.integers(0, cfg.vocab_size, (b, s))
    targets = np.where(rng.random((b, s)) < 0.2, -1, tokens)
    out = {"tokens": torch.from_numpy(tokens),
           "targets": torch.from_numpy(targets)}
    if cfg.family == "encdec":
        out["frames"] = torch.from_numpy(rng.normal(
            size=(b, full["cpu_enc"], cfg.frontend_dim)).astype(np.float32))
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.from_numpy(rng.normal(
            size=(b, 16, cfg.d_model)).astype(np.float32))
    return out


def _lt_compare(torch, gp, go, gm, cp, co, cm, lr):
    """Worst relative differences of one step on the card (g*) against
    the CPU (c*): loss and metrics, first moments, confident and bounded
    param updates. Each CPU leaf is copied to the card's device and
    compared there."""
    from repro_torch.training.optimizer import tree_leaves
    out = dict(loss_rel=abs(float(gm["loss"]) - float(cm["loss"]))
               / abs(float(cm["loss"])),
               grad_norm_rel=abs(float(gm["grad_norm"])
                                 - float(cm["grad_norm"]))
               / float(cm["grad_norm"]),
               m_rel=0.0, param_confident=0.0, param_bounded=0.0,
               leaves=len(tree_leaves(cp)))
    for pa, pc, ma, mc in zip(tree_leaves(gp), tree_leaves(cp),
                              tree_leaves(go["m"]), tree_leaves(co["m"])):
        pa, pc, mc = pa.float(), pc.to(pa.device), mc.to(ma.device)
        top = float(mc.abs().max())
        if top > 0:
            out["m_rel"] = max(out["m_rel"],
                               float((ma - mc).abs().max()) / top)
        sure = (mc.abs() >= 1e-3 * top) & (mc.abs() > (1 - 0.9) * 1e-6)
        d = (pa - pc.float()).abs()
        if bool(sure.any()):
            out["param_confident"] = max(out["param_confident"],
                                         float(d[sure].max()) / lr)
        out["param_bounded"] = max(out["param_bounded"], float(
            (d / (2 * lr * (1 + 0.1 * pc.float().abs()))).max()))
    return out


def lt_vs_cpu(torch, dev, k4, full):
    """(b) One ``make_train_step`` step a family at full width (cut in
    depth) in f32 on the card against the same step on the CPU from the
    same params and batch. deepseek's routing (experts chosen and
    (token, choice) pairs kept) must be equal on both. Returns K4's
    launches on the card (the rwkv6 step)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.training import AdamWConfig, adamw_init
    ocfg = AdamWConfig(lr=LT_LR, warmup_steps=1, total_steps=10)
    out, launches = {}, 0
    for fam, cfg in full["cpu"].items():
        t0 = time.perf_counter()
        model = build_model(cfg)
        gpu, cpu = _lt_params(torch, model, cfg, SEED + 51, dev)
        nb = _lt_batch(torch, cfg, full, SEED + 52)
        step = make_train_step(cfg, ocfg, remat=False)
        routes = []
        real_route = L.moe_route

        def recorder(*args, **kw):
            r = real_route(*args, **kw)
            routes.append({key: r[key].detach().cpu() for key in (
                "gate_idx", "keep", "probs")})
            return r
        L.moe_route = recorder
        try:
            k4.launches = 0
            gp, go, gm = step(gpu, adamw_init(gpu),
                              {k: v.to(dev) for k, v in nb.items()})
            _sync(torch, dev)
            launches += k4.launches
            t_card = time.perf_counter() - t0
            cp, co, cm = step(cpu, adamw_init(cpu), nb)
            t_cpu = time.perf_counter() - t0 - t_card
        finally:
            L.moe_route = real_route
        row = _lt_compare(torch, gp, go, gm, cp, co, cm, LT_LR)
        row.update(config=f"{cfg.name} widths, {cfg.num_layers} layers, "
                          f"float32", loss=float(cm["loss"]),
                   k4_launches=k4.launches if fam == "rwkv" else None,
                   card_s=t_card, cpu_step_s=t_cpu,
                   total_s=time.perf_counter() - t0)
        if fam == "moe":
            n = len(routes) // 2
            card, host = routes[:n], routes[n:]
            row["routing_equal"] = all(
                torch.equal(a["gate_idx"], b["gate_idx"])
                and torch.equal(a["keep"], b["keep"])
                for a, b in zip(card, host))
            top = [torch.sort(r["probs"], dim=-1, descending=True).values
                   for r in host]
            row["min_kth_gap"] = min(float(
                (t[..., cfg.top_k - 1] - t[..., cfg.top_k]).min())
                for t in top)
            check(row["routing_equal"], f"moe routing differs: {row}")
        out[fam] = row
        check(row["loss_rel"] <= LT_LOSS_RTOL
              and row["grad_norm_rel"] <= LT_GRAD_TOL
              and row["m_rel"] <= LT_GRAD_TOL
              and row["param_confident"] <= LT_PARAM_TOL
              and row["param_bounded"] <= 1.0,
              f"{fam} train step vs the CPU: {row}")
        del gpu, cpu, gp, go, cp, co
        _free(torch, dev)
    emit("lt_vs_cpu", tolerance=dict(
        loss_rtol=LT_LOSS_RTOL, grad_share=LT_GRAD_TOL,
        param_confident_times_lr=LT_PARAM_TOL,
        param_bounded="2 lr (1 + wd |p|)"), **out)
    return launches


def _lt_trainer(full, cfg, dev, ckpt_dir, ckpt_every):
    from repro_torch.data import TokenTaskConfig, token_batch
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig, Trainer, TrainerConfig
    tk = TokenTaskConfig(vocab_size=full["task_vocab"], seq_len=full["seq"],
                         batch_size=full["batch"], task="repeat")
    tc = TrainerConfig(
        total_steps=full["steps"], ckpt_every=ckpt_every,
        ckpt_dir=ckpt_dir, keep_last=1, log_every=full["ckpt_every"],
        opt=AdamWConfig(lr=LT_TRAIN_LR, warmup_steps=2,
                        total_steps=full["steps"]))
    return Trainer(build_model(cfg), tc,
                   lambda s: token_batch(tk, s, device=dev), device=dev)


def lt_llama(torch, dev, full):
    """(c) llama3.2-1b at full width and ``LT_TRAINER_LAYERS`` layers in
    bf16 through ``Trainer``: an uninterrupted run of ``steps`` steps,
    then the same
    run with a RuntimeError at step ``crash_at`` through
    ``run_with_restarts``, checkpoints every ``ckpt_every`` steps under
    checkpoints/: losses and final params equal bit for bit, the loss
    falls below half its first value. Step ms, tokens/s, peak memory,
    and a profile of steady steps (host launches, device busy share)."""
    import shutil
    from repro_torch.training.optimizer import tree_leaves
    cfg, root = full["trainer_llama"], full["ckpt_root"]
    shutil.rmtree(root, ignore_errors=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 53)
    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    plain = _lt_trainer(full, cfg, dev, os.path.join(root, "plain"), 0)
    ref = plain.run(gen)
    plain_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else None
    want = [x.clone() for x in tree_leaves(ref["state"]["params"])]
    # a profile of steady steps from the final state
    state = ref["state"]
    batch = plain.batch_fn(0)

    def steps():
        st = state
        for _ in range(full["profile_steps"]):
            p, o, e, _ = plain._step_fn(st["params"], st["opt"], st["err"],
                                        batch)
            st = {"params": p, "opt": o, "err": e}
        return st
    prof = None
    if on_card:
        step_ms = statistics.median(h["time_s"] for h in ref["history"][2:]
                                    ) * 1e3
        _, wall, by_name, n_ops, host, gaps, api = _trace(torch, steps)
        prof = _trace_fields(wall, by_name, n_ops, host, gaps, api,
                             full["profile_steps"], step_ms)
    del state, ref["state"], batch
    _free(torch, dev)
    crashed = {"done": False}

    def hook(step):
        if step == full["crash_at"] and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("simulated node failure")
    t1 = time.perf_counter()
    again = _lt_trainer(full, cfg, dev, os.path.join(root, "crash"),
                        full["ckpt_every"])
    res = again.run_with_restarts(gen, failure_hook=hook)
    crash_s = time.perf_counter() - t1
    losses = [h["loss"] for h in ref["history"]]
    got = [h["loss"] for h in res["history"]]
    same_params = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(res["state"]["params"]), want))
    times = [h["time_s"] for h in ref["history"][2:]]
    row = dict(config=f"{cfg.name} full width, {cfg.num_layers} layers, "
                      f"{cfg.dtype}",
               batch=full["batch"], seq=full["seq"], steps=full["steps"],
               crash_at=full["crash_at"], ckpt_every=full["ckpt_every"],
               losses=losses, restarted_losses=got,
               losses_equal=got == losses[full["crash_at"]:],
               final_params_equal=same_params, crashed=crashed["done"],
               step_ms_median=statistics.median(times) * 1e3,
               step_ms_min=min(times) * 1e3, step_ms_max=max(times) * 1e3,
               tokens_per_s=full["batch"] * full["seq"]
               / statistics.median(times),
               first_step_s=ref["history"][0]["time_s"],
               uninterrupted_run_s=plain_s, restarted_run_s=crash_s,
               peak_bytes=peak, profile=prof)
    emit("lt_llama", **row)
    check(crashed["done"] and row["losses_equal"] and same_params,
          f"restart differs from the uninterrupted run: {losses} vs {got}")
    check(all(np.isfinite(losses)) and losses[-1] < 0.5 * losses[0],
          f"llama loss did not fall below half: {losses}")
    del res, want
    shutil.rmtree(root, ignore_errors=True)
    _free(torch, dev)
    return row


def lt_remat_and_compression(torch, dev, full):
    """(d) one llama3.2-1b gradient at full width and depth with remat on
    and off: loss and every gradient bit for bit, both peaks. (f) those
    gradients through ``compress_grads`` at ratio 0.05: each leaf sends
    its top-k by |acc| with ties (#{|acc| > thr} < k <= #sent = #{|acc|
    >= thr}), the residual is exactly acc off the mask and 0 on it, the
    sent bf16 value is acc rounded on the mask, and in f32 acc * mask +
    residual == acc; the call's ms."""
    from repro_torch.data import TokenTaskConfig, token_batch
    from repro_torch.models import build_model
    from repro_torch.training import (compress_grads, compression_init,
                                      deterministic)
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.trainer import loss_and_grads
    cfg = full["llama"]
    model = build_model(cfg)
    on_card = torch.device(dev).type == "cuda"
    params = model.init(torch.Generator(device=dev).manual_seed(SEED + 54),
                        device=dev)
    tk = TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=full["seq"],
                         batch_size=full["batch"], task="repeat")
    batch = token_batch(tk, 0, device=dev)
    res, peaks = {}, {}
    for remat in (False, True):
        _free(torch, dev)
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() if on_card else 0
        with deterministic(all_ops=True):
            res[remat] = loss_and_grads(model, params, batch, remat=remat)
        _sync(torch, dev)
        peaks[remat] = (torch.cuda.max_memory_allocated() - base
                        if on_card else None)
    a, b = res[False], res[True]
    remat_row = dict(loss=float(a[0]), loss_equal=bool(torch.equal(a[0],
                                                                    b[0])),
                     grads_equal=all(torch.equal(x, y) for x, y in zip(
                         tree_leaves(a[2]), tree_leaves(b[2]))),
                     peak_bytes_over_params=peaks)
    emit("lt_remat", **remat_row)
    check(remat_row["loss_equal"] and remat_row["grads_equal"],
          f"remat changes the gradient: {remat_row}")
    grads = a[2]
    del res, b
    _free(torch, dev)
    err = compression_init(grads)
    if on_card:
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
    sent, resid, metrics = compress_grads(grads, err, ratio=LT_RATIO)
    if on_card:
        ev[1].record()
        torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1]) if on_card else None
    leaves, ok = [], True
    for g, s_, r_ in zip(tree_leaves(grads), tree_leaves(sent),
                         tree_leaves(resid)):
        acc = g.float()
        k = max(int(acc.numel() * LT_RATIO), 1)
        thr = torch.topk(acc.abs().reshape(-1), k).values[-1]
        mask = acc.abs() >= thr
        n_sent, n_above = int(mask.sum()), int((acc.abs() > thr).sum())
        exact = (bool(torch.equal(acc * mask.float() + r_, acc))
                 and bool(torch.equal(r_[~mask], acc[~mask]))
                 and bool((r_[mask] == 0).all())
                 and bool(torch.equal(s_[mask], acc[mask].to(s_.dtype)))
                 and bool((s_[~mask] == 0).all()))
        leaf_ok = n_above < k <= n_sent and exact
        ok = ok and leaf_ok
        leaves.append(dict(size=acc.numel(), k=k, sent=n_sent,
                           above=n_above, sent_fraction=n_sent / acc.numel(),
                           exact=exact))
    row = dict(ratio=LT_RATIO, compress_ms=ms, leaves=leaves,
               compressed_grad_norm=float(metrics["compressed_grad_norm"]))
    emit("lt_compression", **row)
    check(ok, f"compression: {row}")
    del grads, sent, resid, params
    _free(torch, dev)
    return remat_row, row


def lt_rwkv(torch, dev, k4, full):
    """(e) rwkv6-7b at full width and ``LT_RWKV_LAYERS`` layers in bf16,
    B=2, S=1024: ``rwkv_steps`` make_train_step steps without remat (K4
    once a layer a step: the forward; the backward recomputes the chunked
    form), then one with remat (twice a layer), all on one batch, whose
    loss must be finite and fall; ms a step and the WKV backward's share
    of it (CUDA events around ``ops._Wkv6Scan.backward``)."""
    from repro_torch.data import TokenTaskConfig, token_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig, adamw_init
    cfg = full["rwkv"]
    on_card = torch.device(dev).type == "cuda"
    model = build_model(cfg)
    params = _lm_params(torch, model, SEED + 55, dev)
    opt = adamw_init(params)
    tk = TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=full["seq"],
                         batch_size=full["rwkv_batch"], task="repeat")
    ocfg = AdamWConfig(lr=LT_RWKV_LR, warmup_steps=1,
                       total_steps=full["rwkv_steps"] + 1)
    batch = token_batch(tk, 0, device=dev)
    bwd_events = []
    real_bwd = ops._Wkv6Scan.backward

    def timed_backward(ctx, *grads):
        if not on_card:
            return real_bwd(ctx, *grads)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = real_bwd(ctx, *grads)
        b.record()
        bwd_events.append((a, b))
        return out
    ops._Wkv6Scan.backward = staticmethod(timed_backward)
    rows, losses = [], []
    try:
        for i in range(full["rwkv_steps"] + 1):
            remat = i == full["rwkv_steps"]
            step = make_train_step(cfg, ocfg, remat=remat)
            bwd_events.clear()
            _sync(torch, dev)
            k4.launches = 0
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            _sync(torch, dev)
            dt = time.perf_counter() - t0
            wkv_ms = sum(a.elapsed_time(b) for a, b in bwd_events)
            losses.append(float(m["loss"]))
            rows.append(dict(step=i, remat=remat, loss=losses[-1],
                             k4_launches=k4.launches, step_ms=dt * 1e3,
                             wkv_backward_ms=wkv_ms if on_card else None,
                             wkv_backward_share=(wkv_ms / (dt * 1e3)
                                                 if on_card else None)))
    finally:
        ops._Wkv6Scan.backward = staticmethod(real_bwd)
    plain = [r for r in rows if not r["remat"]]
    out = dict(config=f"{cfg.name} widths, {cfg.num_layers} of 32 layers, "
                      f"{cfg.dtype}", batch=full["rwkv_batch"],
               seq=full["seq"], steps=rows,
               step_ms_median=statistics.median(r["step_ms"]
                                                for r in plain[1:]),
               wkv_backward_share_median=(statistics.median(
                   r["wkv_backward_share"] for r in plain[1:])
                   if on_card else None))
    emit("lt_rwkv", **out)
    nl = cfg.num_layers
    check(all(np.isfinite(losses)) and losses[full["rwkv_steps"] - 1]
          < losses[0], f"rwkv loss not falling: {losses}")
    if on_card:
        check(all(r["k4_launches"] == (2 if r["remat"] else 1) * nl
                  for r in rows), f"K4 launches a step: {rows}")
    del params, opt
    _free(torch, dev)
    return sum(r["k4_launches"] for r in rows), out


def lm_train_phase(torch, dev, k4, smi):
    """Phase 12 end to end: (a) the WKV gradient, (b) each family's train
    step against the CPU, (c) llama3.2-1b trained with a crash and a
    restart, (d) remat and (f) compression on its gradients, (e) rwkv6-7b
    trained. Returns the K4 numbers the ``kernels`` line needs."""
    full = _lt_full()
    seconds = {}
    t0 = time.perf_counter()
    wkv_err = lt_wkv_grad(torch, dev, k4, full)
    seconds["a_wkv_grad"] = time.perf_counter() - t0
    launches = lt_vs_cpu(torch, dev, k4, full)
    seconds["b_vs_cpu"] = time.perf_counter() - t0 - sum(seconds.values())
    llama = lt_llama(torch, dev, full)
    seconds["c_llama"] = time.perf_counter() - t0 - sum(seconds.values())
    remat, comp = lt_remat_and_compression(torch, dev, full)
    seconds["d_f_remat_compression"] = (time.perf_counter() - t0
                                        - sum(seconds.values()))
    rwkv_launches, rwkv = lt_rwkv(torch, dev, k4, full)
    launches += rwkv_launches
    seconds["e_rwkv"] = time.perf_counter() - t0 - sum(seconds.values())
    emit("lt_phase", nvidia_smi=smi, seconds=time.perf_counter() - t0,
         by_part=seconds, k4_train_launches=launches)
    return {"launches": launches, "max_abs_err": wkv_err, "llama": llama,
            "rwkv": rwkv, "remat": remat, "compression": comp}


# ----------------------------------------------------------------------
# Phase 12b: LM training over a mesh -- Trainer(shardings=...), FSDP over
# 'data' and TP over 'model', one process a rank (four gloo ranks sharing
# cuda:0 at (2, 2) on one card; NCCL one rank a card with four cards);
# pure data parallelism over 'pod' on a (2, 2, 1) mesh of the same ranks.
# ----------------------------------------------------------------------

LS_MESH = (2, 2)
# The mesh of the "pod" run: llama3.2-1b over (pod=2, data=2, model=1),
# from the (2, 2) run's params and batches (each rank one row of B=4),
# sharing llama's one-device reference.
LS_POD_MESH = (2, 2, 1)
# llama3.2-1b at full width cut to LS_LLAMA_LAYERS of 16 layers, bf16,
# global B=4, S=1024 with remat, LS_STEPS steps (at full depth and 3
# steps its ranks took 41.8 s of a 152.6 s phase on the H100; the cut
# pays for the pod run); rwkv6-7b at full width and LS_RWKV_LAYERS of 32
# layers (4 took 18.7 s of the ranks' time), bf16, B=2, S=1024, remat
# (K4 twice a layer a step on every rank, at 32 of its 64 heads), with
# lt_rwkv's params; the crash and restart on SMOKE llama3.2-1b in bf16,
# B=4, S=1024: at 2 layers of the full widths it took 57 s (two 3.8 GB
# saves and a restore through four ranks), more than the phase's time.
# Every run is the "copy_map" task over the whole vocabulary: in
# "repeat" rows every token of a row is the same, so attention's output
# is its value whatever the scores, and the q and k projections'
# gradients are rounding noise.
LS_LLAMA_LAYERS, LS_STEPS, LS_RWKV_LAYERS, LS_RWKV_STEPS = 4, 2, 2, 2
# deepseek-moe-16b at full width cut to LS_MOE_LAYERS layers (as _lt_full
# cuts it for the CPU), bf16, B=4, S=1024, remat, 2 steps: each rank holds
# half of a layer's 64 experts (experts over 'model') and gathers their
# 'data' halves at use.
LS_MOE_LAYERS, LS_MOE_STEPS = 2, 2
# qwen2-vl-2b at full width cut to LS_VLM_LAYERS of 28 layers (~0.42 B
# params), with 256 patch rows at the head of the sequence (a quarter of
# it, as launch.steps.input_specs draws them); zamba2-1.2b cut
# to LS_ZAMBA_LAYERS of 38 (~0.38 B): one stage of 6 Mamba layers and a
# seventh, so the tied shared block runs twice; seamless-m4t-medium cut
# to LS_ENCDEC_LAYERS encoder and decoder layers (~0.59 B, most of it
# the 256,206-row embedding and head), with LT_SEQ frames of width 1,024.
# All bf16, B=4, S=1024, remat, LS_NEW_STEPS steps; each rank runs
# zamba2's SSD on 32 of its 64 heads.
LS_VLM_LAYERS, LS_ZAMBA_LAYERS, LS_ENCDEC_LAYERS = 4, 7, 2
LS_NEW_STEPS = 2
# A collective waiting longer than this fails the phase (a step here
# took 12 s at most).
LS_TIMEOUT_S = 120.0
# Gates on the sharded steps against the one-device steps (_lt_compare's
# measures, and the relative L2 of each (layer, head)). In bf16 the
# sharded step rounds in other places: a row-parallel product's partials
# are rounded to bf16 before their all-reduce, the data ranks' bf16
# gradients are summed in bf16 by the reduce-scatter. The loss, a mean
# over 2,048-4,096 tokens near log(vocab) at init, moves by far less than
# one rounding (1e-2; the H100 gave 1.8e-5 for llama3.2-1b, 8.1e-5 for
# rwkv6-7b); the global gradient norm by about one (2e-2; 2.1e-4,
# 4.2e-4). The first moments ((1 - b1) times the clipped gradient) move
# by more, and the phase measures how much rounding alone moves them:
# the one-device first-step gradients in bf16 against the same step in
# f32 (the noise floor; H100: each leaf 1.1-2.7% in relative L2 in
# llama3.2-1b, 0.2-17.3% in rwkv6-7b, whose bf16 gradients inside the
# layers all sit 12-17% from f32 while lm_head's sits at 2%; worst head
# 3.3% and 17.9%; worst entry 2.8% and 17.9% of its leaf's largest). The
# sharded step sits at or under that floor (2.8% / 13.3% L2, heads 3.5% /
# 16.1%, entries 3.1% / 14.0%). A fault in one head on one rank -- rank
# 0's block of head 0, layer 0 of wq / tm/wr zeroed, which the phase
# plants in every run -- moves its leaf's L2 to 12.5%, under the rwkv6
# floor, so the per-leaf gates (0.25 L2, 0.3 of the largest; a missed or
# doubled reduction moves a leaf by 0.5 or more) cannot see it; the
# per-head L2 reads 0.71 for it (the head's other half lies on the other
# data rank) and 1.0 on whole arrays, and is gated at 0.35, about twice
# the floor and half the fault. The phase fails if the floor passes a
# gate or the planted fault does not. The f32 CPU tests hold the same
# code to 1e-5. The bf16 params are not compared: one bf16 ulp of a
# weight is 0.26 lr at |w| = 0.02 and 26 lr at a norm's 1.0, so a
# rounding flip alone passes any lr bound.
# deepseek-moe-16b routes each token to 6 of 64 experts, and rounding
# moves the router's logits: bf16 against f32 on one device routes 1,128
# and 2,516 of a layer's 24,576 (token, choice) pairs elsewhere (H100),
# the sharded step against the one-device step 709 and 1,924, and in
# both 119-126 of the 128 (layer, expert)s hold another token set, so
# gating only the experts whose tokens agree would gate almost none: the
# gates read every expert. A token that moves takes its whole
# contribution from one expert's rows to another's, so the floor's worst
# entry is 70% of its leaf's largest (we_down; lm_head 43%, embed 28%:
# the moved tokens' hidden states change downstream), against 3% without
# experts: the entry gate for deepseek is 0.85, between that floor and a
# dropped or doubled leaf (1.0 of its largest; the sharded step 43%).
# Per leaf the floor reads 5-14% (the sharded step 4-12%), under 0.25 as
# for the others. Per (layer, expert) the floor reads 33% (router, we_up;
# attention heads 10%) and the sharded step 29%, while the planted fault
# (rank 0's block of expert 0, layer 0 of we_up: half its rows, the rest
# on the other data rank) reads 71%: gated at 0.5, 1.5x the floor and
# 0.7x the fault. Its per-leaf reading (13%) sits under the floor, as
# rwkv6's does.
# qwen2-vl-2b, zamba2-1.2b and seamless-m4t-medium keep llama3.2-1b's
# gates. Their floors (H100, worst entry / leaf L2 / head L2): the VLM
# 2.3% / 2.0% / 2.8% and the enc-dec 1.1% / 1.1% / 2.2%, as llama3.2-1b;
# zamba2 19.2% / 12.0% / 11.4% (its bf16 gradients inside the Mamba
# layers sit 10-12% from f32, the head's 5%, as rwkv6's do), under the
# gates by 1.5x or more. The sharded steps read under their floors
# (2.4 / 2.0 / 2.7%, 1.4 / 1.3 / 2.3%, 12.3 / 8.5 / 7.7%), and each
# planted fault -- rank 0's block of head 0, layer 0 of attn/wq,
# cross_attn/wq and a Mamba head's rows of out_proj (a "heads_x" axis of
# ssm_head_dim rows, _ls_axes) -- reads 0.70-0.71 per head. zamba2's
# per-head scalars (a_log, dt_bias, d_skip: one entry a (layer, head),
# each a sum over every token) take no per-head L2: their relative
# error is one rounding's, which read 0.5-4.5 in a bf16 SMOKE floor;
# their entries and leaf L2 stay gated.
LS_LOSS_RTOL, LS_GRAD_NORM_RTOL, LS_M_TOL, LS_M_L2_TOL, LS_M_HEAD_TOL = (
    1e-2, 2e-2, 0.3, 0.25, 0.35)
LS_MOE_M_TOL, LS_MOE_M_EXPERT_TOL = 0.85, 0.5
LS_GATES = {
    "llama": dict(m_rel=LS_M_TOL, m_l2=LS_M_L2_TOL, m_head_l2=LS_M_HEAD_TOL),
    "pod": dict(m_rel=LS_M_TOL, m_l2=LS_M_L2_TOL, m_head_l2=LS_M_HEAD_TOL),
    "rwkv": dict(m_rel=LS_M_TOL, m_l2=LS_M_L2_TOL, m_head_l2=LS_M_HEAD_TOL),
    "moe": dict(m_rel=LS_MOE_M_TOL, m_l2=LS_M_L2_TOL,
                m_head_l2=LS_MOE_M_EXPERT_TOL),
    "vlm": dict(m_rel=LS_M_TOL, m_l2=LS_M_L2_TOL, m_head_l2=LS_M_HEAD_TOL),
    "zamba2": dict(m_rel=LS_M_TOL, m_l2=LS_M_L2_TOL,
                   m_head_l2=LS_M_HEAD_TOL),
    "encdec": dict(m_rel=LS_M_TOL, m_l2=LS_M_L2_TOL,
                   m_head_l2=LS_M_HEAD_TOL)}
# The leaves' head axes (a "heads_x" axis holds a head every head_dim
# entries; "experts" an expert: the per-head L2 is then per (layer,
# expert)), and the leaf where the phase plants its fault (rank 0's block
# of head or expert 0, layer 0).
LS_HEAD_AXES = ("heads", "kv_heads", "heads_x", "experts")
LS_PLANT = {"llama": "layers/attn/wq", "pod": "layers/attn/wq",
            "rwkv": "layers/tm/wr",
            "moe": "layers/moe/we_up", "vlm": "layers/attn/wq",
            "zamba2": "layers/out_proj", "encdec": "decoder/cross_attn/wq"}
LS_RUNS = ("llama", "pod", "rwkv", "moe", "vlm", "zamba2", "encdec")


def _ls_full():
    import dataclasses
    from repro_torch.configs import get_config
    llama = dataclasses.replace(get_config("llama3.2-1b"),
                                num_layers=LS_LLAMA_LAYERS)
    return dict(
        llama=llama, pod=llama,
        rwkv=dataclasses.replace(get_config("rwkv6-7b"),
                                 num_layers=LS_RWKV_LAYERS),
        moe=dataclasses.replace(get_config("deepseek-moe-16b"),
                                num_layers=LS_MOE_LAYERS),
        vlm=dataclasses.replace(get_config("qwen2-vl-2b"),
                                num_layers=LS_VLM_LAYERS),
        zamba2=dataclasses.replace(get_config("zamba2-1.2b"),
                                   num_layers=LS_ZAMBA_LAYERS),
        encdec=dataclasses.replace(
            get_config("seamless-m4t-medium"), num_layers=LS_ENCDEC_LAYERS,
            encoder_layers=LS_ENCDEC_LAYERS,
            decoder_layers=LS_ENCDEC_LAYERS),
        restart=dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                                    dtype="bfloat16"),
        seq=LT_SEQ, rank_device=None, ckpt_root=os.path.join(ROOT, "checkpoints",
                               "chip_smoke_lm_train_sharded"))


def _ls_steps(name):
    return {"rwkv": LS_RWKV_STEPS, "moe": LS_MOE_STEPS, "vlm": LS_NEW_STEPS,
            "zamba2": LS_NEW_STEPS, "encdec": LS_NEW_STEPS}.get(name,
                                                               LS_STEPS)


def _ls_extras(torch, cfg, full, b, step, dev):
    """The non-token inputs of a step's whole batch, drawn on ``dev`` from
    a generator seeded with the step (every rank draws the same): the
    VLM's patch embeddings (a quarter of the sequence, as
    ``launch.steps.input_specs`` draws them), the enc-dec's frames."""
    g = torch.Generator(device=dev).manual_seed(SEED + 80 + step)
    if cfg.family == "vlm":
        return {"patch_embeds": torch.randn(
            (b, max(full["seq"] // 4, 16), cfg.d_model), generator=g,
            device=dev)}
    if cfg.family == "encdec":
        return {"frames": torch.randn((b, full["seq"], cfg.frontend_dim),
                                      generator=g, device=dev)}
    return {}


def _ls_trainer(torch, name, full, dev, shardings=None, ckpt_dir="unused",
                ckpt_every=0, steps=LS_STEPS):
    """The Trainer of run ``name`` (one of ``LS_RUNS`` or "restart")."""
    from repro_torch.data import TokenTaskConfig, token_batch
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig, Trainer, TrainerConfig
    rwkv, cfg = name == "rwkv", full[name]
    tk = TokenTaskConfig(
        vocab_size=cfg.vocab_size, seq_len=full["seq"],
        batch_size=LT_RWKV_BATCH if rwkv else LT_BATCH, task="copy_map")
    tc = TrainerConfig(
        total_steps=steps, ckpt_every=ckpt_every, ckpt_dir=ckpt_dir,
        keep_last=2, log_every=1000, remat=True,
        opt=AdamWConfig(lr=LT_RWKV_LR if rwkv else LT_TRAIN_LR,
                        warmup_steps=1, total_steps=steps))
    return Trainer(build_model(cfg), tc,
                   lambda s: dict(token_batch(tk, s, device=dev),
                                  **_ls_extras(torch, cfg, full,
                                               tk.batch_size, s, dev)),
                   shardings=shardings, device=dev)


def _ls_keep_first(tr, look=None):
    """Keep the metrics of ``tr``'s first step, and its params and AdamW
    state, or only ``look(params, opt)``'s result when ``look`` is given
    (so no copy of the state outlives the step)."""
    first, step_fn = {}, tr._step_fn

    def keep(*args):
        out = step_fn(*args)
        if not first:
            first["metrics"] = out[3]
            if look is None:
                first.update(params=out[0], opt=out[1])
            else:
                first["look"] = look(out[0], out[1])
        return out
    tr._step_fn = keep
    return first


def _ls_start(torch, params):
    """A start state of whole params whose AdamW moments are zeros
    expanded over the params' shapes (no memory: ``run`` cuts each rank's
    block out of them)."""
    from repro_torch.models.params import tree_map
    z = lambda p: torch.zeros((), dtype=torch.float32,
                              device=p.device).expand(p.shape)
    return {"params": params,
            "opt": {"m": tree_map(z, params), "v": tree_map(z, params),
                    "step": torch.zeros((), dtype=torch.int32,
                                        device=_leaf0(params).device)},
            "err": torch.zeros((), device=_leaf0(params).device)}


def _peak_reset(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(torch, dev):
    return (torch.cuda.max_memory_allocated(dev)
            if torch.device(dev).type == "cuda" else None)


def _leaf0(tree):
    from repro_torch.training.optimizer import tree_leaves
    return tree_leaves(tree)[0]


def _ls_params(torch, name, cfg, dev):
    """The start params of run ``name``: from a seeded generator, with
    rwkv6-7b's ``_lm_params`` and zamba2's ``_hy_zamba_params`` (the
    ranks draw the same on their devices)."""
    from repro_torch.models import build_model
    model = build_model(cfg)
    if name == "rwkv":
        return _lm_params(torch, model, SEED + 55, dev)
    if name == "zamba2":
        return _hy_zamba_params(torch, model, SEED + 63, dev)
    seed = SEED + {"moe": 62, "vlm": 64, "encdec": 65}.get(name, 60)
    return model.init(torch.Generator(device=dev).manual_seed(seed),
                      device=dev)


class _LsRoutes:
    """Records the routing (``gate_idx``, ``keep``) of the first
    ``layers`` calls of ``layers.moe_route`` inside ``with``: a step's
    forward, layer by layer (remat's recomputes in the backward come
    after)."""

    def __init__(self, layers):
        self.layers, self.got = layers, []

    def __enter__(self):
        from repro_torch.models import layers as L
        self._real = L.moe_route

        def record(*args, **kw):
            r = self._real(*args, **kw)
            if len(self.got) < self.layers:
                self.got.append((r["gate_idx"].detach().clone(),
                                 r["keep"].detach().clone()))
            return r
        L.moe_route = record
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers as L
        L.moe_route = self._real


def _ls_route_diff(torch, got, ref, experts):
    """Per layer, the (token, choice) routings of ``got`` that differ from
    ``ref`` (chosen expert or kept), and a (layers, experts) mask of the
    experts whose kept token sets differ; ``ref`` may hold more groups
    than ``got``, whose groups are ``ref``'s from ``lo`` on (a tuple
    ``(routes, lo)``)."""
    ref, lo = ref
    flips, differ = [], []
    for (gi, gk), (ri, rk) in zip(got, ref):
        ri = ri[lo:lo + gi.shape[0]].to(gi.device)
        rk = rk[lo:lo + gi.shape[0]].to(gi.device)
        flips.append(int(((gi != ri) | (gk != rk)).sum()))
        ar = torch.arange(experts, device=gi.device)

        def held(i, k):         # (ng, g, E): the token holds a kept slot
            return ((i[..., None] == ar) & k[..., None]).any(dim=2)
        differ.append((held(gi, gk) != held(ri, rk)).any(dim=1).any(dim=0))
    return flips, torch.stack(differ)


def _ls_empty_experts(torch, routes, experts):
    """Per layer, the experts that hold no kept token."""
    out = []
    for i, k in routes:
        ar = torch.arange(experts, device=i.device)
        out.append(int((~((i[..., None] == ar) & k[..., None]).any(
            dim=(0, 1, 2))).sum()))
    return out


def ls_one_device(torch, dev, full):
    """The one-device references: each run of ``LS_RUNS`` (llama3.2-1b,
    rwkv6-7b, deepseek-moe-16b, qwen2-vl-2b, zamba2-1.2b,
    seamless-m4t-medium) trained by ``Trainer`` on the card; their losses,
    each rank's blocks of the first-step moments (bf16: 2**-9 of a value,
    far inside the gates) on the host with each leaf's largest, grad
    norm, step ms and peak, and deepseek's first-step routing; and the
    noise floor of the gates: the first step's gradients in bf16 against
    the same in f32 (a float32 model from the same params and batch), in
    the measures of ``_ls_compare`` (deepseek's with the routings that
    differ, and the experts whose token sets differ, counted per
    layer). The pod run shares llama's entry, with its ranks' blocks over
    its own mesh."""
    import dataclasses
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_map
    from repro_torch.training import adamw_init
    from repro_torch.training.determinism import deterministic
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.trainer import loss_and_grads
    out = {}
    for name in (n for n in LS_RUNS if n != "pod"):
        cfg = full[name]
        moe = cfg.family == "moe"
        nl = cfg.num_layers if moe else 0
        params = _ls_params(torch, name, cfg, dev)
        tr = _ls_trainer(torch, name, full, dev, steps=_ls_steps(name))
        first = _ls_keep_first(tr)
        _peak_reset(torch, dev)
        with _LsRoutes(nl) as routes:
            res = tr.run(start_state={"params": params,
                                      "opt": adamw_init(params),
                                      "err": torch.zeros((), device=dev)})
        times = [h["time_s"] for h in res["history"][1:]]
        m1 = first["opt"]["m"]
        m1_16 = tree_map(lambda m: m.to(torch.bfloat16), m1)
        for run in [name] + (["pod"] if name == "llama" else []):
            t0, parts = time.perf_counter(), {}
            blocks = _ls_rank_blocks(torch, tr.model, m1_16, parts,
                                     _ls_shape(run))
            out[run] = dict(
                m1=blocks, blocks_s=time.perf_counter() - t0,
                blocks_s_by_part=parts,
                m1_top=[float(m.abs().max()) for m in tree_leaves(m1)],
                losses=[h["loss"] for h in res["history"]],
                grad_norm1=float(first["metrics"]["grad_norm"]),
                step_ms=statistics.median(times) * 1e3,
                peak_bytes=_peak(torch, dev))
        del res, first, m1, m1_16
        _free(torch, dev)
        t0 = time.perf_counter()
        batch = tr.local_batch(tr.batch_fn(0))
        f32 = build_model(dataclasses.replace(cfg, dtype="float32"))
        with deterministic(all_ops=True):
            with _LsRoutes(nl) as r16:
                g16 = loss_and_grads(tr.model, params, batch, remat=True)[2]
            del params
            with _LsRoutes(nl) as r32:
                g32 = loss_and_grads(
                    f32, tree_map(lambda x: x.float(), _ls_params(
                        torch, name, cfg, dev)), batch, remat=True)[2]
        extra = {}
        tops = [float(g.abs().max()) for g in tree_leaves(g32)]
        axes, hd = _ls_axes(tr.model), _ls_head_dim(cfg)
        if moe:
            flips, differ = _ls_route_diff(torch, r16.got, (r32.got, 0),
                                           cfg.num_experts)
            extra = dict(routing_flips_by_layer=flips,
                         experts_moved_by_layer=differ.sum(1).tolist(),
                         tokens_by_layer=int(r16.got[0][0].numel()))
            out[name]["routes"] = [(i.cpu(), k.cpu()) for i, k in routes.got]
            out[name]["empty_experts_by_layer"] = _ls_empty_experts(
                torch, routes.got, cfg.num_experts)
        out[name]["floor"] = dict(
            _ls_compare(torch, None, g16, g32, tops, None, axes, hd,
                        plant=LS_PLANT[name]),
            seconds=time.perf_counter() - t0, **extra)
        if name == "llama":
            out["pod"]["floor"] = out[name]["floor"]
        del tr, g16, g32, batch, routes, r16, r32
        _free(torch, dev)
    return out


def _ls_rank_blocks(torch, model, tree, parts=None, shape=LS_MESH):
    """Each rank's blocks of ``tree`` (whole params-shaped arrays on the
    card) over a mesh of ``shape`` (``runtime.MESH_AXES`` by its number
    of dims), in host memory that ``spawn`` hands to the ranks without a
    copy: ``[rank]``. A rank's blocks are packed on
    the card into one buffer (16-byte aligned), copied to the host in one
    transfer through a pinned staging buffer, then into one new
    shared-memory segment, of which every leaf is a view (one segment a
    rank, in place of a segment and a pageable copy a leaf). ``parts``
    (a dict) gathers the seconds of each part: pack, d2h, segment,
    copy."""
    def lap(name, t):
        now = time.perf_counter()
        if parts is not None:
            parts[name] = parts.get(name, 0.0) + now - t
        return now
    from repro_torch.distributed import sharding as SH
    from repro_torch.training.optimizer import tree_map
    mesh = _ls_mesh(torch, shape)
    specs = SH.param_pspecs(model.defs(), mesh)
    out, stage = [], None
    for rank in range(len(mesh.device_list)):
        t = time.perf_counter()
        blocks = []

        def cut(x, s):
            blocks.append(x[SH.NamedSharding(mesh, s).devices_indices_map(
                tuple(x.shape))[rank]])
            return len(blocks) - 1
        index = tree_map(cut, tree, specs)
        offs, total = [], 0
        for b in blocks:
            offs.append(total)
            total += -(-b.numel() * b.element_size() // 16) * 16
        dev = blocks[0].device
        packed = torch.empty(total, dtype=torch.uint8, device=dev)

        def view(buf, i):
            b = blocks[i]
            n = b.numel() * b.element_size()
            return buf[offs[i]:offs[i] + n].view(b.dtype).view(b.shape)
        for i, b in enumerate(blocks):
            view(packed, i).copy_(b)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            t = lap("pack", t)
            if stage is None or stage.numel() < total:
                stage = torch.empty(total, dtype=torch.uint8,
                                    pin_memory=True)
            stage[:total].copy_(packed)
            packed = stage[:total]
        t = lap("d2h", t)
        # a fresh segment (share_memory_ of a new tensor would copy its
        # uninitialised bytes into one: 0.7 s for 0.6 GB on the CPU)
        seg = torch.empty(0, dtype=torch.uint8).set_(
            torch.UntypedStorage._new_shared(total))
        t = lap("segment", t)
        seg.copy_(packed)
        lap("copy", t)
        out.append(tree_map(lambda i: view(seg, i), index))
        del blocks, packed
    return out


def _ls_shape(name):
    """The mesh shape of run ``name``."""
    return LS_POD_MESH if name == "pod" else LS_MESH


def _ls_mesh(torch, shape):
    """A plain mesh of ``shape`` over ``runtime.MESH_AXES`` (host devices:
    for the specs and the blocks a rank holds)."""
    import math
    from repro_torch.distributed.mesh import Mesh
    from repro_torch.distributed.runtime import MESH_AXES
    return Mesh(MESH_AXES[len(shape)], tuple(shape),
                (torch.device("cpu"),) * math.prod(shape))


def _ls_rows(pm, batch):
    """The [lo, hi) of this rank's rows of a global batch of ``batch``
    rows, counted here from the rule the JAX package states (the batch
    split over the axes of ``(pod, data)`` that divide it, in turn, the
    first the major one; copied over the others) and the rank's
    coordinates."""
    block, parts = 0, 1
    for a in ("pod", "data"):
        n = pm.axis_size(a)
        if batch % (parts * n) == 0:
            block, parts = block * n + (pm.coord(a) if n > 1 else 0), \
                parts * n
    step = batch // parts
    return block * step, (block + 1) * step


def _ls_paths(tree, prefix=""):
    """The "/"-joined leaf paths of a tree, in ``tree_leaves``' order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _ls_paths(tree[k], f"{prefix}{k}/")]
    return [prefix[:-1]]


def _ls_axes(model):
    """The logical axes of each leaf of ``model.defs()``, in
    ``tree_leaves``' order. zamba2's ``out_proj`` rows are its SSD heads'
    (a head every ``ssm_head_dim`` rows): read as a "heads_x" axis."""
    def walk(defs, path):
        if isinstance(defs, dict):
            return [a for k in sorted(defs) for a in walk(defs[k],
                                                          f"{path}{k}/")]
        if model.cfg.family == "zamba2" and path == "layers/out_proj/":
            return [("layers", "heads_x", "embed")]
        return [tuple(defs.axes)]
    return walk(model.defs(), "")


def _ls_head_dim(cfg):
    if cfg.family == "zamba2":
        return cfg.ssm_head_dim
    return getattr(cfg, "rwkv_head_dim", None) or cfg.head_dim


def _ls_head_axis(axes):
    """The dim of a leaf's head axis, or None."""
    return next((i for i, a in enumerate(axes) if a in LS_HEAD_AXES), None)


def _ls_head_sums(x, axes, head_dim):
    """(dim of the head axis, sums of ``x`` per (layer, head), shaped
    (layers or 1, heads)) for a leaf with a head axis, else (None, None).
    """
    h = _ls_head_axis(axes)
    if h is None:
        return None, None
    lay = axes.index("layers") if "layers" in axes else None
    if axes[h] == "heads_x":
        x = x.unflatten(h, (-1, head_dim))
    x = x.movedim(h, 0)[None] if lay is None else x.movedim((lay, h),
                                                            (0, 1))
    return h, x.reshape(x.shape[0], x.shape[1], -1).sum(-1)


def _ls_reduce(pm, t, op, axes=None):
    """``t`` reduced in place over ``axes`` (every axis by default) of
    ``pm`` straight through the process group, so outside the collective
    tallies; nothing with ``pm`` None."""
    import torch.distributed as dist
    for a in (() if pm is None else axes or pm.axis_names):
        if pm.axis_size(a) > 1:
            dist.all_reduce(t, op=op, group=pm.group(a))


def _ls_compare(torch, pm, got_m, ref_m, tops, specs, axes, head_dim, *,
                plant):
    """The first moments ``got_m`` against the one-device ``ref_m`` (this
    rank's blocks of both over ``pm``, the latter on the host; whole
    arrays with ``pm`` None), maxed over the mesh: the worst
    entry as a share of its leaf's largest (``tops``); each leaf's
    relative L2; and each (layer, head)'s -- or (layer, expert)'s --
    relative L2 in the leaves with a head or experts axis and more than
    one entry a (layer, head) (a head or an expert without a reference
    gradient has none: it reads 0, or inf if it got one). The same three for the leaf ``plant`` with its first
    head or expert of layer 0 zeroed on rank 0: a planted fault (one
    head's gradient dropped), which the gates must see. The reductions
    stay outside the collective tallies."""
    import torch.distributed as dist
    from repro_torch.training.optimizer import spec_leaves, tree_leaves
    paths = _ls_paths(ref_m)
    n = len(paths)
    got = tree_leaves(got_m)
    dev = got[0].device
    specs = spec_leaves(specs) if pm is not None else [()] * n
    held = _ls_owner(pm, specs) if pm is not None else [True] * n
    lead = pm is None or pm.rank == 0
    # [share by leaf, planted share, head L2 by leaf, planted head L2]
    # (max); [d2, r2 by leaf, planted d2, r2] (sum)
    row = torch.zeros(2 * n + 2, dtype=torch.float64, device=dev)
    sq = torch.zeros(2 * n + 2, dtype=torch.float64, device=dev)
    per_head = set()
    for i, (gm, rm, s, ax) in enumerate(zip(got, tree_leaves(ref_m), specs,
                                            axes)):
        mc = rm.to(dev).float()
        cases = [gm.float()]
        if paths[i] == plant:
            if lead:
                cases.append(cases[0].clone())
                cut = [slice(None)] * len(ax)
                cut[ax.index("layers")] = 0
                h = _ls_head_axis(ax)
                cut[h] = slice(0, head_dim if ax[h] == "heads_x" else 1)
                cases[1][tuple(cut)] = 0.0
            else:
                cases.append(cases[0])
        for j, g in enumerate(cases):
            d = g - mc
            if tops[i] > 0:
                row[i if j == 0 else n] = d.abs().max() / tops[i]
            if held[i]:                # each block once in the L2 sums
                k = (i, n + i) if j == 0 else (2 * n, 2 * n + 1)
                sq[k[0]] = torch.sum(torch.square(d.double()))
                sq[k[1]] = torch.sum(torch.square(mc.double()))
            h, d2 = _ls_head_sums(torch.square(d.double()), ax, head_dim)
            if h is None or d2.numel() == d.numel():
                # no head axis, or one entry a (layer, head) (zamba2's
                # a_log, dt_bias, d_skip: their entries and L2 are gated)
                continue
            per_head.add(i)
            sums = torch.stack([d2, _ls_head_sums(
                torch.square(mc.double()), ax, head_dim)[1]])
            # a head's entries off the head dim lie on other ranks
            _ls_reduce(pm, sums, dist.ReduceOp.SUM,
                       [e for k, e in enumerate(s) if e and k != h])
            ratio = torch.where(sums[1] > 0, sums[0] / sums[1].clamp(
                min=1e-300), torch.where(sums[0] > 0, torch.inf, 0.0))
            row[n + 1 + i if j == 0 else 2 * n + 1] = ratio.sqrt().max()
    _ls_reduce(pm, row, dist.ReduceOp.MAX)
    _ls_reduce(pm, sq, dist.ReduceOp.SUM)
    l2 = (sq[:n] / sq[n:2 * n].clamp(min=1e-300)).sqrt().tolist()
    row, sq = row.tolist(), sq.tolist()
    heads = {p: row[n + 1 + i] for i, p in enumerate(paths)
             if i in per_head}
    out = dict(m_rel=max(row[:n]), m_l2=max(l2), m_head_l2=max(heads.values()),
               m_rel_by_leaf=dict(zip(paths, row[:n])),
               m_l2_by_leaf=dict(zip(paths, l2)), m_head_l2_by_leaf=heads,
               planted=dict(leaf=plant, m_rel=row[n],
                            m_l2=(sq[2 * n] / max(sq[2 * n + 1], 1e-300))
                            ** 0.5, m_head_l2=row[2 * n + 1]))
    return out


def _ls_owner(pm, specs):
    """Per leaf spec, whether this rank adds its block to a sum over the
    mesh: index 0 on every axis the leaf is replicated over."""
    out = []
    for s in specs:
        used = {e for e in s if e is not None}
        out.append(all(pm.coord(a) == 0 for a in pm.axis_names
                       if a not in used))
    return out


def _ls_expected(torch, cfg, mesh_shape=LS_MESH):
    """The collectives a rank issues in one remat train step over a mesh
    of ``mesh_shape`` (every family but rwkv6), counted from the specs
    (``param_pspecs``) and the layers' TP, expert-parallel and SSD-head
    sites as ``tests/test_torch_dist_train.py`` counts them, a remat'd
    layer's forward twice (remat recomputes it in the backward) and
    zamba2's shared block, which keeps its activations, once an
    invocation; and the bytes of its FSDP all-gathers and reduce-scatters
    (each the gathered block, in the params' dtype) and of its
    all-reduces over ``pod`` (every gradient block, the loss's total and
    count, the global norm): ``(counts, bytes)`` by ``"op/axis"``. A
    collective over an axis of one rank is none."""
    import collections
    import math
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import build_model
    from repro_torch.models.params import ParamDef
    from repro_torch.training.optimizer import spec_leaves, tree_leaves
    mesh = _ls_mesh(torch, mesh_shape)
    sizes = dict(mesh.shape)
    tp = sizes.get("model", 1)
    defs = build_model(cfg).defs()
    specs = SH.param_pspecs(defs, mesh)
    item = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()

    def leaf(path):
        d, sp = defs, specs
        for k in path.split("/"):
            d, sp = d[k], sp[k]
        assert isinstance(d, ParamDef)
        stacked = d.axes[0] == "layers"
        return (tuple(sp)[1:] if stacked else tuple(sp),
                d.shape[1:] if stacked else d.shape)

    def layout(shape, cands):
        for cand in tuple(cands) + ((None,) * len(shape),):
            cand = tuple(cand) + (None,) * (len(shape) - len(cand))
            if all(n % (sizes[e] if e else 1) == 0
                   for n, e in zip(shape, cand)):
                return cand

    up, down = ((None, "model"), ("model", None)), (("model", None),
                                                    (None, "model"))
    kv_tp = cfg.num_kv_heads % tp == 0
    # gated MLPs (MoE's shared experts always)
    swiglu = cfg.activation == "swiglu" or cfg.family == "moe"

    def attn(prefix):
        heads = (None, "model", None)
        kv = heads if kv_tp else (None,) * 3
        wo = ("model", None, None) if cfg.num_heads % tp == 0 else (None,) * 3
        return [(f"{prefix}/wq", (heads,)), (f"{prefix}/wk", (kv,)),
                (f"{prefix}/wv", (kv,)), (f"{prefix}/wo", (wo,))]

    def mlp(prefix):
        return ([(f"{prefix}/w_gate", up)] if swiglu else []) + [
            (f"{prefix}/w_up", up), (f"{prefix}/w_down", down)]

    # (uses, forwards, backwards): a remat'd stack of nl layers runs its
    # forward twice; a leaf outside the layers once
    nl = cfg.num_layers
    head = [("embed", (("model", None),)),
            ("embed", (("model", None),)) if cfg.tie_embeddings
            else ("lm_head", ((None, "model"),))]
    groups = [(head, 1, 1)]
    whole = []              # gathered whole at use (zamba2's in_proj, conv)
    n, nbytes = collections.Counter(), collections.Counter()
    fam = cfg.family
    q_bwd = 1 + (0 if kv_tp else 2)       # q's copy_to (K's and V's)
    up_bwd = 2 if swiglu else 1           # the up projections' copy_to
    if fam == "zamba2":
        inv = len(range(0, nl, cfg.attn_every or nl))
        groups += [([("layers/out_proj", down)], 2 * nl, nl),
                   (attn("shared/attn") + mlp("shared/mlp"), inv, inv)]
        whole = [("layers/in_proj", 2 * nl, nl), ("layers/conv_w", 2 * nl, nl),
                 ("layers/conv_b", 2 * nl, nl)]
        # Mamba: the norm's statistic twice, out_proj's all-reduce once
        # (remat's recompute stops before a layer's last all-reduce);
        # back: in_proj's copy_to and the statistic's; norm_s's split_to
        # back. The shared block: wo's and the down's all-reduce; back:
        # q's, the up projections' copy_to.
        n["all_reduce/model"] += nl * (2 + 1) + nl * 2 + inv * (
            2 + q_bwd + up_bwd)
        n["all_gather/model"] += nl
    elif fam == "encdec":
        ne, nd = cfg.encoder_layers, cfg.decoder_layers
        groups += [([("frontend_proj", ((None, None),))], 1, 1),
                   (attn("encoder/attn") + mlp("encoder/mlp"), 2 * ne, ne),
                   (attn("decoder/self_attn") + attn("decoder/cross_attn")
                    + mlp("decoder/mlp"), 2 * nd, nd)]
        # forward: each wo's all-reduce twice, the down's once; back:
        # each q's copy_to (K's and V's), the cross-attention's kv_x
        # copy_to under kv_tp, the up projections'
        n["all_reduce/model"] += ne * (2 + 1 + q_bwd + up_bwd) + nd * (
            2 * 2 + 1 + q_bwd + q_bwd + (1 if kv_tp else 0) + up_bwd)
    else:
        groups += [(attn("layers/attn") + mlp(
            "layers/moe/shared" if fam == "moe" else "layers/mlp"),
            2 * nl, nl)]
        if fam == "moe":
            groups += [([("layers/moe/router", ((None, "model"),))] + [
                (f"layers/moe/{k}", (("model", None, None),))
                for k in ("we_gate", "we_up", "we_down")], 2 * nl, nl)]
        # Forward: wo's all-reduce twice, the MLP's (or shared experts')
        # down once: remat's recompute stops at the last activation the
        # backward reads (torch.utils.checkpoint), before a layer's last
        # all-reduce. Backward: q's copy_to (K/V's too without kv_tp),
        # the up projections'.
        n["all_reduce/model"] += nl * (2 + 1) + nl * (q_bwd + up_bwd)
    for uses, fwd, once in groups:
        for path, cands in uses:
            spec, shape = leaf(path)
            if "data" in spec:
                gathered = math.prod(shape) // (tp if "model" in spec else 1)
                n["all_gather/data"] += fwd
                n["reduce_scatter/data"] += once
                nbytes["all_gather/data"] += fwd * gathered * item
                nbytes["reduce_scatter/data"] += once * gathered * item
            src = spec.index("model") if "model" in spec else None
            lay = layout(shape, cands)
            dst = lay.index("model") if "model" in lay else None
            if src != dst:   # gather_from forward, split_to's gather back
                n["all_gather/model"] += fwd * (src is not None) + once * (
                    dst is not None)
    for path, fwd, once in whole:     # all-gathered, reduce-scattered back
        spec, shape = leaf(path)
        for axis in filter(None, spec):
            n[f"all_gather/{axis}"] += fwd
            n[f"reduce_scatter/{axis}"] += once
            if axis == "data":
                gathered = math.prod(shape) // (tp if "model" in spec else 1)
                nbytes["all_gather/data"] += fwd * gathered * item
                nbytes["reduce_scatter/data"] += once * gathered * item
    n["all_reduce/data"] += 3 + sum(
        "data" not in sp for sp in spec_leaves(specs))
    if fam == "moe":
        n["all_reduce/data"] += 2 * 2 * nl       # the aux loss's me, ce
        # the combine's all-reduce (forward), xg's copy_to (backward);
        # the gathered logits (forward), the combine's split_to (back)
        n["all_reduce/model"] += 2 * nl + nl
        n["all_gather/model"] += 2 * nl + nl
    # with the vocab on 'model': the embedding, the head's copy_to, the
    # loss (max, sum of exps, target logit); the global norm
    n["all_reduce/model"] += (1 + 1 + 3) * (cfg.vocab_size % tp == 0) + 1
    # over 'pod': every gradient block; the loss's total and count and
    # the global norm (f32 scalars); the aux loss's me and ce (f32, one
    # entry an expert)
    aux = 2 * 2 * nl if fam == "moe" else 0
    n["all_reduce/pod"] += len(spec_leaves(specs)) + 3 + aux
    nbytes["all_reduce/pod"] += 3 * 4 + aux * cfg.num_experts * 4 + sum(
        math.prod(d.shape) // math.prod(
            sizes[a] for e in sp if e for a in ((e,) if isinstance(e, str)
                                                else e)) * item
        for d, sp in zip(tree_leaves(defs), spec_leaves(specs)))
    live = lambda k: sizes.get(k.split("/")[1], 1) > 1
    return ({k: v for k, v in sorted(n.items()) if live(k)},
            {k: v for k, v in sorted(nbytes.items()) if live(k)})


def _ls_counts():
    from repro_torch.distributed import collectives as C
    return ({f"{op}/{axis}": n for (op, axis), n in sorted(
        C.launches.items())},
        {f"{op}/{axis}": n for (op, axis), n in sorted(
            C.bytes_moved.items())})


def ls_train(torch, pm, full, name, ref, k4):
    """One sharded run on this rank from the one-device run's start
    params, drawn on the rank's device (the trainer cuts its blocks):
    losses, step ms, tokens/s, the rank's peak, collectives and K4
    launches a run, whether the rank's batch rows are those ``_ls_rows``
    counts, and the first step against the one-device step (``ref``'s
    first-step params and moments, on the host)."""
    from repro_torch.distributed import collectives as C
    from repro_torch.training.trainer import state_shardings
    from repro_torch.models import build_model
    import torch.distributed as dist
    cfg = full[name]
    steps = _ls_steps(name)
    moe = cfg.family == "moe"
    sh = state_shardings(build_model(cfg), pm)
    tr = _ls_trainer(torch, name, full, pm.device, shardings=sh,
                     steps=steps)
    # No rank touches another's card: with a card a rank, a rank that ran
    # kernels on cuda:0 while rank 0's NCCL kernels spun there waiting
    # for it hung both (4 H100s, a 600 s watchdog timeout).
    mine = ref["m1"][pm.rank]
    routes = _LsRoutes(cfg.num_layers if moe else 0)

    def look(p, o):
        t0 = time.perf_counter()
        extra = {}
        if moe:
            # this rank's groups are the one-device step's from lo on
            ng = routes.got[0][0].shape[0]
            flips, differ = _ls_route_diff(
                torch, routes.got, (ref["routes"], pm.coord("data") * ng),
                cfg.num_experts)
            flips = torch.tensor(flips, dtype=torch.float64,
                                 device=pm.device)
            differ = differ.double()
            _ls_reduce(pm, flips, dist.ReduceOp.SUM, ["data"])
            _ls_reduce(pm, differ, dist.ReduceOp.MAX, ["data"])
            # the same bits on every 'model' rank of a row block
            same = []
            for gi, gk in routes.got:
                for t in (gi.double(), gk.double()):
                    hi, lo = t.clone(), t.clone()
                    _ls_reduce(pm, hi, dist.ReduceOp.MAX, ["model"])
                    _ls_reduce(pm, lo, dist.ReduceOp.MIN, ["model"])
                    same.append(bool(torch.equal(hi, lo)))
            flag = torch.tensor([float(all(same))], device=pm.device)
            _ls_reduce(pm, flag, dist.ReduceOp.MIN)
            extra = dict(routing_flips_by_layer=[int(x) for x in
                                                 flips.tolist()],
                         experts_moved_by_layer=[int(x) for x in
                                                 differ.sum(1).tolist()],
                         routing_equal_on_model_ranks=bool(flag.item()
                                                           == 1.0))
        out = _ls_compare(
            torch, pm, o["m"], mine, ref["m1_top"], tr.specs["params"],
            _ls_axes(tr.model), _ls_head_dim(cfg),
            plant=LS_PLANT[name])
        return dict(out, compare_s=time.perf_counter() - t0, **extra)
    start = _ls_params(torch, name, cfg, pm.device)
    first = _ls_keep_first(tr, look)
    rows, local_batch = [], tr.local_batch

    def local(batch):
        got = local_batch(batch)
        if not rows:
            lo, hi = _ls_rows(pm, batch["tokens"].shape[0])
            rows.append(all(torch.equal(got[k], v[lo:hi])
                            for k, v in batch.items()))
        return got
    tr.local_batch = local
    k4_in = []
    real_cuda = k4.wkv6_scan_cuda

    def recording(*args):
        if not k4_in:
            k4_in.append([None if a is None else a.detach().clone()
                          for a in args])
        return real_cuda(*args)
    k4.wkv6_scan_cuda = recording
    _sync(torch, pm.device)
    _peak_reset(torch, pm.device)
    k4.launches = 0
    C.reset_counts()
    try:
        with routes:
            res = tr.run(start_state=_ls_start(torch, start))
    finally:
        k4.wkv6_scan_cuda = real_cuda
    _sync(torch, pm.device)
    launches = k4.launches
    counts, nbytes = _ls_counts()
    times = [h["time_s"] for h in res["history"][1:]]
    batch = LT_RWKV_BATCH if name == "rwkv" else LT_BATCH
    del routes
    row = dict(
        config=f"{cfg.name} widths, {cfg.num_layers} layers, {cfg.dtype}, "
               f"B={batch}, S={full['seq']}, remat, mesh {dict(pm.shape)}",
        rows_equal=rows == [True],
        losses=[h["loss"] for h in res["history"]],
        step_ms=[h["time_s"] * 1e3 for h in res["history"]],
        step_ms_median=statistics.median(times) * 1e3,
        tokens_per_s=batch * full["seq"] / statistics.median(times),
        peak_bytes=_peak(torch, pm.device),
        k4_launches=launches,
        collectives_per_step={k: v / steps for k, v in counts.items()},
        collective_bytes_per_step={k: v / steps for k, v in nbytes.items()},
        grad_norm1=float(first["metrics"]["grad_norm"]), **first["look"])
    if k4_in:
        want = k4.wkv6_scan_plain(*k4_in[0])
        got = real_cuda(*k4_in[0])
        _sync(torch, pm.device)
        row["k4_vs_plain"] = dict(
            shape=list(k4_in[0][0].shape), dtype=str(k4_in[0][0].dtype),
            bitwise=_bitwise(torch, want, got),
            max_abs_err=_max_err(want, got))
    del res, tr, first, k4_in, start, mine
    _free(torch, pm.device)
    return row


def ls_restart(torch, pm, full, root):
    """SMOKE llama3.2-1b in bf16 over the mesh: two steps uninterrupted,
    then the same two with checkpoints every step and a
    ``SimulatedFailure`` on every rank before the second, through
    ``run_with_restarts``: losses and every rank's final blocks bit for
    bit."""
    import torch.distributed as dist
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import tree_leaves
    from repro_torch.training.trainer import SimulatedFailure, state_shardings
    cfg = full["restart"]
    sh = state_shardings(build_model(cfg), pm)
    gen = torch.Generator(device=pm.device).manual_seed(SEED + 61)
    plain = _ls_trainer(torch, "restart", full, pm.device, shardings=sh,
                        steps=2)
    ref = plain.run(gen)
    crashed = []

    def hook(step):
        if step == 1 and not crashed:
            crashed.append(step)
            raise SimulatedFailure("simulated node failure")
    again = _ls_trainer(torch, "restart", full, pm.device, shardings=sh,
                        ckpt_dir=os.path.join(root, "restart"),
                        ckpt_every=1, steps=2)
    t0 = time.perf_counter()
    res = again.run_with_restarts(gen, failure_hook=hook)
    run_s = time.perf_counter() - t0
    same = torch.tensor(
        [float(all(torch.equal(a, b) for a, b in zip(
            tree_leaves(res["state"]), tree_leaves(ref["state"]))))],
        device=pm.device)
    _ls_reduce(pm, same, dist.ReduceOp.MIN)
    losses = [h["loss"] for h in ref["history"]]
    got = [h["loss"] for h in res["history"]]
    return dict(config=f"{cfg.name} widths, {cfg.num_layers} layers, "
                       f"{cfg.dtype}, B={LT_BATCH}, S={full['seq']}",
                losses=losses, restarted_losses=got, crashed=bool(crashed),
                losses_equal=got == losses[1:],
                states_equal_on_every_rank=bool(same.item() == 1.0),
                restarted_run_s=run_s)


def ls_rank(rank, world, port, backend, full, refs, out_dir):
    """One rank of the phase: joins the process group, trains each run of
    ``LS_RUNS`` over the mesh and runs the restart; writes its rows."""
    import torch
    from repro_torch.distributed import runtime as R
    from repro_torch.kernels import wkv6_scan as k4
    dev = torch.device(full["rank_device"] or "cuda",
                       rank % max(torch.cuda.device_count(), 1))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    pm = R.init("localhost", port, world, rank, backend=backend,
                device=dev, shape=LS_MESH, timeout_s=LS_TIMEOUT_S)
    meshes = {LS_MESH: pm, LS_POD_MESH: R.process_mesh(
        LS_POD_MESH, R.MESH_AXES[3], dev, timeout_s=LS_TIMEOUT_S)}
    out = dict(rank=rank, device=str(dev), backend=backend,
               init_s=time.perf_counter() - t0)
    for name in LS_RUNS:
        t1 = time.perf_counter()
        out[name] = ls_train(torch, meshes[_ls_shape(name)],
                             full, name, refs[name], k4)
        out[name + "_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["restart"] = ls_restart(torch, pm, full, out_dir)
    out["restart_s"] = time.perf_counter() - t1
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def lm_train_sharded_phase(torch, dev, k4, smi):
    """Phase 12b: the one-device references on the card, then four ranks
    (``runtime.spawn``; gloo on cuda:0, or NCCL one rank a card with four
    cards) train llama3.2-1b, rwkv6-7b, deepseek-moe-16b, qwen2-vl-2b,
    zamba2-1.2b and seamless-m4t-medium through
    ``Trainer(shardings=...)`` from the same params, each run's first step
    gated against the one-device step (the gates shown to sit between the
    bf16 noise floor and a planted fault; deepseek's per expert, its
    routings that differ counted per layer and its routing the same bits
    on every 'model' rank), the
    collectives a rank issues a step against the count from the specs
    (every run but rwkv6-7b), every rank's K4 launches counted and K4 held
    against its plain version on a rank's real inputs; the crash and
    restart bit for bit. Returns the K4 numbers the ``kernels`` line
    needs."""
    import shutil
    from repro_torch.distributed import runtime as R
    full = _ls_full()
    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 4 else "gloo"
    refs = ls_one_device(torch, dev, full)
    ref_s = time.perf_counter() - t0
    shutil.rmtree(full["ckpt_root"], ignore_errors=True)
    os.makedirs(full["ckpt_root"])
    # The ranks take their blocks of the references from the host (in
    # shared memory) and draw the start params on their own devices.
    host = {n: {k: refs[n].pop(k) for k in ("m1", "m1_top", "routes")
                if k in refs[n]} for n in refs}
    ref_bytes = (torch.cuda.memory_reserved(dev)
                 if torch.device(dev).type == "cuda" else None)
    t1 = time.perf_counter()
    R.spawn(ls_rank, 4, (R.free_port(), backend, full, host,
                         full["ckpt_root"]))
    ranks_s = time.perf_counter() - t1
    rows = []
    for r in range(4):
        with open(os.path.join(full["ckpt_root"], f"rank{r}.json")) as f:
            rows.append(json.load(f))
    del host
    shutil.rmtree(full["ckpt_root"], ignore_errors=True)
    out = dict(nvidia_smi=smi, backend=backend, cards=cards, mesh=LS_MESH,
               pod_mesh=LS_POD_MESH, ranks=4, parent_reserved_bytes=ref_bytes,
               tolerance=dict(loss_rtol=LS_LOSS_RTOL,
                              grad_norm_rtol=LS_GRAD_NORM_RTOL,
                              first_moments=LS_GATES))
    k4_err, launches, failed = 0.0, 0, []
    for name in LS_RUNS:
        ref, lead = refs[name], rows[0][name]
        loss_rel = max(abs(a - b) / abs(b) for a, b in
                       zip(lead["losses"], ref["losses"]))
        gn_rel = abs(lead["grad_norm1"] - ref["grad_norm1"]) / ref[
            "grad_norm1"]
        row = dict(lead, one_device_losses=ref["losses"],
                   noise_floor=ref["floor"],
                   reference_blocks_s=ref["blocks_s"],
                   reference_blocks_s_by_part=ref["blocks_s_by_part"],
                   one_device_step_ms=ref["step_ms"],
                   one_device_peak_bytes=ref["peak_bytes"],
                   loss_rel=loss_rel, grad_norm_rel=gn_rel,
                   peak_bytes_by_rank=[x[name]["peak_bytes"] for x in rows],
                   k4_launches_by_rank=[x[name]["k4_launches"]
                                        for x in rows],
                   step_ms_by_rank=[x[name]["step_ms_median"] for x in rows],
                   seconds_by_rank=[x[name + "_s"] for x in rows],
                   pod_all_reduce_bytes_per_step=lead[
                       "collective_bytes_per_step"].get("all_reduce/pod"))
        if not all(x[name]["rows_equal"] for x in rows):
            failed.append(f"{name}: a rank's batch rows")
        if full[name].family != "rwkv6":
            counts, nbytes = _ls_expected(torch, full[name], _ls_shape(name))
            row["expected_collectives_per_step"] = counts
            row["expected_bytes_per_step"] = nbytes
            if not all(x[name]["collectives_per_step"] == counts
                       for x in rows):
                failed.append(f"{name}: collectives a step against the "
                              f"specs' count")
            if not all(x[name]["collective_bytes_per_step"][k] == v
                       for x in rows for k, v in nbytes.items()):
                failed.append(f"{name}: FSDP and pod bytes a step "
                              f"against the specs")
        if full[name].family == "moe":
            row["one_device_empty_experts_by_layer"] = ref[
                "empty_experts_by_layer"]
            if not all(x[name]["routing_equal_on_model_ranks"]
                       for x in rows):
                failed.append(f"{name}: routing differs between the "
                              f"'model' ranks")
        gates = LS_GATES[name]
        row["gates"] = gates
        out[name] = row
        if not (all(np.isfinite(lead["losses"]))
                and loss_rel <= LS_LOSS_RTOL
                and gn_rel <= LS_GRAD_NORM_RTOL
                and all(lead[k] <= v for k, v in gates.items())):
            failed.append(f"sharded {name} against one device")
        # The gates must pass the bf16 noise floor and see a fault in one
        # head or expert (the per-head L2 alone can: one head of 64 in
        # one of 4 layers moves its leaf's L2 by a few per cent).
        if not all(ref["floor"][k] <= v for k, v in gates.items()):
            failed.append(f"{name}: the bf16 noise floor above a gate")
        if not lead["planted"]["m_head_l2"] > gates["m_head_l2"]:
            failed.append(f"{name}: a planted fault under the gates")
        if name == "rwkv" and torch.device(dev).type == "cuda":
            cfg = full["rwkv"]
            want = cfg.num_layers * LS_RWKV_STEPS * 2      # remat
            launches = sum(row["k4_launches_by_rank"])
            if not all(n == want for n in row["k4_launches_by_rank"]):
                failed.append(f"K4 launches by rank, want {want} each")
            heads = cfg.rwkv_heads // LS_MESH[1]
            for x in rows:
                k = x["rwkv"]["k4_vs_plain"]
                if not (k["bitwise"] and k["shape"] == [
                        LT_RWKV_BATCH // LS_MESH[0], full["seq"], heads,
                        cfg.rwkv_head_dim]):
                    failed.append(f"K4 on rank {x['rank']}")
                k4_err = max(k4_err, k["max_abs_err"])
    rs = rows[0]["restart"]
    out["restart"] = dict(rs, seconds_by_rank=[x["restart_s"]
                                               for x in rows])
    if not (rs["crashed"] and rs["losses_equal"]
            and rs["states_equal_on_every_rank"]):
        failed.append("the sharded restart against the uninterrupted run")
    out["seconds"] = dict(one_device=ref_s, ranks=ranks_s,
                          total=time.perf_counter() - t0,
                          rank_init=[x["init_s"] for x in rows])
    emit("lm_train_sharded", **out)
    check(not failed, f"lm_train_sharded: {failed}")
    del refs
    _free(torch, dev)
    pod = dict(cfg=full["pod"], seq=full["seq"], batch=LT_BATCH,
               per_rank=[dict(launches=x["pod"]["collectives_per_step"],
                              tensor_bytes=x["pod"][
                                  "collective_bytes_per_step"])
                         for x in rows])
    return {"launches": launches, "max_abs_err": k4_err, "pod": pod}


# ----------------------------------------------------------------------
# Phase 12c: LM decode over a mesh -- launch.steps.make_serve_step on each
# rank's blocks in serve mode (every weight read as the block the rank
# stores; rows of activations, token ids, softmax statistics and partial
# sums cross ranks), four gloo ranks sharing cuda:0 at (2, 2) on one card
# (NCCL one rank a card with four cards), and at (2, 2, 1) for
# llama3.2-1b.
# ----------------------------------------------------------------------

LD_MESH, LD_POD_MESH = (2, 2), (2, 2, 1)
# B=8 (two rows a rank at (2, 2), data=2; one at (2, 2, 1)), a 64-token
# prompt prefilled on one device, then LD_STEPS decode steps from the
# placed cache blocks, every run fed the one-device run's greedy tokens.
LD_BATCH, LD_PROMPT, LD_STEPS = 8, 64, 8
# llama3.2-1b at full width and depth (bf16, ternary and the pod mesh;
# f32 at LD_F32_LAYERS); h2o-danube-1.8b at full width cut to 2 of 24 layers, its
# sliding window cut to a ring of 64 slots, so the prompt fills it and
# every decode step wraps it (each of the two 'model' ranks holds 32
# slots); rwkv6-7b at full width cut to 4 of 32 layers, bf16 and
# ternary (K4 on 32 of its 64 heads a rank).
LD_DANUBE_LAYERS, LD_DANUBE_RING, LD_RWKV_LAYERS = 2, 64, 4
# llama3.2-1b's f32 run cut to 4 of 16 layers (at 16 its ranks took 9.9
# s of the phase's 85 on the H100; the bf16 and ternary runs keep the
# full depth).
LD_F32_LAYERS = 4
# The other families at full width, depth cut: qwen2-vl-2b at 4 of 28
# layers (bf16 and ternary; M-RoPE, the tied head), deepseek-moe-16b at
# 2 of 28 (bf16; 8 tokens in one group of the global batch, capacity 1),
# zamba2-1.2b at 6 of 38 (bf16 and ternary: one shared-block invocation,
# its KV cache clamped to a ring of LD_ZAMBA_RING slots, so the prompt
# fills it and every step wraps it), seamless-m4t-medium at 2 of 12
# decoder layers (bf16; 2 of 12 encoder layers encode LD_FRAMES frames
# into the cross K/V on one device).
LD_QWEN_LAYERS, LD_MOE_LAYERS, LD_ZAMBA_LAYERS, LD_SEAMLESS_LAYERS = (
    4, 2, 6, 2)
LD_ZAMBA_RING, LD_FRAMES = 64, 128
# Context parallelism: global batches the batch axes do not
# divide, so the rows are whole on every rank of an axis and the cache is
# split over a sequence or state dim there. B=1 over (2, 2): llama3.2-1b
# at full depth, an LD_CP_CACHE-slot cache over ("data", "model") filled
# by one forward over an LD_CP_PROMPT-token prompt (each layer's K and V
# taken from its attention, ``_ld_forward_prefill``); h2o-danube-1.8b at
# LD_DANUBE_LAYERS on its real 4,096-slot ring, an LD_CP_DANUBE_PROMPT-
# token prompt so that the steps wrap it; rwkv6-7b at LD_RWKV_LAYERS, bf16
# and ternary (hd 64 over data 2: 32 rows a rank through K4's stripe
# entry); zamba2-1.2b at LD_ZAMBA_LAYERS on its 4,096-slot window, the
# SSM head dim over 'data'. llama3.2-1b at full depth again at B=2 over
# (2, 2, 1) (rows over 'pod', whole over 'data') and at B=8 over (2, 2)
# with LD_ODD_CACHE slots, which 'model' does not divide (its KV heads
# over 'model'). The widths are the configs' own.
LD_CP_PROMPT, LD_CP_CACHE, LD_CP_DANUBE_PROMPT = 4096, 8192, 4092
LD_CP_WINDOW = 4096
LD_ODD_CACHE = LD_PROMPT + LD_STEPS + 1
LD_CP_RUNS = {
    "cp_llama": dict(batch=1, prompt=LD_CP_PROMPT, cache=LD_CP_CACHE,
                     forward=True),
    "cp_danube": dict(batch=1, prompt=LD_CP_DANUBE_PROMPT,
                      cache=LD_CP_DANUBE_PROMPT + LD_STEPS, forward=True),
    "cp_rwkv": dict(batch=1), "cp_rwkv_q": dict(batch=1),
    "cp_zamba": dict(batch=1, cache=LD_CP_WINDOW),
    "cp_pod": dict(batch=2, mesh=LD_POD_MESH),
    "odd_llama": dict(cache=LD_ODD_CACHE)}
LD_RUNS = ("llama", "pod", "llama_q", "llama_f32", "danube", "rwkv",
           "rwkv_q", "qwen", "qwen_q", "deepseek", "zamba", "zamba_q",
           "seamless") + tuple(LD_CP_RUNS)
LD_TIMEOUT_S = 120.0
# f32: the sharded step differs from one device in the order of its sums
# alone (the CPU tests hold SMOKE widths to 1e-5).
LD_F32_ATOL = 1e-4
# bf16 and ternary: the logits' relative L2 a (step, row), worst over the
# run, against the one-device step, gated between the bf16 noise floor
# (the one-device bf16 step against the same step in f32 from the same
# params and cache, measured every run) and a planted fault (rank 0's
# block of layer 0's output projection zeroed on one device, measured
# every run). The gate is LD_REL_L2, which must sit between the two. The
# runs of LD_FLOOR_RUNS are gated at LD_FLOOR_X times their floor
# instead: zamba2-1.2b's bf16 floor reads 5.9-6.3% on the H100, above
# LD_REL_L2 (every other run's 0.6-2.2%). The phase fails if the sharded
# step passes the gate, or the planted fault does not.
LD_REL_L2, LD_FLOOR_X = 0.05, 2.0
LD_FLOOR_RUNS = ("zamba", "zamba_q", "cp_zamba")
# The leaf whose rank-0 block of layer 0 the planted fault zeroes.
LD_PLANT = {"llama": "layers/attn/wo", "pod": "layers/attn/wo",
            "llama_q": "layers/attn/wo", "danube": "layers/attn/wo",
            "rwkv": "layers/tm/wo", "rwkv_q": "layers/tm/wo",
            "qwen": "layers/attn/wo", "qwen_q": "layers/attn/wo",
            "deepseek": "layers/moe/we_down", "zamba": "layers/out_proj",
            "zamba_q": "layers/out_proj",
            "seamless": "decoder/cross_attn/wo",
            "cp_llama": "layers/attn/wo", "cp_danube": "layers/attn/wo",
            "cp_rwkv": "layers/tm/wo", "cp_rwkv_q": "layers/tm/wo",
            "cp_zamba": "layers/out_proj", "cp_pod": "layers/attn/wo",
            "odd_llama": "layers/attn/wo"}


def _ld_full():
    import dataclasses
    from repro_torch.configs import get_config
    llama = get_config("llama3.2-1b")
    rwkv = dataclasses.replace(get_config("rwkv6-7b"),
                               num_layers=LD_RWKV_LAYERS)
    qwen = dataclasses.replace(get_config("qwen2-vl-2b"),
                               num_layers=LD_QWEN_LAYERS)
    zamba = dataclasses.replace(get_config("zamba2-1.2b"),
                                num_layers=LD_ZAMBA_LAYERS,
                                long_context_window=LD_ZAMBA_RING)
    return dict(
        llama=llama, pod=llama, llama_q=llama,
        llama_f32=dataclasses.replace(llama, dtype="float32",
                                      num_layers=LD_F32_LAYERS),
        danube=dataclasses.replace(get_config("h2o-danube-1.8b"),
                                   num_layers=LD_DANUBE_LAYERS,
                                   sliding_window=LD_DANUBE_RING),
        rwkv=rwkv, rwkv_q=rwkv, qwen=qwen, qwen_q=qwen,
        deepseek=dataclasses.replace(get_config("deepseek-moe-16b"),
                                     num_layers=LD_MOE_LAYERS),
        zamba=zamba, zamba_q=zamba,
        cp_llama=llama, cp_pod=llama, odd_llama=llama,
        cp_danube=dataclasses.replace(get_config("h2o-danube-1.8b"),
                                      num_layers=LD_DANUBE_LAYERS),
        cp_rwkv=rwkv, cp_rwkv_q=rwkv,
        cp_zamba=dataclasses.replace(get_config("zamba2-1.2b"),
                                     num_layers=LD_ZAMBA_LAYERS),
        seamless=dataclasses.replace(
            get_config("seamless-m4t-medium"), num_layers=LD_SEAMLESS_LAYERS,
            encoder_layers=LD_SEAMLESS_LAYERS,
            decoder_layers=LD_SEAMLESS_LAYERS),
        frames=LD_FRAMES, batch=LD_BATCH, prompt=LD_PROMPT,
        steps=LD_STEPS, rank_device=None,
        runs={name: _ld_run(name) for name in LD_RUNS},
        out_dir=os.path.join(ROOT, "checkpoints", "chip_smoke_lm_decode"))


def _ld_run(name):
    """Run ``name``'s batch, prompt, cache slots, mesh shape and whether
    its prompt is prefilled by one forward (else by stepping the
    decoder); ``_ld_full()["runs"]`` holds every run's."""
    run = dict(batch=LD_BATCH, prompt=LD_PROMPT, cache=None,
               mesh=LD_POD_MESH if name == "pod" else LD_MESH,
               forward=False)
    run.update(LD_CP_RUNS.get(name, {}))
    if run["cache"] is None:
        run["cache"] = run["prompt"] + LD_STEPS
    return run


def _ld_shape(name):
    return _ld_run(name)["mesh"]


# The seed a run's params are drawn from (its ternary run's too).
LD_SEEDS = {"danube": 72, "rwkv": 71, "qwen": 74, "deepseek": 75,
            "zamba": 76, "seamless": 77}


def _ld_params(torch, name, cfg, dev):
    """The serving params of run ``name`` drawn on ``dev`` (every rank
    draws the same): from ``model.init``, rwkv6-7b's with ``_lm_params``
    and zamba2-1.2b's with ``_hy_zamba_params``; packed by
    ``quantize_for_serving`` for the ternary runs."""
    from repro_torch.models import build_model
    from repro_torch.serving import quantize_for_serving
    model = build_model(cfg)
    seed = SEED + LD_SEEDS.get(name.removesuffix("_q"), 70)
    if cfg.family == "rwkv6":
        params = _lm_params(torch, model, seed, dev)
    elif cfg.family == "zamba2":
        params = _hy_zamba_params(torch, model, seed, dev)
    else:
        params = _tf_params(torch, model, seed, dev)
    if name.endswith("_q"):
        params = quantize_for_serving(params)[0]
    return params


class _LdLogits:
    """Records the logits each serve step takes its argmax of
    (``layers.greedy_tokens``) inside ``with``."""

    def __enter__(self):
        from repro_torch.models import layers as L
        self.got, self._real = [], L.greedy_tokens

        def record(logits, vocab):
            self.got.append(logits[:, -1].detach().float().clone())
            return self._real(logits, vocab)
        L.greedy_tokens = record
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers as L
        L.greedy_tokens = self._real


class _LdRoutes:
    """The MoE's routing (``layers.moe_route_logits``) inside ``with``:
    recorded (``routes`` None: each call's result, kept on its device),
    or replayed (each call returns the next routing of ``routes``, on the
    logits' device, and adds to ``differ`` the (token, choice)s whose
    expert or keep differs from the routing the call computed, of
    ``total``). A bf16 router's logits tie within an ulp, so two steps
    that sum in other orders route some tokens otherwise; replayed, the
    runs compare the same routing's arithmetic."""

    def __init__(self, routes=None):
        self.routes, self.got, self.differ, self.total = routes, [], 0, 0

    def __enter__(self):
        from repro_torch.models import layers as L
        self._real = L.moe_route_logits

        def route(logits, cfg, cap):
            r = self._real(logits, cfg, cap)
            if self.routes is None:
                self.got.append({k: v.clone() for k, v in r.items()})
                return r
            want = {k: v.to(logits.device)
                    for k, v in self.routes[len(self.got)].items()}
            self.got.append(None)
            self.differ = self.differ + (
                (r["gate_idx"] != want["gate_idx"])
                | (r["keep"] != want["keep"])).sum()
            self.total += r["gate_idx"].numel()
            return want
        L.moe_route_logits = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers as L
        L.moe_route_logits = self._real


def _ld_forced(torch, cfg, params, cache, inputs, dev, steps=None):
    """``make_serve_step`` steps of ``cfg`` from ``cache`` fed the token
    rows ``inputs`` (steps, B, 1), or, with ``steps``, greedy from the
    rows ``inputs`` (B, 1) on: each step's logits (steps, B, V) f32,
    greedy tokens (steps, B) and ms."""
    from repro_torch.launch.steps import make_serve_step
    step = make_serve_step(cfg)
    toks, ms = [], []
    tok = inputs
    with _LdLogits() as rec:
        for s in range(steps or inputs.shape[0]):
            _sync(torch, dev)
            t0 = time.perf_counter()
            tok, cache = step(params, cache, tok if steps else inputs[s])
            _sync(torch, dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            toks.append(tok[:, 0])
    return torch.stack(rec.got), torch.stack(toks), ms


def _ld_rel(torch, got, ref):
    """Relative L2 over the vocabulary of each (step, row)."""
    d = (got.double() - ref.double()).square().sum(-1)
    return (d / ref.double().square().sum(-1).clamp(min=1e-300)).sqrt()


def _ld_planted(torch, cfg, params, leaf, shape):
    """A copy of ``params`` with rank 0's block of layer 0 of ``leaf`` (its
    block under ``decode_pspecs``: for a packed leaf, its scale's) zeroed
    -- a fault in one rank's block."""
    from repro_torch.distributed import sharding as SH
    mesh = _ls_mesh(torch, shape)
    specs = SH.decode_pspecs(cfg, mesh, params, {}, LD_BATCH)["params"]
    out = dict(params)
    node, spec, path = out, specs, leaf.split("/")
    for k in path[:-1]:
        node[k] = dict(node[k])
        node, spec = node[k], spec[k]
    w, s = node[path[-1]], spec[path[-1]]
    if isinstance(w, dict):
        w, s = dict(w), s["scale"]
        t = w["scale"].clone()
        t[SH.NamedSharding(mesh, s).devices_indices_map(
            tuple(t.shape))[0]][0] = 0
        w["scale"] = t
        node[path[-1]] = w
    else:
        t = w.clone()
        t[SH.NamedSharding(mesh, s).devices_indices_map(
            tuple(t.shape))[0]][0] = 0
        node[path[-1]] = t
    return out


def _ld_forward_prefill(torch, model, params, prompt, cache):
    """``cache`` (a dense model's, empty) filled by one forward over
    ``prompt`` (B, S): each layer's K (after RoPE) and V as its attention
    hands them to ``layers.blockwise_attention``, written to slots
    [0, S) (S at most the cache's slots: a ring's slots too), ``pos`` S.
    Returns the last position's logits (B, 1, V) and the cache."""
    from repro_torch.models import layers as L
    kv, real = [], L.blockwise_attention

    def record(q, k, v, **kw):
        kv.append((k, v))
        return real(q, k, v, **kw)
    L.blockwise_attention = record
    try:
        logits, _ = model.apply(params, {"tokens": prompt})
    finally:
        L.blockwise_attention = real
    s = prompt.shape[1]
    for i, (k, v) in enumerate(kv):
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    cache["pos"] = torch.full((), s, dtype=torch.int32,
                              device=prompt.device)
    return logits[:, -1:].clone(), cache


def ld_one_device(torch, dev, full):
    """The one-device references on the card, for each run: a 64-token
    prompt prefilled by stepping the decoder (seamless' cross K/V first,
    from ``LD_FRAMES`` frames of a numpy seed), then ``LD_STEPS`` greedy
    serve steps (their tokens are every run's inputs): the logits, the
    tokens, the top-2 gaps and the step ms; for the bf16 and ternary
    runs the noise floor (the same steps in f32 from the same params and
    cache) and the planted fault (``_ld_planted``), each as the worst
    relative L2 of a (step, row)'s logits. A MoE run's routing is
    recorded and replayed in the floor and the fault (``_LdRoutes``)."""
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_map
    out = {}
    steps = full["steps"]
    for name in LD_RUNS:
        t0 = time.perf_counter()
        cfg, run = full[name], full["runs"][name]
        if name == "pod":
            out[name] = out["llama"]
            continue
        b = run["batch"]
        model = build_model(cfg)
        params = _ld_params(torch, name, cfg, dev)
        prompt = torch.from_numpy(np.random.default_rng(SEED + 73).integers(
            0, cfg.vocab_size, (b, run["prompt"]), dtype=np.int32)).to(dev)
        cache = model.init_cache(b, run["cache"], device=dev)
        if cfg.family == "encdec":
            from repro_torch.models import encdec
            frames = torch.from_numpy(np.random.default_rng(
                SEED + 78).normal(size=(b, full["frames"],
                                        cfg.frontend_dim)).astype(
                                            np.float32)).to(dev)
            cache["ck"], cache["cv"] = encdec.prefill_cross_kv(
                params, encdec.encode(params, frames, cfg), cfg)
        if run["forward"]:
            logits, cache = _ld_forward_prefill(torch, model, params, prompt,
                                                cache)
        else:
            for i in range(run["prompt"]):
                logits, cache = model.decode(params, cache,
                                             prompt[:, i:i + 1])
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        del logits
        with _LdRoutes() as rec:
            logits, toks, ms = _ld_forced(torch, cfg, params, cache, tok,
                                          dev, steps)
        # a MoE's routing, replayed in the floor, the fault and the ranks
        routes = [{k: v.cpu() for k, v in r.items()} for r in rec.got] \
            if cfg.family == "moe" else None
        inputs = torch.cat([tok[None], toks[:-1, :, None]])
        top2 = torch.topk(logits, 2, dim=-1).values
        row = dict(cache={k: v.cpu() for k, v in cache.items()},
                   inputs=inputs.cpu(), logits=logits.cpu(),
                   tokens=toks.cpu(), gap=(top2[..., 0] - top2[..., 1]).cpu(),
                   step_ms=statistics.median(ms[1:]), step_ms_all=ms,
                   routes=routes)
        if cfg.dtype != "float32":
            import dataclasses
            f32 = dataclasses.replace(cfg, dtype="float32")
            up = lambda t: t.float() if t.is_floating_point() else t
            with _LdRoutes(routes) as rf:
                lf = _ld_forced(torch, f32, tree_map(up, params),
                                tree_map(up, cache), inputs, dev)[0]
            row["floor"] = float(_ld_rel(torch, logits, lf).max())
            planted = _ld_planted(torch, cfg, params, LD_PLANT[name],
                                  _ld_shape(name))
            with _LdRoutes(routes):
                lp = _ld_forced(torch, cfg, planted, cache, inputs, dev)[0]
            row["planted"] = float(_ld_rel(torch, lp, logits).max())
            if routes:
                row["floor_routings_differ"] = [int(rf.differ), rf.total]
            del lf, lp, planted
        row["seconds"] = time.perf_counter() - t0
        out[name] = row
        del params, cache, logits
        _free(torch, dev)
    return out


def _ld_counter():
    """``tools/decode_collectives.py``: the collectives of a sharded decode
    step counted from the specs (the CPU tests hold the ranks against the
    same count)."""
    path = os.path.join(ROOT, "tools")
    if path not in sys.path:
        sys.path.insert(0, path)
    import decode_collectives
    return decode_collectives


def _ld_expected(torch, cfg, quant, shape, batch, cache_len, frames):
    """The collectives (count, bytes) a rank issues in one sharded decode
    step of ``cfg`` over a mesh of ``shape`` at a global batch of
    ``batch`` from a cache of ``cache_len`` slots (the enc-dec's cross K/V
    of ``frames``), counted from the specs (``decode_pspecs``) by
    ``decode_collectives.decode_counts``."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.models.params import as_dtype
    from repro_torch.serving import quantize_for_serving
    mesh = _ls_mesh(torch, shape)
    model = build_model(cfg)
    params = model.abstract_params()
    if quant:
        params = quantize_for_serving(params)[0]
    cache = model.init_cache(batch, cache_len, device="meta")
    if cfg.family == "encdec":
        cache["ck"] = cache["cv"] = torch.empty(
            cache["k"].shape[:2] + (frames,) + cache["k"].shape[3:],
            device="meta")
    allspec = SH.decode_pspecs(cfg, mesh, params, cache, batch)
    e = torch.empty((), dtype=as_dtype(cfg.dtype)).element_size()
    groups = L.moe_groups(batch, 1, cfg) if cfg.family == "moe" else None
    return _ld_counter().decode_counts(
        cfg, dict(mesh.shape), params, allspec["params"], cache,
        allspec["cache"], batch, e, groups)


def _ld_k3_per_step(cfg):
    """K3 launches a ternary decode step: 3 a layer (the MLP or the MoE's
    shared experts), 8 for rwkv6-7b, zamba2's and the enc-dec's by
    ``_hy_k3_per_step``."""
    if cfg.family in ("zamba2", "encdec"):
        return _hy_k3_per_step(cfg)
    return (8 if cfg.family == "rwkv6" else 3) * cfg.num_layers


def ld_decode(torch, pm, full, name, ref, k3, k4):
    """One run of the phase on this rank: its blocks of the params (drawn
    on its device, then cut) and of the one-device run's prefilled
    cache, ``LD_STEPS`` serve steps fed the one-device tokens; against
    the one-device run: the logits' worst relative L2 and absolute error
    (maxed over the mesh, outside the tallies), the greedy tokens where
    the one-device top-2 gap is more than twice the row's error; the
    rank's collectives a step, step ms, K3 and K4 launches, and each
    kernel against its plain version on its first call's inputs. A MoE
    run replays the one-device routing (``_LdRoutes``) and counts the
    (token, choice)s its own routing would have changed."""
    import torch.distributed as dist
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.steps import make_serve_step
    cfg, dev = full[name], pm.device
    batch = full["runs"][name]["batch"]
    whole = _ld_params(torch, name, cfg, dev)
    cache = {k: v.to(dev) for k, v in ref["cache"].items()}
    specs = SH.decode_pspecs(cfg, pm, whole, cache, batch)
    blocks = SH.local_block(whole, specs["params"], pm)
    cache_b = SH.local_block(cache, specs["cache"], pm)
    del whole, cache
    _free(torch, dev)
    inputs = [SH.local_block(t, specs["tokens"], pm)
              for t in ref["inputs"]]
    lo, hi = _ls_rows(pm, batch)
    step = make_serve_step(cfg)
    seen = {}
    reals = {"k3": k3.ternary_matmul_cuda, "k4": k4.wkv6_scan_cuda,
             "stripe": k4.wkv6_stripe_cuda}

    def keep(key):
        def call(*args):
            if key not in seen:
                seen[key] = [a.detach().clone() if hasattr(a, "detach")
                             else a for a in args]
            return reals[key](*args)
        return call
    k3.ternary_matmul_cuda, k4.wkv6_scan_cuda = keep("k3"), keep("k4")
    k4.wkv6_stripe_cuda = keep("stripe")
    counts, ms, toks = [], [], []
    _sync(torch, dev)
    k3.launches = k4.launches = k4.stripe_launches = 0
    try:
        with pm, _LdLogits() as rec, _LdRoutes(ref["routes"]) as routes:
            for s in range(full["steps"]):
                C.reset_counts()
                _sync(torch, dev)
                t0 = time.perf_counter()
                tok, cache_b = step(blocks, cache_b, inputs[s])
                _sync(torch, dev)
                ms.append((time.perf_counter() - t0) * 1e3)
                counts.append(_ls_counts())
                toks.append(tok[:, 0])
    finally:
        k3.ternary_matmul_cuda, k4.wkv6_scan_cuda = reals["k3"], reals["k4"]
        k4.wkv6_stripe_cuda = reals["stripe"]
    launches = {"ternary_matmul": k3.launches, "wkv6_scan": k4.launches,
                "wkv6_stripe": k4.stripe_launches}
    got = torch.stack(rec.got)                      # (steps, rows, V_r)
    v_r = got.shape[-1]
    v_lo = pm.coord("model") * v_r if v_r < cfg.vocab_size else 0
    want = ref["logits"][:, lo:hi, v_lo:v_lo + v_r].to(dev)
    diff = (got.double() - want.double())
    sums = torch.stack([diff.square().sum(-1),
                        want.double().square().sum(-1)])
    err = diff.abs().amax(-1)
    _ls_reduce(pm, sums, dist.ReduceOp.SUM, ["model"])
    _ls_reduce(pm, err, dist.ReduceOp.MAX, ["model"])
    rel = (sums[0] / sums[1].clamp(min=1e-300)).sqrt()
    gap = ref["gap"][:, lo:hi].to(dev).double()
    sure = gap > 2 * err
    same = torch.stack(toks).cpu() == ref["tokens"][:, lo:hi]
    worst = torch.tensor([float(rel.max()), float(err.max()),
                          float((sure.cpu() & ~same).sum())],
                         dtype=torch.float64, device=dev)
    _ls_reduce(pm, worst, dist.ReduceOp.MAX)
    checks = {}
    for key, plain, real in (("k3", k3.ternary_matmul_plain, reals["k3"]),
                             ("k4", k4.wkv6_scan_plain, reals["k4"]),
                             ("stripe", k4.wkv6_stripe_plain,
                              reals["stripe"])):
        if key in seen:
            a, b = plain(*seen[key]), real(*seen[key])
            a, b = (a if isinstance(a, tuple) else (a,)), (
                b if isinstance(b, tuple) else (b,))
            _sync(torch, dev)
            checks[key] = dict(shape=list(seen[key][0].shape),
                               bitwise=_bitwise(torch, a, b),
                               max_abs_err=_max_err(a, b))
    if "stripe" in seen:
        checks["stripe"]["vs_whole_state"] = _ld_stripe_vs_whole(
            torch, pm, k4, seen["stripe"], reals["stripe"])
    first = counts[0]
    return dict(
        config=f"{cfg.name} widths, {cfg.num_layers} layers, {cfg.dtype}"
               f"{', ternary' if name.endswith('_q') else ''}, "
               f"B={batch}, {full['runs'][name]['cache']} cache slots, "
               f"mesh {dict(pm.shape)}",
        rows=[lo, hi], rel_l2=worst[0].item(), max_abs_err=worst[1].item(),
        tokens_differ_where_sure=int(worst[2].item()),
        sure_share=float(sure.double().mean()),
        step_ms=ms, step_ms_median=statistics.median(ms[1:]),
        launches=launches, kernels_vs_plain=checks,
        routings_differ=[int(routes.differ), routes.total],
        collectives_per_step=first[0], collective_bytes_per_step=first[1],
        steps_alike=all(c == first for c in counts))


def _ld_stripe_vs_whole(torch, pm, k4, args, stripe):
    """K4's stripe entry on a rank's first call's inputs against the
    whole-state kernel: the stripes' partials and rows gathered over
    'data' (outside the step's tallies), combined in ascending row order
    (``wkv6_stripe_combine``), against ``wkv6_scan_cuda`` on the gathered
    state: ``o`` and the rows bit for bit (where the stripe is a multiple
    of 16 rows ``o`` is; else its largest error)."""
    from repro_torch.distributed import collectives as C
    r, k, v, logw, u, rows, lo = args
    part, beta, new_rows = stripe(*args)
    parts = C.gather_dim(part, 3, "data", pm)
    state0 = C.gather_dim(rows, 2, "data", pm)
    o, state = k4.wkv6_scan_cuda(r, k, v, logw, u, state0.contiguous())
    got = k4.wkv6_stripe_combine(parts, beta, v)
    dk = rows.shape[2]
    return dict(rows=dk, o_bitwise=bool(torch.equal(got, o)),
                o_max_abs_err=_max_err([o], [got]),
                state_bitwise=bool(torch.equal(
                    new_rows, state[:, :, lo:lo + dk])))


def ld_rank(rank, world, port, backend, full, refs, out_dir):
    """One rank of the phase: joins the process group and runs every run
    of ``LD_RUNS`` over its mesh; writes its rows."""
    import torch
    from repro_torch.distributed import runtime as R
    from repro_torch.kernels import ternary_matmul as k3
    from repro_torch.kernels import wkv6_scan as k4
    dev = torch.device(full["rank_device"] or "cuda",
                       rank % max(torch.cuda.device_count(), 1))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    pm = R.init("localhost", port, world, rank, backend=backend,
                device=dev, shape=LD_MESH, timeout_s=LD_TIMEOUT_S)
    meshes = {LD_MESH: pm, LD_POD_MESH: R.process_mesh(
        LD_POD_MESH, R.MESH_AXES[3], dev, timeout_s=LD_TIMEOUT_S)}
    out = dict(rank=rank, device=str(dev), init_s=time.perf_counter() - t0)
    for name in LD_RUNS:
        t1 = time.perf_counter()
        out[name] = ld_decode(torch, meshes[tuple(full["runs"][name][
            "mesh"])], full, name, refs[name], k3, k4)
        out[name + "_s"] = time.perf_counter() - t1
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def ld_stripe_times(torch, dev, k4):
    """K4's stripe entry at the decode call of the cp_rwkv runs' ranks (B=1,
    T=1, 32 heads a model rank, hd 64, 32 rows a data rank; bf16 r/k/v/u,
    f32 logw and state rows): both stripes bit for bit with the plain
    version, and combined (``wkv6_stripe_combine``) bit for bit with the
    whole-state kernel's ``o`` and state; its device ms from a cold L2
    and warm, the plain version's, the whole-state K4's at the same heads,
    each beside its bound. The stripe's bytes: r, k, v, u in bf16 read
    once whole, logw in f32 on the stripe's rows alone (all the kernel
    reads of it), the state rows read and written, the partials and
    beta written; its operations 7 dk_loc hd a (b, t, h) (the dry run's
    count; the bound reads them at the f32 rate)."""
    g = torch.Generator().manual_seed(SEED + 79)
    flush = torch.ones(FLUSH_BYTES // 4, device=dev)
    b, t, h, hd, dk = 1, 1, 32, 64, 32
    r, k, v, lw, u, s0 = _wkv_inputs(torch, g, dev, b, t, h, hd,
                                     torch.bfloat16, True)
    rows = [s0[:, :, lo:lo + dk].contiguous() for lo in range(0, hd, dk)]
    got = [k4.wkv6_stripe_cuda(r, k, v, lw, u, x, i * dk)
           for i, x in enumerate(rows)]
    plain = [k4.wkv6_stripe_plain(r, k, v, lw, u, x, i * dk)
             for i, x in enumerate(rows)]
    o, state = k4.wkv6_scan_cuda(r, k, v, lw, u, s0)
    comb = k4.wkv6_stripe_combine(torch.cat([x[0] for x in got], dim=3),
                                  got[0][1], v)
    _sync(torch, dev)
    bitwise = all(_bitwise(torch, p, q) for p, q in zip(plain, got))
    whole = bool(torch.equal(comb, o)) and bool(torch.equal(
        torch.cat([x[2] for x in got], dim=2), state))
    check(bitwise and whole, f"K4's stripe entry: bitwise {bitwise} with "
          f"its plain version, {whole} with the whole-state kernel")
    n, g_loc = b * t * h * hd, dk // min(k4.IS, dk)
    nbytes = (3 * 2 * n + 2 * h * hd + 4 * b * t * h * dk
              + 2 * 4 * b * h * dk * hd + 4 * b * t * h * g_loc * hd
              + 4 * b * t * h)
    bound, by = _bound_ms(nbytes, 7 * b * t * h * dk * hd)
    run = lambda: k4.wkv6_stripe_cuda(r, k, v, lw, u, rows[0], 0)
    full = lambda: k4.wkv6_scan_cuda(r, k, v, lw, u, s0)
    wbound, wby = _bound_ms(*_k4_cost(b, t, h, hd, True))
    out = dict(shape=dict(batch=b, steps=t, heads=h, head_dim=hd,
                          rows=dk),
               ms=_device_ms(torch, run, flush),
               warm_l2_ms=_warm_ms(torch, run), call_ms=_call_ms(torch, run),
               plain_ms=_device_ms(torch, lambda: k4.wkv6_stripe_plain(
                   r, k, v, lw, u, rows[0], 0), flush, reps=3),
               bound_ms=bound, bound_by=by, library_ms=None,
               whole_state=dict(ms=_device_ms(torch, full, flush),
                                warm_l2_ms=_warm_ms(torch, full),
                                bound_ms=wbound, bound_by=wby),
               bitwise=bitwise, combined_equals_whole=whole,
               max_abs_err=max(_max_err(p, q) for p, q in zip(plain, got)))
    del flush
    return out


def lm_decode_sharded_phase(torch, dev, k3, k4, smi):
    """Phase 12c: the one-device references on the card, then four ranks
    (``runtime.spawn``; gloo on cuda:0, or NCCL one rank a card with four
    cards) run ``make_serve_step`` on their blocks of llama3.2-1b (bf16
    over (2, 2) and (2, 2, 1), ternary, f32), h2o-danube-1.8b (its ring
    wrapping), rwkv6-7b, qwen2-vl-2b and zamba2-1.2b (bf16 and ternary),
    deepseek-moe-16b and seamless-m4t-medium (bf16) from the same
    prefilled caches and tokens: the logits against one device (f32 within
    ``LD_F32_ATOL``; bf16 and ternary under ``LD_REL_L2``, which must sit
    between the measured noise floor and a planted fault), greedy tokens
    equal where one device's top-2 gap is sure, every rank's collectives
    a step equal to ``_ld_expected``'s count from the specs, its K3 and
    K4 launches counted and each kernel bit for bit with its plain
    version on the rank's first call's inputs; each rank's step ms
    beside the one-device step's. The runs of ``LD_CP_RUNS`` take global
    batches the batch axes do not divide (context-parallel caches, K4's
    stripe entry) and a cache that 'model' does not divide; the stripe
    entry is timed first (``ld_stripe_times``). Returns the kernels'
    numbers and a rank's tallies of the (2, 2) llama3.2-1b run (for
    ``dryrun``)."""
    import shutil
    from repro_torch.distributed import runtime as R
    full = _ld_full()
    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 4 else "gloo"
    stripe = ld_stripe_times(torch, dev, k4) if dev.type == "cuda" else None
    refs = ld_one_device(torch, dev, full)
    ref_s = time.perf_counter() - t0
    shutil.rmtree(full["out_dir"], ignore_errors=True)
    os.makedirs(full["out_dir"])
    t1 = time.perf_counter()
    R.spawn(ld_rank, 4, (R.free_port(), backend, full, refs,
                         full["out_dir"]))
    ranks_s = time.perf_counter() - t1
    rows = []
    for r in range(4):
        with open(os.path.join(full["out_dir"], f"rank{r}.json")) as f:
            rows.append(json.load(f))
    shutil.rmtree(full["out_dir"], ignore_errors=True)
    out = dict(nvidia_smi=smi, backend=backend, cards=cards, mesh=LD_MESH,
               pod_mesh=LD_POD_MESH, ranks=4,
               tolerance=dict(f32_atol=LD_F32_ATOL, rel_l2=LD_REL_L2,
                              floor_x=LD_FLOOR_X,
                              floor_runs=list(LD_FLOOR_RUNS),
                              tokens="equal where the one-device top-2 "
                                     "gap exceeds twice the row's error"))
    kinds = ("ternary_matmul", "wkv6_scan", "wkv6_stripe")
    failed, launches = [], dict.fromkeys(kinds, 0)
    errs = dict.fromkeys(kinds, 0.0)
    for name in LD_RUNS:
        ref, lead, cfg = refs[name], rows[0][name], full[name]
        run = full["runs"][name]
        quant = name.endswith("_q")
        counts, nbytes = _ld_expected(torch, cfg, quant, run["mesh"],
                                      run["batch"], run["cache"],
                                      full["frames"])
        row = dict(lead, one_device_step_ms=ref["step_ms"],
                   one_device_step_ms_all=ref["step_ms_all"],
                   reference_s=ref["seconds"],
                   step_ms_by_rank=[x[name]["step_ms_median"] for x in rows],
                   seconds_by_rank=[x[name + "_s"] for x in rows],
                   launches_by_rank=[x[name]["launches"] for x in rows],
                   expected_collectives_per_step=counts,
                   expected_bytes_per_step=nbytes)
        for k in ("floor", "planted", "floor_routings_differ"):
            if k in ref:
                row[k] = ref[k]
        if not all(x[name]["collectives_per_step"] == counts
                   and x[name]["collective_bytes_per_step"] == nbytes
                   and x[name]["steps_alike"] for x in rows):
            failed.append(f"{name}: collectives a step against the "
                          f"specs' count")
        if lead["tokens_differ_where_sure"]:
            failed.append(f"{name}: greedy tokens where the gap is sure")
        if cfg.dtype == "float32":
            if not lead["max_abs_err"] <= LD_F32_ATOL:
                failed.append(f"{name}: f32 logits against one device")
        else:
            row["gate"] = LD_FLOOR_X * row["floor"] \
                if name in LD_FLOOR_RUNS else LD_REL_L2
            if not row["floor"] <= row["gate"] < row["planted"]:
                failed.append(f"{name}: the gate not between the noise "
                              f"floor and the planted fault")
            if not lead["rel_l2"] <= row["gate"]:
                failed.append(f"{name}: logits against one device")
        if dev.type == "cuda":
            # rwkv6's state rows split over 'data' where no batch axis
            # splits the rows (B=1): the stripe entry
            sizes = dict(_ls_mesh(torch, run["mesh"]).shape)
            split = (cfg.family == "rwkv6" and sizes.get("data", 1) > 1
                     and _ld_counter().row_parts(sizes, run["batch"]) == 1)
            wkv = cfg.num_layers * full["steps"] \
                if cfg.family == "rwkv6" else 0
            want = {"ternary_matmul": _ld_k3_per_step(cfg) * full["steps"]
                    if quant else 0,
                    "wkv6_scan": 0 if split else wkv,
                    "wkv6_stripe": wkv if split else 0}
            row["expected_launches_by_rank"] = want
            for x in rows:
                if x[name]["launches"] != want:
                    failed.append(f"{name}: rank {x['rank']}'s launches "
                                  f"{x[name]['launches']}, want {want}")
                for key, kname in (("k3", "ternary_matmul"),
                                   ("k4", "wkv6_scan"),
                                   ("stripe", "wkv6_stripe")):
                    chk = x[name]["kernels_vs_plain"].get(key)
                    if want[kname] and not (chk and chk["bitwise"]):
                        failed.append(f"{name}: {kname} on rank "
                                      f"{x['rank']}: {chk}")
                    if chk:
                        errs[kname] = max(errs[kname], chk["max_abs_err"])
                whole = x[name]["kernels_vs_plain"].get("stripe", {}).get(
                    "vs_whole_state")
                if want["wkv6_stripe"] and not (
                        whole and whole["state_bitwise"]
                        and (whole["o_bitwise"] or whole["rows"] % 16)):
                    failed.append(f"{name}: the stripes against the "
                                  f"whole-state K4 on rank {x['rank']}: "
                                  f"{whole}")
                launches = {k: launches[k] + x[name]["launches"][k]
                            for k in launches}
        out[name] = row
    out["seconds"] = dict(one_device=ref_s, ranks=ranks_s,
                          total=time.perf_counter() - t0,
                          rank_init=[x["init_s"] for x in rows])
    out["wkv6_stripe_times"] = stripe
    emit("lm_decode_sharded", **out)
    check(not failed, f"lm_decode_sharded: {failed}")
    del refs
    _free(torch, dev)
    return {"launches": launches, "max_abs_err": errs, "stripe": stripe,
            "llama": dict(cfg=full["llama"], batch=full["batch"],
                          cache=full["runs"]["llama"]["cache"],
                          per_rank=[dict(
                              launches=x["llama"]["collectives_per_step"],
                              tensor_bytes=x["llama"][
                                  "collective_bytes_per_step"])
                              for x in rows])}


# ----------------------------------------------------------------------
# Phase 13: the dry run (``launch.dryrun``) against the card: the fake
# trace of a step against the same step run for real in this run.
# ----------------------------------------------------------------------

DR_CACHE = 512               # cache slots of the decode steps compared
DR_TRAIN_STEPS = 3           # timed real train steps (median)
# Rounds of K3's host time through ternary_matmul_fwd and directly, each
# round in turn ABBA: the host's speed drifts within a run.
DR_HOST_ORDER = (("ternary_matmul_fwd", "ternary_matmul_cuda"),
                 ("ternary_matmul_cuda", "ternary_matmul_fwd")) * 3


def _dr_shape(kind, seq, batch):
    """A dry-run cell outside ``configs.shapes``: the shapes this script
    runs (the JAX package's cells hold 32k-token caches and B=256)."""
    from repro_torch.configs.shapes import ShapeSpec
    return ShapeSpec(f"chip_smoke_{kind}", kind, seq, batch)


def _shape_only_matches(torch, fwd, args):
    """``fwd`` on ``args`` (CUDA tensors) and on fake copies of them:
    each output's (shape, dtype, device), real and shape-only."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    real = fwd(*args)
    with FakeTensorMode() as mode:
        fake = fwd(*(None if a is None else mode.from_tensor(a)
                     for a in args))
    torch.cuda.synchronize()

    def meta(outs):
        outs = outs if isinstance(outs, tuple) else (outs,)
        return [[list(x.shape), str(x.dtype), str(x.device)] for x in outs]
    return dict(real=meta(real), shape_only=meta(fake),
                equal=meta(real) == meta(fake))


def dryrun_decode(torch, dev, k3, k4, model, weights, cache_len=DR_CACHE,
                  batch=LM_BATCH):
    """One decode step of ``model`` at ``batch`` from a ``cache_len``
    cache, for each weight set of ``weights`` ({"bf16": params,
    "ternary": quantized params}), on the card and as the dry run's fake
    trace of the same cell: the trace's K3 and K4 shape-only calls must
    equal the launch counters' deltas of the real step, and its param
    and cache bytes the real trees' bytes."""
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.steps import make_serve_step
    cfg = model.cfg
    shape = _dr_shape("decode", cache_len, batch)
    step = make_serve_step(cfg)
    out = {}
    for name, params in weights.items():
        low = DR.lower_cell(cfg, shape, dev,
                            quant="ternary" if name == "ternary" else None)
        cache = model.init_cache(batch, cache_len, device=dev)
        tok = torch.ones((batch, 1), dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        k3.launches = k4.launches = 0
        step(params, cache, tok)
        torch.cuda.synchronize()
        launches = {"ternary_matmul": k3.launches, "wkv6_scan": k4.launches}
        row = dict(trace_s=low["trace_s"], shape_only={
                       "ternary_matmul": low["k3"], "wkv6_scan": low["k4"]},
                   launches=launches,
                   param_bytes=[low["bytes"]["params"],
                                DR.tree_bytes(params)],
                   cache_bytes=[low["bytes"]["cache"], DR.tree_bytes(cache)])
        out[f"{cfg.name}_{name}"] = row
        check(low["k3"]["calls"] == launches["ternary_matmul"]
              and low["k4"]["calls"] == launches["wkv6_scan"],
              f"dry-run tallies differ from a real {cfg.name} {name} "
              f"decode step: {row}")
        check(row["param_bytes"][0] == row["param_bytes"][1]
              and row["cache_bytes"][0] == row["cache_bytes"][1],
              f"dry-run bytes differ from the real trees: {row}")
        del cache
    return out


def dryrun_collectives(dev, pod, decode):
    """The dry run's collectives (``launch.collective_analysis``): one
    rank's step of ``lm_train_sharded``'s pod run (llama3.2-1b at full
    width and 4 layers, bf16, B=4, S=1024, remat) traced on fake tensors
    of the card over a fake (2, 2, 1) process group, and one rank's
    decode step of ``lm_decode_sharded``'s llama3.2-1b run (full width
    and depth, bf16, B=8, a 72-slot cache) over a fake (2, 2) group,
    each against the tallies a step every rank of that run measured in
    this run."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.launch import collective_analysis as CA
    t0 = time.perf_counter()
    with CA.fake_process_mesh(LS_POD_MESH, dev) as pm:
        got = CA.trace_step(pod["cfg"], ShapeSpec(
            "chip_smoke_train", "train", pod["seq"], pod["batch"]), pm,
            remat=True)
        sizes = dict(pm.shape)
    trace_s = time.perf_counter() - t0
    equal = [all(got[part] == {k: v for k, v in rank[part].items()}
                 for part in ("launches", "tensor_bytes"))
             for rank in pod["per_rank"]]
    t0 = time.perf_counter()
    with CA.fake_process_mesh(LD_MESH, dev) as pm:
        dec = CA.trace_step(decode["cfg"], ShapeSpec(
            "chip_smoke_decode", "decode", decode["cache"], decode["batch"]),
            pm)
    decode_s = time.perf_counter() - t0
    dec_equal = [all(dec[part] == rank[part]
                     for part in ("launches", "tensor_bytes"))
                 for rank in decode["per_rank"]]
    return dict(decode=dict(
                    config=f"{decode['cfg'].name} full width and depth, "
                           f"{decode['cfg'].dtype}, B={decode['batch']}, "
                           f"a {decode['cache']}-slot cache",
                    mesh=list(LD_MESH), trace_s=decode_s, traced=dec,
                    measured_rank0=decode["per_rank"][0],
                    equal_by_rank=dec_equal),
                config=f"{pod['cfg'].name} widths, "
                       f"{pod['cfg'].num_layers} layers, {pod['cfg'].dtype}, "
                       f"B={pod['batch']}, S={pod['seq']}, remat",
                mesh=list(LS_POD_MESH), trace_s=trace_s, traced=got,
                measured_rank0=pod["per_rank"][0],
                equal_by_rank=equal,
                record=CA.collective_bytes(got["launches"],
                                           got["tensor_bytes"], sizes))


def dryrun_phase(torch, dev, k3, k4, smi, rwkv, pod, sharded_decode):
    """Phase 13: (a) llama3.2-1b at full width and depth, bf16, B=4,
    S=1024 (the ``lm_train`` shape): the dry run's FLOPs against
    ``FlopCounterMode`` over one real ``make_train_step`` step on the
    card, exactly; param and AdamW bytes against the real trees'; the
    predicted peak against ``max_memory_allocated`` of a real step, and
    the step's FLOPs over its time. (b) the ternary llama3.2-1b decode
    step at B=4: K3's shape-only calls against its launches
    (``dryrun_decode``; rwkv6-7b's, ``rwkv``, ran in the LM slice). (c)
    K3's and K4's shape-only outputs against the kernels' at the decode
    shapes, and the host time of a K3 call through ``ternary_matmul_fwd``
    (which also tests for a tensor without storage) beside a direct
    ``ternary_matmul_cuda`` call, in alternating rounds. (d) the dry
    run's collectives (``dryrun_collectives``) against the tallies of
    ``lm_train_sharded``'s pod run (``pod``) and of
    ``lm_decode_sharded``'s llama3.2-1b run (``sharded_decode``)."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import build_model
    from repro_torch.serving import quantize_for_serving
    from repro_torch.training.optimizer import adamw_init
    t0 = time.perf_counter()
    cfg = get_config("llama3.2-1b")
    low = DR.lower_cell(cfg, _dr_shape("train", LT_SEQ, LT_BATCH), dev)
    rec = DR.analyze(low, dev)
    model = build_model(cfg)
    params = _tf_params(torch, model, SEED + 60, dev)
    opt = adamw_init(params)
    tokens = torch.from_numpy(np.random.default_rng(SEED + 61).integers(
        0, cfg.vocab_size, (LT_BATCH, LT_SEQ), dtype=np.int32)).to(dev)
    batch = {"tokens": tokens, "targets": tokens}
    step = make_train_step(cfg)
    with FlopCounterMode(display=False) as counter:
        step(params, opt, batch)
    torch.cuda.synchronize()
    _free(torch, dev)
    times, peaks = [], []
    for _ in range(DR_TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        peaks.append(torch.cuda.max_memory_allocated())
    step_s = statistics.median(times)
    mem = rec["memory"]
    train = dict(
        config=f"{cfg.name} full width and depth, {cfg.dtype}, remat",
        batch=LT_BATCH, seq=LT_SEQ, trace_s=low["trace_s"],
        flops=dict(dry_run=rec["flops"], real=counter.get_total_flops(),
                   dry_run_by_op=rec["flops_by_op"]),
        param_bytes=[mem["param_bytes"], DR.tree_bytes(params)],
        opt_bytes=[mem["opt_bytes"], DR.tree_bytes(opt)],
        peak_bytes=dict(predicted=mem["peak_bytes"], measured=max(peaks),
                        ratio=mem["peak_bytes"] / max(peaks)),
        fits=rec["fits"], capacity_bytes=mem["capacity_bytes"],
        step_ms=[t * 1e3 for t in times],
        tflop_per_s=rec["flops"] / step_s / 1e12,
        share_of_bf16_peak=rec["flops"] / step_s / H100_BF16_FLOPS,
        nvidia_smi=smi)
    check(train["flops"]["dry_run"] == train["flops"]["real"],
          f"dry-run FLOPs differ from the real step's: {train['flops']}")
    check(train["param_bytes"][0] == train["param_bytes"][1]
          and train["opt_bytes"][0] == train["opt_bytes"][1],
          f"dry-run param/opt bytes differ: {train}")
    check(rec["fits"], f"llama3.2-1b's train step does not fit: {mem}")
    del opt, batch, tokens
    _free(torch, dev)

    q, _ = quantize_for_serving(params)
    del params
    _free(torch, dev)
    decode = dryrun_decode(torch, dev, k3, k4, model, {"ternary": q})
    up = q["layers"]["mlp"]["w_up"]
    w, s = up["packed"][0].contiguous(), up["scale"][0].contiguous()
    x = torch.randn((LM_BATCH, 1, w.shape[0] * 4), dtype=torch.bfloat16,
                    device=dev)
    g = torch.Generator().manual_seed(SEED + 62)
    wkv = _wkv_inputs(torch, g, dev, LM_BATCH, 1, 64, 64, torch.bfloat16,
                      state=True)
    shapes = {"ternary_matmul": _shape_only_matches(
                  torch, k3.ternary_matmul_fwd, (x, w, s)),
              "wkv6_scan": _shape_only_matches(torch, k4.wkv6_scan_fwd,
                                                tuple(wkv))}
    calls = {"ternary_matmul_fwd": lambda: k3.ternary_matmul_fwd(x, w, s),
             "ternary_matmul_cuda": lambda: k3.ternary_matmul_cuda(x, w, s)}
    host = {name: [] for name in calls}
    for order in DR_HOST_ORDER:
        for name in order:
            host[name].append(_host_us(torch, calls[name]))
    host = dict(samples_us=host, shape={"M": LM_BATCH, "K": x.shape[-1],
                                        "N": w.shape[1]},
                **{f"{name}_us": statistics.median(v)
                   for name, v in host.items()})
    host["fwd_minus_cuda_us"] = (host["ternary_matmul_fwd_us"]
                                 - host["ternary_matmul_cuda_us"])
    check(all(r["equal"] for r in shapes.values()),
          f"shape-only outputs differ from the kernels': {shapes}")
    del q, up, w, s, x, wkv
    _free(torch, dev)
    collectives = dryrun_collectives(dev, pod, sharded_decode)
    check(len(collectives["equal_by_rank"]) == 4
          and all(collectives["equal_by_rank"]),
          f"the dry run's collectives differ from lm_train_sharded's pod "
          f"run: {collectives}")
    check(len(collectives["decode"]["equal_by_rank"]) == 4
          and all(collectives["decode"]["equal_by_rank"]),
          f"the dry run's decode collectives differ from "
          f"lm_decode_sharded's llama3.2-1b run: {collectives['decode']}")
    seconds = time.perf_counter() - t0
    emit("dryrun", nvidia_smi=smi, seconds=seconds, train=train,
         decode={**rwkv["steps"], **decode}, rwkv_seconds=rwkv["seconds"],
         shape_only_outputs=shapes, k3_host_us=host,
         collectives=collectives)
    steps = {**rwkv["steps"], **decode}
    return {name: dict(shape_only_calls=sum(r["shape_only"][name]["calls"]
                                            for r in steps.values()),
                       launches=sum(r["launches"][name]
                                    for r in steps.values()))
            for name in ("ternary_matmul", "wkv6_scan")}


if __name__ == "__main__":
    sys.exit(main())
