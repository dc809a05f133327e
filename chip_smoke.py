#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (orb_slam3_modified_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each ({"phase": ...}); any failure exits non-zero
before the last line:
  device     card name and count, and nvidia-smi's name and power limit
             (also printed raw on a line of its own);
  build      nvcc for csrc/hamming.cu (both entries): command, seconds,
             ptxas' registers / shared memory / spills per kernel, and the
             tensor-core instructions (BMMA, IMMA) that cuobjdump finds in
             each kernel's SASS; fails if an entry has none;
  kernel     each hand-written entry against its plain torch version on the
             card (bit-exact): hamming_matrix at six shapes, the fused
             mutual-best match at (4096, 1024) windowed and unwindowed and at
             ragged shapes; kernel, plain and yardstick device times and the
             card's bound. Each time is CUDA events around one replay of a
             CUDA graph holding many calls, so the host's cost per call is not
             in it; the profiler's kernel durations are printed beside it;
  slice      the main path: the monocular chunk step at bench width (752x480
             uint8 frames, 1024 ORB features over 8 levels, a 4096-point map
             cache, rounds=3 iters=6), one warm-up and 4 timed 16-frame
             chunks. Fails unless every frame is ok within 0.05 m of ground
             truth, the fused match launched at least twice per frame and the
             matrix entry, off this path, not at all. Also
             checks that a chunk run with the plain matchers gives identical
             poses, and times the branch-free recovery form (the one CUDA
             graph capture takes) beside the step's host-read gate;
  breakdown  CUDA-event times of the slice's stages, the windowed match
             against the path it replaced, and the device busy time, launches
             and idle share of one track step (torch.profiler) with the fused
             match and with the replaced path;
  system     the whole monocular main path through the entry point a user
             calls: SlamSystem(...).make_chunked_frontend(chunk=16, lag=1) on
             bench.py's headline scene (400 frames, the first 64 as warm-up,
             then the async mapper drained before the timer, as bench.py
             does), async local mapping on its own CUDA stream, loop closing
             on (bench.py:387): the closer runs on the mapper worker after
             each keyframe. frames/s, chunk ms (with and without mapper work
             during the dispatch, and the ms each ms of it costs), tracked
             frames, keyframes, map points, scale-aligned ATE, the stage
             breakdown, the closer's counts, each Hamming entry's launches,
             plain-version calls, peak memory. Fails unless every frame
             retires in order, every timed frame is tracked, ATE < 0.25 m, the
             matrix entry launched, the fused entry launched at least twice per
             chunk-stepped frame, no plain (CPU-path) matcher or Hamming
             version was called, and, when the closer neither closed, merged
             nor relocalized, the map equals the one before loop closing was
             ported (SYSTEM_RUN_I) to the bit;
  loop       bench.py's ring scene (run_hard_scene): one full revolution of
             400 frames at 752x480, 1024 features, chunk 8, lag 1, async
             mapper, loop closing on, 64 warm-up frames, the mapper drained,
             then timed. The system phase's numbers, plus maps, the closer's
             counts and stage times (words, query, verify, correct, merge,
             gba), relocalization attempts and successes, the largest map's
             keyframe ATE, each verified keyframe pair with the match and
             inlier counts its gates saw, and both entries' launches made by
             the closer and by relocalization. Fails unless every frame retires in
             order, no plain version is called, the fused entry was launched
             by the closer or relocalization, tracked timed frames and ATE are
             no worse than the JAX reference's on the same frames (REF_LOOP),
             and, if the reference closed a loop or merged there, the port
             did too;
  stereo     the headline scene as a rectified pair (the right camera
             displaced by configs/euroc_stereo.yaml's 0.110074 m baseline),
             SlamSystem(sensor=STEREO, bf=baseline * fx, min_depth=0.3)
             .make_chunked_frontend(chunk=16, lag=1, stereo=True), as the
             system phase runs it (400 frames, 64 warm-up, async mapper, loop
             closing on): a chunk's left and right images are one extraction
             batch and each frame's left -> right match is one launch of the
             matrix entry (ops/stereo_match.py). The system phase's numbers,
             plus the stereo match's ms per chunk (CUDA events and host
             time), its matrix launches, the close points spawned from depth,
             and one frame's match on the card against the CPU's (exact).
             Fails unless every frame retires in order, every timed frame is
             tracked, the scale-aligned fit's |s - 1| < 0.15
             (tests/test_chunked.py:126-127), the ATE is no worse than the JAX
             reference's worst CPU run on the same frames (REF_STEREO), no
             plain version is called, the fused entry launched at least twice
             per chunk-stepped frame and the matrix entry at least once per
             frame by the stereo match;
  rgbd       the same orbit with the renderer's float32 metric depth maps,
             SlamSystem(sensor=RGBD, bf (virtual), depth_scale=1,
             th_far_points=0).make_chunked_frontend(..., rgbd=True): the depth
             lookup (one gather per chunk) and uR = u - bf/z feed the same
             stereo rows; the same numbers with depth_lookup ms per chunk, and
             the same gates against REF_RGBD (no stereo match), on the scene's
             first 200 frames (N_DEPTH_FRAMES: the inertial phases' time);
  mono_inertial  the inertial main path frame by frame:
             SlamSystem(sensor=IMU_MONOCULAR).track_features(...,
             imu_samples=) on tests/test_e2e_inertial.py's course at full
             width (752x480, 1024 features a frame, a 1.5 m circle at 0.8
             rad/s under a ceiling of 5000 points, the noise-free 200 Hz IMU,
             its first 320 frames, 128 warm-up), loop closing on, the staged IMU init
             synchronous: frames/s, ms a frame of tracking, the VI frame
             solve and the preintegration (CUDA events), the launches of one
             VI solve and of one frame's preintegration (torch.profiler), the
             init solves', the full VI BAs' and vi_refine's ms, every init
             event, the map and the ATE beside the JAX reference's
             (REF_MONO_INERTIAL). Fails unless every part of the inertial
             path ran, the IMU initialized and reached the reference's stage,
             the timed frames tracked are no fewer than the reference's, over
             the timed frames (all after VIBA1) the ATE is no worse than the
             reference's worst and |s - 1| < 0.1, no plain version is called
             and the matrix entry launched;
  mono_inertial_image  the image entry track_monocular_inertial on
             bench.py's VI scene (main_vi: 512x384, write_euroc_sequence's
             quarter orbit, the noise-free 200 Hz IMU), its first 72 frames
             (28 warm-up), with extraction ms: the same numbers, the path's
             gates only (its accelerations leave the monocular scale
             unobservable in both packages, REF_MONO_INERTIAL_IMAGE);
  stereo_inertial  the same through track_stereo(..., imu_samples=) on the
             stereo scene's 752x480 pair (same orbit law, cut to 150 frames,
             60 warm-up): every timed frame tracked and, over them, |s - 1|
             < 0.15 and the ATE no worse than the reference's
             (REF_STEREO_INERTIAL);
  vi, si     bench.py's main_vi through the chunked frontend:
             SlamSystem(sensor=IMU_MONOCULAR (vi) or IMU_STEREO with a
             0.11 m baseline (si)).make_chunked_frontend(chunk=8, lag=1) on
             its VI scene (512x384, the 400-frame quarter orbit and its
             IMU stream, 1024 features, 160 warm-up frames; si its first
             200 frames, 80 warm-up, for the script's time; the async
             mapper with the staged IMU init on its worker, loop closing
             on): frames/s, chunk ms, the frames the VI chunk step ran,
             init events and stage, ATE and scale over the timed frames,
             the preintegration's and the VI solves' ms a VI chunk (CUDA
             events), one VI chunk's launches (torch.profiler), each
             Hamming entry's launches. Fails unless every frame retires in
             order, no plain version is called, the VI chunk step ran with
             at least two fused-entry launches per frame it stepped, and
             the stage reached, the tracked timed frames and the timed ATE
             are no worse than the JAX reference's worst chunked run on the
             same frames (REF_VI, REF_SI);
  cli        the port's runner as its users call it: the headline scene's
             first 96 frames (752x480, EuRoC intrinsics) written as a EuRoC
             folder through io/png.py with a settings file of the
             reference's format (no distortion, 1024 features over 8
             levels), then run.main([... "--dataset", "euroc", "--sensor",
             "mono", "--chunked", "--chunk-size", "16", "--kf-out",
             "--atlas-out", "--semantic-out" ...]) on the card (async
             mapper, loop closing on). The runner's frames/s, decode and
             upload ms a frame (PNG_DECODER names the decoder), both entries'
             launches, the depth net's ms a frame on the card. Fails unless
             the frames read back equal the rendered ones, the trajectory
             file, every pose and the map equal those of the same frames fed
             from memory through SlamSystem.make_chunked_frontend(chunk=16,
             lag=1) to the bit, every frame from the initialization on is in
             the trajectory file, eval's ATE < 0.25 m, the fused entry
             launched at least twice per chunk-stepped frame, the matrix entry
             launched, no plain version was called, the atlas loads back
             equal to the map, a second run.main with --atlas-in tracks the
             next 16 frames with every holder of the map bound to the loaded
             one, the depth net's card output on one frame is within 1e-4
             relative of its CPU output (class maps equal off near-ties) and
             the semantic cloud is not empty;
then one line {"phase": "seconds", ...} (each phase's host seconds, its
scene renders included),
one line {"kernels": [...]} (each entry's `launches` counted on the
main path, the system phase, with the slice's, the loop's, the stereo, the
rgbd, the three inertial, the vi and si and the cli phases' counts beside
it in `launches_by_path`, the closer's and
relocalization's share of the loop phase's in `loop_by_stage`, and
`kernel_phase_calls`) and, last, {"ok": true, "device": {...}}.

Exits non-zero without printing a result when torch sees no CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA H100 data sheet):
# HBM3 3.35 TB/s, 1,979 TOP/s int8 on the tensor cores, 67 TFLOP/s float32
# outside them. A 256-bit Hamming distance counts as 256 int8 multiply-adds of
# +-1 values (2 operations each), which the tensor cores can do. For the record
# only: the CUDA-core bound of the popcount matrix kernel, 32-bit POPC at 16 per SM per clock
# (CUDA C++ Programming Guide), 132 SMs at the 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_FLOPS_PER_S = 67e12
POPC_PER_S = 132 * 16 * 1.98e9
WINDOW_FLOPS = 5  # per pair: 2 subtractions, 2 products, 1 sum

SEED = 0
FRAME_W, FRAME_H = 752, 480  # bench.py's headline scene
N_FEATURES = 1024
CACHE_CAP = 4096
CHUNK = 16
N_TIMED = 4
TRANS_GATE_M = 0.05
N_SYSTEM_FRAMES = 400  # bench.py's headline run
N_SYSTEM_WARM = 64
ATE_GATE_M = 0.25  # tests/test_chunked.py:67
N_LOOP_FRAMES = 400  # bench.py's run_hard_scene
LOOP_CHUNK = 8  # bench.py's BENCH_CHUNK default for the ring scene
# the JAX reference on the loop phase's frames (scripts/reference_system_counts.py
# loop, CPU, async mapper, loop closing on; its runs differ with the threads'
# timing): every timed frame tracked, no loop closed, no map merged, no
# relocalization; ate_gate_m is the worst ATE of its runs
REF_LOOP = {"tracked_timed": 336, "loops_closed": 0, "merges": 0,
            "ate_gate_m": 0.16438958104690987}
# the system phase before loop closing was ported (its repeatable result on an
# NVIDIA H100 80GB HBM3, PERF.md's run I): with a closer that neither closes,
# merges nor relocalizes, the map must come out the same to the bit
SYSTEM_RUN_I = {"ate_m": 0.13359771593053277, "keyframes": 23, "map_points": 2079}
# the stereo and rgbd phases: the headline orbit with a rectified right image
# (configs/euroc_stereo.yaml's Stereo.T_c1_c2 baseline) or a metric depth map
BASELINE_M = 0.110074137800478
MIN_DEPTH = 0.3
# rgbd cut from the scene's 400 frames to keep the script within its time
# once the inertial phases run (PERF.md §4)
N_DEPTH_FRAMES = {"stereo": 400, "rgbd": 200}
SCALE_GATE = 0.15  # |s - 1| of the scale-aligned fit, tests/test_chunked.py:126-127
# the JAX reference on the same frames (scripts/reference_system_counts.py
# stereo / rgbd, CPU, async mapper, loop closing on; its runs differ with the
# threads' timing): every timed frame tracked in every run; ate_gate_m is the
# worst ATE of its runs
REF_STEREO = {"runs": 3, "tracked_timed": 336, "keyframes": (27, 27), "map_points": (4113, 4210),
              "ate_m": (0.10160958624582596, 0.16466816872393464),
              "ate_gate_m": 0.16466816872393464}
# (rgbd on its first 200 frames: `reference_system_counts.py rgbd --frames 200`)
REF_RGBD = {"runs": 3, "frames": 200, "tracked_timed": 136, "keyframes": (17, 17),
            "map_points": (2513, 2561), "ate_m": (0.039293098615536995, 0.04828283613994794),
            "ate_gate_m": 0.04828283613994794}


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters=20, warmup=3):
    """Mean milliseconds per call over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls):
    """Device milliseconds per call: CUDA events around one replay of a CUDA
    graph that holds `calls` calls of fn, so no host work is timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def profiled_ms(fn, calls):
    """Device milliseconds per call, summed over the kernels (and memsets)
    that torch.profiler records in `calls` eager calls, and the same by name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.device_time / 1e3 / calls
    return sum(by_name.values()), by_name


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {
        "phase": "device",
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
    }
    emit(info)
    return info


def _ptxas_by_kernel(text):
    """{kernel: {"registers", "smem_bytes", "spill_stores", "spill_loads"}} from ptxas -v."""
    import re

    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            out.setdefault(name, {}).update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out.setdefault(name, {}).update(registers=int(m[1]),
                                            smem_bytes=int(smem[1]) if smem else 0)
    return out


def _sass_counts(library):
    """{kernel: {"BMMA": n, "IMMA": n, "atomics": n}} from cuobjdump -sass."""
    import re

    from orb_slam3_modified_tpu_torch._cuda import cuda_tool

    sass = subprocess.run([cuda_tool("cuobjdump"), "-sass", str(library)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    out = {}
    for name, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*Function : |\Z)", sass, re.S):
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", body)
        out[name] = {"BMMA": ops.count("BMMA"), "IMMA": ops.count("IMMA"),
                     "atomics": sum(op.startswith(("RED", "ATOM")) for op in ops)}
    return out


def _short_name(mangled):
    """hamming.cu's kernels by name; match_kernel<windowed> has two instances."""
    for short, pattern in (("hamming_mma_kernel", "hamming_mma_kernel"),
                           ("match_finish_kernel", "match_finish_kernel"),
                           ("match_kernel<true>", "match_kernelILb1E"),
                           ("match_kernel<false>", "match_kernelILb0E")):
        if pattern in mangled:
            return short
    return mangled


def phase_build():
    from orb_slam3_modified_tpu_torch.features.matcher import MATCH_KERNEL
    from orb_slam3_modified_tpu_torch.ops.hamming import HAMMING_KERNEL

    t0 = time.perf_counter()
    info = HAMMING_KERNEL.build(force=True)  # compiles csrc/hamming.cu: both entries
    MATCH_KERNEL.build()  # loads the same library
    seconds = time.perf_counter() - t0
    ptxas = _ptxas_by_kernel(info["ptxas"]) if info else {}
    sass = _sass_counts(HAMMING_KERNEL.library)
    per_kernel = {}
    for name, counts in sass.items():
        per_kernel[_short_name(name)] = {**ptxas.get(name, {}), **counts}
    emit({"phase": "build", "seconds": seconds, "source": HAMMING_KERNEL.source.name,
          "cmd": info["cmd"] if info else None, "kernels": per_kernel})
    for entry in ("hamming_mma_kernel", "match_kernel<true>", "match_kernel<false>"):
        k = per_kernel.get(entry, {})
        if k.get("BMMA", 0) + k.get("IMMA", 0) == 0:
            raise SystemExit(f"build: {entry} has no tensor-core MMA in its SASS: {k}")
    return per_kernel


def _random_desc(rng, n, dev):
    bits = rng.integers(0, 2**32, (n, 8), dtype=np.uint32).view(np.int32)
    return torch.tensor(bits, device=dev)


def _unpack_pm1(desc):
    """(N, 8) int32 -> (N, 256) bf16 of +-1 (bit set -> -1)."""
    shifts = torch.arange(32, device=desc.device, dtype=torch.int32)
    bits = (desc[..., None] >> shifts) & 1
    return (1 - 2 * bits.reshape(desc.shape[0], -1)).to(torch.bfloat16)


def _bound(bytes_moved, int8_ops, fp32_flops=0):
    """(least ms, what bounds it): bytes over HBM rate against each operation
    type over its peak (the units run side by side, so the larger counts)."""
    times = {"bytes": bytes_moved / HBM_BYTES_PER_S * 1e3,
             "operations": max(int8_ops / INT8_OPS_PER_S, fp32_flops / FP32_FLOPS_PER_S) * 1e3}
    by = max(times, key=times.get)
    return times[by], by


def hamming_bound_ms(n1, n2):
    """Inputs read once, the int32 matrix written once; n1 n2 256 +-1 int8 MACs."""
    return _bound((n1 + n2) * 32 + n1 * n2 * 4, 2 * 256 * n1 * n2)


def kernel_hamming(dev):
    from orb_slam3_modified_tpu_torch.ops import hamming
    from orb_slam3_modified_tpu_torch.ops.hamming import hamming_matrix, hamming_matrix_plain

    rng = np.random.default_rng(SEED)
    rows = {}
    # (1024, 8192): the mapper's batched match, 8 neighbours' features in one launch
    for n1, n2 in [(4096, 1024), (1024, 1024), (1024, 8192), (1000, 333), (1, 1), (65, 129),
                   (17, 4097)]:
        a, b = _random_desc(rng, n1, dev), _random_desc(rng, n2, dev)
        out = hamming_matrix(a, b)
        ref = hamming_matrix_plain(a, b)
        torch.cuda.synchronize()
        err = int((out - ref).abs().max())
        tile = hamming.MATRIX_TILE
        row = {"shape": [n1, n2], "max_abs_err": err,
               "grid": [-(-n2 // tile), -(-n1 // tile)], "block": 128}
        if n1 * n2 >= 1000 * 333:  # timed at the shapes with real work
            pa, pb = _unpack_pm1(a), _unpack_pm1(b)
            lib = torch.matmul(pa, pb.T)  # exact: +-1 products, |sum| <= 256
            lib_err = int(((256 - lib.float()) / 2 - out.float()).abs().max())
            bound, by = hamming_bound_ms(n1, n2)
            kernel_ms = graph_ms(lambda: hamming_matrix(a, b), 200)
            library_ms = graph_ms(lambda: torch.matmul(pa, pb.T), 200)
            kernel_prof_ms, kernel_by_name = profiled_ms(lambda: hamming_matrix(a, b), 50)
            library_prof_ms, library_by_name = profiled_ms(lambda: torch.matmul(pa, pb.T), 50)
            row.update({
                "library_max_abs_err": lib_err,
                "kernel_ms": kernel_ms,
                "plain_ms": graph_ms(lambda: hamming_matrix_plain(a, b), 10),
                "library_ms": library_ms,
                "bound_ms": bound, "bound_by": by,
                "popc_bound_ms": n1 * n2 * 8 / POPC_PER_S * 1e3,  # popcount kernel's CUDA-core figure
                "kernel_share_of_bound": bound / kernel_ms,
                "kernel_over_library": kernel_ms / library_ms,
                "kernel_profiler_ms": kernel_prof_ms, "kernel_profiler_by_name_ms": kernel_by_name,
                "library_profiler_ms": library_prof_ms,
                "library_profiler_by_name_ms": library_by_name,
            })
            err = max(err, lib_err)
        emit({"phase": "kernel", "name": "hamming_matrix", **row})
        if err != 0:
            raise SystemExit(f"hamming_matrix disagrees at {(n1, n2)}: {row}")
        rows[(n1, n2)] = row
    return rows


def _match_inputs(rng, n1, n2, dev):
    """A cache of n1 points against n2 features at bench width: a quarter of
    the points are features seen before (a few bits off, a few px away), the
    rest unrelated; 70% in view, 95% of features valid, radius 15 px per
    octave (tracking/fused.py's first pass)."""
    d2 = rng.integers(0, 2**32, (n2, 8), dtype=np.uint32)
    d1 = rng.integers(0, 2**32, (n1, 8), dtype=np.uint32)
    uv2 = (rng.random((n2, 2)) * [FRAME_W, FRAME_H]).astype(np.float32)
    uv1 = (rng.random((n1, 2)) * [FRAME_W, FRAME_H]).astype(np.float32)
    seen = rng.random(n1) < 0.25
    src = rng.integers(0, n2, n1)
    d1[seen] = d2[src[seen]]
    for i in np.nonzero(seen)[0]:
        for _ in range(8):
            d1[i, rng.integers(0, 8)] ^= np.uint32(1 << int(rng.integers(0, 32)))
    uv1[seen] = uv2[src[seen]] + rng.normal(0, 3, (int(seen.sum()), 2)).astype(np.float32)
    level = torch.tensor(rng.integers(0, 8, n2), device=dev)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    return (t(d1.view(np.int32)), t(rng.random(n1) < 0.7), t(d2.view(np.int32)),
            t(rng.random(n2) < 0.95), t(uv1), t(uv2),
            15.0 * torch.pow(1.2, level.to(torch.float32)))


def match_bound_ms(n1, n2, windowed):
    """Inputs read once (descriptors, flags, and the window's uv and radius),
    idx / ok / dist written once; the products of entry 1 and, windowed, the
    window test of every pair in float32."""
    bytes_in = (n1 + n2) * (32 + 1) + ((n1 + n2) * 8 + n2 * 4 if windowed else 0)
    return _bound(bytes_in + n1 * (8 + 1 + 4), 2 * 256 * n1 * n2,
                  WINDOW_FLOPS * n1 * n2 if windowed else 0)


def kernel_match(dev):
    from orb_slam3_modified_tpu_torch.features import matcher as m

    rng = np.random.default_rng(SEED + 1)
    rows = {}
    for n1, n2, windowed in [(4096, 1024, True), (4096, 1024, False), (1000, 333, True),
                             (65, 129, False), (17, 4097, True)]:
        d1, v1, d2, v2, uv1, uv2, r = _match_inputs(rng, n1, n2, dev)
        if windowed:
            args = (d1, v1, d2, v2, uv1, uv2, r, m.TH_HIGH, 0.9)
            name = "windowed_mutual_best_match"
        else:
            args = (d1, v1, d2, v2, m.TH_LOW, 0.8)
            name = "mutual_best_match"
        fused, plain, old = getattr(m, name), getattr(m, f"{name}_plain"), _old_matchers(m)[name]
        got, want, was = fused(*args), plain(*args), old(*args)
        torch.cuda.synchronize()
        exact = all(torch.equal(g, w) for g, w in zip(got, want))
        old_exact = all(torch.equal(g, w) for g, w in zip(was, want))
        row = {"shape": [n1, n2], "windowed": windowed, "exact": exact,
               # memset, match kernel (row blocks x column splits), finish kernel
               "grid": [-(-n1 // m.MATCH_ROWS), -(-n2 // m.MATCH_COLS)],
               "block": m.MATCH_THREADS, "finish_grid": -(-n1 // 256), "finish_block": 256,
               "old_path_exact": old_exact, "n_ok": int(got[1].sum()),
               "max_abs_err": max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))}
        if n1 == 4096:
            bound, by = match_bound_ms(n1, n2, windowed)
            kernel_ms = graph_ms(lambda: fused(*args), 200)
            old_ms = graph_ms(lambda: old(*args), 50)
            prof_ms, by_name = profiled_ms(lambda: fused(*args), 50)
            row.update({
                "kernel_ms": kernel_ms, "plain_ms": graph_ms(lambda: plain(*args), 10),
                "old_path_ms": old_ms, "library_ms": None,
                "bound_ms": bound, "bound_by": by, "kernel_share_of_bound": bound / kernel_ms,
                "old_path_over_kernel": old_ms / kernel_ms,
                "kernel_profiler_ms": prof_ms, "kernel_profiler_by_name_ms": by_name,
                "old_path_profiler_ms": profiled_ms(lambda: old(*args), 20)[0],
            })
        emit({"phase": "kernel", "name": "mutual_best_match", **row})
        if not (exact and old_exact and (row["n_ok"] > 0 or n1 < 1000)):
            raise SystemExit(f"mutual_best_match disagrees at {(n1, n2, windowed)}: {row}")
        rows[(n1, n2, windowed)] = row
    return rows


def phase_kernel(dev):
    from orb_slam3_modified_tpu_torch.features.matcher import MATCH_KERNEL
    from orb_slam3_modified_tpu_torch.ops.hamming import HAMMING_KERNEL

    HAMMING_KERNEL.launches = MATCH_KERNEL.launches = 0
    hamming = kernel_hamming(dev)
    match = kernel_match(dev)
    # launches in this phase: checks, warm-ups, captures and profiled calls
    return hamming, match, {"hamming_matrix": HAMMING_KERNEL.launches,
                            "mutual_best_match": MATCH_KERNEL.launches}


_HEADLINE = {}


def _headline(cam):
    """bench.py's headline scene, rendered once: the 400-frame quarter orbit
    (bench.py:61-71) over the seeded texture, uint8 frames."""
    from orb_slam3_modified_tpu_torch.utils.synthetic import orbit_trajectory
    from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import make_texture, render_sequence

    if "frames" not in _HEADLINE:
        T_all = orbit_trajectory(400, radius=4.0, sweep=np.pi / 2)
        _HEADLINE["T"] = T_all
        _HEADLINE["frames"] = render_sequence(cam, T_all, make_texture(SEED, 96, 1024),
                                              plane_z=2.0, plane_half=10.0)
    return _HEADLINE["T"], _HEADLINE["frames"]


def _scene(dev):
    from orb_slam3_modified_tpu_torch.cameras import Camera
    from orb_slam3_modified_tpu_torch.features.extractor import ExtractorConfig, ORBExtractor
    from orb_slam3_modified_tpu_torch.lie.se3 import SE3
    from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import seed_map_cache

    k = FRAME_W / 752  # bench.py's intrinsics, scaled with the frame width
    cam = Camera.pinhole(458.654 * k, 457.296 * k, 367.215 * k, 248.375 * k,
                         width=FRAME_W, height=FRAME_H, device=dev)
    ecfg = ExtractorConfig(n_features=N_FEATURES)
    n_frames = 2 + CHUNK * (1 + N_TIMED)
    T_all, all_frames = _headline(cam)
    T_seq = SE3(T_all.R[:n_frames], T_all.t[:n_frames])
    frames = all_frames[:n_frames]
    kf = np.linspace(0, n_frames - 1, 4).round().astype(int)
    extractor = ORBExtractor(ecfg, cam.height, cam.width, device=dev)
    kf_feats = extractor(torch.from_numpy(frames[kf]).to(dev))
    cache = seed_map_cache(cam, kf_feats, SE3(T_seq.R[kf], T_seq.t[kf]), 2.0, CACHE_CAP)
    return cam, ecfg, T_seq, frames, cache


def _state(T_seq, i, dev):
    from orb_slam3_modified_tpu_torch.tracking.fused import DeviceTrackState

    return DeviceTrackState(
        R=T_seq.R[i - 1].to(dev), t=T_seq.t[i - 1].to(dev),
        R_prev=T_seq.R[i - 2].to(dev), t_prev=T_seq.t[i - 2].to(dev),
        ok=torch.ones((), dtype=torch.bool, device=dev),
    )


def _run_chunks(step, state, cache, chunks):
    """Run the chunks in order; returns (state, [outs], [chunk ms])."""
    outs, ms = [], []
    for imgs in chunks:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, out, _ = step(state, cache, imgs)
        end.record()
        outs.append(out)
        ms.append((start, end))
    torch.cuda.synchronize()
    return state, outs, [s.elapsed_time(e) for s, e in ms]


def _plain_matchers(matcher):
    """The track step's matcher entries (tracking/fused.py) -> their plain versions."""
    return {"mutual_best_match": matcher.mutual_best_match_plain,
            "windowed_mutual_best_match": matcher.windowed_mutual_best_match_plain}


def _old_matchers(matcher):
    """The track step's matcher entries -> the unfused path on the card: the window
    as a torch mask, the matrix kernel (entry 1), the torch reductions."""
    def windowed(d1, v1, d2, v2, uv1, uv2, r, max_dist, ratio):
        return matcher.mutual_best_match(d1, v1, d2, v2, max_dist, ratio,
                                         extra_mask=matcher.window_mask(uv1, uv2, r))

    def brute(d1, v1, d2, v2, max_dist, ratio):
        return matcher.match_from_matrix(matcher.hamming_matrix(d1, d2), v1, v2, max_dist, ratio, None)

    return {"mutual_best_match": brute, "windowed_mutual_best_match": windowed}


def phase_slice(dev):
    from orb_slam3_modified_tpu_torch.features import matcher
    from orb_slam3_modified_tpu_torch.ops.hamming import HAMMING_KERNEL
    from orb_slam3_modified_tpu_torch.tracking import fused
    from orb_slam3_modified_tpu_torch.tracking.chunked import make_chunk_step
    from orb_slam3_modified_tpu_torch.tracking.tracker import inv_level_sigma2

    t0 = time.perf_counter()
    cam, ecfg, T_seq, frames, cache = _scene(dev)
    setup_s = time.perf_counter() - t0
    inv_s2 = inv_level_sigma2(ecfg.n_levels, ecfg.scale)
    chunks = [
        torch.from_numpy(frames[2 + c * CHUNK : 2 + (c + 1) * CHUNK]).to(dev)
        for c in range(1 + N_TIMED)
    ]
    state0 = _state(T_seq, 2, dev)
    step = make_chunk_step(cam, inv_s2, ecfg, rounds=3, iters=6, device=dev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()
    HAMMING_KERNEL.launches = matcher.MATCH_KERNEL.launches = 0
    # main path: one warm-up chunk, then the timed chunks
    state_w, outs_w, _ = _run_chunks(step, state0, cache, chunks[:1])
    t_wall = time.perf_counter()
    state_t, outs_t, chunk_ms = _run_chunks(step, state_w, cache, chunks[1:])
    wall_s = time.perf_counter() - t_wall
    launches = {"mutual_best_match": matcher.MATCH_KERNEL.launches,
                "hamming_matrix": HAMMING_KERNEL.launches}  # off the path: expect 0
    peak_mem = torch.cuda.max_memory_allocated()

    R = torch.cat([o.R for o in outs_w + outs_t]).cpu()
    t = torch.cat([o.t for o in outs_w + outs_t]).cpu()
    n_inl = torch.cat([o.n_inliers for o in outs_w + outs_t]).cpu()
    gt_t = T_seq.t[2 : 2 + len(t)]
    gt_R = T_seq.R[2 : 2 + len(t)]
    t_err = torch.linalg.norm(t - gt_t, dim=-1)
    cos = ((gt_R.transpose(-1, -2) @ R).diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2
    r_err_deg = torch.rad2deg(torch.arccos(cos.clamp(-1, 1)))
    ok = n_inl >= 20

    # the same first timed chunk through the plain matchers: identical poses
    with mock.patch.multiple(fused, **_plain_matchers(matcher)):
        _, outs_p, plain_chunk_ms = _run_chunks(step, state_w, cache, chunks[1:2])
    plain_same = all(torch.equal(a, b) for a, b in zip(outs_p[0], outs_t[0]))
    # the branch-free recovery form (what graph capture takes) over the same chunks
    with mock.patch.object(fused, "_branch_free", lambda t: True):
        _, outs_s, select_ms = _run_chunks(step, state_w, cache, chunks[1:])
    select_same = all(
        torch.equal(a.R, b.R) and torch.equal(a.t, b.t) for a, b in zip(outs_s, outs_t)
    )

    n_timed = CHUNK * N_TIMED
    result = {
        "phase": "slice",
        "frames": [cam.width, cam.height], "n_features": ecfg.n_features,
        "n_levels": ecfg.n_levels, "cache_points": int(cache.valid.sum()),
        "chunk": CHUNK, "timed_chunks": N_TIMED, "setup_s": setup_s,
        "chunk_ms": chunk_ms, "chunk_ms_p50": float(np.median(chunk_ms)),
        "frames_per_s": n_timed / (sum(chunk_ms) / 1e3),
        "frames_per_s_wall": n_timed / wall_s,
        "frames_ok": int(ok.sum()), "frames_total": int(ok.numel()),
        "n_inliers_min": int(n_inl.min()), "n_inliers_median": float(n_inl.float().median()),
        "max_trans_err_m": float(t_err.max()), "max_rot_err_deg": float(r_err_deg.max()),
        "launches": launches, "launches_per_frame": {k: v / len(t) for k, v in launches.items()},
        "max_memory_allocated": peak_mem, "memory_allocated_before": mem_before,
        "plain_match_chunk_ms": plain_chunk_ms[0], "plain_match_same_outputs": plain_same,
        "recovery_host_read_chunk_ms_p50": float(np.median(chunk_ms)),
        "recovery_branch_free_chunk_ms": select_ms,
        "recovery_branch_free_chunk_ms_p50": float(np.median(select_ms)),
        "recovery_branch_free_same_poses": select_same,
    }
    emit(result)
    failures = []
    if not bool(ok.all()):
        failures.append(f"{int((~ok).sum())} frames not ok")
    if float(t_err.max()) >= TRANS_GATE_M:
        failures.append(f"translation error {float(t_err.max()):.4f} m >= {TRANS_GATE_M}")
    if launches["mutual_best_match"] < 2 * len(t):
        failures.append(f"the fused match launched fewer than 2 times per frame: {launches}")
    if launches["hamming_matrix"] != 0:
        failures.append(f"the matrix kernel is back on the main path: {launches}")
    if not plain_same:
        failures.append("plain-matcher chunk gave different outputs")
    if not select_same:
        failures.append("branch-free recovery form gave different poses")
    if failures:
        raise SystemExit("slice failed: " + "; ".join(failures))
    return result, (cam, ecfg, inv_s2, chunks, state_w, cache)


def _profile(fn):
    """Device time and kernel launches of one call, from torch.profiler.

    Returns (device_busy_ms, kernel_launches, wall_ms, top kernels)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return busy_ms, len(kernels), wall_ms, [[k[:80], v] for k, v in top]


def phase_breakdown(dev, ctx):
    """Stage times on the slice's inputs (CUDA events): the extractor's
    stages over one 16-frame chunk, and one track step with its parts at the
    main path's shapes; then profiler passes over one track step, with the
    fused match and with the unfused match path, and over one extraction."""
    from orb_slam3_modified_tpu_torch.cameras import project
    from orb_slam3_modified_tpu_torch.features.extractor import EDGE, ORBExtractor
    from orb_slam3_modified_tpu_torch.features import matcher
    from orb_slam3_modified_tpu_torch.features.matcher import TH_HIGH, windowed_mutual_best_match
    from orb_slam3_modified_tpu_torch.lie.se3 import SE3
    from orb_slam3_modified_tpu_torch.ops.brief import GATHER_R, brief_from_patches
    from orb_slam3_modified_tpu_torch.ops.fast import border_mask, fast_score_maps, nonmax_3x3
    from orb_slam3_modified_tpu_torch.ops.image import gaussian_blur, resize
    from orb_slam3_modified_tpu_torch.ops.orientation import (
        ic_angles_from_patches, patches_from_padded,
    )
    from orb_slam3_modified_tpu_torch.ops.select import cell_topk, global_topk
    from orb_slam3_modified_tpu_torch.optim.pose_opt import pose_optimization
    from orb_slam3_modified_tpu_torch.tracking import fused
    from orb_slam3_modified_tpu_torch.tracking.fused import TrackStep

    cam, ecfg, inv_s2, chunks, state, cache = ctx
    imgs = chunks[1]
    ex = ORBExtractor(ecfg, cam.height, cam.width, device=dev)
    im0 = imgs.float()
    budget0 = ex.levels[0][1]

    def pyramid():
        return [resize(im0, getattr(ex, f"resize_wy{lvl}"), getattr(ex, f"resize_wx{lvl}"))
                for lvl, _, _ in ex.levels[1:]]

    def fast_nms():
        hi, lo = fast_score_maps(im0, ecfg.ini_th, ecfg.min_th)
        return nonmax_3x3(hi), nonmax_3x3(lo)

    hi, lo = fast_nms()
    border = border_mask(cam.height, cam.width, EDGE, dev)
    hi, lo = torch.where(border, hi, 0.0), torch.where(border, lo, 0.0)

    def select():
        return global_topk(*cell_topk(hi, lo, ecfg.cell, ecfg.k_per_cell), budget0)

    ys, xs, _, _ = select()
    blurred = gaussian_blur(im0, ex.gauss_taps)
    padded = torch.nn.functional.pad(blurred, (GATHER_R,) * 4)

    def describe():
        patches = patches_from_padded(padded, ys, xs, 2 * GATHER_R + 1)
        ang = ic_angles_from_patches(patches, ex.centroid_wx, ex.centroid_wy)
        return brief_from_patches(patches, ang, ex.pattern)

    feats = ex(imgs)
    f = [x[0] for x in feats]  # uv, desc, angle, level, response, valid of frame 0
    step = TrackStep(cam, inv_s2, ecfg.n_features, 3, 6, device=dev)
    T = SE3(state.R, state.t)
    uv = project(cam, T.apply(cache.pos))
    r = 15.0 * torch.pow(1.2, f[3].float())
    window_args = (cache.desc, cache.valid, f[1], f[5], uv, f[0], r, TH_HIGH, 0.9)
    idx, okm, _ = windowed_mutual_best_match(*window_args)
    old_windowed = _old_matchers(matcher)["windowed_mutual_best_match"]
    inv_s2_t = torch.as_tensor(inv_s2, device=dev)[f[3][idx].long()]

    def track():
        return step(state, cache, f[0], f[1], f[3], f[5])

    times = {
        "extract_chunk_ms": cuda_ms(lambda: ex(imgs), iters=5, warmup=1),
        "pyramid_chunk_ms": cuda_ms(pyramid, iters=10),
        "fast_nms_level0_chunk_ms": cuda_ms(fast_nms, iters=10),
        "cell_global_topk_level0_chunk_ms": cuda_ms(select, iters=10),
        "blur_level0_chunk_ms": cuda_ms(lambda: gaussian_blur(im0, ex.gauss_taps), iters=10),
        "gather_angle_brief_level0_chunk_ms": cuda_ms(describe, iters=10),
        "track_step_ms": cuda_ms(track, iters=5, warmup=1),
        "windowed_match_ms": cuda_ms(lambda: windowed_mutual_best_match(*window_args), iters=20),
        "windowed_match_old_path_ms": cuda_ms(lambda: old_windowed(*window_args), iters=20),
        "pose_solve_ms": cuda_ms(
            lambda: pose_optimization(T, cam, cache.pos, f[0][idx], inv_s2_t, 3, 6, valid=okm),
            iters=5, warmup=1),
    }
    busy, n_kernels, wall, top = _profile(track)
    # idle share against the unprofiled step: the profiler slows the host
    times.update({
        "track_step_profiled_wall_ms": wall, "track_step_device_busy_ms": busy,
        "track_step_device_idle_share": 1.0 - busy / times["track_step_ms"],
        "track_step_kernel_launches": n_kernels,
        "track_step_top_kernels_ms": top,
    })
    with mock.patch.multiple(fused, **_old_matchers(matcher)):  # before: the unfused match path
        old_ms = cuda_ms(track, iters=5, warmup=1)
        busy, n_kernels, wall, top = _profile(track)
    times.update({
        "old_path_track_step_ms": old_ms, "old_path_track_step_device_busy_ms": busy,
        "old_path_track_step_device_idle_share": 1.0 - busy / old_ms,
        "old_path_track_step_kernel_launches": n_kernels,
        "old_path_track_step_top_kernels_ms": top,
    })
    busy, n_kernels, wall, top = _profile(lambda: ex(imgs))
    times.update({
        "extract_chunk_profiled_wall_ms": wall, "extract_chunk_device_busy_ms": busy,
        "extract_chunk_device_idle_share": 1.0 - busy / times["extract_chunk_ms"],
        "extract_chunk_kernel_launches": n_kernels, "extract_chunk_top_kernels_ms": top,
    })
    emit({"phase": "breakdown", **times})
    return times


def _count_plain_calls(stack):
    """Patch every plain (CPU-path) matcher and Hamming version to count its
    calls; on the card the main path must take none of them."""
    from orb_slam3_modified_tpu_torch.features import matcher
    from orb_slam3_modified_tpu_torch.ops import hamming

    calls = {}

    def counted(module, name):
        fn = getattr(module, name)
        key = f"{module.__name__.rsplit('.', 1)[-1]}.{name}"
        calls[key] = 0

        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)

        stack.enter_context(mock.patch.object(module, name, wrapper))

    counted(hamming, "hamming_matrix_plain")
    for name in ("hamming_matrix_plain", "mutual_best_match_plain",
                 "windowed_mutual_best_match_plain"):
        counted(matcher, name)
    return calls


_RING = {}


def _ring(cam):
    """bench.py's ring scene (render_ring_sequence, run_hard_scene), rendered
    once: one full revolution of 400 frames at 20 frames/s, radius 4 m, height
    0.4, over the plane z = 2 m with a 2048^2 texture upsampled from a seeded
    128^2 draw."""
    from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import (
        make_texture, render_sequence, ring_trajectory,
    )

    if "frames" not in _RING:
        T_all = ring_trajectory(N_LOOP_FRAMES)
        _RING["T"] = T_all
        with np.errstate(invalid="ignore"):  # rays parallel to the plane
            _RING["frames"] = render_sequence(cam, T_all, make_texture(SEED, 128, 2048),
                                              plane_z=2.0, plane_half=10.0)
    return _RING["T"], _RING["frames"]


def _headline_depth(cam, scene):
    """The headline orbit's right images (stereo: the right camera displaced
    by BASELINE_M along the left one's x) or metric depth maps (rgbd),
    rendered once."""
    from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import (
        make_texture, render_rgbd_sequence, render_stereo_sequence,
    )

    if scene not in _HEADLINE:
        T_all, _ = _headline(cam)
        tex = make_texture(SEED, 96, 1024)
        with np.errstate(invalid="ignore"):  # rays parallel to the plane
            if scene == "stereo":
                _HEADLINE[scene] = render_stereo_sequence(cam, T_all, tex, BASELINE_M,
                                                          plane_z=2.0, plane_half=10.0)[1]
            else:
                _HEADLINE[scene] = render_rgbd_sequence(cam, T_all, tex, plane_z=2.0,
                                                        plane_half=10.0)[1]
    return _HEADLINE[scene]


def _count_stereo_matches(stack):
    """Patch the stereo match's Hamming matrix to count its calls and the
    matrix entry's launches they make."""
    from orb_slam3_modified_tpu_torch.ops import stereo_match
    from orb_slam3_modified_tpu_torch.ops.hamming import HAMMING_KERNEL

    counts = {"calls": 0, "hamming_matrix": 0}
    fn = stereo_match.hamming_matrix

    def wrapper(*a, **k):
        before = HAMMING_KERNEL.launches
        try:
            return fn(*a, **k)
        finally:
            counts["calls"] += 1
            counts["hamming_matrix"] += HAMMING_KERNEL.launches - before

    stack.enter_context(mock.patch.object(stereo_match, "hamming_matrix", wrapper))
    return counts


def _count_loop_matches(stack):
    """Patch the closer's and relocalization's matcher to count the launches
    of each entry that each of them makes."""
    from orb_slam3_modified_tpu_torch.features import matcher
    from orb_slam3_modified_tpu_torch.loop import loop_closer, relocalization
    from orb_slam3_modified_tpu_torch.ops.hamming import HAMMING_KERNEL

    kernels = {"hamming_matrix": HAMMING_KERNEL, "mutual_best_match": matcher.MATCH_KERNEL}
    launches = {key: dict.fromkeys(kernels, 0) for key in ("closer", "relocalization")}

    def counted(module, key):
        fn = module.mutual_best_match

        def wrapper(*a, **k):
            before = {name: kern.launches for name, kern in kernels.items()}
            try:
                return fn(*a, **k)
            finally:
                for name, kern in kernels.items():
                    launches[key][name] += kern.launches - before[name]

        stack.enter_context(mock.patch.object(module, "mutual_best_match", wrapper))

    counted(loop_closer, "closer")
    counted(relocalization, "relocalization")
    return launches


def _main_path(dev, scene, async_mapping=True, start=0):
    """The main path end to end through the user's entry point, as bench.py
    drives the reference: scene "system" is the headline run
    (bench.py:357-449, chunk 16), "loop" the ring scene (run_hard_scene,
    bench.py:121-201, chunk 8), "stereo" and "rgbd" the headline run with a
    right image or a depth map per frame; loop closing on in all. Returns
    (the phase's result line, the gate failures common to all)."""
    import contextlib

    from orb_slam3_modified_tpu_torch import native
    from orb_slam3_modified_tpu_torch.cameras import Camera
    from orb_slam3_modified_tpu_torch.eval.ate import align_horn, ate_rmse, largest_map_ate
    from orb_slam3_modified_tpu_torch.features import matcher
    from orb_slam3_modified_tpu_torch.features.extractor import ExtractorConfig
    from orb_slam3_modified_tpu_torch.ops.hamming import HAMMING_KERNEL
    from orb_slam3_modified_tpu_torch.system.slam_system import (
        MONOCULAR, RGBD, STEREO, SlamSystem, SystemConfig,
    )

    k = FRAME_W / 752
    cam = Camera.pinhole(458.654 * k, 457.296 * k, 367.215 * k, 248.375 * k,
                         width=FRAME_W, height=FRAME_H, device=dev)
    t0 = time.perf_counter()
    if scene == "loop":
        T_all, frames = _ring(cam)
        chunk, n_full = LOOP_CHUNK, N_LOOP_FRAMES
    else:
        T_all, frames = _headline(cam)  # rendered once, in the slice's set-up
        chunk, n_full = CHUNK, N_DEPTH_FRAMES.get(scene, N_SYSTEM_FRAMES)
    sensor = {"stereo": STEREO, "rgbd": RGBD}.get(scene, MONOCULAR)
    # a frame's right image (stereo) or depth map (rgbd), as track_image's keyword
    extra = _headline_depth(cam, scene)[start:] if sensor != MONOCULAR else None
    extra_kw = {"stereo": "img_right", "rgbd": "depth_img"}.get(scene)
    frames = frames[start:]
    n = min(n_full, len(frames))
    bf = BASELINE_M * float(cam.params[0]) if sensor != MONOCULAR else 0.0
    slam = SlamSystem(SystemConfig(cam=cam, sensor=sensor, feat_cap=N_FEATURES,
                                   extractor=ExtractorConfig(n_features=N_FEATURES),
                                   use_loop_closing=True, device=str(dev), bf=bf,
                                   min_depth=MIN_DEPTH, depth_scale=1.0, th_far_points=0.0))
    fe = slam.make_chunked_frontend(chunk=chunk, lag=1, async_mapping=async_mapping,
                                    stereo=sensor == STEREO, rgbd=sensor == RGBD)

    def track(i):
        return fe.track_image(frames[i], ts=i / 20.0,
                              **({extra_kw: extra[i]} if extra_kw else {}))

    setup_s = time.perf_counter() - t0
    am = slam.async_mapper
    drain = am.flush if am is not None else (lambda: None)
    # host intervals of each chunk dispatch (with its frame count) and of
    # each keyframe the mapper thread processes: their overlap is the mapper
    # work that shared the host (and the GIL) with a chunk's dispatch
    dispatches, mapper_work, closer_ms = [], [], []
    dispatch, on_keyframe = fe._dispatch_buffer, slam.mapper.on_keyframe

    def timed_dispatch():
        n_frames = len(fe._buf)
        t = time.perf_counter()
        dispatch()
        dispatches.append((t, time.perf_counter(), n_frames))

    def timed_on_keyframe(*a, **kw):
        t = time.perf_counter()
        try:
            return on_keyframe(*a, **kw)
        finally:
            mapper_work.append((t, time.perf_counter()))

    closer_on_keyframe = slam.closer.on_keyframe

    def timed_closer(k_):
        t = time.perf_counter()
        try:
            return closer_on_keyframe(k_)
        finally:
            closer_ms.append((time.perf_counter() - t) * 1e3)

    fe._dispatch_buffer = timed_dispatch
    slam.mapper.on_keyframe = timed_on_keyframe
    if am is not None:
        am.post_fn = timed_closer
    else:
        slam.closer.on_keyframe = timed_closer
    # keyframes created, and keyframe decisions taken with the mapper
    # backlogged (NeedNewKeyFrame then inserts only when tracking starves)
    kf_log = {"created": 0, "decisions_backlogged": 0}
    create_keyframe, busy_fn = slam.tracker._create_keyframe, slam.tracker.mapper_busy_fn

    def counted_create_keyframe(*a, **kw):
        kf_log["created"] += 1
        return create_keyframe(*a, **kw)

    def counted_busy():
        busy = busy_fn()
        kf_log["decisions_backlogged"] += bool(busy)
        return busy

    slam.tracker._create_keyframe = counted_create_keyframe
    if busy_fn is not None:
        slam.tracker.mapper_busy_fn = counted_busy
    # stereo / rgbd: the chunk step's match / lookup, timed on the host and by
    # CUDA events on its stream, and the close points keyframes spawn from depth
    stage = {STEREO: ("stereo_match", "match"), RGBD: ("depth_lookup", "lookup")}.get(sensor)
    stage_times, spawned = [], {"points": 0, "keyframes": 0}
    if stage is not None:
        step = fe._chunk_step()
        stage_fn = getattr(step, stage[1])

        def timed_stage(*a):
            ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t = time.perf_counter()
            ev0.record()
            try:
                return stage_fn(*a)
            finally:
                ev1.record()
                stage_times.append(((time.perf_counter() - t) * 1e3, ev0, ev1))

        setattr(step, stage[1], timed_stage)
        spawn = slam.tracker._spawn_depth_points

        def counted_spawn(k_, rec):
            n0 = int(slam.map.mp_valid.sum())
            spawn(k_, rec)
            spawned["points"] += int(slam.map.mp_valid.sum()) - n0
            spawned["keyframes"] += 1

        slam.tracker._spawn_depth_points = counted_spawn
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem_before = torch.cuda.memory_allocated()
    retired = []
    with contextlib.ExitStack() as stack:
        plain_calls = _count_plain_calls(stack)
        loop_launches = _count_loop_matches(stack)
        stereo_launches = _count_stereo_matches(stack)
        HAMMING_KERNEL.launches = matcher.MATCH_KERNEL.launches = 0
        for i in range(N_SYSTEM_WARM):
            retired += track(i)
        drain()  # the mapper's first keyframes drain before the timer, as bench.py
        warm = {"hamming_matrix": HAMMING_KERNEL.launches,
                "mutual_best_match": matcher.MATCH_KERNEL.launches}
        n_warm_dispatch, n_warm_stage = len(dispatches), len(stage_times)
        fe.stats.samples.clear()
        slam.mapper.stats.samples.clear()
        t0 = time.perf_counter()
        for i in range(N_SYSTEM_WARM, n):
            retired += track(i)
        retired += fe.flush()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        drain()
        launches = {"hamming_matrix": HAMMING_KERNEL.launches,
                    "mutual_best_match": matcher.MATCH_KERNEL.launches}
    peak_mem = torch.cuda.max_memory_allocated()
    fe_stats, map_stats = fe.stats.summary(), slam.mapper.stats.summary()
    slam.shutdown()

    fids = [r[0] for r in retired]
    tracked_timed = sum(r[2] is not None for r in retired if r[0] >= N_SYSTEM_WARM)
    traj = slam.tracker.absolute_trajectory()
    est = np.array([np.linalg.inv(T)[:3, 3] for _, _, T in traj])
    R, t = T_all.R.numpy(), T_all.t.numpy()
    gt = np.array([-R[f + start].T @ t[f + start] for _, f, _ in traj])
    ate, scale = ate_rmse(est, gt) if len(traj) >= 3 else (float("inf"), 0.0)
    half = [i for i, (_, f, _) in enumerate(traj) if f < n // 2]
    ate_half = ate_rmse(est[half], gt[half])[0] if len(half) >= 3 else float("inf")
    # where along the trajectory the error sits: the aligned error's mean
    # over each tenth, and the scale fitted to each quarter alone (a
    # drifting scale shows as a trend)
    err = align_horn(est.T, gt.T)[3] if len(traj) >= 3 else np.zeros(0)
    err_by_tenth = [float(e.mean()) for e in np.array_split(err, 10) if len(e)]
    scale_by_quarter = [ate_rmse(est[q], gt[q])[1] for q in np.array_split(np.arange(len(traj)), 4)
                        if len(q) >= 3]
    m = slam.map
    gt_by_fid = {f: -R[f + start].T @ t[f + start] for f in range(n)}
    lm_ate, lm_scale, lm_kfs, _ = (largest_map_ate(m, gt_by_fid) if m.n_keyframes(all_maps=True) >= 3
                                   else (float("inf"), 0.0, 0, -1))
    full = [d for d in dispatches[n_warm_dispatch:] if d[2] == chunk]
    chunk_ms = [(d1 - d0) * 1e3 for d0, d1, _ in full]
    overlap_ms = [sum(max(0.0, min(d1, w1) - max(d0, w0)) for w0, w1 in mapper_work) * 1e3
                  for d0, d1, _ in full]
    idle_ms = [c for c, o in zip(chunk_ms, overlap_ms) if o == 0]
    busy_ms = [c for c, o in zip(chunk_ms, overlap_ms) if o > 0]
    # least squares chunk_ms = a + b * overlap_ms: b is the dispatch time one
    # ms of mapper work costs
    slope = (float(np.polyfit(overlap_ms, chunk_ms, 1)[0])
             if len(set(overlap_ms)) > 1 else None)
    stepped = sum(d[2] for d in dispatches)
    pct = lambda xs, q: float(np.percentile(xs, q)) if xs else None  # noqa: E731
    stage_result = {}
    if stage is not None:  # the timed chunks' match / lookup (events are done: synchronized)
        dev_ms = [e0.elapsed_time(e1) for _, e0, e1 in stage_times[n_warm_stage:]]
        host_ms = [h for h, _, _ in stage_times[n_warm_stage:]]
        stage_result = {stage[0]: {"chunks": len(dev_ms),
                                   "ms_per_chunk_mean": float(np.mean(dev_ms)),
                                   "ms_per_chunk_p50": pct(dev_ms, 50),
                                   "ms_per_chunk_p90": pct(dev_ms, 90),
                                   "host_ms_per_chunk_p50": pct(host_ms, 50),
                                   "share_of_chunk_p50": (pct(dev_ms, 50) / pct(chunk_ms, 50)
                                                          if chunk_ms else None)}}
    n_timed = n - N_SYSTEM_WARM
    c = slam.closer
    closer_stages = {name: {"total_ms": float(np.sum(v) * 1e3), "count": len(v)}
                     for name, v in c.stats.samples.items()}
    result = {
        # frames cut from the scene's 400 (the rgbd phase's cut, if made, shows here)
        "phase": scene, "start": start, "frames": n,
        "frame_cut": (N_LOOP_FRAMES if scene == "loop" else N_SYSTEM_FRAMES) - n,
        "sensor": {MONOCULAR: "monocular", STEREO: "stereo", RGBD: "rgbd"}[sensor], "bf": bf,
        "warm_frames": N_SYSTEM_WARM, "timed_frames": n_timed, "size": [FRAME_W, FRAME_H],
        "n_features": N_FEATURES, "chunk": chunk, "lag": 1, "async_mapping": async_mapping,
        "loop_closing": True, "setup_s": setup_s, "timed_wall_s": wall_s,
        "frames_per_s": n_timed / wall_s,
        "chunk_ms_p50": pct(chunk_ms, 50), "chunk_ms_p90": pct(chunk_ms, 90),
        "chunk_ms_mapper_idle_p50": pct(idle_ms, 50), "chunk_ms_mapper_busy_p50": pct(busy_ms, 50),
        "chunks_timed": len(chunk_ms), "chunks_mapper_idle": len(idle_ms),
        "chunks_mapper_busy": len(busy_ms), "chunk_ms": chunk_ms,
        "chunk_mapper_overlap_ms": overlap_ms, "chunk_ms_per_mapper_ms": slope,
        "retired_in_order": fids == list(range(n)), "retired": len(fids),
        "tracked_timed": tracked_timed, "tracked_total": sum(r[2] is not None for r in retired),
        "keyframes": m.n_keyframes(), "map_points": m.n_points(),
        "keyframes_all_maps": m.n_keyframes(all_maps=True),
        "map_points_all_maps": m.n_points(all_maps=True),
        "maps_created": m.n_maps, "maps_alive": len(m.map_ids()),
        "keyframes_created_after_init": kf_log["created"],
        "keyframe_decisions_backlogged": kf_log["decisions_backlogged"],
        "ate_m": ate, "ate_scale": scale, "ate_frames": len(traj),
        "ate_first_half_m": ate_half, "ate_err_by_tenth_m": err_by_tenth,
        "ate_scale_by_quarter": scale_by_quarter,
        "largest_map_kf_ate_m": lm_ate, "largest_map_kf_scale": lm_scale,
        "largest_map_keyframes": lm_kfs,
        "closer": {"keyframes": len(closer_ms), "queries": c.n_queries,
                   "verifications": c.n_verifications, "loops_closed": c.n_loops_closed,
                   "merges": c.n_merges, "gba_runs": c.n_gba_runs, "loops": c.loops,
                   "ms_per_keyframe_mean": float(np.mean(closer_ms)) if closer_ms else 0.0,
                   "ms_per_keyframe_max": float(np.max(closer_ms)) if closer_ms else 0.0,
                   "stages": closer_stages,
                   # each verified pair by frame id, with the counts each gate saw
                   "verify_log": c.verify_log},
        "reloc_attempts": slam.reloc_attempts, "reloc_successes": slam.reloc_successes,
        "chunk_stepped_frames": stepped, "slow_path_frames": n - stepped,
        "launches": launches, "launches_warm_up": warm,
        "launches_per_chunk_stepped_frame": {k_: v / max(stepped, 1) for k_, v in launches.items()},
        "launches_by_stage": loop_launches, "stereo_match_launches": stereo_launches,
        "depth_stage_ms": stage_result, "close_points_spawned": spawned["points"],
        "keyframes_spawning_points": spawned["keyframes"],
        "plain_calls": plain_calls, "mapper_errors": am.errors if am is not None else [],
        "native_covis": native.get_lib() is not None,
        "frontend_stages": fe_stats, "mapper_stages": map_stats,
        "max_memory_allocated": peak_mem, "memory_allocated_before": mem_before,
    }
    emit(result)
    failures = []
    if fids != list(range(n)):
        failures.append(f"frames not retired in order: {len(fids)} of {n}")
    if any(plain_calls.values()):
        failures.append(f"plain versions called on the card: {plain_calls}")
    return result, failures


def phase_system(dev, async_mapping=True, start=0):
    """bench.py's headline run through the user's entry point, loop closing
    on (for scripts/system_repeat.py's comparisons: async_mapping=False runs
    the mapper and closer in the tracker's thread, start > 0 enters the orbit
    at that frame)."""
    result, failures = _main_path(dev, "system", async_mapping, start)
    n_timed, stepped, launches = (result["timed_frames"], result["chunk_stepped_frames"],
                                  result["launches"])
    c = result["closer"]
    if (async_mapping and start == 0 and c["loops_closed"] + c["merges"] == 0
            and result["reloc_attempts"] == 0):
        got = {k_: result[k_] for k_ in SYSTEM_RUN_I}
        if got != SYSTEM_RUN_I:
            failures.append(f"a closer that did nothing changed the map: {got} != {SYSTEM_RUN_I}")
    if result["tracked_timed"] != n_timed:
        failures.append(f"{n_timed - result['tracked_timed']} timed frames not tracked")
    if not result["ate_m"] < ATE_GATE_M:
        failures.append(f"ATE {result['ate_m']} m >= {ATE_GATE_M}")
    if launches["hamming_matrix"] == 0:
        failures.append("the matrix entry never launched on the main path")
    if launches["mutual_best_match"] < 2 * stepped:
        failures.append(f"the fused entry launched fewer than 2 times per chunk-stepped frame: "
                        f"{launches['mutual_best_match']} for {stepped}")
    if failures:
        raise SystemExit("system failed: " + "; ".join(failures))
    return result


def phase_loop(dev, async_mapping=True, start=0):
    """bench.py's ring scene (run_hard_scene) through the user's entry point:
    relocalization, new maps and merges, loop detection, Sim3 verification,
    the essential graph and global BA run here when the scene calls for them.
    Gates beside the common ones: the fused entry launched by the closer or
    relocalization; tracked timed frames and ATE no worse than the JAX
    reference's on the same frames (REF_LOOP); loops closed + merges >= 1
    only when the reference closed one."""
    result, failures = _main_path(dev, "loop", async_mapping, start)
    if start == 0:
        by_stage = result["launches_by_stage"]
        if by_stage["closer"]["mutual_best_match"] + by_stage["relocalization"]["mutual_best_match"] == 0:
            failures.append("the fused entry was launched by neither the closer nor relocalization")
        if result["tracked_timed"] < REF_LOOP["tracked_timed"]:
            failures.append(f"tracked timed frames {result['tracked_timed']} < the reference's "
                            f"{REF_LOOP['tracked_timed']}")
        if not result["ate_m"] <= REF_LOOP["ate_gate_m"]:
            failures.append(f"ATE {result['ate_m']} m > {REF_LOOP['ate_gate_m']} (the reference's "
                            f"worst on these frames)")
        closed = result["closer"]["loops_closed"] + result["closer"]["merges"]
        if REF_LOOP["loops_closed"] + REF_LOOP["merges"] >= 1 and closed < 1:
            failures.append("no loop closed and no map merged")
    if failures:
        raise SystemExit("loop failed: " + "; ".join(failures))
    return result


def _match_check(dev):
    """One headline frame's left -> right match on the card against the same
    features' match on the CPU (the plain Hamming version): exact."""
    from orb_slam3_modified_tpu_torch.cameras import Camera
    from orb_slam3_modified_tpu_torch.features.extractor import ExtractorConfig, ORBExtractor
    from orb_slam3_modified_tpu_torch.ops.stereo_match import match_stereo

    k = FRAME_W / 752
    cam = Camera.pinhole(458.654 * k, 457.296 * k, 367.215 * k, 248.375 * k,
                         width=FRAME_W, height=FRAME_H, device=dev)
    _, frames = _headline(cam)
    right = _headline_depth(cam, "stereo")
    ex = ORBExtractor(ExtractorConfig(n_features=N_FEATURES), FRAME_H, FRAME_W, device=dev)
    f = ex(torch.from_numpy(np.stack([frames[100], right[100]])).to(dev))
    args = [x[i] for i in (0, 1) for x in (f.uv, f.desc, f.level, f.valid)]
    bf = BASELINE_M * float(cam.params[0])
    got = match_stereo(*args, bf, MIN_DEPTH)
    want = match_stereo(*(a.cpu() for a in args), bf, MIN_DEPTH)
    exact = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    return {"frame": 100, "shape": [N_FEATURES, N_FEATURES], "exact": exact,
            "matched": int(want[2].sum())}


def phase_depth(dev, scene, async_mapping=True, start=0):
    """The stereo or rgbd main path (see the module docstring). Gates beside
    the common ones: every timed frame tracked, |s - 1| < SCALE_GATE, ATE no
    worse than the reference's worst run on the same frames, the fused entry
    at least twice per chunk-stepped frame, and (stereo) the matrix entry at
    least once per frame by the stereo match, whose card result equals the
    CPU's on one frame."""
    ref = {"stereo": REF_STEREO, "rgbd": REF_RGBD}[scene]
    check = _match_check(dev) if scene == "stereo" else None
    result, failures = _main_path(dev, scene, async_mapping, start)
    n, n_timed, stepped = result["frames"], result["timed_frames"], result["chunk_stepped_frames"]
    emit({"phase": f"{scene}_against_reference", "reference": ref,
          "port": {k_: result[k_] for k_ in ("tracked_timed", "keyframes", "map_points", "ate_m",
                                             "ate_scale")}})
    if check is not None:
        emit({"phase": "stereo_match_check", **check})
        if not check["exact"]:
            failures.append(f"the stereo match on the card differs from the CPU's: {check}")
    if result["tracked_timed"] != n_timed:
        failures.append(f"{n_timed - result['tracked_timed']} timed frames not tracked")
    if not abs(result["ate_scale"] - 1.0) < SCALE_GATE:
        failures.append(f"scale {result['ate_scale']}: |s - 1| >= {SCALE_GATE}")
    if start == 0 and not result["ate_m"] <= ref["ate_gate_m"]:
        failures.append(f"ATE {result['ate_m']} m > {ref['ate_gate_m']} (the reference's worst "
                        f"on these frames)")
    if result["launches"]["mutual_best_match"] < 2 * stepped:
        failures.append(f"the fused entry launched fewer than 2 times per chunk-stepped frame: "
                        f"{result['launches']['mutual_best_match']} for {stepped}")
    if scene == "stereo" and result["stereo_match_launches"]["hamming_matrix"] < n:
        failures.append(f"the stereo match launched the matrix entry "
                        f"{result['stereo_match_launches']['hamming_matrix']} times for {n} frames")
    if failures:
        raise SystemExit(f"{scene} failed: " + "; ".join(failures))
    return result


# the inertial phases: per-frame entry points.
# - mono_inertial: tests/test_e2e_inertial.py's course at full width (a
#   752x480 EuRoC camera on a 1.5 m horizontal circle at 0.8 rad/s, looking
#   up at a ceiling of 5000 points 2-6 m above, 0.4 px noise, the noise-free
#   200 Hz IMU of the same motion, camera = body), 1024 features a frame,
#   320 frames at 20 frames/s (the test's 140 run on to VIBA2 at 15 s), 128
#   warm-up (400 and 160 before the vi and si phases needed the time),
#   through SlamSystem.track_features(imu_samples=): the scene where both
#   packages initialize mono-inertial (the reference's scale over the timed
#   frames is within 0.1 of metric on four of its five draw sets).
# - mono_inertial_image: bench.py's VI scene (main_vi: a 512x384 pinhole,
#   write_euroc_sequence's quarter orbit of 400 frames, radius 4 m, sweep
#   pi/2, the noise-free 200 Hz IMU, identity extrinsics) through the image
#   entry track_monocular_inertial, cut to its first 72 frames (28
#   warm-up; 200 and 80 before the vi and si phases needed the time, 100
#   and 40 before the cli phase did; the port's first init is at frame
#   41, the reference's at 47). Its accelerations (0.02-0.03 m/s^2)
#   leave the monocular scale unobservable: the reference never
#   initializes there for good (six init events over 400 frames, each
#   reset by the bad-IMU rule), so the phase gates the path only and
#   reports its accuracy.
# - stereo_inertial: the stereo scene's 752x480 pair on bench.py's VI orbit
#   law, cut to its first 150 frames (60 warm-up; 200 and 64 before the vi
#   and si phases needed the time).
# (frames, warm-up frames)
# - vi / si: bench.py's main_vi through the chunked frontend (see
#   phase_chunked_vi): vi the VI scene uncut, 160 warm-up frames; si its
#   first 200 frames, 80 warm-up (the script's time).
VI_FRAMES = {"mono_inertial": (320, 128), "mono_inertial_image": (72, 28),
             "stereo_inertial": (150, 60), "vi": (400, 160), "si": (200, 80)}
VI_CAM = (330.0, 330.0, 256.0, 192.0, 512, 384)  # bench.py's main_vi camera
VI_BASELINE_M = 0.11  # bench.py's main_vi stereo baseline
VI_CHUNK = 8  # bench.py's main_vi chunk
COURSE = dict(radius=1.5, omega=0.8, n_points=5000, ceiling=(2.0, 6.0), seed=5, noise_px=0.4)
MONO_SCALE_GATE = 0.1  # tests/test_e2e_inertial.py:102-108
# the JAX reference on the same frames and IMU stream
# (scripts/reference_system_counts.py mono_inertial / mono_inertial_image /
# stereo_inertial, CPU, the per-frame entry points, loop closing on): a run
# repeats to the bit, and only the two-view initializer's random minimal
# sets differ between the packages (each draws from its own generator), so
# mono_inertial's reference is five runs on five draw sets (its own and
# jax.random.fold_in offsets 1-4), the others runs of its own draws:
# tracked_timed_min is the least of them, timed_ate_gate_m the worst ATE
# over the timed frames, imu_stage_reached the highest stage any init
# event reached.
# (mono_inertial and stereo_inertial on their first 320 and 150 frames:
# reference_system_counts.py mono_inertial --frames 320 --draws k,
# stereo_inertial --frames 150; their warm-up 2/5 of the cut)
REF_MONO_INERTIAL = {"runs": 5, "draw_sets": [0, 1, 2, 3, 4], "frames": 320,
                     "tracked_timed_min": 192, "imu_stage": 3, "imu_stage_reached": 3,
                     "init_events_applied": 3, "keyframes": (6, 10), "map_points": (2296, 2662),
                     "init_frame": (43, 45),
                     "post_init_ate_m": (0.1207883960904261, 0.14820569062239577),
                     "timed_ate_m": (0.007194362361608643, 0.10877564241757275),
                     "timed_ate_gate_m": 0.10877564241757275,
                     "timed_scale": (1.0023713594581127, 1.1464833927106068)}
# mono_inertial_image: one run of its own draws on the first 100 frames
# (reference_system_counts.py mono_inertial_image --frames 100; the
# 400-frame scene's three runs agreed to the bit); two init events, the
# first reset by the bad-IMU rule
REF_MONO_INERTIAL_IMAGE = {"runs": 1, "frames": 100, "tracked_timed_min": 53, "imu_stage": 1,
                           "imu_stage_reached": 1, "init_events_applied": 2, "keyframes": 4,
                           "map_points": 642, "init_frame": 47,
                           "post_init_ate_m": 0.1854245583917652,
                           "post_init_scale": 6.1138060915677315,
                           "timed_ate_m": 0.1854245583917652,
                           "timed_scale": 6.1138060915677315}
REF_STEREO_INERTIAL = {"runs": 1, "frames": 150, "tracked_timed_min": 90, "imu_stage": 2,
                       "imu_stage_reached": 2, "init_events_applied": 2, "keyframes": 17,
                       "map_points": 2674, "init_frame": 45,
                       "post_init_ate_m": 0.0738048168847618,
                       "post_init_scale": 1.3966156113752146,
                       "timed_ate_m": 0.065788411114596,
                       "timed_ate_gate_m": 0.065788411114596,
                       "timed_scale": 1.3446691095263077}


# bench.py's main_vi scenes through the chunked frontend on the JAX
# reference (scripts/reference_system_counts.py vi / si, CPU; the async
# mapper's timing makes runs differ): the least tracked timed frames, the
# least stage reached, the worst ATE over the timed frames. vi's outcome is
# bimodal (a small first init scale trips the bad-IMU reset, or not): three
# runs were made first, three more after the port's first full run tracked
# one timed frame fewer than their least (PERF.md §6)
REF_VI = {"runs": 6, "tracked_timed_min": 234, "tracked_timed": [240, 239, 235, 236, 237, 234],
          "imu_stage_reached": [3, 3, 2, 3, 2, 2], "imu_stage_reached_min": 2,
          "vi_frames": [306, 292, 252, 238, 248, 254], "keyframes": [47, 41, 18, 3, 12, 10],
          "map_points": [1489, 1430, 1173, 447, 952, 1041], "init_frame": [93, 93, 85, 101, 93, 85],
          "timed_ate_m": [0.853733675762074, 0.573081247144534, 1.1100313134145952,
                          0.7768277545898448, 1.0565473896235844, 1.0448755706508102],
          "timed_ate_gate_m": 1.1100313134145952,
          "timed_scale": [0.011894269701368893, 0.04064722766999758, 0.012164561729574164,
                          0.0409256509219673, 0.029897698787042952, 0.031928576027543225]}
# si on its first 200 frames (si --frames 200, 80 warm-up)
REF_SI = {"runs": 3, "frames": 200, "tracked_timed_min": 120, "tracked_timed": [120, 120, 120],
          "imu_stage_reached": [2, 2, 2], "imu_stage_reached_min": 2,
          "vi_frames": [127, 127, 127], "keyframes": [34, 29, 27],
          "map_points": [3586, 3116, 2824], "init_frame": [80, 80, 80],
          "timed_ate_m": [0.20298321745808728, 0.1702657106455705, 0.055132299692892815],
          "timed_ate_gate_m": 0.20298321745808728,
          "timed_scale": [1.5560088147966722, 0.9149642414507372, 1.1111993381330854]}


def _vi_scene(scene, cam):
    """(frames, right images or None, SE3 of the true poses, imu_stream) of
    an image scene, rendered once: bench.py's VI orbit law of 400 frames
    (radius 4 m, sweep pi/2, height 0.4) and its IMU stream, cut to the
    scene's first frames."""
    from orb_slam3_modified_tpu_torch.lie.se3 import SE3
    from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import (
        imu_stream, make_texture, orbit_poses, render_sequence, render_stereo_sequence,
    )

    n, _ = VI_FRAMES[scene]
    orbit = dict(fps=20.0, radius=4.0, sweep=np.pi / 2)
    T_all = orbit_poses(400, **orbit)
    T_all = SE3(T_all.R[:n], T_all.t[:n])
    tex = make_texture(SEED, 96, 1024)
    with np.errstate(invalid="ignore"):  # rays parallel to the plane
        if scene in ("stereo_inertial", "si"):
            baseline = VI_BASELINE_M if scene == "si" else BASELINE_M
            frames, right = render_stereo_sequence(cam, T_all, tex, baseline, plane_z=2.0,
                                                   plane_half=10.0)
        else:
            frames, right = render_sequence(cam, T_all, tex, plane_z=2.0, plane_half=10.0), None
    return frames, right, T_all, imu_stream(400, **orbit)


def ceiling_course(cam, n, max_feats, fps=20.0, imu_rate=200.0):
    """tests/test_e2e_inertial.py's course (COURSE), frame by frame: a list
    of n (host Features, true camera centre, imu samples since the previous
    frame as (acc, gyro, dts) float32) of the camera circling under the
    ceiling, camera = body, gravity -9.81 z."""
    from orb_slam3_modified_tpu_torch.lie.se3 import SE3np
    from orb_slam3_modified_tpu_torch.utils.synthetic_features import SyntheticFeatureWorld

    r, w = COURSE["radius"], COURSE["omega"]
    rng = np.random.default_rng(COURSE["seed"])
    world = SyntheticFeatureWorld(n_points=COURSE["n_points"], feat_cap=max_feats,
                                  noise_px=COURSE["noise_px"], seed=COURSE["seed"])
    pts = rng.uniform(-4, 4, (COURSE["n_points"], 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(*COURSE["ceiling"], COURSE["n_points"])
    world.points = pts
    g = np.array([0.0, 0.0, -9.81])

    def state(t):
        c, s_ = np.cos(w * t), np.sin(w * t)
        R_wb = np.array([[c, -s_, 0.0], [s_, c, 0.0], [0.0, 0.0, 1.0]])
        return R_wb, r * np.array([c, s_, 0.0]), -r * w * w * np.array([c, s_, 0.0])

    out = []
    for i in range(n):
        R_wb, p, _ = state(i / fps)
        feats, _ = world.observe(cam, SE3np(R_wb.T.astype(np.float32),
                                            (-R_wb.T @ p).astype(np.float32)),
                                 max_feats=max_feats)
        acc, gyro = [], []
        for j in range(int(imu_rate / fps) if i > 0 else 0):
            R_j, _, a_j = state((i - 1) / fps + j / imu_rate)
            acc.append(R_j.T @ (a_j - g))
            gyro.append([0.0, 0.0, w])
        k = len(acc)
        out.append((feats, p, (np.array(acc, np.float32).reshape(k, 3),
                               np.array(gyro, np.float32).reshape(k, 3),
                               np.full(k, 1.0 / imu_rate, np.float32))))
    return out


def phase_inertial(dev, scene):
    """The inertial main path frame by frame, loop closing on, the staged
    IMU init synchronous (see VI_FRAMES): SlamSystem(sensor=IMU_MONOCULAR)
    .track_features(..., imu_samples=) on the course (mono_inertial) or
    .track_monocular_inertial on bench.py's VI scene (mono_inertial_image),
    SlamSystem(sensor=IMU_STEREO).track_stereo(..., imu_samples=)
    (stereo_inertial). Times (host clock; CUDA events for the VI frame solve
    and the preintegration), launches of one VI solve and of one frame's
    preintegration (torch.profiler), the init / VIBA / vi_refine ms, the map
    and the IMU's stage, and the scale-aligned ATE of the frames tracked
    from the IMU init on and of the timed ones among them. Gates: every part
    of the inertial path ran (every frame's preintegration, the VI frame
    solve, the init solve and its full VI BA, vi_refine), the IMU
    initialized during the run and reached the reference's highest stage,
    no plain version called, the matrix entry launched on the path; but for
    mono_inertial_image, whose scale no package can observe, also the timed
    frames tracked no fewer than the reference's, the post-init ATE no worse
    than the reference's worst and, over the timed frames, |s - 1| under
    MONO_SCALE_GATE (mono_inertial) or SCALE_GATE (stereo_inertial)."""
    import contextlib

    from orb_slam3_modified_tpu_torch.cameras import Camera
    from orb_slam3_modified_tpu_torch.eval.ate import ate_rmse
    from orb_slam3_modified_tpu_torch.features import matcher
    from orb_slam3_modified_tpu_torch.features.extractor import ExtractorConfig
    from orb_slam3_modified_tpu_torch.ops.hamming import HAMMING_KERNEL
    from orb_slam3_modified_tpu_torch.system.slam_system import (
        IMU_MONOCULAR, IMU_STEREO, SlamSystem, SystemConfig,
    )
    from orb_slam3_modified_tpu_torch.tracking import imu_frontend, tracker as tracker_mod
    from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import imu_between

    stereo = scene == "stereo_inertial"
    course = scene == "mono_inertial"
    gated = scene != "mono_inertial_image"
    n, n_warm = VI_FRAMES[scene]
    if scene == "mono_inertial_image":
        intr = VI_CAM
    else:
        k = FRAME_W / 752
        intr = (458.654 * k, 457.296 * k, 367.215 * k, 248.375 * k, FRAME_W, FRAME_H)
    cam = Camera.pinhole(*intr[:4], width=intr[4], height=intr[5], device=dev)
    t0 = time.perf_counter()
    if course:
        frames = ceiling_course(Camera.pinhole(*intr[:4], width=intr[4], height=intr[5],
                                               device="cpu"), n, N_FEATURES)
        gt = {f: frames[f][1] for f in range(n)}
    else:
        frames, right, T_all, (its, igyro, iacc) = _vi_scene(scene, cam)
        R, t = T_all.R.numpy(), T_all.t.numpy()
        gt = {f: -R[f].T @ t[f] for f in range(n)}
    bf = BASELINE_M * intr[0] if stereo else 0.0
    slam = SlamSystem(SystemConfig(cam=cam, sensor=IMU_STEREO if stereo else IMU_MONOCULAR,
                                   feat_cap=N_FEATURES,
                                   extractor=ExtractorConfig(n_features=N_FEATURES),
                                   use_loop_closing=True, device=str(dev), bf=bf,
                                   min_depth=MIN_DEPTH))
    imu = slam.tracker.imu
    setup_s = time.perf_counter() - t0
    # the VI frame solve and the preintegration, by CUDA events; the last
    # call's arguments kept for the launch count
    timed = {"vi_solve": [], "preintegration": []}
    last_args = {}

    def evented(key, fn):
        def wrapper(*a, **kw):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            try:
                return fn(*a, **kw)
            finally:
                e1.record()
                timed[key].append((e0, e1))
                last_args[key] = (a, kw)
        return wrapper

    vi_refines = []  # keyframes the mapper's VI window BA ran on, the whole run
    vi_refine = slam.mapper._vi_refine

    def counted_vi_refine(k_, *a, **kw):
        vi_refines.append(k_)
        return vi_refine(k_, *a, **kw)

    slam.mapper._vi_refine = counted_vi_refine
    init_frame, poses = None, []
    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        plain_calls = _count_plain_calls(stack)
        stack.enter_context(mock.patch.object(tracker_mod, "vi_pose_optimization_marg", evented(
            "vi_solve", tracker_mod.vi_pose_optimization_marg)))
        stack.enter_context(mock.patch.object(imu_frontend, "integrate", evented(
            "preintegration", imu_frontend.integrate)))
        HAMMING_KERNEL.launches = matcher.MATCH_KERNEL.launches = 0
        prev = None
        for i in range(n):
            if i == n_warm:
                torch.cuda.synchronize()
                warm_counts = {key: len(v) for key, v in timed.items()}
                slam.timing.samples.clear()
                slam.mapper.stats.samples.clear()
                t_timed = time.perf_counter()
            ts = i / 20.0
            if course:
                T = slam.track_features(frames[i][0], ts, imu_samples=frames[i][2])
            elif stereo:
                T = slam.track_stereo(frames[i], right[i], ts,
                                      imu_samples=imu_between(its, igyro, iacc, prev, ts))
            else:
                T = slam.track_monocular_inertial(frames[i], ts,
                                                  imu_between(its, igyro, iacc, prev, ts))
            prev = ts
            poses.append(T)
            if init_frame is None and imu.initialized:
                init_frame = i
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t_timed
        launches = {"hamming_matrix": HAMMING_KERNEL.launches,
                    "mutual_best_match": matcher.MATCH_KERNEL.launches}
    # launches and device time of one VI solve and one frame's preintegration
    profiled = {}
    for key, fn in (("vi_solve", tracker_mod.vi_pose_optimization_marg),
                    ("preintegration", imu_frontend.integrate)):
        if key in last_args:
            a, kw = last_args[key]
            busy, n_k, wall, top = _profile(lambda: fn(*a, **kw))
            profiled[key] = {"device_busy_ms": busy, "kernel_launches": n_k, "wall_ms": wall,
                             "top_kernels_ms": top}
    slam.shutdown()
    n_timed = n - n_warm
    ms = {key: [e0.elapsed_time(e1) for e0, e1 in v[warm_counts[key]:]] for key, v in timed.items()}
    traj = [(f, T) for _, f, T in slam.tracker.absolute_trajectory()
            if init_frame is not None and f >= init_frame]

    def fit(frames_poses):
        if len(frames_poses) < 3:
            return float("inf"), 0.0
        return ate_rmse(np.array([np.linalg.inv(T)[:3, 3] for _, T in frames_poses]),
                        np.array([gt[f] for f, _ in frames_poses]))

    ate, s_post = fit(traj)
    # the gates' window: the timed frames, all after the IMU's first init
    # (and, monocular, after VIBA1 at 5 s), as tests/test_e2e_inertial.py
    # holds its gates on its last frames; before VIBA1 a monocular map keeps
    # the first init's scale, which the two-view draws set in both packages
    ate_timed, s = fit([(f, T) for f, T in traj if f >= n_warm])
    timing = {name: v for name, v in slam.timing.summary().items()}
    mapper_stages = slam.mapper.stats.summary()
    m = slam.map
    c = slam.closer
    vi_per_frame = len(ms["vi_solve"]) / n_timed
    result = {
        "phase": scene, "entry": "track_stereo(imu_samples=)" if stereo
        else "track_features(imu_samples=)" if course else "track_monocular_inertial",
        "frames": n, "warm_frames": n_warm,
        "timed_frames": n_timed, "size": list(intr[4:]), "n_features": N_FEATURES, "bf": bf,
        "loop_closing": True, "setup_s": setup_s, "timed_wall_s": wall_s,
        "frames_per_s": n_timed / wall_s,
        "tracked_timed": sum(T is not None for T in poses[n_warm:]),
        "tracked_total": sum(T is not None for T in poses),
        "keyframes": m.n_keyframes(), "map_points": m.n_points(), "maps_created": m.n_maps,
        "imu_initialized": bool(imu.initialized), "imu_stage": int(imu.stage),
        "init_frame": init_frame, "post_init_frames": len(traj),
        "post_init_ate_m": ate, "post_init_scale": float(s_post),
        "timed_ate_m": ate_timed, "timed_scale": float(s),
        "init_events": [{k_: e[k_] for k_ in ("kind", "stage", "scale", "ts", "applied", "t_solve")}
                        for e in imu.init_log],
        "init_events_applied": sum(e["applied"] and e["kind"] == "init" for e in imu.init_log),
        "imu_stage_reached": max([e["stage"] + 1 for e in imu.init_log
                                  if e["applied"] and e["kind"] == "init"], default=0),
        "ms_per_frame": {"extract": timing.get("extract", {}).get("mean_ms"),
                         "track": timing.get("track", {}).get("mean_ms"),
                         "vi_solve_device": float(np.sum(ms["vi_solve"])) / n_timed,
                         "preintegration_device": float(np.sum(ms["preintegration"])) / n_timed},
        "vi_solve_ms_p50": float(np.median(ms["vi_solve"])) if ms["vi_solve"] else None,
        "vi_solves_per_frame": vi_per_frame,
        "preintegration_ms_p50": (float(np.median(ms["preintegration"]))
                                  if ms["preintegration"] else None),
        "profiled": profiled,
        "vi_solve_launches_per_frame": (profiled["vi_solve"]["kernel_launches"] * vi_per_frame
                                        if "vi_solve" in profiled else None),
        "preintegration_launches_per_frame": profiled.get("preintegration", {}).get(
            "kernel_launches"),
        # the staged init's solves (host wall ms, the whole run) and the
        # mapper's VI window BA per keyframe (timed frames)
        "imu_stages": imu.stats.summary(),
        "vi_refine_ms_per_keyframe": mapper_stages.get("vi_refine", {}).get("mean_ms"),
        "vi_refine_keyframes": len(vi_refines),
        "mapper_stages": mapper_stages, "entry_stages": timing,
        "closer": {"queries": c.n_queries, "verifications": c.n_verifications,
                   "loops_closed": c.n_loops_closed, "merges": c.n_merges,
                   "gba_runs": c.n_gba_runs},
        "reloc_attempts": slam.reloc_attempts, "launches": launches, "plain_calls": plain_calls,
    }
    emit(result)
    ref = {"mono_inertial": REF_MONO_INERTIAL, "mono_inertial_image": REF_MONO_INERTIAL_IMAGE,
           "stereo_inertial": REF_STEREO_INERTIAL}[scene]
    emit({"phase": f"{scene}_against_reference", "reference": ref,
          "port": {k_: result[k_] for k_ in ("tracked_timed", "keyframes", "map_points",
                                             "imu_stage", "imu_stage_reached",
                                             "init_events_applied", "init_frame",
                                             "post_init_ate_m", "post_init_scale",
                                             "timed_ate_m", "timed_scale")}})
    failures = []
    # the slice's path ran: every frame preintegrated, the VI frame solve,
    # the staged init with its full VI BA, and the mapper's VI window BA
    ran = {"preintegration": len(timed["preintegration"]) >= n - 1,
           "vi_solve": len(timed["vi_solve"]) > 0,
           "init_solve": any(k_.startswith("init_solve") for k_ in result["imu_stages"]),
           "full_vi_ba": any(k_.startswith("full_vi_ba") for k_ in result["imu_stages"]),
           "vi_refine": len(vi_refines) > 0}
    if not all(ran.values()):
        failures.append(f"parts of the inertial path did not run: {ran}")
    if not result["init_events_applied"]:
        failures.append("the IMU never initialized")
    if result["imu_stage_reached"] < ref["imu_stage_reached"]:
        failures.append(f"the IMU reached stage {result['imu_stage_reached']} < the reference's "
                        f"{ref['imu_stage_reached']}")
    if gated and result["tracked_timed"] < ref["tracked_timed_min"]:
        failures.append(f"{result['tracked_timed']} timed frames tracked < the reference's "
                        f"{ref['tracked_timed_min']}")
    scale_gate = SCALE_GATE if stereo else MONO_SCALE_GATE
    if gated and not abs(s - 1.0) < scale_gate:
        failures.append(f"scale {s} over the timed frames: |s - 1| >= {scale_gate}")
    if gated and not ate_timed <= ref["timed_ate_gate_m"]:
        failures.append(f"ATE over the timed frames {ate_timed} m > {ref['timed_ate_gate_m']} "
                        f"(the reference's worst on these frames)")
    if any(plain_calls.values()):
        failures.append(f"plain versions called on the card: {plain_calls}")
    if launches["hamming_matrix"] == 0:
        failures.append("the matrix entry never launched on this path")
    if failures:
        raise SystemExit(f"{scene} failed: " + "; ".join(failures))
    return result


def phase_chunked_vi(dev, scene):
    """bench.py's main_vi (bench.py:205-300) on the port: SlamSystem(sensor=
    IMU_MONOCULAR (vi) or IMU_STEREO with the 0.11 m baseline (si))
    .make_chunked_frontend(chunk=8, lag=1) on the VI scene (VI_FRAMES),
    async mapper with the staged IMU init on its worker, loop closing on,
    160 warm-up frames, the mapper drained, then timed. frames/s, chunk ms,
    the frames each step ran (the VI chunk step from the IMU init on), init
    events and stage, the ATE and scale over the timed frames, the
    preintegration's and the VI solves' ms a VI chunk (CUDA events), one VI
    chunk's launches (torch.profiler) and each Hamming entry's launches.
    Gates (REF_VI / REF_SI, the reference's chunked runs on the same frames):
    every frame retired in order, no plain version called, the VI chunk
    step ran and launched the fused entry at least twice per frame it
    stepped, the stage reached, tracked timed frames and timed ATE no worse
    than the reference's worst run."""
    import contextlib

    from orb_slam3_modified_tpu_torch.cameras import Camera
    from orb_slam3_modified_tpu_torch.eval.ate import ate_rmse
    from orb_slam3_modified_tpu_torch.features import matcher
    from orb_slam3_modified_tpu_torch.features.extractor import ExtractorConfig
    from orb_slam3_modified_tpu_torch.ops.hamming import HAMMING_KERNEL
    from orb_slam3_modified_tpu_torch.system.slam_system import (
        IMU_MONOCULAR, IMU_STEREO, SlamSystem, SystemConfig,
    )
    from orb_slam3_modified_tpu_torch.tracking import chunked, vi_fused
    from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import imu_between

    stereo = scene == "si"
    n, n_warm = VI_FRAMES[scene]
    ref = REF_SI if stereo else REF_VI
    cam = Camera.pinhole(*VI_CAM[:4], width=VI_CAM[4], height=VI_CAM[5], device=dev)
    t0 = time.perf_counter()
    frames, right, T_all, (its, igyro, iacc) = _vi_scene(scene, cam)
    R, t = T_all.R.numpy(), T_all.t.numpy()
    gt = {f: -R[f].T @ t[f] for f in range(n)}
    bf = VI_BASELINE_M * VI_CAM[0] if stereo else 0.0
    slam = SlamSystem(SystemConfig(cam=cam, sensor=IMU_STEREO if stereo else IMU_MONOCULAR,
                                   feat_cap=N_FEATURES,
                                   extractor=ExtractorConfig(n_features=N_FEATURES),
                                   use_loop_closing=True, device=str(dev), bf=bf,
                                   min_depth=MIN_DEPTH))
    fe = slam.make_chunked_frontend(chunk=VI_CHUNK, lag=1, stereo=stereo)
    imu = slam.tracker.imu
    setup_s = time.perf_counter() - t0
    # each dispatch: host interval, frames, whether the VI chunk step ran it,
    # the fused entry's launches in it, and the CUDA events of its
    # preintegration and VI solves
    dispatches, events, last_vi_call = [], {"preintegration": [], "vi_solve": []}, {}
    dispatch = fe._dispatch_buffer

    def timed_dispatch():
        rec = {"frames": len(fe._buf), "vi": fe._vi, "launches0": matcher.MATCH_KERNEL.launches,
               "events": {"preintegration": [], "vi_solve": []}}
        events["current"] = rec["events"]
        rec["t0"] = time.perf_counter()
        dispatch()
        rec["t1"] = time.perf_counter()
        rec["fused"] = matcher.MATCH_KERNEL.launches - rec["launches0"]
        dispatches.append(rec)

    def evented(key, fn):
        def wrapper(*a, **kw):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            try:
                return fn(*a, **kw)
            finally:
                e1.record()
                events["current"][key].append((e0, e1))
        return wrapper

    fe._dispatch_buffer = timed_dispatch
    vi_step_cls = chunked.VIStereoChunkStep if stereo else chunked.VIChunkStep
    step_forward = vi_step_cls.forward

    def kept_forward(self, *a):
        last_vi_call["args"] = (self, a)
        return step_forward(self, *a)

    retired, init_frame, prev = [], None, None
    torch.cuda.synchronize()
    with contextlib.ExitStack() as stack:
        plain_calls = _count_plain_calls(stack)
        stack.enter_context(mock.patch.object(chunked, "integrate", evented(
            "preintegration", chunked.integrate)))
        stack.enter_context(mock.patch.object(vi_fused, "vi_pose_optimization_marg", evented(
            "vi_solve", vi_fused.vi_pose_optimization_marg)))
        stack.enter_context(mock.patch.object(vi_step_cls, "forward", kept_forward))
        HAMMING_KERNEL.launches = matcher.MATCH_KERNEL.launches = 0
        for i in range(n):
            if i == n_warm:
                slam.async_mapper.flush()  # as bench.py: the mapper drains before the timer
                torch.cuda.synchronize()
                n_warm_dispatch = len(dispatches)
                fe.stats.samples.clear()
                slam.mapper.stats.samples.clear()
                t_timed = time.perf_counter()
            ts = i / 20.0
            samples = imu_between(its, igyro, iacc, prev, ts)
            prev = ts
            retired += fe.track_image(frames[i], ts, img_right=right[i] if stereo else None,
                                      imu_samples=samples)
            if init_frame is None and imu.initialized:
                init_frame = i
        retired += fe.flush()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t_timed
        slam.async_mapper.flush()
        launches = {"hamming_matrix": HAMMING_KERNEL.launches,
                    "mutual_best_match": matcher.MATCH_KERNEL.launches}
    # launches and device time of one VI chunk (the last one dispatched)
    profiled = None
    if "args" in last_vi_call:
        step, a = last_vi_call["args"]
        busy, n_k, wall, top = _profile(lambda: step_forward(step, *a))
        profiled = {"frames": int(a[2].shape[0]), "device_busy_ms": busy,
                    "kernel_launches": n_k, "wall_ms": wall, "top_kernels_ms": top}
    fe_stats, map_stats = fe.stats.summary(), slam.mapper.stats.summary()
    slam.shutdown()
    fids = [r[0] for r in retired]
    traj = slam.tracker.absolute_trajectory()

    def fit(frames_poses):
        if len(frames_poses) < 3:
            return float("inf"), 0.0
        rmse, s_ = ate_rmse(np.array([np.linalg.inv(T)[:3, 3] for _, T in frames_poses]),
                            np.array([gt[f] for f, _ in frames_poses]))
        return rmse, float(s_)

    pairs = [(f, T) for _, f, T in traj]
    ate_timed, s_timed = fit([(f, T) for f, T in pairs if f >= n_warm])
    ate_post, s_post = fit([(f, T) for f, T in pairs
                            if init_frame is not None and f >= init_frame])
    timed = dispatches[n_warm_dispatch:]
    full = [d for d in timed if d["frames"] == VI_CHUNK]
    chunk_ms = [(d["t1"] - d["t0"]) * 1e3 for d in full]
    vi_disp = [d for d in dispatches if d["vi"]]
    vi_frames = sum(d["frames"] for d in vi_disp)
    vi_fused_launches = sum(d["fused"] for d in vi_disp)
    timed_vi = [d for d in timed if d["vi"]]

    def ms_per_chunk(key):
        per = [sum(e0.elapsed_time(e1) for e0, e1 in d["events"][key]) for d in timed_vi
               if d["frames"] == VI_CHUNK]
        return {"chunks": len(per), "ms_per_chunk_p50": float(np.median(per)) if per else None,
                "ms_per_chunk_mean": float(np.mean(per)) if per else None,
                "calls_per_chunk": (float(np.mean([len(d["events"][key]) for d in timed_vi]))
                                    if timed_vi else None)}

    pct = lambda xs, q: float(np.percentile(xs, q)) if xs else None  # noqa: E731
    m = slam.map
    c = slam.closer
    applied = [e for e in imu.init_log if e["applied"] and e["kind"] == "init"]
    n_timed = n - n_warm
    result = {
        "phase": scene, "entry": "make_chunked_frontend(chunk=8, lag=1).track_image(imu_samples=)",
        "sensor": "IMU_STEREO" if stereo else "IMU_MONOCULAR", "frames": n, "warm_frames": n_warm,
        "timed_frames": n_timed, "size": list(VI_CAM[4:]), "n_features": N_FEATURES, "bf": bf,
        "chunk": VI_CHUNK, "lag": 1, "async_mapping": True, "loop_closing": True,
        "setup_s": setup_s, "timed_wall_s": wall_s, "frames_per_s": n_timed / wall_s,
        "chunk_ms_p50": pct(chunk_ms, 50), "chunk_ms_p90": pct(chunk_ms, 90),
        "chunks_timed": len(chunk_ms), "chunk_ms": chunk_ms,
        "retired_in_order": fids == list(range(n)), "retired": len(fids),
        "tracked_timed": sum(r[2] is not None for r in retired if r[0] >= n_warm),
        "tracked_total": sum(r[2] is not None for r in retired),
        "untracked_frames": [r[0] for r in retired if r[2] is None],
        "slow_path_frames_timed": fe_stats.get("slow_path", {}).get("count", 0),
        "timed_frames_chunk_stepped": sum(d["frames"] for d in timed),
        "vi_chunk_stepped_frames": vi_frames,
        "vi_chunk_stepped_timed": sum(d["frames"] for d in timed_vi),
        "visual_chunk_stepped_frames": sum(d["frames"] for d in dispatches) - vi_frames,
        "fused_launches_per_vi_frame": vi_fused_launches / max(vi_frames, 1),
        "keyframes": m.n_keyframes(), "map_points": m.n_points(), "maps_created": m.n_maps,
        "imu_initialized": bool(imu.initialized), "imu_stage": int(imu.stage),
        "imu_stage_reached": max([e["stage"] + 1 for e in applied], default=0),
        "init_frame": init_frame,
        "init_events": [{k_: e[k_] for k_ in ("kind", "stage", "scale", "ts", "applied", "t_solve")}
                        for e in imu.init_log],
        "timed_ate_m": ate_timed, "timed_scale": s_timed,
        "post_init_ate_m": ate_post, "post_init_scale": s_post,
        "preintegration_device": ms_per_chunk("preintegration"),
        "vi_solve_device": ms_per_chunk("vi_solve"),
        "profiled_vi_chunk": profiled,
        "vi_chunk_launches_per_frame": (profiled["kernel_launches"] / profiled["frames"]
                                        if profiled else None),
        "imu_stages": imu.stats.summary(),
        "closer": {"queries": c.n_queries, "verifications": c.n_verifications,
                   "loops_closed": c.n_loops_closed, "merges": c.n_merges,
                   "gba_runs": c.n_gba_runs},
        "reloc_attempts": slam.reloc_attempts, "launches": launches, "plain_calls": plain_calls,
        "mapper_errors": slam.async_mapper.errors,
        "frontend_stages": fe_stats, "mapper_stages": map_stats,
    }
    emit(result)
    emit({"phase": f"{scene}_against_reference", "reference": ref,
          "port": {k_: result[k_] for k_ in ("tracked_timed", "vi_chunk_stepped_frames",
                                             "keyframes", "map_points", "imu_stage_reached",
                                             "init_frame", "timed_ate_m", "timed_scale")}})
    failures = []
    if fids != list(range(n)):
        failures.append(f"frames not retired in order: {len(fids)} of {n}")
    if any(plain_calls.values()):
        failures.append(f"plain versions called on the card: {plain_calls}")
    if vi_frames == 0:
        failures.append("no frame was stepped by the VI chunk step")
    elif result["fused_launches_per_vi_frame"] < 2:
        failures.append(f"the fused entry launched {vi_fused_launches} times for {vi_frames} "
                        f"VI frames")
    if result["imu_stage_reached"] < ref["imu_stage_reached_min"]:
        failures.append(f"the IMU reached stage {result['imu_stage_reached']} < the reference's "
                        f"{ref['imu_stage_reached_min']}")
    if result["tracked_timed"] < ref["tracked_timed_min"]:
        failures.append(f"{result['tracked_timed']} timed frames tracked < the reference's "
                        f"{ref['tracked_timed_min']}")
    if not ate_timed <= ref["timed_ate_gate_m"]:
        failures.append(f"ATE over the timed frames {ate_timed} m > {ref['timed_ate_gate_m']} "
                        f"(the reference's worst on these frames)")
    if failures:
        raise SystemExit(f"{scene} failed: " + "; ".join(failures))
    return result


# the cli phase: the port's runner on the headline frames written as a
# EuRoC folder (io/png.py), its first 96 frames; a resume from the atlas it
# writes runs on the next 16
N_CLI_FRAMES = 96
N_CLI_RESUME = 16
DEPTH_NET_RTOL = 1e-4  # the depth net on the card against the CPU, relative
DEPTH_NET_TIE = 1e-3  # class maps compared where the CPU's two logits are further apart


def _write_cli_sequence(root, frames, first, cam, cfg_path):
    """frames as a EuRoC folder (frame i at i / 20 s, nanosecond stamps)
    and, with cfg_path, a settings file in the reference's dotted keys:
    the camera, no distortion, N_FEATURES features over 8 levels. Returns
    the stamps in seconds as the reader computes them."""
    from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import write_euroc_images

    t_ns = [int(round((first + i) / 20.0 * 1e9)) for i in range(len(frames))]
    write_euroc_images(f"{root}/mav0/cam0", t_ns, frames)
    if cfg_path:
        fx, fy, cx, cy = (float(x) for x in cam.params[:4])
        with open(cfg_path, "w") as f:
            f.write("%YAML:1.0\n---\n" + "".join(
                f"{k}: {v!r}\n" for k, v in (
                    ("Camera.type", "PinHole"), ("Camera.fx", fx), ("Camera.fy", fy),
                    ("Camera.cx", cx), ("Camera.cy", cy), ("Camera.width", cam.width),
                    ("Camera.height", cam.height), ("Camera.fps", 20.0), ("Camera.RGB", 1),
                    ("ORBextractor.nFeatures", N_FEATURES), ("ORBextractor.nLevels", 8))))
    return [t * 1e-9 for t in t_ns]


def _same_map(a, b):
    """Field names of the two MapStates that differ (arrays bit for bit)."""
    import dataclasses

    out = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            if x.dtype != y.dtype or not np.array_equal(x, y):
                out.append(f.name)
        elif f.name in ("active_map", "n_maps", "n_inertial_ba", "imu_initialized", "next_kf"):
            if x != y:
                out.append(f.name)
        elif f.name == "loop_edges" and [tuple(e) for e in x] != [tuple(e) for e in y]:
            out.append(f.name)
    return out


def _depth_net_check(dev, image):
    """The shipped depth net (models/depth.py) on one frame, card against
    CPU, and its ms a frame on the card (one upload, the net and both
    resizes, CUDA events)."""
    from orb_slam3_modified_tpu_torch.models import depth

    net_d, meta = depth.default_depth_model(device=dev)
    net_c, _ = depth.default_depth_model(device="cpu")
    hw = tuple(int(x) for x in meta["train_res"].split("x"))
    img = np.asarray(image, np.float32)
    d_dev, d_cpu = (depth.make_depth_fn(n, hw)(img) for n in (net_d, net_c))
    s_dev, s_cpu = (depth.make_seg_fn(n, hw)(img) for n in (net_d, net_c))
    logits = depth._run_at_train_res(net_c, img, hw)[1].numpy()
    clear = np.abs(logits[1] - logits[0]) > DEPTH_NET_TIE
    rel = float(np.max(np.abs(d_dev - d_cpu) / d_cpu))
    t0 = time.perf_counter()
    for _ in range(10):
        depth.make_depth_fn(net_d, hw)(img)
        depth.make_seg_fn(net_d, hw)(img)
    host_ms = (time.perf_counter() - t0) / 10 * 1e3
    return {"shape": list(img.shape), "train_res": list(hw), "depth_max_rel_err": rel,
            "depth_rtol": DEPTH_NET_RTOL, "seg_equal_off_ties": bool(np.array_equal(
                s_dev[clear], s_cpu[clear])), "seg_ties": int((~clear).sum()),
            "ms_per_frame": cuda_ms(lambda: depth._run_at_train_res(net_d, img, hw), iters=20),
            "depth_and_seg_fns_host_ms_per_frame": host_ms}


def phase_cli(dev):
    """The port's runner, as its users call it (see the module docstring):
    run.main on the headline frames written as a EuRoC folder, against the
    same frames fed from memory through SlamSystem.make_chunked_frontend."""
    import contextlib
    import io
    import tempfile

    from orb_slam3_modified_tpu_torch import run
    from orb_slam3_modified_tpu_torch.cameras import Camera
    from orb_slam3_modified_tpu_torch.eval import __main__ as eval_main
    from orb_slam3_modified_tpu_torch.features import matcher
    from orb_slam3_modified_tpu_torch.features.extractor import ExtractorConfig
    from orb_slam3_modified_tpu_torch.io import datasets, png
    from orb_slam3_modified_tpu_torch.ops.hamming import HAMMING_KERNEL
    from orb_slam3_modified_tpu_torch.slam_map.serialization import load_atlas
    from orb_slam3_modified_tpu_torch.system.slam_system import (
        MONOCULAR, SlamSystem, SystemConfig,
    )
    from orb_slam3_modified_tpu_torch.tracking.chunked import ChunkedTracker

    k = FRAME_W / 752
    cam = Camera.pinhole(458.654 * k, 457.296 * k, 367.215 * k, 248.375 * k,
                         width=FRAME_W, height=FRAME_H, device=dev)
    T_all, all_frames = _headline(cam)
    n, n2 = N_CLI_FRAMES, N_CLI_RESUME
    frames, more = all_frames[:n], all_frames[n:n + n2]
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cfg = f"{tmp}/cli.yaml"
        ts = _write_cli_sequence(f"{tmp}/seq", frames, 0, cam, cfg)
        _write_cli_sequence(f"{tmp}/more", more, n, cam, None)
        write_s = time.perf_counter() - t0
        read_back = [fr.image for fr in datasets.EurocDataset(f"{tmp}/seq")]
        # io/png.py reads them too, whichever decoder the readers chose
        t0 = time.perf_counter()
        by_png = [png.read_png_gray(f) for f in datasets.EurocDataset(f"{tmp}/seq").files]
        png_ms = (time.perf_counter() - t0) / n * 1e3
        frames_equal = len(read_back) == n and all(
            np.array_equal(a, b.astype(np.float32)) and np.array_equal(c, b)
            for a, b, c in zip(read_back, frames, by_png))
        if not frames_equal:
            failures.append("the frames read back differ from the rendered frames")
        out = {x: f"{tmp}/{x}" for x in ("traj.txt", "kf.txt", "atlas", "cloud.ply",
                                         "resumed.txt", "gt.txt")}
        argv = ["--dataset", "euroc", "--path", f"{tmp}/seq", "--config", cfg, "--sensor",
                "mono", "--chunked", "--chunk-size", str(CHUNK), "--device", str(dev), "--out",
                out["traj.txt"], "--kf-out", out["kf.txt"], "--atlas-out", out["atlas"],
                "--semantic-out", out["cloud.ply"]]
        stepped = [0]
        dispatch = ChunkedTracker._dispatch_buffer

        def counted_dispatch(self):
            stepped[0] += len(self._buf)
            return dispatch(self)

        printed = io.StringIO()
        with contextlib.ExitStack() as stack:
            plain_calls = _count_plain_calls(stack)
            stack.enter_context(mock.patch.object(ChunkedTracker, "_dispatch_buffer",
                                                  counted_dispatch))
            stack.enter_context(contextlib.redirect_stdout(printed))
            torch.cuda.synchronize()
            HAMMING_KERNEL.launches = matcher.MATCH_KERNEL.launches = 0
            res = run.main(argv)
            launches = {"hamming_matrix": HAMMING_KERNEL.launches,
                        "mutual_best_match": matcher.MATCH_KERNEL.launches}
        upload_s = sum(res.frontend.stats.samples.get("upload", []))
        slam = res.slam

        # the same frames from memory through the frontend the runner drives
        mem = SlamSystem(SystemConfig(cam=cam, sensor=MONOCULAR, feat_cap=N_FEATURES,
                                      extractor=ExtractorConfig(n_features=N_FEATURES),
                                      use_loop_closing=True, device=str(dev)))
        fe = mem.make_chunked_frontend(chunk=CHUNK, lag=1)
        t0 = time.perf_counter()
        retired = []
        for i in range(n):
            retired += fe.track_image(frames[i], ts[i])
        retired += fe.flush()
        mem.shutdown()
        mem_s = time.perf_counter() - t0
        mem.save_trajectory_tum(f"{tmp}/mem.txt")
        with open(out["traj.txt"], "rb") as f, open(f"{tmp}/mem.txt", "rb") as g:
            same_traj = f.read() == g.read()
        same_abs = [(a[0], a[1]) for a in slam.tracker.absolute_trajectory()] == [
            (a[0], a[1]) for a in mem.tracker.absolute_trajectory()] and all(
            np.array_equal(a[2], b[2]) for a, b in zip(slam.tracker.absolute_trajectory(),
                                                       mem.tracker.absolute_trajectory()))
        map_diff = _same_map(slam.map, mem.map)
        if not (same_traj and same_abs and not map_diff and res.retired == [r[0] for r in
                                                                            retired]):
            failures.append(f"the runner's trajectory or map differ from the in-memory "
                            f"frontend's: file {same_traj}, poses {same_abs}, map {map_diff}")

        # the trajectory file against the ground truth through eval's main
        traj = np.loadtxt(out["traj.txt"], ndmin=2)
        R, t = T_all.R.numpy(), T_all.t.numpy()
        with open(out["gt.txt"], "w") as f:
            for i in range(n):
                c = -R[i].T @ t[i]
                f.write(f"{ts[i]:.6f} {c[0]:.7f} {c[1]:.7f} {c[2]:.7f} 0 0 0 1\n")
        with contextlib.redirect_stdout(printed):
            ate = eval_main.main([out["gt.txt"], out["traj.txt"]])
        # a monocular trajectory starts at the two-view initialization, as
        # the reference's (SaveTrajectoryTUM skips the frames before it)
        missing = sorted(set(range(n)) - {int(round(x * 20.0)) for x in traj[:, 0]})
        if missing != list(range(len(missing))) or len(traj) != n - len(missing):
            failures.append(f"frames missing from the trajectory file after the "
                            f"initialization: {missing}")
        if not ate < ATE_GATE_M:
            failures.append(f"ATE {ate} m >= {ATE_GATE_M}")
        if launches["hamming_matrix"] == 0:
            failures.append("the matrix entry never launched on the runner's path")
        if launches["mutual_best_match"] < 2 * stepped[0]:
            failures.append(f"the fused entry launched fewer than 2 times per chunk-stepped "
                            f"frame: {launches['mutual_best_match']} for {stepped[0]}")
        if any(plain_calls.values()):
            failures.append(f"plain versions called on the card: {plain_calls}")

        # the atlas the runner wrote, and a resume from it on the next frames
        atlas_diff = _same_map(load_atlas(out["atlas"]), slam.map)
        if atlas_diff:
            failures.append(f"the atlas loads back different: {atlas_diff}")
        with contextlib.redirect_stdout(printed):
            resumed = run.main(["--dataset", "euroc", "--path", f"{tmp}/more", "--config", cfg,
                                "--sensor", "mono", "--chunked", "--chunk-size", str(CHUNK),
                                "--device", str(dev), "--out", out["resumed.txt"],
                                "--atlas-in", out["atlas"]])
        r = resumed.slam
        holders = all(h is r.map for h in (r.tracker.map, r.mapper.map, r.closer.map,
                                            r.async_mapper.mapper.map,
                                            resumed.frontend.tracker.map))
        if resumed.retired != list(range(n2)) or not holders:
            failures.append(f"the resume retired {resumed.retired} (holders bound: {holders})")
        with open(out["cloud.ply"]) as f:
            cloud_points = int([next(f) for _ in range(3)][2].split()[-1])
    net = _depth_net_check(dev, frames[0])
    if not net["depth_max_rel_err"] <= DEPTH_NET_RTOL or not net["seg_equal_off_ties"]:
        failures.append(f"the depth net on the card differs from the CPU: {net}")
    if cloud_points == 0:
        failures.append("the semantic cloud is empty")
    result = {
        "phase": "cli", "frames": n, "size": [FRAME_W, FRAME_H], "n_features": N_FEATURES,
        "chunk": CHUNK, "lag": 1, "async_mapping": True, "loop_closing": True,
        "png_decoder": datasets.PNG_DECODER, "frames_read_back_equal": frames_equal,
        "png_module_decode_ms_per_frame": png_ms,
        "write_sequence_s": write_s, "runner_s": res.seconds, "runner_frames_per_s":
        n / res.seconds, "in_memory_frames_per_s": n / mem_s,
        "decode_ms_per_frame": res.read_seconds / n * 1e3,
        "upload_ms_per_frame": upload_s / n * 1e3,
        "io_ms_per_frame": (res.read_seconds + upload_s) / n * 1e3,
        "retired_in_order": res.retired == list(range(n)), "tracked": len(traj),
        "untracked_before_init": missing,
        "keyframes": slam.map.n_keyframes(), "map_points": slam.map.n_points(),
        "ate_m": ate, "trajectory_equal_in_memory": same_traj, "poses_equal_in_memory": same_abs,
        "map_fields_differing_from_in_memory": map_diff, "atlas_fields_differing": atlas_diff,
        "resume": {"frames": resumed.n_frames, "retired_in_order": resumed.retired == list(
            range(n2)), "holders_bound": holders, "maps": r.map.n_maps,
            "keyframes_all_maps": r.map.n_keyframes(all_maps=True)},
        "semantic_cloud_points": cloud_points, "depth_net": net,
        "chunk_stepped_frames": stepped[0], "launches": launches,
        "launches_per_chunk_stepped_frame": {k_: v / max(stepped[0], 1)
                                             for k_, v in launches.items()},
        "plain_calls": plain_calls, "frontend_stages": res.frontend.stats.summary(),
    }
    emit(result)
    if failures:
        raise SystemExit("cli failed: " + "; ".join(failures))
    return result


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a GPU",
              file=sys.stderr)
        return 2
    import orb_slam3_modified_tpu_torch  # noqa: F401  (TF32 off)

    dev = torch.device("cuda", 0)
    seconds = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    t_start = time.perf_counter()
    device = timed("device", phase_device)
    timed("build", phase_build)
    hamming, match, kernel_launches = timed("kernel", phase_kernel, dev)
    slice_result, ctx = timed("slice", phase_slice, dev)
    timed("breakdown", phase_breakdown, dev, ctx)
    system = timed("system", phase_system, dev)
    loop = timed("loop", phase_loop, dev)
    stereo = timed("stereo", phase_depth, dev, "stereo")
    rgbd = timed("rgbd", phase_depth, dev, "rgbd")
    mono_inertial = timed("mono_inertial", phase_inertial, dev, "mono_inertial")
    mono_inertial_image = timed("mono_inertial_image", phase_inertial, dev, "mono_inertial_image")
    stereo_inertial = timed("stereo_inertial", phase_inertial, dev, "stereo_inertial")
    vi = timed("vi", phase_chunked_vi, dev, "vi")
    si = timed("si", phase_chunked_vi, dev, "si")
    cli = timed("cli", phase_cli, dev)
    # host seconds of each phase (scene renders included) and of the script
    emit({"phase": "seconds", **seconds, "total": time.perf_counter() - t_start})
    source = "orb_slam3_modified_tpu_torch/csrc/hamming.cu"
    replaces = "orb_slam3_modified_tpu/ops/pallas_kernels.py:31"
    hot_h, hot_m = hamming[(4096, 1024)], match[(4096, 1024, True)]
    emit({"kernels": [
        {
            "name": "hamming_matrix", "route": "cuda", "source": source, "replaces": replaces,
            # the system phase's searches (initialization, projection, the mapper)
            # launch it; the chunk step does not (the slice checks 0 there);
            # kernel_phase_calls counts the kernel phase's checks, warm-ups,
            # captures and profiled calls
            "launches": system["launches"]["hamming_matrix"], "on_main_path": True,
            "launches_by_path": {"slice": slice_result["launches"]["hamming_matrix"],
                                 "system": system["launches"]["hamming_matrix"],
                                 "loop": loop["launches"]["hamming_matrix"],
                                 "stereo": stereo["launches"]["hamming_matrix"],
                                 "rgbd": rgbd["launches"]["hamming_matrix"],
                                 "mono_inertial": mono_inertial["launches"]["hamming_matrix"],
                                 "mono_inertial_image":
                                     mono_inertial_image["launches"]["hamming_matrix"],
                                 "stereo_inertial":
                                     stereo_inertial["launches"]["hamming_matrix"],
                                 "vi": vi["launches"]["hamming_matrix"],
                                 "si": si["launches"]["hamming_matrix"],
                                 "cli": cli["launches"]["hamming_matrix"]},
            "stereo_match_launches": stereo["stereo_match_launches"]["hamming_matrix"],
            "loop_by_stage": {stage: v["hamming_matrix"]
                              for stage, v in loop["launches_by_stage"].items()},
            "kernel_phase_calls": kernel_launches["hamming_matrix"],
            "max_abs_err": max(r["max_abs_err"] for r in hamming.values()),
            "ms": hot_h["kernel_ms"], "plain_ms": hot_h["plain_ms"],
            "bound_ms": hot_h["bound_ms"], "bound_by": hot_h["bound_by"],
            "library_ms": hot_h["library_ms"], "held_against_plain": True,
        },
        {
            "name": "mutual_best_match", "route": "cuda", "source": source, "replaces": replaces,
            "launches": system["launches"]["mutual_best_match"], "on_main_path": True,
            "launches_by_path": {"slice": slice_result["launches"]["mutual_best_match"],
                                 "system": system["launches"]["mutual_best_match"],
                                 "loop": loop["launches"]["mutual_best_match"],
                                 "stereo": stereo["launches"]["mutual_best_match"],
                                 "rgbd": rgbd["launches"]["mutual_best_match"],
                                 "mono_inertial": mono_inertial["launches"]["mutual_best_match"],
                                 "mono_inertial_image":
                                     mono_inertial_image["launches"]["mutual_best_match"],
                                 "stereo_inertial":
                                     stereo_inertial["launches"]["mutual_best_match"],
                                 "vi": vi["launches"]["mutual_best_match"],
                                 "si": si["launches"]["mutual_best_match"],
                                 "cli": cli["launches"]["mutual_best_match"]},
            "loop_by_stage": {stage: v["mutual_best_match"]
                              for stage, v in loop["launches_by_stage"].items()},
            "kernel_phase_calls": kernel_launches["mutual_best_match"],
            "max_abs_err": max(r["max_abs_err"] for r in match.values()),
            "ms": hot_m["kernel_ms"], "plain_ms": hot_m["plain_ms"],
            "bound_ms": hot_m["bound_ms"], "bound_by": hot_m["bound_by"],
            "library_ms": None, "old_path_ms": hot_m["old_path_ms"],
            "unwindowed_ms": match[(4096, 1024, False)]["kernel_ms"],
            "held_against_plain": True,
        },
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": device["name"], "count": device["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
