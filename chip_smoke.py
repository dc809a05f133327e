#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (orb_slam3_modified_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each ({"phase": ...}); any failure exits non-zero
before the last line:
  device     card name and count, and nvidia-smi's name and power limit
             (also printed raw on a line of its own);
  build      nvcc for the kernel in csrc/: command, seconds, and ptxas'
             registers / shared memory / spills;
  kernel     each hand-written kernel against its plain torch version on the
             card at the main path's shapes (bit-exact), with kernel, plain
             and one-library-call device times and the card's bound. Each
             time is CUDA events around one replay of a CUDA graph holding
             many calls, so the host's cost per call is not in it; the
             profiler's kernel durations are printed beside it as a check;
  slice      the main path: the monocular chunk step at bench width (752x480
             uint8 frames, 1024 ORB features over 8 levels, a 4096-point map
             cache, rounds=3 iters=6), one warm-up and 4 timed 16-frame
             chunks. Fails unless every frame is ok within 0.05 m of ground
             truth and every kernel of the path launched. Also checks that a
             chunk run with the plain Hamming gives identical poses, and
             times the branch-free recovery form (the one CUDA graph capture
             takes) beside the step's host-read gate;
  breakdown  CUDA-event times of the slice's stages, and the device busy
             time of one track step and of one extraction (torch.profiler);
then one line {"kernels": [...]} and, last, {"ok": true, "device": {...}}.

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

# H100 SXM: HBM3 3.35 TB/s (data sheet). 32-bit POPC issues at 16 per SM per
# clock on compute capability 9.0 (CUDA C++ Programming Guide, arithmetic
# instruction throughput), 132 SMs at the 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
POPC_PER_S = 132 * 16 * 1.98e9

SEED = 0
FRAME_W, FRAME_H = 752, 480  # bench.py's headline scene
N_FEATURES = 1024
CACHE_CAP = 4096
CHUNK = 16
N_TIMED = 4
TRANS_GATE_M = 0.05


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
    """Device milliseconds per call, summed over the kernels that
    torch.profiler records in `calls` eager calls; also their names."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    names = sorted({e.name[:60] for e in kernels})
    return sum(e.device_time for e in kernels) / 1e3 / calls, names


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


def phase_build():
    from orb_slam3_modified_tpu_torch.ops.hamming import HAMMING_KERNEL

    t0 = time.perf_counter()
    info = HAMMING_KERNEL.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {HAMMING_KERNEL.source.name: info}})


def _random_desc(rng, n, dev):
    bits = rng.integers(0, 2**32, (n, 8), dtype=np.uint32).view(np.int32)
    return torch.tensor(bits, device=dev)


def _unpack_pm1(desc):
    """(N, 8) int32 -> (N, 256) bf16 of +-1 (bit set -> -1)."""
    shifts = torch.arange(32, device=desc.device, dtype=torch.int32)
    bits = (desc[..., None] >> shifts) & 1
    return (1 - 2 * bits.reshape(desc.shape[0], -1)).to(torch.bfloat16)


def hamming_bound_ms(n1, n2):
    bytes_moved = (n1 + n2) * 32 + n1 * n2 * 4
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = n1 * n2 * 8 / POPC_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernel(dev):
    from orb_slam3_modified_tpu_torch.ops.hamming import hamming_matrix, hamming_matrix_plain

    rng = np.random.default_rng(SEED)
    rows = {}
    for n1, n2 in [(4096, 1024), (1024, 1024), (1000, 333)]:
        a, b = _random_desc(rng, n1, dev), _random_desc(rng, n2, dev)
        out = hamming_matrix(a, b)
        ref = hamming_matrix_plain(a, b)
        torch.cuda.synchronize()
        err = int((out - ref).abs().max())
        pa, pb = _unpack_pm1(a), _unpack_pm1(b)
        lib = torch.matmul(pa, pb.T)  # exact: +-1 products, |sum| <= 256
        lib_err = int(((256 - lib.float()) / 2 - out.float()).abs().max())
        bound, by = hamming_bound_ms(n1, n2)
        kernel_ms = graph_ms(lambda: hamming_matrix(a, b), 200)
        library_ms = graph_ms(lambda: torch.matmul(pa, pb.T), 200)
        kernel_prof_ms, kernel_names = profiled_ms(lambda: hamming_matrix(a, b), 50)
        library_prof_ms, library_names = profiled_ms(lambda: torch.matmul(pa, pb.T), 50)
        row = {
            "shape": [n1, n2], "max_abs_err": err, "library_max_abs_err": lib_err,
            "kernel_ms": kernel_ms,
            "plain_ms": graph_ms(lambda: hamming_matrix_plain(a, b), 10),
            "library_ms": library_ms,
            "bound_ms": bound, "bound_by": by,
            "kernel_share_of_bound": bound / kernel_ms,
            "kernel_over_library": kernel_ms / library_ms,
            "kernel_ms_per_mpair": kernel_ms / (n1 * n2 / 1e6),
            "library_ms_per_mpair": library_ms / (n1 * n2 / 1e6),
            "kernel_profiler_ms": kernel_prof_ms, "kernel_profiler_names": kernel_names,
            "library_profiler_ms": library_prof_ms, "library_profiler_names": library_names,
        }
        emit({"phase": "kernel", "name": "hamming_matrix", **row})
        if err != 0 or lib_err != 0:
            raise SystemExit(f"hamming_matrix disagrees at {(n1, n2)}: {err} / {lib_err}")
        rows[(n1, n2)] = row
    return rows


def _scene(dev):
    from orb_slam3_modified_tpu_torch.cameras import Camera
    from orb_slam3_modified_tpu_torch.features.extractor import ExtractorConfig, ORBExtractor
    from orb_slam3_modified_tpu_torch.lie.se3 import SE3
    from orb_slam3_modified_tpu_torch.utils.synthetic import orbit_trajectory
    from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import (
        make_texture, render_sequence, seed_map_cache,
    )

    k = FRAME_W / 752  # bench.py's intrinsics, scaled with the frame width
    cam = Camera.pinhole(458.654 * k, 457.296 * k, 367.215 * k, 248.375 * k,
                         width=FRAME_W, height=FRAME_H, device=dev)
    ecfg = ExtractorConfig(n_features=N_FEATURES)
    n_frames = 2 + CHUNK * (1 + N_TIMED)
    T_all = orbit_trajectory(400, radius=4.0, sweep=np.pi / 2)
    T_seq = SE3(T_all.R[:n_frames], T_all.t[:n_frames])
    frames = render_sequence(cam, T_seq, make_texture(SEED, 96, 1024), plane_z=2.0, plane_half=10.0)
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


def phase_slice(dev):
    from orb_slam3_modified_tpu_torch.features import matcher
    from orb_slam3_modified_tpu_torch.ops.hamming import HAMMING_KERNEL, hamming_matrix_plain
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
    HAMMING_KERNEL.launches = 0
    # main path: one warm-up chunk, then the timed chunks
    state_w, outs_w, _ = _run_chunks(step, state0, cache, chunks[:1])
    t_wall = time.perf_counter()
    state_t, outs_t, chunk_ms = _run_chunks(step, state_w, cache, chunks[1:])
    wall_s = time.perf_counter() - t_wall
    launches = {"hamming_matrix": HAMMING_KERNEL.launches}
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

    # the same first timed chunk through the plain Hamming: identical poses
    with mock.patch.object(matcher, "hamming_matrix", hamming_matrix_plain):
        _, outs_p, plain_chunk_ms = _run_chunks(step, state_w, cache, chunks[1:2])
    plain_same = bool(torch.equal(outs_p[0].R, outs_t[0].R) and torch.equal(outs_p[0].t, outs_t[0].t))
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
        "plain_hamming_chunk_ms": plain_chunk_ms[0], "plain_hamming_same_poses": plain_same,
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
    if any(v == 0 for v in launches.values()):
        failures.append(f"a kernel of the path never launched: {launches}")
    if not plain_same:
        failures.append("plain-Hamming chunk gave different poses")
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
    main path's shapes; then a profiler pass over one track step."""
    from orb_slam3_modified_tpu_torch.cameras import project
    from orb_slam3_modified_tpu_torch.features.extractor import EDGE, ORBExtractor
    from orb_slam3_modified_tpu_torch.features.matcher import TH_HIGH, mutual_best_match
    from orb_slam3_modified_tpu_torch.lie.se3 import SE3
    from orb_slam3_modified_tpu_torch.ops.brief import GATHER_R, brief_from_patches
    from orb_slam3_modified_tpu_torch.ops.fast import border_mask, fast_score_maps, nonmax_3x3
    from orb_slam3_modified_tpu_torch.ops.image import gaussian_blur, resize
    from orb_slam3_modified_tpu_torch.ops.orientation import (
        ic_angles_from_patches, patches_from_padded,
    )
    from orb_slam3_modified_tpu_torch.ops.select import cell_topk, global_topk
    from orb_slam3_modified_tpu_torch.optim.pose_opt import pose_optimization
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
    spatial = ((uv[:, None, :] - f[0][None]) ** 2).sum(-1) < (15.0 * torch.pow(1.2, f[3].float())) ** 2
    idx, okm, _ = mutual_best_match(cache.desc, cache.valid, f[1], f[5], TH_HIGH, 0.9, spatial)
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
        "windowed_match_ms": cuda_ms(
            lambda: mutual_best_match(cache.desc, cache.valid, f[1], f[5], TH_HIGH, 0.9, spatial),
            iters=20),
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
    busy, n_kernels, wall, top = _profile(lambda: ex(imgs))
    times.update({
        "extract_chunk_profiled_wall_ms": wall, "extract_chunk_device_busy_ms": busy,
        "extract_chunk_device_idle_share": 1.0 - busy / times["extract_chunk_ms"],
        "extract_chunk_kernel_launches": n_kernels, "extract_chunk_top_kernels_ms": top,
    })
    emit({"phase": "breakdown", **times})
    return times


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a GPU",
              file=sys.stderr)
        return 2
    import orb_slam3_modified_tpu_torch  # noqa: F401  (TF32 off)

    dev = torch.device("cuda", 0)
    device = phase_device()
    phase_build()
    kernel_rows = phase_kernel(dev)
    slice_result, ctx = phase_slice(dev)
    phase_breakdown(dev, ctx)
    hot = kernel_rows[(4096, 1024)]
    emit({"kernels": [{
        "name": "hamming_matrix",
        "route": "cuda",
        "source": "orb_slam3_modified_tpu_torch/csrc/hamming.cu",
        "replaces": "orb_slam3_modified_tpu/ops/pallas_kernels.py:31",
        "launches": slice_result["launches"]["hamming_matrix"],
        "max_abs_err": max(r["max_abs_err"] for r in kernel_rows.values()),
        "ms": hot["kernel_ms"],
        "plain_ms": hot["plain_ms"],
        "bound_ms": hot["bound_ms"],
        "bound_by": hot["bound_by"],
        "library_ms": hot["library_ms"],
        "held_against_plain": True,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": device["name"], "count": device["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
