"""Dataset runner CLI: the counterpart of the reference's Examples/ mains.

Port of orb_slam3_modified_tpu/run.py (:20-343), after
Examples/Monocular/mono_euroc.cc, Examples/Stereo/stereo_euroc.cc,
Examples/RGB-D/rgbd_tum.cc and their inertial siblings:

  python -m orb_slam3_modified_tpu_torch.run --dataset euroc --path /data/MH01 \\
      --config configs/euroc_mono.yaml --sensor mono --out traj.txt [--device cuda]

The JAX runner's flags plus --device (default cuda: without a card it
raises; pass --device cpu for the CPU). Frames are read and decoded on the
host (io/datasets.py) and uploaded by the system's entry points; a
rectified stereo pair is remapped on the device (cameras/rectify.py).
Where the port differs from the JAX runner:
- --atlas-in rebinds every holder of the map (the tracker, the mapper, the
  closer, and through them the async mapper and the chunked frontend made
  after it), registers the closer's keyframe-removal hook on the loaded
  map, puts its keyframes into the closer's keyframe database and starts a
  new map in the atlas, as System::System does after LoadAtlas (Map::PostLoad
  fills the KeyFrameDatabase; Atlas::CreateNewMap);
- --viz-out names each overlay by the frame id the tracker or the chunked
  frontend assigned to the frame, not by the loop's counter, and draws the
  tracker's last frame whenever its id reaches the next multiple of
  --viz-every (the chunked frontend reports the last frame of each chunk).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch


@dataclasses.dataclass
class RunResult:
    slam: object  # system/slam_system.py::SlamSystem, shut down
    frontend: object  # tracking/chunked.py::ChunkedTracker with --chunked, else None
    retired: list  # frame ids in the order their poses came out
    n_frames: int
    seconds: float  # the tracking loop, flush and shutdown included
    read_seconds: float  # of which reading and decoding the frames (host)


def imu_tuple(samples, prev_ts):
    """(acc (N, 3), gyro (N, 3), dts (N,)) float32 from a frame's dataset
    ImuSamples, dts from the previous frame's last sample (GrabImuData +
    PreintegrateIMU, src/Tracking.cc:1621,1627); None without samples."""
    if not samples:
        return None
    acc = np.stack([s.acc for s in samples]).astype(np.float32)
    gyro = np.stack([s.gyro for s in samples]).astype(np.float32)
    tss = np.array([s.ts for s in samples])
    t0 = prev_ts if prev_ts is not None else tss[0]
    dts = np.diff(np.concatenate([[t0], tss])).astype(np.float32)
    return acc, gyro, np.maximum(dts, 0.0)


def resume(slam, m) -> None:
    """Make the loaded atlas `m` the system's map before tracking starts."""
    slam.map = slam.tracker.map = slam.mapper.map = m
    c = slam.closer
    if c is not None:
        c.map = m
        m.kf_removed_callbacks.append(c._on_kf_removed)
        for k in m.keyframe_indices(all_maps=True):
            c.kfdb.add(int(k), c._words_of(int(k)))
    m.create_new_map()


def _parser():
    p = argparse.ArgumentParser(description="SLAM dataset runner (PyTorch / CUDA)")
    p.add_argument("--dataset", choices=["euroc", "tum", "kitti"], required=True)
    p.add_argument("--path", required=True)
    p.add_argument("--config", default=None, help="settings YAML (reference format)")
    p.add_argument("--vocab", default=None,
                   help="vocabulary: ORBvoc.txt (reference text format) or .npz; "
                        "default: the packaged vocabulary")
    p.add_argument("--sensor", choices=["mono", "stereo", "rgbd", "mono-imu", "stereo-imu",
                                        "rgbd-imu"], default="mono")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    p.add_argument("--out", default="trajectory_tum.txt")
    p.add_argument("--kf-out", default=None)
    p.add_argument("--atlas-out", default=None, help="save atlas checkpoint")
    p.add_argument("--atlas-in", default=None, help="resume from checkpoint")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--no-loop", action="store_true")
    p.add_argument("--chunked", action="store_true",
                   help="chunk-pipelined frontend (all six sensors; tracking/chunked.py)")
    p.add_argument("--chunk-size", type=int, default=16)
    p.add_argument("--sync-mapping", action="store_true",
                   help="run local mapping synchronously at keyframe time (deterministic; "
                        "default overlaps it on a worker thread like the reference's "
                        "LocalMapping thread)")
    p.add_argument("--debug-out", default=None,
                   help="write the IMU init's traces as JSON lines (SaveDebugData, "
                        "src/System.cc:1305)")
    p.add_argument("--viz-out", default=None,
                   help="write annotated overlays (keypoints, state, counts) to this "
                        "directory (FrameDrawer, src/FrameDrawer.cc)")
    p.add_argument("--viz-every", type=int, default=10,
                   help="overlay every Nth frame id (with --viz-out)")
    p.add_argument("--semantic-out", default=None,
                   help="write a coloured semantic PLY cloud: posed frames through the "
                        "packaged depth + segmentation net (mono_semantic, "
                        "README.md:247-267)")
    p.add_argument("--semantic-stride", type=int, default=8,
                   help="pixel stride for semantic backprojection")
    return p


def main(argv=None) -> RunResult:
    args = _parser().parse_args(argv)

    from . import resolve_device
    from .cameras import Camera
    from .features.extractor import ExtractorConfig
    from .io.datasets import EurocDataset, KittiDataset, TumDataset
    from .system.slam_system import (
        IMU_MONOCULAR, IMU_RGBD, IMU_STEREO, MONOCULAR, RGBD, STEREO, SlamSystem, SystemConfig,
    )

    device = resolve_device(args.device)
    st = None
    if args.config:
        from .io.settings import load_settings

        st = load_settings(args.config, device=device)
        cam, ecfg, bf, dist, rect = st.cam, st.extractor, st.baseline, st.dist, st.rect
    else:
        cam = Camera.pinhole(458.654, 457.296, 367.215, 248.375, width=752, height=480,
                             device=device)
        ecfg = ExtractorConfig()
        bf = 458.654 * 0.11
        dist = rect = None

    sensor = {"mono": MONOCULAR, "stereo": STEREO, "rgbd": RGBD, "mono-imu": IMU_MONOCULAR,
              "stereo-imu": IMU_STEREO, "rgbd-imu": IMU_RGBD}[args.sensor]
    stereo, rgbd, inertial = ("stereo" in args.sensor, "rgbd" in args.sensor,
                              "imu" in args.sensor)
    voc = None
    if args.vocab:
        from .bow.vocabulary import load_orbvoc_text, load_vocabulary_npz

        voc = (load_orbvoc_text(args.vocab) if args.vocab.endswith(".txt")
               else load_vocabulary_npz(args.vocab))
    imu_cfg = None
    if inertial and st is not None and st.imu is not None:
        # the rig's calibration (noise densities, walks, rate, T_b_c1) for
        # every preintegration and inertial solve (ParseIMUParamFile,
        # src/Tracking.cc:1303)
        from .tracking.imu_frontend import ImuConfig

        T_bc = np.asarray(st.imu.T_bc, np.float64)
        imu_cfg = ImuConfig(noise_gyro=st.imu.noise_gyro, noise_acc=st.imu.noise_acc,
                            walk_gyro=st.imu.walk_gyro, walk_acc=st.imu.walk_acc,
                            freq=st.imu.freq, R_bc=T_bc[:3, :3].astype(np.float32),
                            t_bc=T_bc[:3, 3].astype(np.float32))
    slam = SlamSystem(SystemConfig(
        cam=cam, sensor=sensor, extractor=ecfg, feat_cap=ecfg.n_features, vocabulary=voc,
        use_loop_closing=not args.no_loop, bf=bf if stereo or rgbd else 0.0,
        th_far_points=st.th_far_points if st is not None else 0.0, dist=dist, imu=imu_cfg,
        # KB8 fisheye rig (no rectification): general left <-> right matching
        cam_right=st.cam_right if st is not None and stereo else None,
        T_rl=st.T_rl if st is not None and stereo else None, device=str(device)))
    # the atlas carries the MD5 of the closer's vocabulary (src/System.cc:1550)
    atlas_voc = slam.closer.voc if slam.closer is not None else voc
    if args.atlas_in:
        from .slam_map.serialization import load_atlas

        resume(slam, load_atlas(args.atlas_in, voc=atlas_voc))

    if args.dataset == "euroc":
        ds = EurocDataset(args.path, stereo=stereo, with_imu=inertial, with_depth=rgbd)
    elif args.dataset == "tum":
        ds = TumDataset(args.path, with_depth=rgbd)
    else:
        ds = KittiDataset(args.path, stereo=args.sensor == "stereo")

    fe = None
    if args.chunked:
        fe = slam.make_chunked_frontend(chunk=args.chunk_size, lag=1, stereo=stereo, rgbd=rgbd,
                                        async_mapping=not args.sync_mapping)
    drawer = recent_imgs = None
    if args.viz_out:
        from .viz.frame_drawer import FrameDrawer, write_overlay

        drawer = FrameDrawer()
        recent_imgs = {}  # frame id -> host image (the chunked frontend retires late)
    retired, n_done, prev_imu_ts, read_s, viz_due = [], 0, None, 0.0, 0
    t_start = time.perf_counter()
    frames = iter(ds)
    while True:
        t_read = time.perf_counter()
        frame = next(frames, None)
        read_s += time.perf_counter() - t_read
        if frame is None:
            break
        samples = None
        if inertial:
            samples = imu_tuple(frame.imu, prev_imu_ts)
            if frame.imu:
                prev_imu_ts = frame.imu[-1].ts
        fid = slam.tracker.frame_id  # the id the tracker gives this frame
        img = frame.image
        if stereo and frame.image_right is not None:
            img_r = frame.image_right
            if rect is not None:
                # rectification on the device (Settings'
                # precomputeRectificationMaps + cv::remap per frame)
                img, img_r = (x.cpu().numpy() for x in rect.remap(
                    torch.from_numpy(img).to(device), torch.from_numpy(img_r).to(device)))
            if fe is not None:
                out = fe.track_image(np.asarray(img, np.uint8), frame.ts,
                                     img_right=np.asarray(img_r, np.uint8), imu_samples=samples)
            else:
                slam.track_stereo(img, img_r, frame.ts, imu_samples=samples)
        elif rgbd and frame.depth is not None:
            if fe is not None:
                out = fe.track_image(np.asarray(img, np.uint8), frame.ts,
                                     depth_img=np.asarray(frame.depth, np.float32),
                                     imu_samples=samples)
            else:
                slam.track_rgbd(img, frame.depth, frame.ts, imu_samples=samples)
        elif fe is not None:
            out = fe.track_image(np.asarray(img, np.uint8), frame.ts, imu_samples=samples)
        elif args.sensor == "mono-imu":
            slam.track_monocular_inertial(img, frame.ts, samples)
        else:
            slam.track_monocular(img, frame.ts)
        retired += [r[0] for r in out] if fe is not None else [fid]
        n_done += 1
        if drawer is not None:
            recent_imgs[fid] = np.asarray(frame.image)
            for stale in [f for f in recent_imgs if f < fid - 8 * args.chunk_size]:
                del recent_imgs[stale]
            # the tracker's last frame once it reaches the next multiple of
            # --viz-every (the chunked frontend reports a chunk's last frame)
            rec = slam.tracker.last
            if rec is not None and rec.frame_id >= viz_due and rec.frame_id in recent_imgs:
                write_overlay(args.viz_out, slam.tracker, image=recent_imgs.pop(rec.frame_id),
                              drawer=drawer)
                viz_due = (rec.frame_id // max(1, args.viz_every) + 1) * max(1, args.viz_every)
        if args.max_frames and n_done >= args.max_frames:
            break
        if n_done % 100 == 0:
            fps = n_done / (time.perf_counter() - t_start)
            print(f"[{n_done}/{len(ds)}] {fps:.1f} fps, kfs={slam.map.n_keyframes()} "
                  f"mps={slam.map.n_points()}", file=sys.stderr)

    if fe is not None:
        retired += [r[0] for r in fe.flush()]
    slam.shutdown()
    seconds = time.perf_counter() - t_start
    if args.semantic_out:
        _write_semantic_cloud(args, slam, ds, cam)
    slam.save_trajectory_tum(args.out)
    if args.kf_out:
        slam.save_keyframe_trajectory_tum(args.kf_out)
    if args.debug_out:
        n_ev = slam.save_debug_data(args.debug_out)
        print(f"[debug] {n_ev} staged-init events -> {args.debug_out}", file=sys.stderr)
    if args.atlas_out:
        from .slam_map.serialization import save_atlas

        save_atlas(args.atlas_out, slam.map, voc=atlas_voc)
    print(slam.timing.dump())
    print(f"done: {n_done} frames at {n_done / seconds:.1f} fps")
    return RunResult(slam, fe, retired, n_done, seconds, read_s)


def _write_semantic_cloud(args, slam, ds, cam):
    """mono_semantic: SLAM poses + the packaged depth / segmentation net ->
    coloured PLY (README.md:247-267; CloudPoint accumulation,
    src/CloudPoint.cc). The net runs on the system's device."""
    from .models.depth import default_depth_model, make_depth_fn, make_seg_fn
    from .recon.cloud import save_ply, semantic_cloud

    model = default_depth_model(device=slam.device)
    if model is None:
        print("[semantic] no packaged depth model; skipping", file=sys.stderr)
        return
    net, meta = model
    hw = tuple(int(x) for x in meta.get("train_res", "96x128").split("x"))
    pose_of = {fid: T for _, fid, T in slam.tracker.absolute_trajectory()}
    # keyframe-rate replay: every Nth posed frame (the dataset re-iterates)
    step = max(1, len(ds) // 40)
    frames = []
    for i, frame in enumerate(ds):
        if i in pose_of and i % step == 0:
            frames.append((np.asarray(frame.image, np.float32), pose_of[i]))
        if args.max_frames and i >= args.max_frames:
            break
    if not frames:
        print("[semantic] no posed frames; skipping", file=sys.stderr)
        return
    colormap = np.array([[40, 40, 200], [90, 200, 90]], np.uint8)  # bg, surface
    pts, cols = semantic_cloud(cam, frames, make_depth_fn(net, hw), make_seg_fn(net, hw),
                               colormap, stride=args.semantic_stride, voxel=0.05)
    save_ply(args.semantic_out, pts, cols)
    print(f"[semantic] {len(pts)} points from {len(frames)} frames -> {args.semantic_out}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
