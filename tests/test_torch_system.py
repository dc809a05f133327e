"""Port parity for the slice as a whole: SlamSystem.make_chunked_frontend,
JAX vs torch, on the scene of tests/test_chunked.py.

26 rendered 752x480 uint8 frames (the reference's write_euroc_sequence, a
3 m arc over a textured plane), 512 features over 4 levels, 4-frame chunks,
lag 1, synchronous mapping (async_mapping=False, so both runs are
deterministic), loop closing off. Both packages get the same frames.
Gates: the same retired frame ids, in order; tracked flags equal except at
most TRACKED_MARGIN frames; the port's scale-aligned ATE below the
reference test's 0.25 m; the two trajectories within TRAJ_TOL of each other
after one similarity alignment. Each package extracts its own features
(pyramid levels >= 1 round differently, tests/test_torch_extractor.py) and
draws its own two-view minimal sets, so the maps differ by noise.
"""
import numpy as np
import pytest
import torch

from orb_slam3_modified_tpu.cameras import Camera as JCamera
from orb_slam3_modified_tpu_torch import convert
from orb_slam3_modified_tpu_torch.eval.ate import align_horn, ate_rmse

torch.set_num_threads(2)
JCAM = JCamera.pinhole(458.654, 457.296, 367.215, 248.375, width=752, height=480)
N_FRAMES = 26
TRACKED_MARGIN = 2
TRAJ_TOL = 0.05  # m, max camera-centre distance after a similarity alignment


def _run(slam, frames):
    fe = slam.make_chunked_frontend(chunk=4, lag=1, async_mapping=False)
    retired = []
    for i, img in enumerate(frames):
        retired += fe.track_image(img, i / 20.0)
    retired += fe.flush()
    slam.shutdown()
    return retired, slam.tracker.absolute_trajectory()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from orb_slam3_modified_tpu.features.extractor import ExtractorConfig as JExtractorConfig
    from orb_slam3_modified_tpu.io.datasets import EurocDataset
    from orb_slam3_modified_tpu.system.slam_system import SlamSystem as JSlamSystem
    from orb_slam3_modified_tpu.system.slam_system import SystemConfig as JSystemConfig
    from orb_slam3_modified_tpu.utils.synthetic_dataset import write_euroc_sequence
    from orb_slam3_modified_tpu_torch.features.extractor import ExtractorConfig
    from orb_slam3_modified_tpu_torch.system.slam_system import SlamSystem, SystemConfig

    root = str(tmp_path_factory.mktemp("euroc_synth_torch_system"))
    gts = write_euroc_sequence(root, JCAM, n_frames=N_FRAMES, radius=3.0)
    frames = [f.image.astype(np.uint8) for f in EurocDataset(root)]
    jslam = JSlamSystem(JSystemConfig(cam=JCAM, feat_cap=512, use_loop_closing=False,
                                      extractor=JExtractorConfig(n_features=512, n_levels=4)))
    tslam = SlamSystem(SystemConfig(cam=convert.camera(JCAM, device="cpu"), feat_cap=512,
                                    use_loop_closing=False, device="cpu",
                                    extractor=ExtractorConfig(n_features=512, n_levels=4)))
    return _run(jslam, frames), _run(tslam, frames), tslam, gts


def _centres(traj):
    return {fid: np.linalg.inv(T)[:3, 3] for _, fid, T in traj}


def test_frontend_tracks_and_agrees_with_the_reference(runs):
    """One test for the whole run: a module fixture runs once per worker
    that draws one of its tests."""
    (j_ret, j_traj), (t_ret, t_traj), tslam, gts = runs
    fids = [r[0] for r in t_ret]
    assert fids == sorted(fids) and len(t_ret) == N_FRAMES
    assert fids == [r[0] for r in j_ret]
    tracked_t = np.array([r[2] is not None for r in t_ret])
    tracked_j = np.array([r[2] is not None for r in j_ret])
    assert (tracked_t != tracked_j).sum() <= TRACKED_MARGIN
    assert tracked_t.sum() >= N_FRAMES - 6
    assert tslam.map.n_keyframes() >= 2
    c = _centres(t_traj)
    rmse, _ = ate_rmse(np.array(list(c.values())),
                       np.array([np.linalg.inv(gts[f])[:3, 3] for f in c]))
    assert rmse < 0.25, f"ATE {rmse}"
    cj, ct = _centres(j_traj), c
    common = sorted(set(cj) & set(ct))
    assert len(common) >= N_FRAMES - 6
    a = np.array([ct[f] for f in common]).T
    b = np.array([cj[f] for f in common]).T
    _, _, _, err = align_horn(a, b)
    assert err.max() < TRAJ_TOL, err


# ---- cheap cases, without the module fixture


def _anchor_fixture():
    """tests/test_chunked.py::TestAnchorCorrection's fixture, on the port."""
    from orb_slam3_modified_tpu_torch.features.extractor import ExtractorConfig
    from orb_slam3_modified_tpu_torch.slam_map.map_state import MapState
    from orb_slam3_modified_tpu_torch.tracking.chunked import ChunkedTracker
    from orb_slam3_modified_tpu_torch.tracking.fused import DeviceTrackState
    from orb_slam3_modified_tpu_torch.tracking.tracker import Tracker, TrackerConfig

    m = MapState.create(max_kf=8, max_mp=64, feat_cap=16)
    t = Tracker(TrackerConfig(cam=convert.camera(JCAM, device="cpu")), m, device="cpu")
    k = m.alloc_keyframe()
    m.kf_t[k] = np.array([0.0, 0.0, 1.0], np.float32)
    m.kf_frame_id[k] = 0
    t.ref_kf = int(k)
    ct = ChunkedTracker(t, ExtractorConfig(n_features=16))
    ct.state = DeviceTrackState(R=torch.eye(3), t=torch.tensor([0.0, 0.0, 1.5]), R_prev=torch.eye(3),
                                t_prev=torch.tensor([0.0, 0.0, 1.4]), ok=torch.tensor(True))
    return m, ct, int(k)


def test_anchor_correction_follows_a_map_move():
    m, ct, k = _anchor_fixture()
    ct._record_anchor()
    m.kf_t[k] = np.array([0.3, 0.0, 1.0], np.float32)  # a background solve moves the keyframe
    ct._apply_anchor_correction()
    np.testing.assert_allclose(ct.state.t.numpy(), [0.3, 0.0, 1.5], atol=1e-6)
    np.testing.assert_allclose(ct.state.t_prev.numpy(), [0.3, 0.0, 1.4], atol=1e-6)


def test_anchor_falls_back_to_a_covisible_keyframe():
    m, ct, k = _anchor_fixture()
    k2 = m.alloc_keyframe()
    m.kf_t[k2] = np.array([0.1, 0.0, 1.0], np.float32)
    m.kf_frame_id[k2] = 1
    mp = m.alloc_points(8)
    m.mp_pos[mp] = np.random.default_rng(0).uniform(-1, 1, (8, 3))
    m.kf_obs[k, :8] = mp
    m.kf_obs[k2, :8] = mp
    ct._record_anchor()
    assert len(ct._anchor) >= 2
    m.remove_keyframe(k)
    m.kf_t[k2] = np.array([0.1, 0.2, 1.0], np.float32)
    ct._apply_anchor_correction()
    np.testing.assert_allclose(ct.state.t.numpy(), [0.0, 0.2, 1.5], atol=1e-6)


def test_system_refuses_what_later_slices_bring():
    """The inertial sensors build (tracker, mapper and closer share one IMU
    frontend; IMU_MONOCULAR keeps the monocular keyframe ratio, the other two
    the depth sensors'), and so does their chunked frontend, which takes
    track_image(..., imu_samples=) (tests/test_torch_vi_chunked*.py run it);
    a monocular chunked frontend, with no IMU frontend, ignores imu_samples
    as the reference's does; monocular, stereo and RGB-D build. Loop
    closing, ported since, is on by default and builds the closer and the
    relocalization hook; its inertial global BA runs."""
    from orb_slam3_modified_tpu_torch.system.slam_system import (
        IMU_MONOCULAR, IMU_RGBD, IMU_STEREO, RGBD, STEREO, SlamSystem, SystemConfig,
    )

    cam = convert.camera(JCAM, device="cpu")
    blank = np.zeros((480, 752), np.uint8)
    samples = (np.tile(np.float32([0.0, 0.0, 9.81]), (10, 1)), np.zeros((10, 3), np.float32),
               np.full(10, 0.005, np.float32))
    for sensor in (IMU_MONOCULAR, IMU_STEREO, IMU_RGBD):
        slam = SlamSystem(SystemConfig(cam=cam, sensor=sensor, device="cpu", bf=50.0))
        imu = slam.tracker.imu
        assert imu is not None and slam.mapper.imu is imu and slam.closer.imu is imu
        assert slam.closer.cfg.fix_scale and imu.cfg.mono == (sensor == IMU_MONOCULAR)
        assert slam.tcfg.kf_tracked_ratio == (0.9 if sensor == IMU_MONOCULAR else 0.75)
        fe = slam.make_chunked_frontend(async_mapping=False, stereo=sensor == IMU_STEREO,
                                        rgbd=sensor == IMU_RGBD)
        assert fe.imu is imu and not fe._vi
        kw = {IMU_STEREO: {"img_right": blank},
              IMU_RGBD: {"depth_img": np.zeros((480, 752), np.float32)}}.get(sensor, {})
        retired = []
        for i in range(2):  # a blank frame initializes nothing: the slow path retires it
            retired += fe.track_image(blank, i / 20.0, imu_samples=samples, **kw)
        assert [r[0] for r in retired] == [0, 1] and all(r[2] is None for r in retired)
        assert abs(float(imu.preint_frame.dT) - 0.05) < 1e-6
    for sensor in (STEREO, RGBD):  # ORB-SLAM3's keyframe ratio for depth sensors
        tcfg = SlamSystem(SystemConfig(cam=cam, sensor=sensor, bf=50.0, use_loop_closing=False,
                                       device="cpu")).tcfg
        assert (tcfg.bf, tcfg.kf_tracked_ratio) == (50.0, 0.75)
    slam = SlamSystem(SystemConfig(cam=cam, device="cpu"))
    assert slam.tcfg.kf_tracked_ratio == 0.9
    assert slam.closer is not None and slam.tracker.relocalize_fn is not None
    assert SlamSystem(SystemConfig(cam=cam, use_loop_closing=False, device="cpu")).closer is None
    fe = slam.make_chunked_frontend(async_mapping=False)
    assert fe.imu is None
    assert fe.track_image(blank, 0.0, imu_samples=samples) == [(0, 0.0, None)]
    # without an IMU the closer's inertial GBA is never routed to; with one
    # whose chain is too short it declines (False) and the visual GBA runs
    slam.closer.imu = slam.tracker.imu = SlamSystem(
        SystemConfig(cam=cam, sensor=IMU_MONOCULAR, device="cpu")).tracker.imu
    assert slam.closer._global_vi_ba() is False


def test_system_entry_point_defaults_to_cuda():
    from orb_slam3_modified_tpu_torch.system.slam_system import SlamSystem, SystemConfig

    cfg = SystemConfig(cam=convert.camera(JCAM, device="cpu"), use_loop_closing=False)
    if torch.cuda.is_available():
        assert SlamSystem(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            SlamSystem(cfg)


def test_readback_and_upload_round_trip():
    from orb_slam3_modified_tpu_torch.features.extractor import Features
    from orb_slam3_modified_tpu_torch.utils.fetch import Readback, fetch, upload

    a = np.arange(12, dtype=np.int32).reshape(3, 4)
    t = upload(a, "cpu")
    assert t.dtype == torch.int32 and np.array_equal(t.numpy(), a)
    f = Features(*(torch.full((2, 3), i) for i in range(6)))
    got = Readback({"f": f, "n": 3, "t": (t, None)}).wait()
    assert isinstance(got["f"], Features) and got["n"] == 3 and got["t"][1] is None
    assert np.array_equal(got["t"][0], a) and np.array_equal(got["f"].level, np.full((2, 3), 3))
    out = fetch(t)
    out[0, 0] = 99  # writable and not aliasing the tensor
    assert int(t[0, 0]) == 0


class _FakeMapper:
    """What AsyncLocalMapper needs of a LocalMapper: the map's slots, a
    device, a lock slot, and on_keyframe (recorded)."""

    def __init__(self, n=8):
        self.map = type("M", (), {"kf_valid": np.ones(n, bool), "kf_frame_id": np.arange(n) * 10})()
        self.device = torch.device("cpu")
        self.lock = None
        self.calls = []

    def on_keyframe(self, k):
        self.calls.append(k)


def test_async_mapper_holds_keyframes_and_maps_a_released_batch():
    """Held keyframes wait for release(); every live keyframe of a batch is
    mapped with its local BA; a slot culled meanwhile is skipped."""
    import time

    from orb_slam3_modified_tpu_torch.mapping.async_mapper import AsyncLocalMapper

    fake = _FakeMapper()
    am = AsyncLocalMapper(fake)
    try:
        for k in (1, 2, 3):
            am.on_keyframe(k)
        assert not am.busy()  # the worker takes one at once, two wait
        am.on_keyframe(5)
        assert am.busy()  # three waiting: NeedNewKeyFrame's backlog gate
        am.wait_drained()  # nothing released yet
        time.sleep(0.3)  # longer than the worker's poll
        assert fake.calls == []
        fake.map.kf_valid[3] = False  # culled before the worker reached it
        am.release()
        assert not am.busy()
        am.wait_drained()
        assert fake.calls == [1, 2, 5]
        assert am.processed == 3
        am.on_keyframe(4)
        am.flush()  # releases and waits
        assert fake.calls[-1] == 4
    finally:
        am.shutdown()


def test_async_frontend_repeats_itself():
    """Two runs of make_chunked_frontend with the async mapper on the same
    frames give the same trajectory and map: the worker takes keyframes only
    at a retire's end and the tracker reads the map only after it drained,
    so what each retire sees does not depend on the threads' timing. The
    scene is the headline orbit's first 48 frames at 320x240, 256 features,
    4-frame chunks."""
    from orb_slam3_modified_tpu_torch.cameras import Camera
    from orb_slam3_modified_tpu_torch.features.extractor import ExtractorConfig
    from orb_slam3_modified_tpu_torch.system.slam_system import SlamSystem, SystemConfig
    from orb_slam3_modified_tpu_torch.utils.synthetic import orbit_trajectory
    from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import make_texture, render_sequence

    k = 320 / 752
    cam = Camera.pinhole(458.654 * k, 457.296 * k, 367.215 * k, 248.375 * k, width=320, height=240,
                         device="cpu")
    T_all = orbit_trajectory(400, radius=4.0, sweep=np.pi / 2)
    with np.errstate(invalid="ignore"):  # rays parallel to the plane
        frames = render_sequence(cam, T_all, make_texture(0, 96, 1024), plane_z=2.0,
                                 plane_half=10.0)[:48]
    runs = []
    for _ in range(2):
        slam = SlamSystem(SystemConfig(cam=cam, feat_cap=256, use_loop_closing=False, device="cpu",
                                       extractor=ExtractorConfig(n_features=256)))
        fe = slam.make_chunked_frontend(chunk=4, lag=1)
        retired = []
        for i, img in enumerate(frames):
            retired += fe.track_image(img, i / 20.0)
        retired += fe.flush()
        processed = slam.async_mapper.processed
        slam.shutdown()
        runs.append((retired, slam.tracker.absolute_trajectory(), slam.map.n_keyframes(),
                     slam.map.n_points(), processed))
    (ret_a, traj_a, *counts_a), (ret_b, traj_b, *counts_b) = runs
    assert [r[0] for r in ret_a] == list(range(len(frames)))
    assert sum(r[2] is not None for r in ret_a) >= len(frames) - 8
    assert counts_a[2] >= 3, counts_a  # the worker mapped keyframes beyond the initial pair
    assert counts_a == counts_b
    assert [r[0] for r in ret_a] == [r[0] for r in ret_b]
    for (_, fa, Ta), (_, fb, Tb) in zip(traj_a, traj_b, strict=True):
        assert fa == fb and np.array_equal(Ta, Tb)
