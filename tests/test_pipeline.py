import math

import dataclasses
import jax.numpy as jnp
import numpy as np

from tpu_slam.core import se3
from tpu_slam.core.pointcloud import PointCloud
from tpu_slam.graph.loop_closure import LoopClosureParams
from tpu_slam.graph.pose_graph import GraphSolveParams
from tpu_slam.ingest import synthetic as syn
from tpu_slam.pipeline.checkpoint import load_checkpoint, save_checkpoint
from tpu_slam.pipeline.config import OdometryConfig, SLAMConfig
from tpu_slam.pipeline.metrics import ate_rmse, rpe_rmse
from tpu_slam.pipeline.odometry import LidarOdometry
from tpu_slam.pipeline.slam import SLAMSystem
from tpu_slam.registration.icp import ICPParams
from tpu_slam.registration.ndt import NDTParams
import pytest


ODOM_CFG = OdometryConfig(
    scan_capacity=4096,
    downsample_leaf=0.3,
    map_leaf=0.5,
    map_half_extent=16.0,
    map_capacity=16384,
    ndt=NDTParams(max_iterations=25),
)


def _sequence(n_poses=10, radius=2.5, n_azimuth=360, noise=0.01, seed=0,
              arc_fraction=0.25):
    """VLP-16 scans along a circular arc in the office world.

    ``arc_fraction`` of a full circle is swept over ``n_poses`` scans — keep
    inter-scan motion small (<0.5 m / <15 deg) as a real scan stream would.
    """
    world = syn.default_office()
    rng = np.random.default_rng(seed)
    gt = []
    clouds = []
    for k in range(n_poses):
        a = 2 * math.pi * arc_fraction * k / max(n_poses - 1, 1)
        T = syn.se2_pose(radius * math.cos(a), radius * math.sin(a),
                         a + math.pi / 2, z=1.2)
        pts, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=n_azimuth, noise_std=noise, rng=rng)
        cloud = PointCloud.from_points(jnp.asarray(pts[valid]), capacity=16384)
        gt.append(T)
        clouds.append(cloud)
    return clouds, np.stack(gt)


def test_odometry_tracks_arc():
    clouds, gt = _sequence(n_poses=8)
    odo = LidarOdometry(ODOM_CFG)
    poses, log = odo.run(clouds, init_pose=jnp.asarray(gt[0], jnp.float32))
    ate = ate_rmse(poses, gt, align=False)
    assert ate < 0.08, ate
    rpe_t, rpe_r = rpe_rmse(poses, gt)
    assert rpe_t < 0.06
    s = log.summary()
    assert s["n_scans"] == 8
    assert s["mean_matched_fraction"] > 0.5


def test_odometry_icp_plane_method():
    clouds, gt = _sequence(n_poses=5)
    cfg = dataclasses.replace(
        ODOM_CFG, method="icp_plane",
        icp=ICPParams(max_iterations=25, max_corr_dist=1.0))
    odo = LidarOdometry(cfg)
    poses, _ = odo.run(clouds, init_pose=jnp.asarray(gt[0], jnp.float32))
    ate = ate_rmse(poses, gt, align=False)
    assert ate < 0.12, ate


def _slam_cfg(**kw):
    return SLAMConfig(
        odometry=ODOM_CFG,
        keyframe_translation=0.4,
        keyframe_rotation=0.25,
        keyframe_capacity=64,
        keyframe_cloud_capacity=2048,
        loop_every=4,
        loop=LoopClosureParams(
            max_distance=1.5, min_index_gap=8, max_candidates=4,
            min_matched_fraction=0.5, max_error=0.05,
            icp=ICPParams(max_iterations=25, max_corr_dist=1.0,
                          huber_delta=0.3)),
        graph=GraphSolveParams(gn_iterations=6, robust_delta=2.0,
                               robust_kernel="cauchy"),
        edge_capacity=256,
        **kw,
    )


@pytest.mark.slow
def test_slam_full_loop():
    clouds, gt = _sequence(n_poses=40, radius=2.5, n_azimuth=240,
                           arc_fraction=1.0)
    slam = SLAMSystem(_slam_cfg())
    poses, state = slam.run(clouds, init_pose=jnp.asarray(gt[0], jnp.float32))
    assert state.n_keyframes >= 10
    assert state.n_loop_closures > 0
    ate = ate_rmse(poses, gt, align=False)
    assert ate < 0.12, ate


def test_checkpoint_resume_determinism(tmp_path):
    clouds, gt = _sequence(n_poses=6)
    cfg = _slam_cfg()

    slam_a = SLAMSystem(cfg)
    state = slam_a.init_state(jnp.asarray(gt[0], jnp.float32))
    for c in clouds[:3]:
        state, _ = slam_a.step(state, c)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, state)

    # continue run A
    for c in clouds[3:]:
        state, _ = slam_a.step(state, c)
    final_a = np.asarray(state.odom.pose)

    # resume into a fresh system B
    slam_b = SLAMSystem(cfg)
    state_b, manifest = load_checkpoint(path)
    assert manifest["n_keyframes"] == state_b.n_keyframes
    for c in clouds[3:]:
        state_b, _ = slam_b.step(state_b, c)
    final_b = np.asarray(state_b.odom.pose)

    np.testing.assert_allclose(final_a, final_b, atol=1e-5)


def test_metrics_ate_alignment():
    # ATE with alignment is invariant to a global rigid offset
    rng = np.random.default_rng(0)
    n = 20
    gt = np.stack([np.eye(4)] * n)
    gt[:, 0, 3] = np.linspace(0, 10, n)
    offset = np.asarray(se3.exp(jnp.array([1.0, -2.0, 0.5, 0.2, 0.1, -0.3],
                                          jnp.float32)))
    est = np.einsum("ij,njk->nik", offset, gt)
    assert ate_rmse(est, gt, align=True) < 1e-5
    assert ate_rmse(est, gt, align=False) > 1.0


@pytest.mark.slow
def test_slam_sliding_window_eviction():
    """Keyframe capacity fills mid-run: the fixed-lag window evicts instead
    of raising (round-1 weak #6) and the run stays sane."""
    clouds, gt = _sequence(n_poses=30, radius=2.5, n_azimuth=240,
                           arc_fraction=0.75)
    cfg = dataclasses.replace(_slam_cfg(), keyframe_capacity=8,
                              keyframe_rotation=10.0,  # force translation kf
                              keyframe_translation=0.3)
    slam = SLAMSystem(cfg)
    poses, state = slam.run(clouds, init_pose=jnp.asarray(gt[0], jnp.float32))
    assert state.n_evictions > 0
    assert state.n_keyframes <= cfg.keyframe_capacity
    # full trajectory = archive + live window, in order
    assert len(state.archived_poses) == state.n_evictions
    assert np.isfinite(np.asarray(state.graph.poses)).all()
    assert np.isfinite(poses).all()
    ate = ate_rmse(poses, gt, align=False)
    assert ate < 0.3, ate


@pytest.mark.slow
def test_slam_survives_wrong_loop():
    """Regression (round-1 weak #8): with the default robust graph config a
    wrong accepted closure must not fold the trajectory."""
    from tpu_slam.graph.pose_graph import add_edge

    clouds, gt = _sequence(n_poses=40, radius=2.5, n_azimuth=240,
                           arc_fraction=1.0)
    cfg = _slam_cfg()
    slam = SLAMSystem(cfg)
    state = slam.init_state(jnp.asarray(gt[0], jnp.float32))
    poses = []
    injected = False
    for cloud in clouds:
        state, _ = slam.step(state, cloud)
        if not injected and state.n_keyframes >= 20:
            # a gross wrong closure between unrelated keyframes, at loop
            # strength — takes effect at the next graph optimization
            bad_Z = se3.exp(jnp.array([2.0, -1.5, 0.8, 0.4, 0.3, 0.9],
                                      jnp.float32))
            state = dataclasses.replace(
                state, graph=add_edge(
                    state.graph, 2, 17, bad_Z,
                    info=cfg.loop_edge_info
                    * jnp.eye(6, dtype=jnp.float32)))
            injected = True
        poses.append(np.asarray(state.odom.pose))
    assert injected and state.n_loop_closures > 0  # optimizer did run
    ate = ate_rmse(np.stack(poses), gt, align=False)
    assert ate < 0.15, ate


def test_rebuild_map_batched_matches_sequential():
    """One-dispatch map rebuild == the per-keyframe insert loop."""
    from tpu_slam.mapping.voxel_map import empty_map, insert_cloud
    from tpu_slam.pipeline.slam import _rebuild_map_batched
    from tpu_slam.kernels.voxel_hash import INVALID_KEY

    clouds, gt = _sequence(n_poses=4)
    cfg = _slam_cfg()
    slam = SLAMSystem(cfg)
    state = slam.init_state(jnp.asarray(gt[0], jnp.float32))
    for c in clouds:
        state, _ = slam.step(state, c)
    n = state.n_keyframes
    assert n >= 2
    spec = cfg.odometry.map_spec()

    batched = _rebuild_map_batched(state.graph.poses, state.kf_points,
                                   state.kf_mask, jnp.int32(n), spec=spec,
                                   capacity=cfg.odometry.map_capacity)
    seq = empty_map(cfg.odometry.map_capacity)
    for k in range(n):
        cloud = PointCloud(points=state.kf_points[k], mask=state.kf_mask[k])
        seq = insert_cloud(seq, cloud.transform(state.graph.poses[k]), spec,
                           stamp=float(n))

    kb = np.sort(np.asarray(batched.keys))
    ks = np.sort(np.asarray(seq.keys))
    np.testing.assert_array_equal(kb, ks)
    # per-voxel point mass identical (sum over voxels of |count| diff)
    ob = np.argsort(np.asarray(batched.keys), kind="stable")
    os_ = np.argsort(np.asarray(seq.keys), kind="stable")
    np.testing.assert_allclose(np.asarray(batched.count)[ob],
                               np.asarray(seq.count)[os_], rtol=1e-5)


def test_checkpoint_resume_dense_engine(tmp_path):
    """Checkpoint/resume of a DENSE-engine SLAM state (r5: the v3 format
    only knew the sparse voxel map): save mid-run, resume, and the
    resumed run's poses must match the uninterrupted run exactly."""
    import dataclasses as _dc

    from tpu_slam.graph.loop_closure import LoopClosureParams
    from tpu_slam.pipeline.config import OdometryConfig, SLAMConfig
    from tpu_slam.pipeline.slam import SLAMSystem
    from tpu_slam.registration.ndt import NDTParams

    world = syn.default_office()
    rng = np.random.default_rng(3)
    clouds = []
    for k in range(6):
        T = syn.se2_pose(0.25 * k - 0.5, 0.0, 0.05 * k, z=1.2)
        pts, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=360, noise_std=0.005, rng=rng)
        clouds.append(PointCloud.from_points_host(pts[valid],
                                                  capacity=8192))

    cfg = SLAMConfig(
        odometry=OdometryConfig(
            scan_capacity=4096, downsample_leaf=0.25, map_leaf=0.4,
            map_half_extent=16.0, insert_downsampled=True,
            ndt=NDTParams(max_iterations=6, window_dims=(32, 32, 16)),
            pyramid_factor=2),
        odometry_engine="dense",
        keyframe_translation=0.2, keyframe_capacity=16,
        keyframe_cloud_capacity=2048, loop_every=100, edge_capacity=32)
    slam = SLAMSystem(cfg)
    state = slam.init_state(jnp.eye(4))
    for c in clouds[:3]:
        state, _ = slam.step(state, c)
    path = str(tmp_path / "dense_ckpt.npz")
    save_checkpoint(path, state)

    # uninterrupted continuation
    cont = state
    for c in clouds[3:]:
        cont, _ = slam.step(cont, c)
    # resumed continuation
    slam2 = SLAMSystem(cfg)
    resumed, manifest = load_checkpoint(path)
    assert manifest["format_version"] >= 3
    for c in clouds[3:]:
        resumed, _ = slam2.step(resumed, c)

    np.testing.assert_allclose(np.asarray(resumed.odom.pose),
                               np.asarray(cont.odom.pose), atol=1e-6)
    np.testing.assert_allclose(np.asarray(resumed.odom.grid.rows),
                               np.asarray(cont.odom.grid.rows), atol=1e-5)
