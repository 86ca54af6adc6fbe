"""SLAMSystem with the dense-window odometry engine."""

import math

import jax.numpy as jnp
import numpy as np

from tpu_slam.core.pointcloud import PointCloud
from tpu_slam.graph.loop_closure import LoopClosureParams
from tpu_slam.graph.pose_graph import GraphSolveParams
from tpu_slam.ingest import synthetic as syn
from tpu_slam.pipeline.config import OdometryConfig, SLAMConfig
from tpu_slam.pipeline.metrics import ate_rmse
from tpu_slam.pipeline.slam import SLAMSystem
from tpu_slam.registration.icp import ICPParams
from tpu_slam.registration.ndt import NDTParams

import pytest

pytestmark = pytest.mark.slow



def _sequence(n_poses, radius=2.5, n_azimuth=240, seed=0, arc_fraction=1.0):
    world = syn.default_office()
    rng = np.random.default_rng(seed)
    gt, clouds = [], []
    for k in range(n_poses):
        a = 2 * math.pi * arc_fraction * k / max(n_poses - 1, 1)
        T = syn.se2_pose(radius * math.cos(a), radius * math.sin(a),
                         a + math.pi / 2, z=1.2)
        pts, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=n_azimuth, noise_std=0.01, rng=rng)
        clouds.append(PointCloud.from_points_host(pts[valid], capacity=16384))
        gt.append(T)
    return clouds, np.stack(gt)


def test_slam_dense_engine_full_loop():
    clouds, gt = _sequence(n_poses=30)
    cfg = SLAMConfig(
        odometry=OdometryConfig(
            scan_capacity=4096, downsample_leaf=0.3,
            map_leaf=0.5, map_half_extent=16.0, map_capacity=16384,
            ndt=NDTParams(max_iterations=10, coarse_iterations=2,
                          window_dims=(48, 48, 16)),
            pyramid_factor=2),
        odometry_engine="dense",
        keyframe_translation=0.4, keyframe_rotation=0.25,
        keyframe_capacity=64, keyframe_cloud_capacity=2048,
        loop_every=4,
        loop=LoopClosureParams(
            max_distance=1.5, min_index_gap=8, max_candidates=4,
            min_matched_fraction=0.5, max_error=0.05,
            icp=ICPParams(max_iterations=25, max_corr_dist=1.0,
                          huber_delta=0.3)),
        graph=GraphSolveParams(gn_iterations=6, robust_delta=2.0,
                               robust_kernel="cauchy"),
        edge_capacity=256)
    slam = SLAMSystem(cfg)
    poses, state = slam.run(clouds, init_pose=jnp.asarray(gt[0], jnp.float32))
    assert state.n_keyframes >= 8
    ate = ate_rmse(poses, gt, align=False)
    assert ate < 0.12, ate
