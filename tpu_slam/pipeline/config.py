"""Configuration tree for the pipelines.

Mirrors the reference's ROS-param style (every node reads ~-private params
with defaults, SURVEY.md §5 'Config/flag system') as nested frozen
dataclasses: hashable, usable directly as jit static arguments, overridable
from CLI/JSON (cli/).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from tpu_slam.graph.loop_closure import LoopClosureParams
from tpu_slam.graph.pose_graph import GraphSolveParams
from tpu_slam.kernels.voxel_hash import VoxelGridSpec
from tpu_slam.registration.icp import ICPParams
from tpu_slam.registration.ndt import NDTParams


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    """Scan-to-map odometry configuration."""

    # Input handling
    scan_capacity: int = 32768          # padded size of downsampled scans
    downsample_leaf: float = 0.2        # scan voxel-downsample leaf (m)
    scan_max_range: float = 0.0         # horizontal range gate on the
                                        # REGISTRATION input (0 = off): the
                                        # dense window cannot match points
                                        # beyond its extent, so feeding them
                                        # to the solver only depresses the
                                        # matched fraction; standard LiDAR-
                                        # odometry preprocessing (raw scans
                                        # keep every ray)
    insert_downsampled: bool = False    # dense engine: integrate the
                                        # downsampled scan instead of the
                                        # raw cloud (a fraction of the
                                        # insert work; 27-cell
                                        # neighborhood aggregation keeps
                                        # the Gaussians well-supported)

    # Map
    map_leaf: float = 0.5               # map voxel leaf (m)
    map_half_extent: float = 100.0      # world half-extent covered by keys
    map_capacity: int = 131072          # max occupied voxels
    scrolling_window: bool = False      # unbounded worlds: the map lives in
                                        # a sensor-following local window
                                        # (int32 keys cap a FIXED grid at
                                        # 1024 cells/axis); re-centering
                                        # shifts keys by whole cells — a
                                        # dynamic-shift jit, no recompiles
    rebase_fraction: float = 0.25       # re-center once the sensor leaves
                                        # the central (1 - 2f) core of the
                                        # window

    # Registration
    method: str = "ndt"                 # 'ndt' | 'icp_point' | 'icp_plane'
    ndt: NDTParams = NDTParams(max_iterations=30)
    icp: ICPParams = ICPParams(max_iterations=30, max_corr_dist=1.0)
    pyramid_factor: int = 0             # multi-resolution NDT: register
                                        # against a factor-x coarser field
                                        # first (power of 2; 0 = off). Fat
                                        # coarse Gaussians give meter-scale
                                        # capture with correct anisotropy —
                                        # needed when inter-scan motion
                                        # exceeds the fine Gaussians' basin
                                        # (fast outdoor driving)

    # Occupancy maintenance (free-space evidence -> dynamic-point removal)
    use_occupancy: bool = False         # maintain a log-odds grid alongside
                                        # the moments map; map voxels whose
                                        # log-odds fall below the eviction
                                        # threshold (rays now pass through
                                        # them) are removed — moving objects
                                        # do not fossilize in the map
    occupancy_capacity: int = 65536
    occupancy_steps: int = 64           # free-space samples per ray
    occupancy_max_range: float = 30.0
    occupancy_evict_below: float = -1.0

    # Motion model / insertion policy
    deskew: bool = False                # undistort scans with the predicted
                                        # motion (VLP-16 azimuth timing)
    use_constant_velocity: bool = True
    max_pred_translation: float = 0.7   # clamp on CV-extrapolated motion (m)
    max_pred_rotation: float = 0.3      # ... and rotation (rad)
    insert_every: int = 1               # integrate every k-th scan into map
    min_insert_fraction: float = 0.4    # skip map insert below this matched
                                        # fraction. NOTE: the fraction
                                        # conflates registration quality
                                        # with map coverage — when exploring
                                        # (half the scan faces unmapped
                                        # space) it sits near 0.5, and a
                                        # high bar starves the map of
                                        # exactly the new territory it
                                        # needs (death spiral: no insert ->
                                        # lower overlap -> no insert)
    min_accept_fraction: float = 0.3    # below this, reject the registration
                                        # and coast on the prediction

    def map_spec(self) -> VoxelGridSpec:
        return VoxelGridSpec.centered(leaf=self.map_leaf,
                                      half_extent=self.map_half_extent)

    def scan_spec(self) -> VoxelGridSpec:
        return VoxelGridSpec.centered(leaf=self.downsample_leaf,
                                      half_extent=self.map_half_extent)


@dataclasses.dataclass(frozen=True)
class SLAMConfig:
    """Full SLAM system configuration (odometry + graph backend)."""

    odometry: OdometryConfig = OdometryConfig()
    odometry_engine: str = "host"       # 'host' (pipeline.odometry sparse-
                                        # map loop) | 'dense' (one-dispatch
                                        # dense-window engine,
                                        # pipeline.odometry_dense — needs
                                        # odometry.ndt.window_dims)

    # Keyframe policy
    keyframe_translation: float = 0.5   # new keyframe after this motion (m)
    keyframe_rotation: float = 0.3      # ... or this rotation (rad)
    keyframe_capacity: int = 512
    keyframe_cloud_capacity: int = 8192  # stored downsampled points per kf
    window_evict_fraction: float = 0.25  # fixed-lag sliding window: when the
                                        # keyframe or edge capacity fills,
                                        # this fraction of the OLDEST
                                        # keyframes is evicted (their poses
                                        # are exported to the archive first)
                                        # instead of raising

    # Loop closure / graph
    loop_every: int = 5                 # run detection every k keyframes
    loop: LoopClosureParams = LoopClosureParams()
    # Robust (redescending Cauchy) kernel on by default: one wrong accepted
    # closure must not fold the trajectory (wrong-loop regression test in
    # tests/test_pipeline.py)
    graph: GraphSolveParams = GraphSolveParams(gn_iterations=8,
                                               robust_delta=2.0,
                                               robust_kernel="cauchy")
    edge_capacity: int = 2048
    odom_edge_info: float = 100.0       # information weight of odometry edges
    loop_edge_info: float = 25.0        # loop-closure edges get LESS weight
                                        # than odometry: a verified-but-wrong
                                        # closure then cannot out-vote the
                                        # odometry chain before the robust
                                        # kernel cuts it
    rebuild_map_after_loop: bool = True
    reanchor_after_loop: bool = True    # False = loosely-coupled SLAM: the
                                        # pose graph maintains the optimized
                                        # trajectory while odometry free-runs
                                        # (its window is never rebuilt; the
                                        # optimized estimate is read from
                                        # graph.poses). Decouples the map-
                                        # rebuild feedback loop — a rebuilt
                                        # window momentarily changes the
                                        # registration landscape and can
                                        # cost a one-scan misregistration
