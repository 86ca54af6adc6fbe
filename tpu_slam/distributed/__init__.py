"""Multi-device / multi-host scaling over a device mesh.

Replaces the reference's single-process ROS graph + single-GPU CUDA core
(SURVEY.md §2.3) with XLA-collective parallelism:

  * DP: independent registrations (odometry pairs, loop-closure candidate
    verification) sharded over mesh devices (registration_dist);
  * SP-analog: the pose graph solved with keyframe-range-sharded exact
    Schur-complement elimination (schur) — the arrow/block-tridiagonal
    structure of SURVEY §7.3 — plus an edge-sharded, psum-reduced PCG
    (pose_graph_dist) for loop-dense graphs;
  * TP-analog: the voxel map sharded by spatial hash (map_shard);
  * multi-host: jax.distributed bring-up helpers (multihost).
"""

from tpu_slam.distributed.mesh import make_mesh, device_count
from tpu_slam.distributed.registration_dist import sharded_pairwise_icp
from tpu_slam.distributed.pose_graph_dist import optimize_pose_graph_sharded
from tpu_slam.distributed.schur import optimize_pose_graph_schur

__all__ = [
    "make_mesh",
    "device_count",
    "sharded_pairwise_icp",
    "optimize_pose_graph_sharded",
    "optimize_pose_graph_schur",
]
