"""tpu_slam — a 6D LiDAR SLAM engine in JAX (XLA / Pallas / shard_map).

Built from scratch with the capabilities of the mandalarobotics/mandala-mapping
stack (see SURVEY.md): rotating-3D-scanner ingestion, full-rotation scan
aggregation (reference: m3d/m3d_aggregator/src/m3d_aggregator.cpp), laser-to-axis
extrinsic calibration (reference: m3d/m3d_calibration/), and a GPU-class
registration + mapping backend (reference: gpu_6dslam, redesigned in JAX).

Layer map (re-design of the reference's ROS layer stack):

    pipeline/      odometry + full SLAM orchestration  (ref L6 gpu_6dslam_node)
    graph/         pose-graph GN, Schur, loop closure  (ref L6 CPU graph-SLAM)
    mapping/       hashed voxel map, NDT stats          (ref L6 GPU voxel maps)
    registration/  ICP (pt-pt / pt-plane), NDT          (ref L6 CUDA kernels)
    kernels/       terms passes, NN search, voxel hash, downsample
    ingest/        SICK CoLa parse, rotating-unit model, aggregation,
                   calibration                          (ref L1-L5, m3d/*)
    distributed/   mesh shardings + collectives         (replaces ROS pub/sub L0)
    core/          SE(3), padded point clouds
"""

__version__ = "0.1.0"

import jax  # noqa: E402

# Full float32 matmuls everywhere: on NVIDIA GPUs XLA may otherwise run f32
# matmuls/einsums in TF32 (~3 decimal digits). For a SLAM engine that is
# catastrophic in a way no single test catches: every pose composition
# (`pose @ pred`, 6x6 graph blocks, moment einsums) loses ~1e-3 relative
# per op, and the odometry pose's rotation determinant decays scan by scan
# (the scan shrinks, registration biases, loop verification breaks from the
# scaled init). Every matmul in this engine has a tiny contraction dim (K=3
# point transforms, K=6 graph blocks, (P,P) grams at K=3), so full f32
# costs nothing measurable; the hot terms passes are elementwise work.
jax.config.update("jax_default_matmul_precision", "highest")

from tpu_slam.core.pointcloud import PointCloud  # noqa: E402
from tpu_slam.kernels.voxel_hash import VoxelGridSpec, voxel_keys, sort_by_key  # noqa: E402
from tpu_slam.kernels.downsample import voxel_downsample  # noqa: E402
from tpu_slam.kernels.nn_search import nearest_neighbors, nearest_neighbors_hash  # noqa: E402
from tpu_slam.registration.icp import ICPParams, ICPResult, icp  # noqa: E402

__all__ = [
    "PointCloud",
    "VoxelGridSpec",
    "voxel_keys",
    "sort_by_key",
    "voxel_downsample",
    "nearest_neighbors",
    "nearest_neighbors_hash",
    "ICPParams",
    "ICPResult",
    "icp",
]
