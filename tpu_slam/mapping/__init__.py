"""Device-resident voxel mapping.

Replacement for the reference SLAM core's GPU voxel/occupancy map
structures (SURVEY.md §2.2, BASELINE.json north_star). The map is a sorted
array of occupied voxels with Gaussian statistics — no pointers, no host
hash maps; updates are merge-sorts and lookups are binary searches, all
inside jit.
"""

from tpu_slam.mapping.voxel_map import VoxelMap, scan_to_voxel_stats

__all__ = ["VoxelMap", "scan_to_voxel_stats"]
