"""Pose-graph backend: graph construction, Gauss-Newton, loop closure.

Replacement for the reference's CPU graph-SLAM backend
(SURVEY.md §2.2). The solver is matrix-free: Hx products are edge-parallel
gathers + segment reductions, preconditioned CG does the linear algebra —
the structure that shards cleanly over a device mesh (distributed/).
"""

from tpu_slam.graph.pose_graph import (PoseGraph, GraphSolveParams,
                                       optimize_pose_graph)
from tpu_slam.graph.loop_closure import (LoopClosureParams,
                                         propose_candidates, verify_candidates)

__all__ = [
    "PoseGraph",
    "GraphSolveParams",
    "optimize_pose_graph",
    "LoopClosureParams",
    "propose_candidates",
    "verify_candidates",
]
