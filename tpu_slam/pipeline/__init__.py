"""End-to-end pipelines: odometry and full 6D SLAM.

The stand-in for the reference's gpu_6dslam_node (SURVEY.md §1
L6): consumes the aggregated-cloud stream (ingest/), maintains pose + map
on device, closes loops and optimizes the pose graph (graph/).
"""

from tpu_slam.pipeline.config import OdometryConfig, SLAMConfig
from tpu_slam.pipeline.odometry import LidarOdometry
from tpu_slam.pipeline.slam import SLAMSystem

__all__ = ["OdometryConfig", "SLAMConfig", "LidarOdometry", "SLAMSystem"]
