"""Ingestion front end: sensor parsing, frame graph, scan aggregation.

ROS-free re-design of the reference m3d stack (L1-L5 of
SURVEY.md §1): SICK CoLa-A telegram parsing (ref
m3d/sick_minimal_driver/src/lms_mini_lib.cpp), the rotating-unit encoder /
frame-chain model (ref m3d/m3dunit_base/src/encoder_node_li.cpp,
scripts/transformBroadcaster.py), full-rotation scan aggregation (ref
m3d/m3d_aggregator/src/m3d_aggregator.cpp), synthetic world simulation and
offline dataset replay (replacing ROS bag playback).
"""

from tpu_slam.ingest.sick_cola import LaserScan, ScanTelegram, parse_telegram, telegram_to_laser_scan
from tpu_slam.ingest.frames import SensorModel, FrameChain, Calibration
from tpu_slam.ingest.aggregator import AggregatorConfig, AggregatorState, ScanAggregator

__all__ = [
    "LaserScan",
    "ScanTelegram",
    "parse_telegram",
    "telegram_to_laser_scan",
    "SensorModel",
    "FrameChain",
    "Calibration",
    "AggregatorConfig",
    "AggregatorState",
    "ScanAggregator",
]
