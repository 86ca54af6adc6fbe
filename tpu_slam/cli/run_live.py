"""Run the composed live pipeline against real (or simulated) devices.

The bringup twin of universal.launch + m3d_husky_bringup.launch: connects
the SICK scanner (TCP, CoLa-A) and the rotating unit (TCP or serial),
commands the rotation speed, and streams scan lines through the
aggregation chain into SLAM, printing one JSON metrics line per emitted
3D scan.

Examples:
  python -m tpu_slam.cli.run_live --lms-host 192.168.0.10 \
      --m3d-host 192.168.0.11 --speed 12 --scans 10
  python -m tpu_slam.cli.run_live --lms-host 192.168.0.10 \
      --m3d-serial /dev/ttyUSB0 --speed 12
"""

from __future__ import annotations

import argparse
import json

from tpu_slam.cli.common import add_common_args, apply_overrides, emit
from tpu_slam.ingest.aggregator import AggregatorConfig
from tpu_slam.ingest.frames import Calibration, FrameChain, SensorModel
from tpu_slam.ingest.native import NativeLms, NativeM3d
from tpu_slam.pipeline.config import SLAMConfig
from tpu_slam.pipeline.live import LiveConfig, LivePipeline
from tpu_slam.pipeline.slam import SLAMSystem
from tpu_slam.utils.compile_cache import enable_compile_cache


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--lms-host", required=True)
    p.add_argument("--lms-port", type=int, default=2111)
    p.add_argument("--m3d-host", default=None)
    p.add_argument("--m3d-port", type=int, default=10001)
    p.add_argument("--m3d-serial", default=None,
                   help="serial device path (57600 baud) instead of TCP")
    p.add_argument("--speed", type=int, default=12,
                   help="rotation speed command (universal.launch:17)")
    p.add_argument("--sensor", default="LMS100",
                   choices=sorted(["TIM500", "LMS100", "LMS100C", "VLP16"]))
    p.add_argument("--calibration", default=None,
                   help="m3d_calibration.yaml path (default: $ROS_HOME)")
    p.add_argument("--scans", type=int, default=None,
                   help="stop after N emitted 3D scans")
    p.add_argument("--no-slam", action="store_true",
                   help="aggregate only (the reference's aggregator-only "
                        "bringup)")
    add_common_args(p)
    args = p.parse_args(argv)
    enable_compile_cache()

    slam_cfg = apply_overrides(SLAMConfig(), args.set)
    live_cfg = LiveConfig(
        sensor_model=args.sensor,
        aggregator=AggregatorConfig(line_length=1024))

    chain = FrameChain(sensor=SensorModel.by_name(args.sensor),
                       calibration=Calibration.load(args.calibration))

    m3d = NativeM3d()
    if args.m3d_serial:
        m3d.connect_serial(args.m3d_serial)
    elif args.m3d_host:
        m3d.connect_tcp(args.m3d_host, args.m3d_port)
    else:
        raise SystemExit("need --m3d-host or --m3d-serial")
    m3d.set_speed(args.speed)

    lms = NativeLms(cap=live_cfg.line_capacity)
    lms.connect(args.lms_host, args.lms_port)
    lms.start_scan()

    slam = None if args.no_slam else SLAMSystem(slam_cfg)
    pipe = LivePipeline(live_cfg, chain=chain, slam=slam)

    def on_scan(cloud, metrics):
        import dataclasses as dc

        import numpy as np
        rec = {"n_points": int(np.sum(np.asarray(cloud.mask)))}
        if metrics is not None:
            rec.update(dc.asdict(metrics))
        print(json.dumps(rec), flush=True)

    try:
        results = pipe.run(lms, angle_source=m3d.angle,
                           max_scans=args.scans, on_scan=on_scan)
        emit({"n_scans": len(results)}, args.json)
    finally:
        try:
            m3d.set_speed(0)
        except ConnectionError:
            pass
        lms.close()
        m3d.close()


if __name__ == "__main__":
    main()
