"""Run scan-to-map odometry over a recorded sequence."""

from __future__ import annotations

import argparse

import numpy as np

from tpu_slam.cli.common import add_common_args, apply_overrides, emit
from tpu_slam.ingest.dataset import DatasetReader
from tpu_slam.pipeline.config import OdometryConfig
from tpu_slam.pipeline.metrics import ate_rmse, rpe_rmse
from tpu_slam.pipeline.odometry import LidarOdometry
from tpu_slam.utils.compile_cache import enable_compile_cache


def _clouds_from_dataset(reader, capacity):
    import jax.numpy as jnp
    from tpu_slam.core.pointcloud import PointCloud
    for rec in reader:
        pts = rec.points[rec.mask]
        yield PointCloud.from_points(jnp.asarray(pts), capacity=capacity)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--dataset", help="npz dataset directory")
    src.add_argument("--bag", help="rosbag V2.0 file (PointCloud2 scans; "
                     "converted in place next to the bag — the reference's "
                     "bag-replay path, universal_velodyne.launch:49,64)")
    p.add_argument("--bag-topic", default=None,
                   help="PointCloud2 topic (default: first found)")
    p.add_argument("--bag-gt-frame", default=None,
                   help="TF parent frame to attach as ground truth")
    p.add_argument("--out", default=None, help="trajectory output .npz")
    p.add_argument("--input-capacity", type=int, default=32768)
    p.add_argument("--engine", choices=["sparse", "dense"],
                   default="sparse",
                   help="odometry engine: 'dense' is the production "
                        "moment-window engine (one donated dispatch per "
                        "scan; requires --set ndt.window_dims=Wx,Wy,Wz)")
    add_common_args(p)
    args = p.parse_args(argv)
    enable_compile_cache()

    import jax.numpy as jnp

    cfg = apply_overrides(OdometryConfig(), args.set)
    dataset = args.dataset
    if args.bag:
        from tpu_slam.ingest.rosbag import bag_to_dataset
        dataset = bag_to_dataset(args.bag, args.bag + ".dataset",
                                 cloud_topic=args.bag_topic,
                                 gt_frame=args.bag_gt_frame)
    reader = DatasetReader(dataset)
    if args.engine == "dense":
        from tpu_slam.pipeline.odometry_dense import DenseLidarOdometry
        odo = DenseLidarOdometry(cfg)
    else:
        odo = LidarOdometry(cfg)

    gt = reader.gt_poses()
    init = jnp.asarray(gt[0], jnp.float32) if gt is not None else None
    poses, log = odo.run(_clouds_from_dataset(reader, args.input_capacity),
                         init_pose=init)

    summary = dict(log.summary())
    if gt is not None:
        summary["ate_rmse_m"] = ate_rmse(poses, gt, align=False)
        rpe_t, rpe_r = rpe_rmse(poses, gt)
        summary["rpe_trans_m"] = rpe_t
        summary["rpe_rot_rad"] = rpe_r
    if args.out:
        np.savez_compressed(args.out, poses=poses,
                            metrics=[m.to_json() for m in log.records])
        summary["trajectory"] = args.out
    emit(summary, args.json)


if __name__ == "__main__":
    main()
