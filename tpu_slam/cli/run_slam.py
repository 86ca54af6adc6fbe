"""Run the full 6D SLAM pipeline over a recorded sequence.

Supports checkpointing every K scans and resuming from a checkpoint —
SURVEY.md §5's checkpoint/resume obligation.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from tpu_slam.cli.common import add_common_args, apply_overrides, emit
from tpu_slam.ingest.dataset import DatasetReader
from tpu_slam.pipeline.checkpoint import load_checkpoint, save_checkpoint
from tpu_slam.pipeline.config import SLAMConfig
from tpu_slam.pipeline.metrics import ate_rmse
from tpu_slam.pipeline.slam import SLAMSystem
from tpu_slam.utils.compile_cache import enable_compile_cache


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--dataset", required=True)
    p.add_argument("--out", default=None, help="output dir (trajectory, map)")
    p.add_argument("--checkpoint", default=None, help="checkpoint path")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save checkpoint every K scans (0 = off)")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint")
    p.add_argument("--input-capacity", type=int, default=32768)
    add_common_args(p)
    args = p.parse_args(argv)
    enable_compile_cache()

    import jax.numpy as jnp
    from tpu_slam.core.pointcloud import PointCloud

    cfg = apply_overrides(SLAMConfig(), args.set)
    reader = DatasetReader(args.dataset)
    slam = SLAMSystem(cfg)

    gt = reader.gt_poses()
    start = 0
    if args.resume:
        if not (args.checkpoint and os.path.exists(args.checkpoint)):
            raise SystemExit("--resume requires an existing --checkpoint")
        state, manifest = load_checkpoint(args.checkpoint)
        start = manifest["scan_index"]
    else:
        init = jnp.asarray(gt[0], jnp.float32) if gt is not None else None
        state = slam.init_state(init)

    poses = []
    for k in range(start, len(reader)):
        rec = reader[k]
        cloud = PointCloud.from_points(
            jnp.asarray(rec.points[rec.mask]), capacity=args.input_capacity)
        state, m = slam.step(state, cloud)
        poses.append(np.asarray(state.odom.pose))
        if (args.checkpoint and args.checkpoint_every
                and (k + 1) % args.checkpoint_every == 0):
            save_checkpoint(args.checkpoint, state, scan_index=k + 1)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, state, scan_index=len(reader))

    poses = np.stack(poses) if poses else np.zeros((0, 4, 4))
    summary = dict(slam.metrics.summary())
    summary.update(n_keyframes=state.n_keyframes,
                   n_loop_closures=state.n_loop_closures)
    if gt is not None and start == 0 and len(poses) == len(reader):
        summary["ate_rmse_m"] = ate_rmse(poses, gt, align=False)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        np.savez_compressed(os.path.join(args.out, "trajectory.npz"),
                            poses=poses)
        np.savez_compressed(
            os.path.join(args.out, "map.npz"),
            keys=np.asarray(state.odom.vmap.keys),
            count=np.asarray(state.odom.vmap.count),
            sum_pts=np.asarray(state.odom.vmap.sum_pts))
        summary["out"] = args.out
    emit(summary, args.json)


if __name__ == "__main__":
    main()
