"""Voxel-centroid downsampling via sorted segment reductions.

Replacement for PCL's VoxelGrid filter
(m3d_calibration_twiddle.cpp:279-286 downsamples with a 0.1 m leaf before the
overlap cost). Instead of hash maps: sort points by voxel key, reduce each
run of equal keys with segment_sum (deterministic reduction order — fixed
summation order over the sorted layout, which keeps results reproducible
across runs, a requirement SURVEY.md §7.3 calls out).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from tpu_slam.core.pointcloud import PAD_COORD, PointCloud
from tpu_slam.kernels.voxel_hash import (
    INVALID_KEY,
    VoxelGridSpec,
    segment_ids_from_sorted_keys,
    sort_by_key,
)


def voxel_downsample(cloud: PointCloud, spec: VoxelGridSpec,
                     capacity: Optional[int] = None) -> PointCloud:
    """One centroid point per occupied voxel.

    Output capacity defaults to the input capacity (the worst case of one
    point per voxel). Static shapes throughout; occupied-voxel centroids are
    compacted to the front of the output buffer.
    """
    n = cloud.capacity
    out_n = capacity if capacity is not None else n

    skeys, sorted_cloud = sort_by_key(cloud, spec)
    seg_ids, is_start = segment_ids_from_sorted_keys(skeys)
    valid = skeys != INVALID_KEY

    w = valid.astype(cloud.points.dtype)
    pts = jnp.where(valid[:, None], sorted_cloud.points, 0.0)
    sums = jax.ops.segment_sum(pts, seg_ids, num_segments=n)
    counts = jax.ops.segment_sum(w, seg_ids, num_segments=n)

    # A segment is a real voxel iff its first element has a valid key.
    seg_valid = jax.ops.segment_max(
        jnp.where(is_start & valid, 1, 0), seg_ids, num_segments=n) > 0

    safe = jnp.maximum(counts, 1.0)
    centroids = sums / safe[:, None]
    centroids = jnp.where(seg_valid[:, None], centroids, PAD_COORD)

    attrs = None
    if sorted_cloud.attrs is not None:
        # per-voxel attribute mean (intensity etc.) — the channel the
        # reference delivers as RSSI (m3d_aggregator.cpp:269-286) survives
        # downsampling instead of being dropped here
        a = jnp.where(valid[:, None], sorted_cloud.attrs, 0.0)
        attrs = jax.ops.segment_sum(a, seg_ids, num_segments=n) / safe[:, None]
        attrs = jnp.where(seg_valid[:, None], attrs, 0.0)

    out = PointCloud(points=centroids, mask=seg_valid, attrs=attrs)
    out = out.compact()
    if out_n != n:
        def fit(x, fill):
            if out_n < n:
                return x[:out_n]
            pad = jnp.full((out_n - n,) + x.shape[1:], fill, x.dtype)
            return jnp.concatenate([x, pad])
        out = PointCloud(points=fit(out.points, PAD_COORD),
                         mask=fit(out.mask, False),
                         attrs=None if out.attrs is None
                         else fit(out.attrs, 0.0))
    return out
