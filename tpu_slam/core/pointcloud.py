"""Fixed-capacity padded point clouds — the XLA-friendly cloud representation.

XLA requires static shapes; LiDAR scans are variable-size. Every cloud in
tpu_slam is therefore a fixed-capacity ``(N, 3)`` array plus a boolean
validity mask. All kernels respect the mask; padding points are parked at a
far sentinel coordinate so that distance-based logic naturally ignores them.

This replaces the reference's pcl::PointCloud<pcl::PointXYZ> (dynamic vectors,
e.g. m3d/m3d_aggregator/src/m3d_aggregator.cpp:22-143) with a pytree suitable
for jit / vmap / shard_map.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

# Padding points live here: far outside any plausible scene so that radius
# and nearest-neighbor logic rejects them by distance alone.
PAD_COORD = 1.0e8


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PointCloud:
    """Padded point cloud.

    Attributes:
      points: (N, 3) float array; invalid rows hold PAD_COORD sentinels.
      mask:   (N,) bool; True where the row is a real point.
      attrs:  optional (N, A) float array of per-point attributes
              (intensity, ring, time-offset...). Zero where invalid.
    """

    points: jax.Array
    mask: jax.Array
    attrs: Optional[jax.Array] = None

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def count(self) -> jax.Array:
        return jnp.sum(self.mask.astype(jnp.int32))

    @staticmethod
    def from_points(points: jax.Array, capacity: Optional[int] = None,
                    attrs: Optional[jax.Array] = None) -> "PointCloud":
        """Build from a dense (M, 3) array, padding up to ``capacity``."""
        m = points.shape[0]
        n = capacity if capacity is not None else m
        if m > n:
            raise ValueError(f"{m} points exceed capacity {n}")
        pad = jnp.full((n - m, 3), PAD_COORD, dtype=points.dtype)
        pts = jnp.concatenate([points, pad], axis=0)
        mask = jnp.arange(n) < m
        a = None
        if attrs is not None:
            pad_a = jnp.zeros((n - m, attrs.shape[1]), dtype=attrs.dtype)
            a = jnp.concatenate([attrs, pad_a], axis=0)
        return PointCloud(points=pts, mask=mask, attrs=a)

    @staticmethod
    def from_points_host(points, capacity: int,
                         attrs=None) -> "PointCloud":
        """Build from a HOST (numpy) (M, 3) array, padding in numpy.

        The eager-jnp ``from_points`` dispatches shape-(M,...) pad ops per
        call, and every distinct M compiles anew.  Padding on the host
        uploads one fixed-shape buffer instead.
        """
        import numpy as np

        pts = np.asarray(points, np.float32)
        m = pts.shape[0]
        if m > capacity:
            raise ValueError(f"{m} points exceed capacity {capacity}")
        out = np.full((capacity, 3), PAD_COORD, np.float32)
        out[:m] = pts
        mask = np.zeros((capacity,), bool)
        mask[:m] = True
        a = None
        if attrs is not None:
            attrs = np.asarray(attrs)
            a = np.zeros((capacity, attrs.shape[1]), attrs.dtype)
            a[:m] = attrs
            a = jnp.asarray(a)
        return PointCloud(points=jnp.asarray(out), mask=jnp.asarray(mask),
                          attrs=a)

    def transform(self, T: jax.Array) -> "PointCloud":
        from tpu_slam.core import se3
        pts = se3.apply(T, self.points)
        pts = jnp.where(self.mask[:, None], pts, PAD_COORD)
        return dataclasses.replace(self, points=pts)

    def sanitize(self) -> "PointCloud":
        """Force invalid rows onto the sentinel (idempotent)."""
        pts = jnp.where(self.mask[:, None], self.points, PAD_COORD)
        return dataclasses.replace(self, points=pts)

    def filter(self, keep: jax.Array) -> "PointCloud":
        """AND the mask with ``keep`` and re-sanitize. Static shape preserved."""
        mask = jnp.logical_and(self.mask, keep)
        pts = jnp.where(mask[:, None], self.points, PAD_COORD)
        return dataclasses.replace(self, points=pts, mask=mask)

    def compact(self) -> "PointCloud":
        """Stable-sort valid points to the front (same capacity).

        Sort-based compaction, never a dynamic-shape gather: static shapes
        firm up occupancy before bucketed kernels.
        """
        order = jnp.argsort(jnp.logical_not(self.mask), stable=True)
        pts = jnp.take(self.points, order, axis=0)
        mask = jnp.take(self.mask, order, axis=0)
        attrs = None if self.attrs is None else jnp.take(self.attrs, order, axis=0)
        return PointCloud(points=pts, mask=mask, attrs=attrs)


def exclusion_box_filter(cloud: PointCloud, box_min: jax.Array,
                         box_max: jax.Array) -> PointCloud:
    """Robot self-filter: KEEP points OUTSIDE the axis-aligned box.

    Preserves the reference's inverted bounding-box semantics
    (m3d_aggregator.cpp:65-73: points inside the box around the robot are
    discarded; everything outside is kept).
    """
    inside = jnp.all(
        jnp.logical_and(cloud.points >= box_min, cloud.points <= box_max),
        axis=-1)
    return cloud.filter(jnp.logical_not(inside))


def range_filter(cloud: PointCloud, min_range: float, max_range: float,
                 origin: Optional[jax.Array] = None) -> PointCloud:
    """Keep points whose range from ``origin`` lies in [min_range, max_range].

    Mirrors the Velodyne driver's min/max_range config
    (universal_velodyne.launch:54: 0.4-130 m).
    """
    pts = cloud.points if origin is None else cloud.points - origin
    r2 = jnp.sum(pts * pts, axis=-1)
    keep = jnp.logical_and(r2 >= min_range * min_range, r2 <= max_range * max_range)
    return cloud.filter(keep)


def merge(a: PointCloud, b: PointCloud) -> PointCloud:
    """Concatenate two padded clouds (capacity = sum of capacities)."""
    pts = jnp.concatenate([a.points, b.points], axis=0)
    mask = jnp.concatenate([a.mask, b.mask], axis=0)
    attrs = None
    if a.attrs is not None and b.attrs is not None:
        attrs = jnp.concatenate([a.attrs, b.attrs], axis=0)
    return PointCloud(points=pts, mask=mask, attrs=attrs)
