"""Sort-based voxel grid hashing — a substitute for trees and pointers.

The reference's SLAM core used CUDA regular-grid decomposition for NN search
(BASELINE.json north_star; the m3d calibration nodes use PCL KdTreeFLANN,
m3d_calibration_twiddle.cpp:288-306). KD-trees do not map onto XLA; a regular
grid with *sorted* keys does:

  1. quantize each point to an integer cell coordinate,
  2. pack the 3 cell coordinates into one int32 key,
  3. sort points by key (jnp.argsort),
  4. find any cell's run of points with a binary search over the sorted keys.

Everything downstream (voxel downsample, NDT stats, grid-hash NN) rides on
this representation. Keys are collision-free inside a bounded grid
(2^10 cells per axis by default => 30-bit keys in int32); out-of-bounds
points are masked invalid rather than wrapped, so no aliasing ever occurs.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from tpu_slam.core.pointcloud import PointCloud

# Invalid/padding points get the maximum key so they sort to the end.
INVALID_KEY = jnp.iinfo(jnp.int32).max


@dataclasses.dataclass(frozen=True)
class VoxelGridSpec:
    """Static description of a bounded voxel grid.

    Attributes:
      leaf: voxel edge length in meters.
      origin: (3,) world coordinate of grid corner (cell [0,0,0]).
      dim_bits: bits per axis; grid has 2**dim_bits cells per axis.
              3 * dim_bits must be <= 31 to fit an int32 key.
    """

    leaf: float
    origin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    dim_bits: int = 10

    def __post_init__(self):
        if 3 * self.dim_bits > 31:
            raise ValueError("3 * dim_bits must fit in int32")

    @property
    def cells_per_axis(self) -> int:
        return 1 << self.dim_bits

    @property
    def extent(self) -> float:
        return self.leaf * self.cells_per_axis

    @staticmethod
    def centered(leaf: float, half_extent: float,
                 max_bits: int = 10) -> "VoxelGridSpec":
        """Grid centered on the world origin covering [-half_extent, +half_extent].

        Raises ValueError when the request needs more than ``max_bits`` cells
        per axis (int32 keys cap the grid at 2^10 per axis): a silently
        shrunken grid would mask away out-of-range points and report them as
        misses. City-scale maps at fine leaves should use a scrolling window
        (re-center the spec origin on the vehicle) or a coarser leaf instead.
        """
        bits = 1
        while leaf * (1 << bits) < 2.0 * half_extent:
            bits += 1
        if bits > max_bits:
            raise ValueError(
                f"grid of half_extent={half_extent} at leaf={leaf} needs "
                f"2^{bits} cells/axis > the 2^{max_bits} int32-key cap; use a "
                f"coarser leaf (>= {2.0 * half_extent / (1 << max_bits):.3f}) "
                f"or a scrolling window centered on the trajectory")
        ext = leaf * (1 << bits)
        return VoxelGridSpec(leaf=leaf, origin=(-ext / 2, -ext / 2, -ext / 2),
                             dim_bits=bits)


def cell_coords(points: jax.Array, spec: VoxelGridSpec) -> jax.Array:
    """(N, 3) points -> (N, 3) int32 cell coordinates (may be out of bounds)."""
    origin = jnp.asarray(spec.origin, dtype=points.dtype)
    return jnp.floor((points - origin) / spec.leaf).astype(jnp.int32)


def pack_key(coords: jax.Array, spec: VoxelGridSpec) -> jax.Array:
    """Pack (N, 3) int cell coords into int32 keys; out-of-bounds -> INVALID_KEY."""
    n = spec.cells_per_axis
    in_bounds = jnp.all(jnp.logical_and(coords >= 0, coords < n), axis=-1)
    b = spec.dim_bits
    key = (coords[..., 0] << (2 * b)) | (coords[..., 1] << b) | coords[..., 2]
    return jnp.where(in_bounds, key, INVALID_KEY)


def neighbor_offsets_keys(key: jax.Array, spec: VoxelGridSpec) -> jax.Array:
    """Keys of the 27 cells in the 3x3x3 neighborhood of each key.

    key: (...,) int32 valid keys. Returns (..., 27) int32; neighbors that fall
    outside the grid are INVALID_KEY. This is the analog of the CUDA
    grid-decomposition 27-cell probe.
    """
    b = spec.dim_bits
    n = spec.cells_per_axis
    ix = key >> (2 * b)
    iy = (key >> b) & (n - 1)
    iz = key & (n - 1)
    d = jnp.array([-1, 0, 1], dtype=jnp.int32)
    dx, dy, dz = jnp.meshgrid(d, d, d, indexing="ij")
    offs = jnp.stack([dx.ravel(), dy.ravel(), dz.ravel()], axis=-1)  # (27, 3)
    cx = ix[..., None] + offs[:, 0]
    cy = iy[..., None] + offs[:, 1]
    cz = iz[..., None] + offs[:, 2]
    ok = ((cx >= 0) & (cx < n) & (cy >= 0) & (cy < n) & (cz >= 0) & (cz < n)
          & (key[..., None] != INVALID_KEY))
    nkey = (cx << (2 * b)) | (cy << b) | cz
    return jnp.where(ok, nkey, INVALID_KEY)


def voxel_keys(cloud: PointCloud, spec: VoxelGridSpec) -> jax.Array:
    """(N,) int32 voxel key per point; invalid points -> INVALID_KEY."""
    coords = cell_coords(cloud.points, spec)
    key = pack_key(coords, spec)
    return jnp.where(cloud.mask, key, INVALID_KEY)


def sort_by_key(cloud: PointCloud, spec: VoxelGridSpec
                ) -> Tuple[jax.Array, PointCloud]:
    """Sort a cloud by voxel key. Returns (sorted_keys, sorted_cloud).

    Invalid points sort to the tail (INVALID_KEY). The sorted representation
    is what grid-hash NN and segment reductions consume.
    """
    keys = voxel_keys(cloud, spec)
    order = jnp.argsort(keys, stable=True)
    skeys = jnp.take(keys, order)
    pts = jnp.take(cloud.points, order, axis=0)
    mask = jnp.take(cloud.mask, order, axis=0)
    attrs = None if cloud.attrs is None else jnp.take(cloud.attrs, order, axis=0)
    return skeys, PointCloud(points=pts, mask=mask, attrs=attrs)


def segment_ids_from_sorted_keys(sorted_keys: jax.Array
                                 ) -> Tuple[jax.Array, jax.Array]:
    """Dense segment ids for runs of equal sorted keys.

    Returns (segment_ids, is_segment_start). Invalid-key tail points share the
    trailing segment ids; callers must mask them out via the key itself.
    """
    is_start = jnp.concatenate([
        jnp.ones((1,), dtype=bool),
        sorted_keys[1:] != sorted_keys[:-1],
    ])
    seg_ids = jnp.cumsum(is_start.astype(jnp.int32)) - 1
    return seg_ids, is_start
