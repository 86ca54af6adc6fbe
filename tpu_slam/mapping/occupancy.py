"""Occupancy (hit/miss log-odds) layered on the voxel map.

The reference's missing CUDA core kept "occupancy/voxel map structures"
(SURVEY.md §2.2). The moments map (voxel_map) already encodes occupancy by
presence; this module adds free-space evidence: ray traversal as a
fixed-step sampling kernel (no per-ray loops — one (N_rays, S) lattice of
sample points, keys, and a segment reduction), with log-odds per voxel.

Sampling instead of exact DDA traversal is the static-shape choice: a
regular (rays x steps) grid of FMAs and gathers, no data-dependent
control flow. Step = leaf/2 guarantees every traversed voxel is sampled
at least once (at the cost of duplicate samples, which the max-reduction
absorbs).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from tpu_slam.core.pointcloud import PointCloud
from tpu_slam.kernels.voxel_hash import (INVALID_KEY, VoxelGridSpec,
                                         cell_coords, pack_key,
                                         segment_ids_from_sorted_keys)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class OccupancyGrid:
    """Sorted occupancy voxels: key + log-odds. Same layout discipline as
    VoxelMap (sorted keys, INVALID tail, merge-sort updates)."""

    keys: jax.Array       # (C,) int32 sorted
    log_odds: jax.Array   # (C,) float32

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    def occupied_mask(self, threshold: float = 0.0) -> jax.Array:
        return (self.keys != INVALID_KEY) & (self.log_odds > threshold)


def empty_occupancy(capacity: int) -> OccupancyGrid:
    return OccupancyGrid(keys=jnp.full((capacity,), INVALID_KEY, jnp.int32),
                         log_odds=jnp.zeros((capacity,), jnp.float32))


@functools.partial(jax.jit,
                   static_argnames=("spec", "n_steps", "max_range"))
def ray_evidence(origin: jax.Array, cloud: PointCloud, spec: VoxelGridSpec,
                 n_steps: int = 128, max_range: float = 30.0,
                 hit_odds: float = 0.85, miss_odds: float = -0.4
                 ) -> Tuple[jax.Array, jax.Array]:
    """Per-voxel log-odds increments from one scan's rays.

    Args:
      origin: (3,) sensor origin in the map frame.
      cloud: endpoint cloud in the map frame (padded).
      spec: occupancy grid spec (step = leaf/2 along each ray).

    Returns (keys (M,), delta_log_odds (M,)) with one entry per touched
    voxel, compacted, INVALID tail — ready for occupancy_update. M =
    cloud.capacity + a fixed budget for free-space voxels.
    """
    pts = cloud.points
    n = pts.shape[0]
    d = pts - origin
    rng = jnp.linalg.norm(d, axis=1)
    rng_c = jnp.minimum(rng, max_range)
    valid = cloud.mask & (rng > 1e-6)

    # free-space samples: fractions strictly inside the ray (exclude the
    # endpoint voxel by stopping one leaf short)
    step = spec.leaf * 0.5
    t = (jnp.arange(n_steps, dtype=jnp.float32) + 0.5) * step   # (S,)
    frac_end = jnp.maximum(rng_c - spec.leaf, 0.0)
    sample_ok = valid[:, None] & (t[None, :] < frac_end[:, None])
    dirs = d / jnp.maximum(rng, 1e-9)[:, None]
    samples = origin + dirs[:, None, :] * t[None, :, None]      # (N, S, 3)
    skeys = pack_key(cell_coords(samples.reshape(-1, 3), spec), spec)
    skeys = jnp.where(sample_ok.reshape(-1), skeys, INVALID_KEY)

    # endpoint (hit) voxels — only for returns within range
    hit_valid = valid & (rng <= max_range)
    hkeys = pack_key(cell_coords(pts, spec), spec)
    hkeys = jnp.where(hit_valid, hkeys, INVALID_KEY)

    all_keys = jnp.concatenate([skeys, hkeys])
    all_delta = jnp.concatenate([
        jnp.full((n * n_steps,), miss_odds, jnp.float32),
        jnp.full((n,), hit_odds, jnp.float32),
    ])
    all_delta = jnp.where(all_keys == INVALID_KEY, 0.0, all_delta)

    # reduce duplicates: sort by key; per voxel, a hit overrides misses
    # (endpoint evidence wins over grazing free-space samples)
    order = jnp.argsort(all_keys, stable=True)
    k = jnp.take(all_keys, order)
    dl = jnp.take(all_delta, order)
    m = k.shape[0]
    seg_ids, is_start = segment_ids_from_sorted_keys(k)
    seg_max = jax.ops.segment_max(dl, seg_ids, num_segments=m)
    seg_min = jax.ops.segment_min(dl, seg_ids, num_segments=m)
    # hit present -> +hit_odds; else miss -> miss_odds (single application
    # per scan per voxel: bounded per-scan evidence, standard practice)
    seg_delta = jnp.where(seg_max > 0, seg_max, seg_min)
    seg_key = jax.ops.segment_max(
        jnp.where(is_start & (k != INVALID_KEY), k, jnp.int32(-2147483648)),
        seg_ids, num_segments=m)
    seg_valid = jax.ops.segment_max(
        (k != INVALID_KEY).astype(jnp.int32), seg_ids, num_segments=m) > 0
    out_keys = jnp.where(seg_valid, seg_key, INVALID_KEY)
    out_delta = jnp.where(seg_valid, seg_delta, 0.0)
    order2 = jnp.argsort(~seg_valid, stable=True)
    return jnp.take(out_keys, order2), jnp.take(out_delta, order2)


@functools.partial(jax.jit, donate_argnums=0,
                   static_argnames=("min_log", "max_log"))
def occupancy_update(grid: OccupancyGrid, keys: jax.Array,
                     delta: jax.Array, min_log: float = -4.0,
                     max_log: float = 6.0) -> OccupancyGrid:
    """Merge log-odds evidence (sort-merge-reduce, clamped)."""
    C = grid.capacity
    all_keys = jnp.concatenate([grid.keys, keys])
    all_lo = jnp.concatenate([grid.log_odds, delta])
    order = jnp.argsort(all_keys, stable=True)
    k = jnp.take(all_keys, order)
    lo = jnp.take(all_lo, order)
    m = k.shape[0]
    seg_ids, is_start = segment_ids_from_sorted_keys(k)
    mlo = jax.ops.segment_sum(jnp.where(k != INVALID_KEY, lo, 0.0), seg_ids,
                              num_segments=m)
    mk = jax.ops.segment_max(
        jnp.where(is_start & (k != INVALID_KEY), k, jnp.int32(-2147483648)),
        seg_ids, num_segments=m)
    seg_valid = jax.ops.segment_max(
        (k != INVALID_KEY).astype(jnp.int32), seg_ids, num_segments=m) > 0
    mk = jnp.where(seg_valid, mk, INVALID_KEY)
    mlo = jnp.clip(mlo, min_log, max_log)

    # keep the C strongest-evidence voxels (|log odds|), restore key order
    rank = jnp.where(seg_valid, -jnp.abs(mlo), jnp.inf)
    keep = jnp.argsort(rank, stable=True)[:C]
    kk = jnp.take(mk, keep)
    klo = jnp.take(mlo, keep)
    final = jnp.argsort(kk, stable=True)
    return OccupancyGrid(keys=jnp.take(kk, final),
                         log_odds=jnp.take(klo, final))


def shift_occupancy_cells(grid: OccupancyGrid, spec: VoxelGridSpec,
                          shift: jax.Array) -> OccupancyGrid:
    """Scrolling-window rebase of the occupancy grid (see
    voxel_map.shift_map_cells): cell c -> c - shift, out-of-window voxels
    evicted, ``shift`` traced (no recompiles)."""
    b = spec.dim_bits
    n = spec.cells_per_axis
    keys = grid.keys
    occ = keys != INVALID_KEY
    cx = ((keys >> (2 * b)) & (n - 1)) - shift[0]
    cy = ((keys >> b) & (n - 1)) - shift[1]
    cz = (keys & (n - 1)) - shift[2]
    inb = (occ & (cx >= 0) & (cx < n) & (cy >= 0) & (cy < n)
           & (cz >= 0) & (cz < n))
    new_keys = jnp.where(inb, (cx << (2 * b)) | (cy << b) | cz, INVALID_KEY)
    order = jnp.argsort(new_keys, stable=True)
    return OccupancyGrid(
        keys=jnp.take(new_keys, order),
        log_odds=jnp.take(jnp.where(inb, grid.log_odds, 0.0), order))


def query_log_odds_keys(grid: OccupancyGrid, keys: jax.Array) -> jax.Array:
    """(N,) log-odds for voxel keys; 0 (unknown) where absent."""
    pos = jnp.clip(jnp.searchsorted(grid.keys, keys), 0, grid.capacity - 1)
    hit = (jnp.take(grid.keys, pos) == keys) & (keys != INVALID_KEY)
    return jnp.where(hit, jnp.take(grid.log_odds, pos), 0.0)


@functools.partial(jax.jit, static_argnames=("spec", "n_steps", "max_range",
                                             "evict_below"))
def occupancy_maintain(grid: OccupancyGrid, vmap, origin: jax.Array,
                       cloud: PointCloud, spec: VoxelGridSpec,
                       n_steps: int = 64, max_range: float = 30.0,
                       evict_below: float = -1.0):
    """One scan of free-space maintenance: update log-odds, evict
    seen-through map voxels (dynamic-object removal).

    The occupancy grid shares the NDT map's grid spec so keys compare
    directly. A map voxel whose accumulated log-odds fell below
    ``evict_below`` (rays keep passing through where surface once was)
    is removed from the moments map — its Gaussian no longer attracts
    registration and the space reads as free.

    Returns (grid, vmap, n_evicted) in one dispatch.
    """
    from tpu_slam.mapping.voxel_map import evict_where

    keys, delta = ray_evidence(origin, cloud, spec, n_steps=n_steps,
                               max_range=max_range)
    grid = occupancy_update(grid, keys, delta)
    lo = query_log_odds_keys(grid, vmap.keys)
    drop = (vmap.keys != INVALID_KEY) & (lo < evict_below)
    return grid, evict_where(vmap, drop), jnp.sum(drop.astype(jnp.int32))


def occupancy_probability(grid: OccupancyGrid) -> jax.Array:
    """(C,) occupancy probability from log odds."""
    return jax.nn.sigmoid(grid.log_odds)


def query_occupancy(grid: OccupancyGrid, points: jax.Array,
                    spec: VoxelGridSpec) -> jax.Array:
    """(N,) log-odds at query points; 0 (unknown) where no voxel exists."""
    keys = pack_key(cell_coords(points, spec), spec)
    pos = jnp.clip(jnp.searchsorted(grid.keys, keys), 0, grid.capacity - 1)
    hit = (jnp.take(grid.keys, pos) == keys) & (keys != INVALID_KEY)
    return jnp.where(hit, jnp.take(grid.log_odds, pos), 0.0)
