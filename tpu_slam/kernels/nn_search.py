"""Nearest-neighbor search.

Two strategies replace the reference's CUDA grid-decomposition NN kernel
and PCL KdTreeFLANN (m3d_calibration_twiddle.cpp:288-306):

1. **Tiled brute force** — for scan-to-scan ICP after voxel downsampling
   (both clouds ~1e4 points). Query chunks of ``chunk`` rows sweep the
   whole target under ``lax.map``; XLA fuses the difference-form squared
   distances with the row min/argmin, so no (N, M) matrix is stored.

2. **Grid-hash candidates** — for scan-to-map with large targets. The
   target is sorted by voxel key (kernels.voxel_hash); each query probes its
   27-cell neighborhood with a binary search over the sorted keys and gathers
   up to ``k_per_cell`` candidates per cell. Exact within radius = leaf when
   the target has at most k_per_cell points per cell (guaranteed for
   voxel-downsampled targets with k_per_cell >= 1).

Padding points are parked at PAD_COORD (1e8), so they lose every distance
comparison and never need explicit masking inside the hot loops.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from tpu_slam.core.pointcloud import PointCloud
from tpu_slam.kernels.voxel_hash import (
    INVALID_KEY,
    VoxelGridSpec,
    neighbor_offsets_keys,
    voxel_keys,
)

_BIG = 3.0e38


def _pad_rows(x: jax.Array, multiple: int, value: float) -> jax.Array:
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x
    pad = jnp.full((rem,) + x.shape[1:], value, dtype=x.dtype)
    return jnp.concatenate([x, pad], axis=0)


# ---------------------------------------------------------------------------
# 1. Tiled brute force
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("chunk",))
def nearest_neighbors(query: jax.Array, target: jax.Array, chunk: int = 512
                      ) -> Tuple[jax.Array, jax.Array]:
    """For each query point, the index and distance of its nearest target.

    Args:
      query: (N, 3) float32. Padding rows must sit at PAD_COORD.
      target: (M, 3) float32. Padding rows must sit at PAD_COORD.
      chunk: query rows per sweep of the target.

    Returns:
      (idx (N,) int32 into target, dist (N,) float32). Padding queries get
      garbage results; callers mask by the query's validity mask.
    """
    nq = query.shape[0]
    q = _pad_rows(query, chunk, 1.0e8)

    def one_chunk(qc):
        # squared distances by explicit difference (precise at cm scale,
        # unlike the |q|^2 + |t|^2 - 2qt form, which cancels)
        d = jnp.zeros((qc.shape[0], target.shape[0]), dtype=jnp.float32)
        for c in range(3):
            diff = qc[:, c:c + 1] - target[None, :, c]
            d = d + diff * diff
        return jnp.argmin(d, axis=1).astype(jnp.int32), jnp.min(d, axis=1)

    qs = q.reshape(-1, chunk, 3)
    idx, d2 = jax.lax.map(one_chunk, qs)
    idx = idx.reshape(-1)[:nq]
    d2 = d2.reshape(-1)[:nq]
    return idx, jnp.sqrt(jnp.maximum(d2, 0.0))


# ---------------------------------------------------------------------------
# 2. Grid-hash candidate search — for large targets (scan-to-map)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("spec", "k_per_cell"))
def nearest_neighbors_hash(
    query: jax.Array,
    sorted_keys: jax.Array,
    sorted_target: jax.Array,
    spec: VoxelGridSpec,
    k_per_cell: int = 2,
) -> Tuple[jax.Array, jax.Array]:
    """Grid-hash NN: 27-cell probe over a key-sorted target.

    Args:
      query: (N, 3) float32 query points.
      sorted_keys: (M,) int32 voxel keys of the target, ascending
        (kernels.voxel_hash.sort_by_key output).
      sorted_target: (M, 3) float32 target points in sorted order.
      spec: the voxel grid the keys were computed under. Exactness radius is
        one leaf; pick leaf >= the ICP match radius.
      k_per_cell: candidates gathered per neighboring cell.

    Returns:
      (idx (N,) int32 into the *sorted* target, dist (N,) float32).
      Queries with no candidate in their 27-neighborhood get dist=+inf, idx=-1.
    """
    m = sorted_target.shape[0]
    qcloud = PointCloud(points=query, mask=jnp.ones(query.shape[0], bool))
    qkeys = voxel_keys(qcloud, spec)
    nkeys = neighbor_offsets_keys(qkeys, spec)          # (N, 27)

    starts = jnp.searchsorted(sorted_keys, nkeys)        # (N, 27)
    # Candidate index block: (N, 27, K)
    offs = jnp.arange(k_per_cell, dtype=jnp.int32)
    cand = starts[..., None] + offs                      # (N, 27, K)
    cand = jnp.clip(cand, 0, m - 1)
    cand_keys = jnp.take(sorted_keys, cand)              # (N, 27, K)
    ok = (cand_keys == nkeys[..., None]) & (nkeys[..., None] != INVALID_KEY)

    cand_pts = jnp.take(sorted_target, cand.reshape(cand.shape[0], -1), axis=0)
    cand_pts = cand_pts.reshape(cand.shape + (3,))       # (N, 27, K, 3)
    diff = cand_pts - query[:, None, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    d2 = jnp.where(ok, d2, _BIG)

    d2f = d2.reshape(d2.shape[0], -1)
    candf = cand.reshape(cand.shape[0], -1)
    best = jnp.argmin(d2f, axis=1)
    best_d2 = jnp.take_along_axis(d2f, best[:, None], axis=1)[:, 0]
    best_i = jnp.take_along_axis(candf, best[:, None], axis=1)[:, 0]
    found = best_d2 < _BIG
    idx = jnp.where(found, best_i, -1)
    dist = jnp.where(found, jnp.sqrt(jnp.maximum(best_d2, 0.0)), jnp.inf)
    return idx, dist
