"""Sorted-voxel-list map with per-voxel Gaussian statistics.

The reference's missing CUDA core kept GPU voxel structures for NDT matching
and occupancy (SURVEY.md §2.2). This design avoids device hash
tables with pointers entirely:

  * the map is a fixed-capacity array of voxels **sorted by packed cell
    key** (kernels.voxel_hash), empty tail at INVALID_KEY;
  * each voxel carries first/second moments (count, sum, sum of outer
    products) so mean and covariance — and from them NDT Gaussians and
    surface normals — are derivable at any time;
  * insertion = aggregate the incoming scan per voxel (sorted segment_sum),
    concatenate with the map, sort, segment-reduce duplicates, compact:
    pure data-parallel primitives XLA pipelines well, with deterministic
    reduction order (SURVEY.md §7.3);
  * when over capacity, voxels are evicted by oldest update stamp —
    the bounded-capacity knob SURVEY.md §7.3 accepts;
  * lookup is binary search (searchsorted) over the sorted keys — the same
    access path kernels.nn_search.nearest_neighbors_hash uses.

Moments are accumulated in float32; at leaf sizes ~0.1-1 m and counts
<< 1e6 per voxel this holds millimeter-accurate covariances because moments
are taken about the voxel-local origin (points are stored relative to each
voxel's corner, keeping magnitudes ~leaf instead of ~world extent).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from tpu_slam.core.pointcloud import PAD_COORD, PointCloud
from tpu_slam.kernels.voxel_hash import (
    INVALID_KEY,
    VoxelGridSpec,
    segment_ids_from_sorted_keys,
    voxel_keys,
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class VoxelMap:
    """Fixed-capacity sorted voxel map. All arrays length ``capacity``.

    ``sum_pts``/``sum_outer`` are moments of points *relative to the voxel's
    corner coordinate* (decode_corner), for float32 accuracy.
    """

    keys: jax.Array        # (C,) int32 sorted ascending; INVALID_KEY = empty
    count: jax.Array       # (C,) float32 number of integrated points
    sum_pts: jax.Array     # (C, 3) float32 sum of voxel-local coordinates
    sum_outer: jax.Array   # (C, 3, 3) float32 sum of outer products (local)
    stamp: jax.Array       # (C,) float32 last-update time (eviction priority)

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    def n_occupied(self) -> jax.Array:
        return jnp.sum((self.keys != INVALID_KEY).astype(jnp.int32))

    def occupied_mask(self) -> jax.Array:
        return self.keys != INVALID_KEY


def empty_map(capacity: int) -> VoxelMap:
    return VoxelMap(
        keys=jnp.full((capacity,), INVALID_KEY, jnp.int32),
        count=jnp.zeros((capacity,), jnp.float32),
        sum_pts=jnp.zeros((capacity, 3), jnp.float32),
        sum_outer=jnp.zeros((capacity, 3, 3), jnp.float32),
        stamp=jnp.full((capacity,), -jnp.inf, jnp.float32),
    )


def decode_corner(keys: jax.Array, spec: VoxelGridSpec) -> jax.Array:
    """(...,) int32 keys -> (..., 3) float32 world coordinate of cell corner."""
    b = spec.dim_bits
    n = spec.cells_per_axis
    ix = (keys >> (2 * b)) & (n - 1)
    iy = (keys >> b) & (n - 1)
    iz = keys & (n - 1)
    coords = jnp.stack([ix, iy, iz], axis=-1).astype(jnp.float32)
    origin = jnp.asarray(spec.origin, jnp.float32)
    return coords * spec.leaf + origin


@functools.partial(jax.jit, static_argnames=("spec",))
def scan_to_voxel_stats(cloud: PointCloud, spec: VoxelGridSpec
                        ) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Aggregate a cloud into per-voxel moments (voxel-local coordinates).

    Returns (keys (N,), count (N,), sum_pts (N,3), sum_outer (N,3,3)) with
    one leading entry per occupied voxel, INVALID_KEY tail. N = capacity of
    the input cloud (worst case one point per voxel).
    """
    n = cloud.capacity
    keys = voxel_keys(cloud, spec)
    order = jnp.argsort(keys, stable=True)
    skeys = jnp.take(keys, order)
    spts = jnp.take(cloud.points, order, axis=0)
    valid = skeys != INVALID_KEY

    corners = decode_corner(skeys, spec)
    local = jnp.where(valid[:, None], spts - corners, 0.0)
    outer = local[:, :, None] * local[:, None, :]

    seg_ids, is_start = segment_ids_from_sorted_keys(skeys)
    w = valid.astype(jnp.float32)
    cnt = jax.ops.segment_sum(w, seg_ids, num_segments=n)
    ssum = jax.ops.segment_sum(local, seg_ids, num_segments=n)
    souter = jax.ops.segment_sum(outer * w[:, None, None], seg_ids,
                                 num_segments=n)
    seg_key = jax.ops.segment_max(jnp.where(is_start & valid, skeys,
                                            jnp.int32(-2147483648)),
                                  seg_ids, num_segments=n)
    seg_valid = cnt > 0
    out_keys = jnp.where(seg_valid, seg_key, INVALID_KEY)

    # Compact occupied voxels to the front (stable sort by validity).
    order2 = jnp.argsort(~seg_valid, stable=True)
    return (jnp.take(out_keys, order2), jnp.take(cnt, order2),
            jnp.take(ssum, order2, axis=0), jnp.take(souter, order2, axis=0))


@functools.partial(jax.jit, donate_argnums=0)
def insert_scan_stats(vmap: VoxelMap, keys: jax.Array, count: jax.Array,
                      sum_pts: jax.Array, sum_outer: jax.Array,
                      stamp: jax.Array) -> VoxelMap:
    """Merge per-voxel aggregates into the map (sort-merge-reduce-compact).

    Over-capacity resolution: voxels with the *oldest* last-update stamp are
    evicted first; among equal stamps, arbitrary but deterministic.
    """
    C = vmap.capacity
    new_stamp = jnp.where(keys != INVALID_KEY, stamp, -jnp.inf)

    all_keys = jnp.concatenate([vmap.keys, keys])
    all_cnt = jnp.concatenate([vmap.count, count])
    all_sum = jnp.concatenate([vmap.sum_pts, sum_pts], axis=0)
    all_outer = jnp.concatenate([vmap.sum_outer, sum_outer], axis=0)
    all_stamp = jnp.concatenate([vmap.stamp, new_stamp])

    order = jnp.argsort(all_keys, stable=True)
    k = jnp.take(all_keys, order)
    c = jnp.take(all_cnt, order)
    s = jnp.take(all_sum, order, axis=0)
    o = jnp.take(all_outer, order, axis=0)
    st = jnp.take(all_stamp, order)

    m = k.shape[0]
    seg_ids, is_start = segment_ids_from_sorted_keys(k)
    valid = k != INVALID_KEY
    mc = jax.ops.segment_sum(c, seg_ids, num_segments=m)
    ms = jax.ops.segment_sum(s, seg_ids, num_segments=m)
    mo = jax.ops.segment_sum(o, seg_ids, num_segments=m)
    mst = jax.ops.segment_max(jnp.where(valid, st, -jnp.inf), seg_ids,
                              num_segments=m)
    mk = jax.ops.segment_max(jnp.where(is_start & valid, k,
                                       jnp.int32(-2147483648)),
                             seg_ids, num_segments=m)
    seg_valid = mc > 0
    mk = jnp.where(seg_valid, mk, INVALID_KEY)

    # Keep the C most recent voxels: sort by (invalid, -stamp) and truncate,
    # then restore key order for binary-searchability.
    evict_rank = jnp.where(seg_valid, -mst, jnp.inf)
    keep_order = jnp.argsort(evict_rank, stable=True)[:C]
    kk = jnp.take(mk, keep_order)
    kc = jnp.take(mc, keep_order)
    ks = jnp.take(ms, keep_order, axis=0)
    ko = jnp.take(mo, keep_order, axis=0)
    kst = jnp.take(mst, keep_order)

    final = jnp.argsort(kk, stable=True)
    return VoxelMap(
        keys=jnp.take(kk, final),
        count=jnp.take(kc, final),
        sum_pts=jnp.take(ks, final, axis=0),
        sum_outer=jnp.take(ko, final, axis=0),
        stamp=jnp.take(kst, final),
    )


@functools.partial(jax.jit, donate_argnums=0, static_argnames=("new_cap",))
def insert_scan_stats_incremental(vmap: VoxelMap, keys: jax.Array,
                                  count: jax.Array, sum_pts: jax.Array,
                                  sum_outer: jax.Array, stamp: jax.Array,
                                  new_cap: int = 8192) -> VoxelMap:
    """Incremental merge: in-place accumulate hits, gather-merge new keys.

    The full merge (insert_scan_stats) re-sorts capacity+scan keys with the
    whole moment payload every scan. A scan only touches ~1-2k voxels, so
    this path does the minimal work instead, built only from searchsorted,
    small takes and dense elementwise ops:

      1. hits: binary-search each map key in the (sorted, compacted) scan
         aggregates; accumulate moments with a DENSE masked add — no
         scatter;
      2. new keys: compact the first ``new_cap`` misses, then MERGE BY
         GATHER — for output slot k, count new keys placed at or before k
         via searchsorted and select from either the old map or the new
         rows; both source orders are monotone so no sort is needed;
      3. over-capacity or >new_cap new keys (cold start): fall back to the
         exact full merge inside lax.cond — same results, rare.

    Keeps the sorted-keys/INVALID-tail invariant exactly.
    """
    C = vmap.capacity
    s_cap = keys.shape[0]
    valid = keys != INVALID_KEY
    occ = vmap.occupied_mask()

    # -- 1. hits ------------------------------------------------------------
    pos = jnp.clip(jnp.searchsorted(keys, vmap.keys), 0, s_cap - 1)
    hit = (jnp.take(keys, pos) == vmap.keys) & occ
    upd_cnt = jnp.take(count, pos)
    upd_sum = jnp.take(sum_pts, pos, axis=0)
    upd_out = jnp.take(sum_outer, pos, axis=0)
    h = hit.astype(jnp.float32)
    new_count = vmap.count + h * upd_cnt
    new_sum = vmap.sum_pts + h[:, None] * upd_sum
    new_outer = vmap.sum_outer + h[:, None, None] * upd_out
    new_stamp = jnp.where(hit, jnp.maximum(vmap.stamp, stamp), vmap.stamp)

    # -- 2. new keys --------------------------------------------------------
    mpos = jnp.clip(jnp.searchsorted(vmap.keys, keys), 0, C - 1)
    found = jnp.take(vmap.keys, mpos) == keys
    is_new = valid & ~found
    n_new = jnp.sum(is_new.astype(jnp.int32))
    n_occ = jnp.sum(occ.astype(jnp.int32))
    new_cap = min(new_cap, s_cap)
    overflow = (n_new > new_cap) | (n_occ + n_new > C)

    # compact the first new_cap new rows (already key-sorted)
    order = jnp.argsort(~is_new, stable=True)[:new_cap]
    nk = jnp.where(jnp.take(is_new, order), jnp.take(keys, order),
                   INVALID_KEY)
    nc = jnp.take(count, order)
    ns = jnp.take(sum_pts, order, axis=0)
    no = jnp.take(sum_outer, order, axis=0)

    def merged() -> VoxelMap:
        # destination of new row j: its insertion point among old keys plus
        # its own rank; INVALID rows land past the end and are never read
        ins = jnp.searchsorted(vmap.keys, nk).astype(jnp.int32)
        rank = jnp.arange(new_cap, dtype=jnp.int32)
        dest = jnp.where(nk != INVALID_KEY, ins + rank, C + new_cap)
        k_out = jnp.arange(C, dtype=jnp.int32)
        r = jnp.searchsorted(dest, k_out).astype(jnp.int32)   # 'left'
        rc = jnp.clip(r, 0, new_cap - 1)
        take_new = jnp.take(dest, rc) == k_out
        msrc = jnp.clip(k_out - r, 0, C - 1)

        def pick(new_a, old_a):
            nv = jnp.take(new_a, rc, axis=0)
            ov = jnp.take(old_a, msrc, axis=0)
            m = take_new.reshape((-1,) + (1,) * (new_a.ndim - 1))
            return jnp.where(m, nv, ov)

        return VoxelMap(
            keys=pick(nk, vmap.keys),
            count=pick(nc, new_count),
            sum_pts=pick(ns, new_sum),
            sum_outer=pick(no, new_outer),
            stamp=pick(jnp.where(nk != INVALID_KEY, stamp, -jnp.inf),
                       new_stamp))

    def fallback() -> VoxelMap:
        # exact full merge of ALL aggregates into the original (pre-hit)
        # map values — the dense adds above are separate traced values, so
        # vmap.* still names the inputs here
        return insert_scan_stats(vmap, keys, count, sum_pts, sum_outer,
                                 stamp)

    return jax.lax.cond(overflow, fallback, merged)


def build_map_host(points: "np.ndarray", spec: VoxelGridSpec,
                   capacity: int, stamp: float = 0.0) -> VoxelMap:
    """Bulk map construction from a host point array (numpy, exact).

    The offline/bench path: assembling a city-scale map by repeated
    device-side sort-merges costs minutes at millions of points (the
    (N, 3, 3) payload gathers of the full merge lower poorly); one numpy
    sort + reduceat builds the same VoxelMap in ~a second.  Per-scan live
    insertion stays on device (insert_scan_stats_incremental).
    """
    import numpy as np

    pts = np.asarray(points, np.float32)
    n = spec.cells_per_axis
    b = spec.dim_bits
    origin = np.asarray(spec.origin, np.float32)
    cc = np.floor((pts - origin) / spec.leaf).astype(np.int64)
    ok = np.all((cc >= 0) & (cc < n), axis=1)
    pts, cc = pts[ok], cc[ok]
    key = (cc[:, 0] << (2 * b)) | (cc[:, 1] << b) | cc[:, 2]
    order = np.argsort(key, kind="stable")
    key, pts, cc = key[order], pts[order], cc[order]
    uk, start, cnt = np.unique(key, return_index=True, return_counts=True)
    if len(uk) > capacity:
        raise ValueError(f"{len(uk)} occupied voxels > capacity {capacity}")
    corners = cc.astype(np.float32) * spec.leaf + origin
    local = (pts - corners).astype(np.float64)
    outer = local[:, :, None] * local[:, None, :]
    ssum = np.add.reduceat(local, start, axis=0)
    souter = np.add.reduceat(outer.reshape(-1, 9), start, axis=0)

    C = capacity
    keys = np.full(C, np.iinfo(np.int32).max, np.int32)
    count = np.zeros(C, np.float32)
    sum_pts = np.zeros((C, 3), np.float32)
    sum_outer = np.zeros((C, 3, 3), np.float32)
    stamps = np.full(C, -np.inf, np.float32)
    m = len(uk)
    keys[:m] = uk.astype(np.int32)
    count[:m] = cnt
    sum_pts[:m] = ssum
    sum_outer[:m] = souter.reshape(-1, 3, 3)
    stamps[:m] = stamp
    return VoxelMap(keys=jnp.asarray(keys), count=jnp.asarray(count),
                    sum_pts=jnp.asarray(sum_pts),
                    sum_outer=jnp.asarray(sum_outer),
                    stamp=jnp.asarray(stamps))


def insert_cloud(vmap: VoxelMap, cloud: PointCloud, spec: VoxelGridSpec,
                 stamp: float | jax.Array = 0.0,
                 incremental: bool = True) -> VoxelMap:
    """Integrate a (world-frame) cloud into the map."""
    keys, cnt, ssum, souter = scan_to_voxel_stats(cloud, spec)
    if incremental:
        return insert_scan_stats_incremental(
            vmap, keys, cnt, ssum, souter, jnp.asarray(stamp, jnp.float32))
    return insert_scan_stats(vmap, keys, cnt, ssum, souter,
                             jnp.asarray(stamp, jnp.float32))


def shift_map_cells(vmap: VoxelMap, spec: VoxelGridSpec,
                    shift: jax.Array) -> VoxelMap:
    """Translate the map contents by ``-shift`` whole cells (scrolling-
    window rebase): cell c of the old grid becomes cell c - shift; voxels
    leaving the window are evicted. ``shift`` is a traced (3,) int32 —
    re-centering never recompiles.

    Voxel-local moments are relative to each cell's corner, so the rebase
    is exact: only keys change (the world offset the caller tracks absorbs
    the geometric translation).
    """
    b = spec.dim_bits
    n = spec.cells_per_axis
    keys = vmap.keys
    occ = keys != INVALID_KEY
    cx = ((keys >> (2 * b)) & (n - 1)) - shift[0]
    cy = ((keys >> b) & (n - 1)) - shift[1]
    cz = (keys & (n - 1)) - shift[2]
    inb = (occ & (cx >= 0) & (cx < n) & (cy >= 0) & (cy < n)
           & (cz >= 0) & (cz < n))
    new_keys = jnp.where(inb, (cx << (2 * b)) | (cy << b) | cz, INVALID_KEY)
    dead = ~inb
    order = jnp.argsort(new_keys, stable=True)
    take = lambda a: jnp.take(a, order, axis=0)
    z = lambda a: jnp.where(
        dead.reshape((-1,) + (1,) * (a.ndim - 1)), 0.0, a)
    return VoxelMap(keys=take(new_keys),
                    count=take(z(vmap.count)),
                    sum_pts=take(z(vmap.sum_pts)),
                    sum_outer=take(z(vmap.sum_outer)),
                    stamp=take(jnp.where(dead, -jnp.inf, vmap.stamp)))


def evict_where(vmap: VoxelMap, drop: jax.Array) -> VoxelMap:
    """Remove the voxels where ``drop`` is True (e.g. seen-through voxels
    flagged by free-space occupancy evidence — dynamic-object removal).

    One sort restores the sorted-keys/INVALID-tail invariant (INVALID_KEY
    is int32 max, so dead slots order to the tail naturally).
    """
    keys = jnp.where(drop, INVALID_KEY, vmap.keys)
    dead = keys == INVALID_KEY
    order = jnp.argsort(keys, stable=True)
    take = lambda a: jnp.take(a, order, axis=0)
    z = lambda a: jnp.where(
        dead.reshape((-1,) + (1,) * (a.ndim - 1)), 0.0, a)
    return VoxelMap(keys=take(keys),
                    count=take(z(vmap.count)),
                    sum_pts=take(z(vmap.sum_pts)),
                    sum_outer=take(z(vmap.sum_outer)),
                    stamp=take(jnp.where(dead, -jnp.inf, vmap.stamp)))


# ---------------------------------------------------------------------------
# Derived quantities
# ---------------------------------------------------------------------------

def voxel_means(vmap: VoxelMap, spec: VoxelGridSpec) -> jax.Array:
    """(C, 3) world-frame voxel means; PAD_COORD where empty."""
    occ = vmap.occupied_mask()
    cnt = jnp.maximum(vmap.count, 1.0)
    local_mean = vmap.sum_pts / cnt[:, None]
    corners = decode_corner(vmap.keys, spec)
    mean = corners + local_mean
    return jnp.where(occ[:, None], mean, PAD_COORD)


def voxel_covariances(vmap: VoxelMap, min_count: float = 5.0,
                      regularization: float = 1e-3) -> jax.Array:
    """(C, 3, 3) covariance per voxel, identity-regularized.

    Covariance = M2/n - mean mean^T (moments are voxel-local so this is
    well-conditioned in float32). Voxels with fewer than ``min_count``
    points get an isotropic placeholder — their Gaussian is meaningless.
    ``regularization`` adds eps*I, the standard NDT conditioning.
    """
    cnt = jnp.maximum(vmap.count, 1.0)
    mean = vmap.sum_pts / cnt[:, None]
    cov = vmap.sum_outer / cnt[:, None, None] - mean[:, :, None] * mean[:, None, :]
    eye = jnp.eye(3, dtype=cov.dtype)
    cov = cov + regularization * eye
    poor = vmap.count < min_count
    return jnp.where(poor[:, None, None], eye * 0.05, cov)


def voxel_normals(vmap: VoxelMap, min_count: float = 5.0
                  ) -> Tuple[jax.Array, jax.Array]:
    """Surface normal per voxel = eigenvector of the smallest eigenvalue.

    Returns (normals (C, 3), valid (C,)). Valid requires enough points and a
    planar covariance (smallest eigenvalue well below the middle one).
    """
    cov = voxel_covariances(vmap, min_count=min_count)
    evals, evecs = jnp.linalg.eigh(cov)          # ascending eigenvalues
    normals = evecs[:, :, 0]
    planar = evals[:, 0] < 0.25 * jnp.maximum(evals[:, 1], 1e-12)
    valid = vmap.occupied_mask() & (vmap.count >= min_count) & planar
    return normals, valid


def lookup_voxels(vmap: VoxelMap, query_keys: jax.Array) -> jax.Array:
    """Binary-search query keys in the sorted map. Returns (N,) int32 slot
    index, -1 where the key is absent."""
    pos = jnp.searchsorted(vmap.keys, query_keys)
    pos = jnp.clip(pos, 0, vmap.capacity - 1)
    hit = (jnp.take(vmap.keys, pos) == query_keys) & (query_keys != INVALID_KEY)
    return jnp.where(hit, pos, -1)


def neighborhood_moments(vmap: VoxelMap, spec: VoxelGridSpec,
                         lookup: Optional[jax.Array] = None
                         ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Aggregate 3x3x3-neighborhood moments for every occupied voxel.

    Per-voxel statistics are sparse (a fresh voxel may hold 1-4 points);
    surface estimation needs support. For each voxel, gather the moments of
    its 27 neighbors — shifting each neighbor's voxel-local moments to the
    center voxel's corner frame:

        sum'   = sum + n * d
        outer' = outer + d sum^T + sum d^T + n d d^T,   d = corner_v - corner_0

    ``lookup`` (optional): dense cell->slot table (-1 empty) — one gather
    replaces the 27C binary searches (the dominant cost of a field build).

    Returns (count (C,), mean_world (C, 3), cov (C, 3, 3)).
    """
    from tpu_slam.kernels.voxel_hash import neighbor_offsets_keys

    c = vmap.capacity
    nkeys = neighbor_offsets_keys(vmap.keys, spec)            # (C, 27)
    if lookup is not None:
        safe = jnp.clip(nkeys, 0, lookup.shape[0] - 1)
        pos = jnp.take(lookup, safe)
        hit = (pos >= 0) & (nkeys != INVALID_KEY) & (nkeys >= 0)
        pos = jnp.maximum(pos, 0)
    else:
        pos = jnp.clip(jnp.searchsorted(vmap.keys, nkeys), 0, c - 1)
        hit = (jnp.take(vmap.keys, pos) == nkeys) & (nkeys != INVALID_KEY)
    w = hit.astype(jnp.float32)

    n_v = jnp.take(vmap.count, pos) * w                       # (C, 27)
    s_v = jnp.take(vmap.sum_pts, pos, axis=0) * w[..., None]  # (C, 27, 3)
    o_v = jnp.take(vmap.sum_outer, pos, axis=0) * w[..., None, None]

    corners0 = decode_corner(vmap.keys, spec)                 # (C, 3)
    corners_v = decode_corner(nkeys, spec)                    # (C, 27, 3)
    d = jnp.where(hit[..., None], corners_v - corners0[:, None, :], 0.0)

    s_shift = s_v + n_v[..., None] * d
    o_shift = (o_v + d[..., :, None] * s_v[..., None, :]
               + s_v[..., :, None] * d[..., None, :]
               + n_v[..., None, None] * d[..., :, None] * d[..., None, :])

    cnt = jnp.sum(n_v, axis=1)                                # (C,)
    ssum = jnp.sum(s_shift, axis=1)                           # (C, 3)
    souter = jnp.sum(o_shift, axis=1)                         # (C, 3, 3)

    safe = jnp.maximum(cnt, 1.0)
    mean_local = ssum / safe[:, None]
    cov = souter / safe[:, None, None] - mean_local[:, :, None] * mean_local[:, None, :]
    mean_world = corners0 + mean_local
    occ = vmap.occupied_mask()
    mean_world = jnp.where(occ[:, None], mean_world, PAD_COORD)
    return cnt, mean_world, cov


def voxel_normals_neighborhood(vmap: VoxelMap, spec: VoxelGridSpec,
                               min_count: float = 6.0,
                               planarity: float = 0.25
                               ) -> Tuple[jax.Array, jax.Array]:
    """Surface normals from 3x3x3-neighborhood covariance.

    Far more robust than single-voxel normals on sparse maps (a LiDAR scan
    leaves only a few points per voxel). Returns (normals (C,3), valid (C,)).
    """
    cnt, _, cov = neighborhood_moments(vmap, spec)
    cov = cov + 1e-6 * jnp.eye(3, dtype=cov.dtype)
    evals, evecs = jnp.linalg.eigh(cov)
    normals = evecs[:, :, 0]
    planar = evals[:, 0] < planarity * jnp.maximum(evals[:, 1], 1e-12)
    valid = vmap.occupied_mask() & (cnt >= min_count) & planar
    return normals, valid


def build_dense_lookup(vmap: VoxelMap, spec: VoxelGridSpec) -> jax.Array:
    """Dense cell->slot table (size 2^(3*dim_bits), -1 = empty).

    The packed key IS the cell's linear index, so this is one scatter;
    every later probe is one gather instead of a binary search.
    """
    size = 1 << (3 * spec.dim_bits)
    table = jnp.full((size,), jnp.int32(-1))
    occ = vmap.occupied_mask()
    slots = jnp.arange(vmap.capacity, dtype=jnp.int32)
    idx = jnp.where(occ, vmap.keys, size)   # unoccupied -> dropped
    return table.at[idx].set(slots, mode="drop")


@functools.partial(jax.jit, static_argnames=("spec", "factor"))
def coarsen_map(vmap: VoxelMap, spec: VoxelGridSpec, factor: int = 4
                ) -> VoxelMap:
    """Re-aggregate the map's moments at a ``factor``x coarser leaf.

    The coarse map feeds the first level of a multi-resolution NDT pyramid:
    fat coarse Gaussians have meter-scale basins with the CORRECT
    anisotropy (unlike temperature widening, which cannot stretch a
    centimeter-thin wall Gaussian to a 1.5 m capture range, or isotropic
    weighting, which lets ground points veto tangential motion).

    ``factor`` must be a power of two; the coarse spec keeps the origin and
    drops log2(factor) bits per axis.
    """
    import math as _math
    s = int(_math.log2(factor))
    if (1 << s) != factor:
        raise ValueError("factor must be a power of two")
    b = spec.dim_bits
    bc = b - s
    n = spec.cells_per_axis

    keys = vmap.keys
    occ = vmap.occupied_mask()
    ix = (keys >> (2 * b)) & (n - 1)
    iy = (keys >> b) & (n - 1)
    iz = keys & (n - 1)
    cx, cy, cz = ix >> s, iy >> s, iz >> s
    ckeys = (cx << (2 * bc)) | (cy << bc) | cz
    ckeys = jnp.where(occ, ckeys, INVALID_KEY)

    # shift fine voxel-local moments to the coarse corner frame
    fine_corner = decode_corner(keys, spec)
    coarse_spec_leaf = spec.leaf * factor
    origin = jnp.asarray(spec.origin, jnp.float32)
    coarse_corner = (jnp.stack([cx, cy, cz], axis=-1).astype(jnp.float32)
                     * coarse_spec_leaf + origin)
    d = jnp.where(occ[:, None], fine_corner - coarse_corner, 0.0)
    nw = vmap.count
    s_shift = vmap.sum_pts + nw[:, None] * d
    o_shift = (vmap.sum_outer
               + d[:, :, None] * vmap.sum_pts[:, None, :]
               + vmap.sum_pts[:, :, None] * d[:, None, :]
               + nw[:, None, None] * d[:, :, None] * d[:, None, :])

    order = jnp.argsort(ckeys, stable=True)
    k = jnp.take(ckeys, order)
    c = jnp.take(nw, order)
    ss = jnp.take(s_shift, order, axis=0)
    oo = jnp.take(o_shift, order, axis=0)
    st = jnp.take(vmap.stamp, order)
    m = k.shape[0]
    seg_ids, is_start = segment_ids_from_sorted_keys(k)
    valid = k != INVALID_KEY
    mc = jax.ops.segment_sum(jnp.where(valid, c, 0.0), seg_ids,
                             num_segments=m)
    ms = jax.ops.segment_sum(jnp.where(valid[:, None], ss, 0.0), seg_ids,
                             num_segments=m)
    mo = jax.ops.segment_sum(
        jnp.where(valid[:, None, None], oo, 0.0), seg_ids, num_segments=m)
    mst = jax.ops.segment_max(jnp.where(valid, st, -jnp.inf), seg_ids,
                              num_segments=m)
    mk = jax.ops.segment_max(
        jnp.where(is_start & valid, k, jnp.int32(-2147483648)), seg_ids,
        num_segments=m)
    seg_valid = mc > 0
    mk = jnp.where(seg_valid, mk, INVALID_KEY)
    order2 = jnp.argsort(jnp.where(seg_valid, mk, INVALID_KEY), stable=True)
    return VoxelMap(keys=jnp.take(mk, order2),
                    count=jnp.take(mc, order2),
                    sum_pts=jnp.take(ms, order2, axis=0),
                    sum_outer=jnp.take(mo, order2, axis=0),
                    stamp=jnp.take(mst, order2))


def coarse_spec_of(spec: VoxelGridSpec, factor: int) -> VoxelGridSpec:
    """The VoxelGridSpec matching coarsen_map's output keys."""
    import math as _math
    s = int(_math.log2(factor))
    return VoxelGridSpec(leaf=spec.leaf * factor, origin=spec.origin,
                         dim_bits=spec.dim_bits - s)
