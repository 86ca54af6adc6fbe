"""Spatially-sharded voxel map + distributed NDT registration (TP-analog).

The map is the SLAM engine's "model"; at outdoor scale it outgrows one
chip. Sharding (SURVEY.md §2.3 TP row):

  * voxels are partitioned into **x-slabs** — device d owns cells whose x
    cell-coordinate falls in its contiguous range. Slab sharding keeps each
    device's voxel list sorted and self-contained (packed keys are ordered
    by x first), so per-device insertion is the same merge-sort-reduce as
    the single-chip map;
  * scan insertion: the incoming scan's per-voxel aggregates are computed
    replicated (cheap — one scan), each device filters to its slab and
    merges locally. No all-to-all;
  * NDT registration against the sharded map: H, b, cost are sums over
    (point, Gaussian) pairs, so each device computes the partial over ITS
    Gaussians and one ``psum`` combines them — the LM loop then runs
    replicated. One (6,6)+(6,)+scalars all-reduce per LM iteration.

With ``window_dims`` set, registration runs the frozen-bin terms pass on
per-device window rows (``_window_rows_local``); otherwise it runs on the
dense-window packed tier whenever the packed table fits (the same
neighbor-packed rows as single-chip registration.ndt):

  * every device scatters its slab's voxel moments into the global dense
    window and one ``psum_scatter`` along x hands each device its owned
    x-chunk — a bandwidth-optimal re-shard that works for ANY map
    sharding, not just aligned slabs;
  * separable y/z moment passes run locally; the x pass needs one plane
    from each x-neighbor device, exchanged with two ``ppermute``s — the
    halo exchange that makes neighborhood moments EXACT at chunk
    boundaries (a boundary voxel sees all 27 neighbors);
  * Gaussians (closed-form floored sym3 inverses) and the neighbor-packed
    probe rows are built per chunk, padded with one invalid halo plane per
    side so points in a neighbor's chunk still probe this device's border
    Gaussians. Each Gaussian is owned by exactly one device, so the psum
    of per-device H/b/cost/match terms is the exact global objective.

The pre-window slow path (per-voxel eigh over local slabs, boundary
voxels seeing 18/27 neighbors) remains only as the fallback when packing
is disabled or the window does not divide the mesh.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from tpu_slam.core import se3
from tpu_slam.core.pointcloud import PointCloud
from tpu_slam.kernels.voxel_hash import INVALID_KEY, VoxelGridSpec
from tpu_slam.mapping.voxel_map import (VoxelMap, decode_corner, empty_map,
                                        insert_scan_stats,
                                        neighborhood_moments,
                                        scan_to_voxel_stats, voxel_means,
                                        voxel_covariances)
from tpu_slam.core.sym3 import floored_info_sym3_tri
from tpu_slam.registration.ndt import (NDTField, NDTParams, NDTResult,
                                       _ndt_terms, _nbr_moment_pass,
                                       _pack_neighbor_rows, _pack_tier)

_HALO = 1  # x halo planes per side of a device's chunk in the window-rows
           # tier: the dx=+-1 neighbours of the chunk's border cells


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ShardedVoxelMap:
    """Per-device voxel maps stacked on a leading device axis (D, ...)."""

    keys: jax.Array        # (D, C)
    count: jax.Array       # (D, C)
    sum_pts: jax.Array     # (D, C, 3)
    sum_outer: jax.Array   # (D, C, 3, 3)
    stamp: jax.Array       # (D, C)

    @property
    def n_shards(self) -> int:
        return self.keys.shape[0]

    @property
    def shard_capacity(self) -> int:
        return self.keys.shape[1]

    def local(self, d: int) -> VoxelMap:
        return VoxelMap(keys=self.keys[d], count=self.count[d],
                        sum_pts=self.sum_pts[d], sum_outer=self.sum_outer[d],
                        stamp=self.stamp[d])


def empty_sharded_map(n_shards: int, shard_capacity: int) -> ShardedVoxelMap:
    m = empty_map(shard_capacity)
    tile = lambda a: jnp.broadcast_to(a, (n_shards,) + a.shape).copy()
    return ShardedVoxelMap(keys=tile(m.keys), count=tile(m.count),
                           sum_pts=tile(m.sum_pts),
                           sum_outer=tile(m.sum_outer), stamp=tile(m.stamp))


def slab_owner(keys: jax.Array, spec: VoxelGridSpec,
               n_shards: int) -> jax.Array:
    """Device owning each key: contiguous x-slabs of the cell grid."""
    b = spec.dim_bits
    n = spec.cells_per_axis
    ix = (keys >> (2 * b)) & (n - 1)
    cells_per_shard = -(-n // n_shards)
    owner = ix // cells_per_shard
    return jnp.where(keys == INVALID_KEY, -1, owner)


def insert_cloud_sharded(mesh: Mesh, smap: ShardedVoxelMap,
                         cloud: PointCloud, spec: VoxelGridSpec,
                         stamp: float, axis_name: str = "data"
                         ) -> ShardedVoxelMap:
    """Integrate a world-frame cloud into the sharded map."""
    n_shards = mesh.shape[axis_name]
    keys, cnt, ssum, souter = scan_to_voxel_stats(cloud, spec)
    owner = slab_owner(keys, spec, n_shards)

    @functools.partial(
        jax.shard_map, mesh=mesh, check_vma=False,
        in_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name),
                  P(axis_name), P(), P(), P(), P()),
        out_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name),
                   P(axis_name)))
    def shard_insert(k_l, c_l, s_l, o_l, st_l, keys_, cnt_, ssum_, souter_):
        d = jax.lax.axis_index(axis_name)
        mine = slab_owner(keys_, spec, n_shards) == d
        k_in = jnp.where(mine, keys_, INVALID_KEY)
        c_in = jnp.where(mine, cnt_, 0.0)
        s_in = jnp.where(mine[:, None], ssum_, 0.0)
        o_in = jnp.where(mine[:, None, None], souter_, 0.0)
        local = VoxelMap(keys=k_l[0], count=c_l[0], sum_pts=s_l[0],
                         sum_outer=o_l[0], stamp=st_l[0])
        merged = insert_scan_stats(local, k_in, c_in, s_in, o_in,
                                   jnp.float32(stamp))
        return (merged.keys[None], merged.count[None],
                merged.sum_pts[None], merged.sum_outer[None],
                merged.stamp[None])

    k, c, s, o, st = shard_insert(smap.keys, smap.count, smap.sum_pts,
                                  smap.sum_outer, smap.stamp,
                                  keys, cnt, ssum, souter)
    return ShardedVoxelMap(keys=k, count=c, sum_pts=s, sum_outer=o, stamp=st)


def _local_field(local: VoxelMap, spec: VoxelGridSpec,
                 params: NDTParams) -> NDTField:
    """Device-local NDT field (same construction as registration.ndt)."""
    if params.use_neighborhood:
        cnt, means, cov = neighborhood_moments(local, spec)
        valid = local.occupied_mask() & (cnt >= params.min_voxel_count)
    else:
        means = voxel_means(local, spec)
        cov = voxel_covariances(local, min_count=params.min_voxel_count,
                                regularization=0.0)
        valid = local.occupied_mask() & (local.count >= params.min_voxel_count)
    evals, evecs = jnp.linalg.eigh(cov)
    floor = params.evec_floor_ratio * jnp.maximum(evals[:, 2:3], 1e-9)
    inv_evals = 1.0 / jnp.maximum(evals, floor)
    info = jnp.einsum("cij,cj,ckj->cik", evecs, inv_evals, evecs)
    return NDTField(keys=local.keys, means=means, info=info, valid=valid)


def _window_field_local(local: VoxelMap, spec: VoxelGridSpec,
                        params: NDTParams, center: Optional[jax.Array],
                        n_shards: int, axis_name: str) -> NDTField:
    """Per-device dense-window NDT field with exact halo'd moments.

    Runs INSIDE shard_map. Device d ends up owning x-chunk d of the global
    2^window_bits window: one psum_scatter re-shards the raw moments, two
    ppermutes exchange the boundary planes the x moment pass needs, and the
    packed probe table covers the chunk plus one invalid halo plane per
    side (see the module docstring). Mirrors registration.ndt's
    _ndt_field_dense math exactly so sharded == single-chip to float
    tolerance, including chunk-boundary voxels.
    """
    b = spec.dim_bits
    n = spec.cells_per_axis
    wb = min(b, params.window_bits)
    w = 1 << wb
    s_chunk = w // n_shards
    tier = _pack_tier(params, wb)
    leaf = spec.leaf
    occ = local.occupied_mask()
    keys = local.keys
    gx = (keys >> (2 * b)) & (n - 1)
    gy = (keys >> b) & (n - 1)
    gz = keys & (n - 1)

    if wb >= b:
        c0 = jnp.zeros((3,), jnp.int32)
    else:
        if center is None:
            total = jax.lax.psum(
                jnp.sum(jnp.where(occ, local.count, 0.0)), axis_name)
            corners = decode_corner(keys, spec)
            wsum = jax.lax.psum(
                jnp.sum(jnp.where(occ[:, None],
                                  corners * local.count[:, None]
                                  + local.sum_pts, 0.0), axis=0), axis_name)
            center = wsum / jnp.maximum(total, 1.0)
        origin = jnp.asarray(spec.origin, jnp.float32)
        cc = jnp.floor((jnp.asarray(center, jnp.float32) - origin)
                       / leaf).astype(jnp.int32)
        c0 = jnp.clip(cc - w // 2, 0, n - w)

    lx, ly, lz = gx - c0[0], gy - c0[1], gz - c0[2]
    inside = (occ & (lx >= 0) & (lx < w) & (ly >= 0) & (ly < w)
              & (lz >= 0) & (lz < w))
    g_full = w * w * w
    lidx = (lx * w + ly) * w + lz
    lidx = jnp.where(inside, lidx, g_full)

    so = local.sum_outer
    chan = jnp.concatenate([
        local.count[:, None], local.sum_pts,
        so[:, 0, 0:1], so[:, 0, 1:2], so[:, 0, 2:3],
        so[:, 1, 1:2], so[:, 1, 2:3], so[:, 2, 2:3],
        jnp.ones((local.capacity, 1), jnp.float32)], axis=1)
    chan = jnp.where(inside[:, None], chan, 0.0)
    dm = jnp.zeros((g_full + 1, 11), jnp.float32).at[lidx].set(
        chan, mode="drop")[:g_full]
    dm = dm.reshape(w, w, w, 11)
    # re-shard: each device receives the x-chunk it owns, merged over all
    # devices' scatters (slabs are disjoint, so the sum is a merge)
    dm = jax.lax.psum_scatter(dm, axis_name, scatter_dimension=0,
                              tiled=True)                   # (S, w, w, 11)
    occ_c = dm[..., 10]
    a = dm[..., :10]
    a = _nbr_moment_pass(a, 2, leaf)
    a = _nbr_moment_pass(a, 1, leaf)
    # halo exchange: the x pass needs the y/z-aggregated boundary plane of
    # each x-neighbor chunk; edge devices receive zeros (= grid boundary)
    left = jax.lax.ppermute(a[-1], axis_name,
                            [(i, i + 1) for i in range(n_shards - 1)])
    right = jax.lax.ppermute(a[0], axis_name,
                             [(i + 1, i) for i in range(n_shards - 1)])
    ap = jnp.concatenate([left[None], a, right[None]], axis=0)
    ap = _nbr_moment_pass(ap, 0, leaf)
    agg = ap[1:-1].reshape(s_chunk * w * w, 10)             # exact 27-sums

    cnt = agg[:, 0]
    safe = jnp.maximum(cnt, 1.0)
    mean_local = agg[:, 1:4] / safe[:, None]
    mx, my, mz = mean_local[:, 0], mean_local[:, 1], mean_local[:, 2]
    inv = 1.0 / safe
    cov_tri = (agg[:, 4] * inv - mx * mx, agg[:, 5] * inv - mx * my,
               agg[:, 6] * inv - mx * mz, agg[:, 7] * inv - my * my,
               agg[:, 8] * inv - my * mz, agg[:, 9] * inv - mz * mz)
    info_tri = floored_info_sym3_tri(cov_tri, params.evec_floor_ratio)
    valid = (occ_c.reshape(-1) > 0.5) & (cnt >= params.min_voxel_count)

    d = jax.lax.axis_index(axis_name)
    ci = jnp.arange(s_chunk * w * w, dtype=jnp.int32)
    cell = jnp.stack([ci // (w * w) + c0[0] + d * s_chunk,
                      (ci // w) % w + c0[1],
                      ci % w + c0[2]], axis=1)
    origin = jnp.asarray(spec.origin, jnp.float32)
    mean_world = cell.astype(jnp.float32) * leaf + origin + mean_local

    rows16 = jnp.concatenate(
        [mean_world] + [t[:, None] for t in info_tri]
        + [valid[:, None].astype(jnp.float32),
           jnp.zeros((s_chunk * w * w, 6), jnp.float32)], axis=1)
    rows16 = jnp.where(valid[:, None], rows16, 0.0)
    # pad one invalid halo plane per side: points whose center cell is in a
    # neighbor's chunk still probe this device's border Gaussians at dx=+-1
    rows16 = jnp.concatenate([
        jnp.zeros((w * w, 16), jnp.float32),
        rows16,
        jnp.zeros((w * w, 16), jnp.float32)], axis=0)
    nbr_rows = _pack_neighbor_rows(rows16, (s_chunk + 2, w, w), tier)
    origin_cell = jnp.stack([c0[0] + d * s_chunk - 1, c0[1], c0[2]])
    return NDTField(keys=local.keys, means=jnp.zeros((1, 3), jnp.float32),
                    info=jnp.zeros((1, 3, 3), jnp.float32),
                    valid=jnp.zeros((1,), bool), nbr_rows=nbr_rows,
                    origin_cell=origin_cell,
                    window_dims=(s_chunk + 2, w, w))


def _window_rows_local(local: VoxelMap, spec: VoxelGridSpec,
                       params: NDTParams, center: Optional[jax.Array],
                       dims: Tuple[int, int, int], n_shards: int,
                       axis_name: str) -> NDTField:
    """Per-device dense-window field rows for the frozen-bin terms pass.

    The rectangular-window sibling of _window_field_local: same
    psum_scatter re-shard + ppermute halo exchange (exact 27-sums at
    chunk boundaries), but the output is the x-major (G, 16) rows
    kernels.ndt_terms consumes instead of the neighbor-packed rows — so
    sharded registration runs the SAME terms pass the single-device path
    does.  Each device's local window is its x-chunk padded with _HALO
    invalid planes per side; points binned in the halo probe this
    device's border Gaussians at dx=+-1.
    """
    b = spec.dim_bits
    n = spec.cells_per_axis
    wx, wy, wz = dims
    s_chunk = wx // n_shards
    leaf = spec.leaf
    occ = local.occupied_mask()
    keys = local.keys
    gx = (keys >> (2 * b)) & (n - 1)
    gy = (keys >> b) & (n - 1)
    gz = keys & (n - 1)

    if wx >= n and wy >= n and wz >= n:
        c0 = jnp.zeros((3,), jnp.int32)
    else:
        if center is None:
            total = jax.lax.psum(
                jnp.sum(jnp.where(occ, local.count, 0.0)), axis_name)
            corners = decode_corner(keys, spec)
            wsum = jax.lax.psum(
                jnp.sum(jnp.where(occ[:, None],
                                  corners * local.count[:, None]
                                  + local.sum_pts, 0.0), axis=0), axis_name)
            center = wsum / jnp.maximum(total, 1.0)
        origin = jnp.asarray(spec.origin, jnp.float32)
        cc = jnp.floor((jnp.asarray(center, jnp.float32) - origin)
                       / leaf).astype(jnp.int32)
        half = jnp.asarray([wx // 2, wy // 2, wz // 2], jnp.int32)
        hi = jnp.asarray([n - wx, n - wy, n - wz], jnp.int32)
        c0 = jnp.clip(cc - half, 0, hi)

    lx, ly, lz = gx - c0[0], gy - c0[1], gz - c0[2]
    inside = (occ & (lx >= 0) & (lx < wx) & (ly >= 0) & (ly < wy)
              & (lz >= 0) & (lz < wz))
    g_full = wx * wy * wz
    lidx = (lx * wy + ly) * wz + lz
    lidx = jnp.where(inside, lidx, g_full)

    so = local.sum_outer
    chan = jnp.concatenate([
        local.count[:, None], local.sum_pts,
        so[:, 0, 0:1], so[:, 0, 1:2], so[:, 0, 2:3],
        so[:, 1, 1:2], so[:, 1, 2:3], so[:, 2, 2:3],
        jnp.ones((local.capacity, 1), jnp.float32)], axis=1)
    chan = jnp.where(inside[:, None], chan, 0.0)
    dm = jnp.zeros((g_full + 1, 11), jnp.float32).at[lidx].set(
        chan, mode="drop")[:g_full]
    dm = dm.reshape(wx, wy, wz, 11)
    dm = jax.lax.psum_scatter(dm, axis_name, scatter_dimension=0,
                              tiled=True)               # (s_chunk, wy, wz, 11)
    occ_c = dm[..., 10]
    a = dm[..., :10]
    a = _nbr_moment_pass(a, 2, leaf)
    a = _nbr_moment_pass(a, 1, leaf)
    left = jax.lax.ppermute(a[-1], axis_name,
                            [(i, i + 1) for i in range(n_shards - 1)])
    right = jax.lax.ppermute(a[0], axis_name,
                             [(i + 1, i) for i in range(n_shards - 1)])
    ap = jnp.concatenate([left[None], a, right[None]], axis=0)
    ap = _nbr_moment_pass(ap, 0, leaf)
    agg = ap[1:-1].reshape(s_chunk * wy * wz, 10)       # exact 27-sums

    cnt = agg[:, 0]
    safe = jnp.maximum(cnt, 1.0)
    mean_local = agg[:, 1:4] / safe[:, None]
    mx, my, mz = mean_local[:, 0], mean_local[:, 1], mean_local[:, 2]
    inv = 1.0 / safe
    cov_tri = (agg[:, 4] * inv - mx * mx, agg[:, 5] * inv - mx * my,
               agg[:, 6] * inv - mx * mz, agg[:, 7] * inv - my * my,
               agg[:, 8] * inv - my * mz, agg[:, 9] * inv - mz * mz)
    info_tri = floored_info_sym3_tri(cov_tri, params.evec_floor_ratio)
    valid = (occ_c.reshape(-1) > 0.5) & (cnt >= params.min_voxel_count)

    d = jax.lax.axis_index(axis_name)
    ci = jnp.arange(s_chunk * wy * wz, dtype=jnp.int32)
    cell = jnp.stack([ci // (wy * wz) + c0[0] + d * s_chunk,
                      (ci // wz) % wy + c0[1],
                      ci % wz + c0[2]], axis=1)
    origin = jnp.asarray(spec.origin, jnp.float32)
    mean_world = cell.astype(jnp.float32) * leaf + origin + mean_local

    rows16 = jnp.concatenate(
        [mean_world] + [t[:, None] for t in info_tri]
        + [valid[:, None].astype(jnp.float32),
           jnp.zeros((s_chunk * wy * wz, 6), jnp.float32)], axis=1)
    rows16 = jnp.where(valid[:, None], rows16, 0.0)
    rows16 = jnp.concatenate([
        jnp.zeros((_HALO * wy * wz, 16), jnp.float32),
        rows16,
        jnp.zeros((_HALO * wy * wz, 16), jnp.float32)], axis=0)
    dims_local = (s_chunk + 2 * _HALO, wy, wz)
    origin_cell = jnp.stack([c0[0] + d * s_chunk - _HALO, c0[1], c0[2]])
    return NDTField(keys=local.keys, means=None, info=None, valid=None,
                    packed=None, nbr_rows=None, rows=rows16,
                    origin_cell=origin_cell, window_dims=dims_local)


def ndt_register_sharded(mesh: Mesh, source: PointCloud,
                         smap: ShardedVoxelMap, spec: VoxelGridSpec,
                         init_T: Optional[jax.Array] = None,
                         params: NDTParams = NDTParams(),
                         axis_name: str = "data",
                         center: Optional[jax.Array] = None) -> NDTResult:
    """NDT registration against the sharded map.

    The source cloud is replicated (one scan is small); each device forms
    partial H/b/cost over its owned Gaussians; psum combines; the LM loop
    runs in lockstep on every device. With ``window_dims`` set, each
    device runs the frozen-bin terms pass on its halo'd window rows
    (_window_rows_local). Otherwise, with the packed window tier active
    (``pack_budget_mb`` > 0) the field is the halo'd dense window of
    _window_field_local — bit-comparable to the single-chip packed tier —
    and the matched fraction is exact: the per-point indicator is psum'd
    so a point straddling chunks counts once.
    """
    if init_T is None:
        init_T = jnp.eye(4, dtype=source.points.dtype)
    src = source.sanitize()
    n_shards = mesh.shape[axis_name]
    wb = min(spec.dim_bits, params.window_bits)
    if params.window_dims is not None:
        dims = tuple(min(d, spec.cells_per_axis) for d in params.window_dims)
    else:
        dims = ((1 << wb),) * 3
    # window-rows tier: the same frozen-bin pass as single-device
    # registration, on halo-extended per-device chunks
    use_rows = (params.window_dims is not None and params.use_neighborhood
                  and dims[0] % n_shards == 0)
    use_window = (not use_rows and params.use_neighborhood
                  and _pack_tier(params, wb) > 0
                  and (1 << wb) % n_shards == 0)

    @functools.partial(
        jax.shard_map, mesh=mesh, check_vma=False,
        in_specs=(P(axis_name), P(axis_name), P(axis_name), P(axis_name),
                  P(axis_name), P(), P(), P()),
        out_specs=(P(), P(), P(), P(), P()))
    def solve(k_l, c_l, s_l, o_l, st_l, pts, mask, T0):
        local = VoxelMap(keys=k_l[0], count=c_l[0], sum_pts=s_l[0],
                         sum_outer=o_l[0], stamp=st_l[0])
        if use_rows:
            field = _window_rows_local(local, spec, params, center, dims,
                                       n_shards, axis_name)
        elif use_window:
            field = _window_field_local(local, spec, params, center,
                                        n_shards, axis_name)
        else:
            field = _local_field(local, spec, params)
        cloud = PointCloud(points=pts, mask=mask)
        n_src = jnp.maximum(jnp.sum(mask.astype(jnp.float32)), 1.0)

        if use_rows:
            from tpu_slam.kernels.ndt_terms import bin_points, terms_pass
            ndt_terms = terms_pass(params.terms_impl)
            dims_local = field.window_dims
            s_chunk = dims[0] // n_shards
            d_idx = jax.lax.axis_index(axis_name)
            # global window x-range: edge devices' halo planes extend past
            # it, and points there must NOT enter the objective (the
            # single-device pass drops them) — gate by the global bound
            c0gx = field.origin_cell[0] - d_idx * s_chunk + _HALO

            def bin_scan(T_bin):
                pw = pts @ T_bin[:3, :3].T + T_bin[:3, 3]
                gx = jnp.floor(
                    (jnp.clip(pw[:, 0],
                              -3e37, 3e37) - spec.origin[0])
                    / spec.leaf).astype(jnp.int32)
                okg = mask & (gx >= c0gx) & (gx < c0gx + dims[0])
                return bin_points(pts, okg, T_bin, spec.origin, spec.leaf,
                                  dims_local, params.raster_q,
                                  field.origin_cell)

            def make_terms(bins):
                def terms(T, gamma):
                    H, b, cost, cnt = ndt_terms(
                        pts, bins[0], bins[1], field.rows, T, gamma,
                        params.max_corr_dist, dims_local,
                        owned_x=(_HALO, _HALO + s_chunk))
                    H = jax.lax.psum(H, axis_name)
                    b = jax.lax.psum(b, axis_name)
                    cost = jax.lax.psum(cost, axis_name)
                    # each device counts only points binned in its OWNED
                    # planes; a point matching solely via a neighbor
                    # chunk's Gaussians is undercounted (conservative,
                    # affects only cells within one leaf of a boundary)
                    cnt = jax.lax.psum(cnt, axis_name)
                    return H, b, cost, cnt / n_src
                return terms
        else:
            bin_scan = None

            def make_terms(_bins):
                def terms(T, gamma):
                    H, b, cost, match = _ndt_terms(
                        cloud, T, field, spec, params, gamma,
                        per_point_match=True)
                    H = jax.lax.psum(H, axis_name)
                    b = jax.lax.psum(b, axis_name)
                    cost = jax.lax.psum(cost, axis_name)
                    # exact matched fraction: a point gating on several
                    # shards (its 27-neighborhood straddles a chunk
                    # boundary) counts once
                    match = jax.lax.psum(match, axis_name)
                    frac = jnp.sum(jnp.minimum(match, 1.0)) / n_src
                    return H, b, cost, frac
                return terms

        def lm_solve(T00, gamma, max_iters, tol, bins=None):
            terms = make_terms(bins)
            H0, b0, cost0, frac0 = terms(T00, gamma)

            def cond(state):
                T, lam_lm, cost, H, b, frac, it, dx = state
                return (it < max_iters) & (dx > tol) & (lam_lm < 1e6)

            def body(state):
                T, lam_lm, cost, H, b, frac, it, dx = state
                damp = lam_lm * jnp.maximum(jnp.trace(H) / 6.0, 1e-6)
                xi = -jnp.linalg.solve(H + damp * jnp.eye(6, dtype=H.dtype),
                                       b)
                xi = jnp.where(jnp.isfinite(xi), xi, 0.0)
                T_try = se3.retract(T, xi)
                H_t, b_t, cost_t, frac_t = terms(T_try, gamma)
                accept = cost_t < cost
                return (jnp.where(accept, T_try, T),
                        jnp.where(accept, jnp.maximum(lam_lm / 3.0, 1e-7),
                                  lam_lm * 5.0),
                        jnp.where(accept, cost_t, cost),
                        jnp.where(accept, H_t, H),
                        jnp.where(accept, b_t, b),
                        jnp.where(accept, frac_t, frac),
                        it + 1,
                        jnp.where(accept, jnp.linalg.norm(xi), dx))

            init = (T00, jnp.float32(1e-4), cost0, H0, b0, frac0,
                    jnp.int32(0), jnp.float32(jnp.inf))
            return jax.lax.while_loop(cond, body, init)

        def staged_solve(T0s, gamma, n_iters, iters_per_stage, tol):
            """Mirror of ndt_register's staged_window_solve cadence
            (registration/ndt.py): re-bin the scan at the
            CURRENT pose every ``iters_per_stage`` LM iterations, so the
            sharded window-rows tier stays numerically comparable to the
            single-chip path (the r4 parity test tracks this)."""
            if not use_rows:
                T2, _, cost2, _, _, frac2, it2, dx2 = lm_solve(
                    T0s, gamma, n_iters, tol)
                return T2, it2, frac2, cost2, dx2
            n_stages = -(-n_iters // iters_per_stage)

            def cond(c):
                s, T, it, frac, cost, dx = c
                return (s < n_stages) & (dx > tol)

            def body(c):
                s, T, it, frac, cost, dx = c
                T2, _, cost2, _, _, frac2, it2, dx2 = lm_solve(
                    T, gamma, iters_per_stage, tol, bins=bin_scan(T))
                return (s + 1, T2, it + it2, frac2, cost2, dx2)

            init = (jnp.int32(0), T0s, jnp.int32(0), jnp.float32(0.0),
                    jnp.float32(jnp.inf), jnp.float32(jnp.inf))
            _, T, it, frac, cost, dx = jax.lax.while_loop(cond, body, init)
            return T, it, frac, cost, dx

        gamma_f = jnp.float32(params.score_temperature)
        T_c, it_c = T0, jnp.int32(0)
        if use_rows and params.yaw_candidates > 1:
            # same yaw-candidate pre-search as the single-device window path
            gamma_y = gamma_f * max(params.coarse_temperature_scale, 1.0)
            offs = jnp.linspace(-params.yaw_span, params.yaw_span,
                                params.yaw_candidates)
            costs, Tys = [], []
            for k in range(params.yaw_candidates):
                cy, sy = jnp.cos(offs[k]), jnp.sin(offs[k])
                Rz = jnp.eye(4, dtype=jnp.float32)
                Rz = Rz.at[0, 0].set(cy).at[0, 1].set(-sy)
                Rz = Rz.at[1, 0].set(sy).at[1, 1].set(cy)
                Ty = T_c @ Rz
                _, _, cst, _ = make_terms(bin_scan(Ty))(Ty, gamma_y)
                costs.append(cst)
                Tys.append(Ty)
            best = jnp.argmin(jnp.stack(costs))
            T_c = jnp.stack(Tys)[best]
        if (params.coarse_iterations > 0
                and params.coarse_temperature_scale > 1.0):
            # coarse stage re-bins EVERY iteration (ndt_register:841-853)
            T_c, it1, _, _, _ = staged_solve(
                T_c, gamma_f * params.coarse_temperature_scale,
                params.coarse_iterations, 1, 10.0 * params.tolerance)
            it_c = it_c + it1
        T, iters, frac, cost, dx = staged_solve(
            T_c, gamma_f, params.max_iterations,
            max(1, params.rebin_iters), params.tolerance)
        return T, iters + it_c, cost, frac, dx

    T, iters, cost, frac, dx = solve(smap.keys, smap.count, smap.sum_pts,
                                     smap.sum_outer, smap.stamp,
                                     src.points, src.mask, init_T)
    n_src = jnp.maximum(jnp.sum(src.mask.astype(jnp.float32)), 1.0)
    return NDTResult(T=T, iterations=iters, score=-cost / n_src,
                     matched_fraction=frac,
                     converged=dx <= params.tolerance)
