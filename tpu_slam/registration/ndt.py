"""NDT (normal-distributions transform) scan-to-map registration.

Replacement for the reference core's CUDA NDT voxel matching
(SURVEY.md §2.2). Point-to-distribution NDT: each map voxel holds a Gaussian
(mapping.voxel_map moments); each source point is scored against the best
cell in its 3x3x3 neighborhood; the pose is solved by Gauss-Newton on SE(3)
with per-point 3x3 information matrices:

    r_i = p_i - mu(cell_i)            J_i = [I | -hat(p_i)]
    H  = sum J_i^T Lambda_i J_i       b  = sum J_i^T Lambda_i r_i

All correspondence work is per-point gathers of the 27-neighbor cells
(over the sorted voxel list, a dense lookup table, or a dense field window
— the grid-decomposition pattern of the CUDA original), and the reduction
is one fused sum; no dynamic shapes, `lax.while_loop` outer iterations.
Dense-window fields (``window_dims``) run the frozen-bin point-major pass
of kernels.ndt_terms.

Eigenvalue flooring follows standard NDT conditioning (Magnusson 2009):
covariance eigenvalues are clamped below at ``evec_floor_ratio`` times the
largest, keeping Lambda finite on planar/degenerate voxels.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from tpu_slam.core import se3
from tpu_slam.core.pointcloud import PAD_COORD, PointCloud
from tpu_slam.core.sym3 import floored_info_sym3, floored_info_sym3_tri
from tpu_slam.kernels.voxel_hash import (
    INVALID_KEY,
    VoxelGridSpec,
    neighbor_offsets_keys,
    pack_key,
    cell_coords,
)
from tpu_slam.mapping.voxel_map import (
    VoxelMap,
    build_dense_lookup,
    decode_corner,
    neighborhood_moments,
    voxel_covariances,
    voxel_means,
)


@dataclasses.dataclass(frozen=True)
class NDTParams:
    """Static NDT solve configuration."""

    max_iterations: int = 30
    tolerance: float = 1e-4
    use_neighborhood: bool = True    # 3x3x3-aggregated Gaussians (see ndt_field)
    min_voxel_count: float = 5.0
    evec_floor_ratio: float = 0.01   # eigenvalue floor vs largest (Magnusson)
    max_corr_dist: float = 1.0       # Euclidean gate on |p - mu| (meters)
    score_temperature: float = 4.0   # gamma in exp(-d2/(2 gamma)): widens
                                     # the basin of thin planar Gaussians
    coarse_temperature_scale: float = 16.0  # graduated non-convexity: stage-1
                                     # gamma multiplier (wide smooth basin)
    coarse_iterations: int = 10      # LM iterations in the coarse stage
    isotropic_iterations: int = 0    # optional stage-0: point-to-mean pull
                                     # (identity information) for inits
                                     # beyond the Gaussians' basin — enable
                                     # for large inter-scan motion (outdoor)
    dense_lookup_max_bits: int = 24  # materialize the cell->slot table when
                                     # 3*dim_bits <= this (2^24 = 64 MB max)
    pack_budget_mb: int = 0          # device-memory budget for the
                                     # neighbor-packed row tables (see
                                     # NDTField.nbr_rows); 0 disables packing
    window_bits: int = 6             # dense-field window size: 2^window_bits
                                     # cells per axis, centered on the scan
                                     # (see _ndt_field_dense). 0 disables the
                                     # dense build path.
    window_dims: Optional[Tuple[int, int, int]] = None
                                     # rectangular dense window (Wx, Wy, Wz)
                                     # overriding the window_bits cube.
                                     # Outdoor maps are flat: (128, 128, 32)
                                     # at 0.5 m leaf covers +-32 m of range
                                     # for the cell count of a 69^3 cube.
                                     # Selects the frozen-bin terms pass
                                     # (kernels.ndt_terms).
    terms_impl: str = "auto"         # frozen-bin pass: 'auto', 'xla' or
                                     # 'triton' (kernels.ndt_terms.terms_pass)
    raster_q: int = 4                # per-cell point capacity of the frozen
                                     # bins (kernels.ndt_terms.bin_points);
                                     # cells with more downsampled points than
                                     # this drop the excess from the objective
    yaw_candidates: int = 0          # window path: before the coarse stage,
                                     # evaluate the coarse objective at this
                                     # many yaw offsets in +-yaw_span about
                                     # the init's heading and start from the
                                     # best. Yaw is the weakly-captured DoF:
                                     # an unpredicted 0.2 rad turn moves far
                                     # points out of every local basin while
                                     # the 'stay on the mapped footprint'
                                     # alias keeps its matches (measured as
                                     # the r4 city arc lock-in; cost at the
                                     # true pose was 2.3x better but
                                     # unreachable by descent). One bin +
                                     # one pass per candidate.
    yaw_span: float = 0.3            # half-range of the yaw search (rad)
    motion_prior_weight: float = 0.0  # weak prior pulling the solve toward
                                     # its INIT pose (the constant-velocity
                                     # prediction): adds w*I to H and
                                     # w*log(T init^-1) to b. In feature-
                                     # poor corridors the NDT cost is flat
                                     # along-track except for a 0.5 m
                                     # cell-quantization comb, and the
                                     # unanchored solve snaps to 'stay
                                     # where you are' (measured r5: the
                                     # estimate froze for ~10 scans mid-
                                     # leg, a 4.4 m cliff). The prior
                                     # holds the predicted velocity in
                                     # flat directions while thousands of
                                     # data terms dominate observable ones.
    rebin_iters: int = 4             # window path: re-bin the scan every
                                     # this many fine LM iterations (the
                                     # coarse stage re-bins EVERY iteration).
                                     # Frozen bins are translation-tolerant
                                     # (within a cell) but rotation-hostile:
                                     # a 0.2 rad step moves a 40 m point 8 m
                                     # out of its frozen 27-neighborhood, so
                                     # the objective at the true pose loses
                                     # its far points while 'stay at the bin
                                     # pose' keeps them — measured as the
                                     # arc-turn lock-in of the r4 city bench


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NDTField:
    """Solver-ready view of a voxel map: Gaussians with information matrices.

    Built once per map update (ndt_prepare), reused across solves — the
    analog of the CUDA core precomputing voxel stats before ICP/NDT iters.
    """

    keys: jax.Array      # (C,) int32 sorted
    means: jax.Array     # (C, 3) world frame
    info: jax.Array      # (C, 3, 3) Lambda = Sigma^-1 (eigen-floored)
    valid: jax.Array     # (C,) bool
    # Dense cell->slot table: the packed key IS an index into the cell grid
    # (2^(3*dim_bits) entries), so probes become one gather instead of a
    # binary search. None for grids too large to materialize (ndt_field
    # builds it when 3*dim_bits <= dense_lookup_max_bits).
    lookup: Optional[jax.Array] = None   # (2^(3b),) int32 slot, -1 = empty
    # Packed per-voxel row [mean(3), Lam upper-tri(6), valid(1), pad(6)]:
    # ONE (C, 16) row gather replaces the separate (C,3)+(C,3,3)+(C,)
    # gathers; the Mahalanobis math then runs lane-wise on (N, 27).
    packed: Optional[jax.Array] = None   # (C, 16) float32
    # Neighbor-packed dense row table: the whole 3x3x3 neighborhood is
    # packed into wide rows of a dense cell-indexed table and fetched with
    # as few gather indices as possible per point:
    #   (G, 144): row g = the 9 (dy,dz) packed rows of cells g+dy*n+dz
    #             -> 3 gather indices per point (one per dx column);
    #   (G, 48):  row g = the 3 dz packed rows of cells g+dz
    #             -> 9 indices per point (one per (dx,dy) column).
    # Built when the table fits params.pack_budget_mb; G = 2^(3 window_bits)
    # rows regardless of occupancy. When the window is smaller than the map
    # grid, cell 0 of the table is world cell ``origin_cell`` (dynamic — the
    # window follows the scan without recompilation).
    nbr_rows: Optional[jax.Array] = None  # (G, 144) or (G, 48) float32
    # Dense window rows (G, 16) x-major [mean(3), Lam upper-tri(6),
    # valid(1), pad(6)] for the frozen-bin terms pass (kernels.ndt_terms);
    # the field of a rectangular ``window_dims`` window.
    rows: Optional[jax.Array] = None
    origin_cell: Optional[jax.Array] = None  # (3,) int32; None = grid corner
    # Static window shape (Wx, Wy, Wz) of nbr_rows. None = cube inferred
    # from the row count (the single-chip build). The sharded build uses
    # rectangular windows: each device owns an x-chunk of the global window
    # padded with one halo plane per side (distributed/map_shard.py).
    window_dims: Optional[Tuple[int, int, int]] = dataclasses.field(
        default=None, metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NDTResult:
    T: jax.Array
    iterations: jax.Array
    score: jax.Array            # mean exp(-0.5 d2) over matched points
    matched_fraction: jax.Array
    converged: jax.Array


def ndt_field(vmap: VoxelMap, spec: VoxelGridSpec,
              params: NDTParams = NDTParams(),
              center: Optional[jax.Array] = None) -> NDTField:
    """Build the solver-ready NDT field from a voxel map.

    With ``use_neighborhood`` (default), each voxel's Gaussian aggregates
    its 3x3x3 neighborhood moments — the overlapping-cells conditioning of
    classic NDT. A freshly-inserted scan leaves only a few points per voxel;
    single-voxel Gaussians would fall below min_voxel_count across half the
    map and starve the solver of correspondences.

    ``center`` (optional (3,) world position, traced): where to center the
    dense field window when the map grid is larger than 2^window_bits cells
    per axis — pass the current sensor pose in odometry. Defaults to the
    map's point centroid. Registration then only sees Gaussians inside the
    window (half-extent ``2^(window_bits-1) * leaf`` around the center),
    which is the locality a scan-to-map step has anyway.
    """
    wb = min(spec.dim_bits, params.window_bits)
    if params.window_dims is not None:
        if not params.use_neighborhood:
            raise ValueError("rectangular window_dims requires "
                             "use_neighborhood")
        return _ndt_field_dense(vmap, spec, params, center)
    if _pack_tier(params, wb) and params.use_neighborhood:
        return _ndt_field_dense(vmap, spec, params, center)
    lookup = None
    if 3 * spec.dim_bits <= params.dense_lookup_max_bits:
        lookup = build_dense_lookup(vmap, spec)
    if params.use_neighborhood:
        # the dense table also accelerates the 27C moment gathers here
        cnt, means, cov = neighborhood_moments(vmap, spec, lookup=lookup)
        valid = vmap.occupied_mask() & (cnt >= params.min_voxel_count)
    else:
        means = voxel_means(vmap, spec)
        cov = voxel_covariances(vmap, min_count=params.min_voxel_count,
                                regularization=0.0)
        valid = vmap.occupied_mask() & (vmap.count >= params.min_voxel_count)
    info = floored_info_sym3(cov, params.evec_floor_ratio)
    iu0, iu1 = jnp.triu_indices(3)
    packed = jnp.concatenate([
        means,
        info[:, iu0, iu1],
        valid[:, None].astype(jnp.float32),
        jnp.zeros((means.shape[0], 6), jnp.float32),
    ], axis=1)
    return NDTField(keys=vmap.keys, means=means, info=info, valid=valid,
                    lookup=lookup, packed=packed)


def _pack_tier(params: NDTParams, wb: int) -> int:
    """Sub-row count of the neighbor-packed table (9 or 3), or 0 = no pack."""
    if wb <= 0 or params.window_bits <= 0 or params.pack_budget_mb <= 0:
        return 0
    g = 1 << (3 * wb)
    budget = params.pack_budget_mb * (1 << 20)
    if g * 144 * 4 <= budget:
        return 9
    if g * 48 * 4 <= budget:
        return 3
    return 0


def _shift0(x: jax.Array, delta: int, axis: int) -> jax.Array:
    """x shifted so out[i] = x[i + delta] along ``axis``, zero-filled."""
    if delta == 0:
        return x
    n = x.shape[axis]
    pad = [(0, 0)] * x.ndim
    if delta > 0:
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(delta, n)
        pad[axis] = (0, delta)
    else:
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(0, n + delta)
        pad[axis] = (-delta, 0)
    return jnp.pad(x[tuple(sl)], pad)


def _nbr_moment_pass(a: jax.Array, axis: int, t: float) -> jax.Array:
    """One separable 3x3x3 moment-aggregation pass along ``axis``.

    ``a`` is (W, W, W, 10): [count, sum(3), outer upper-tri(6)], moments
    taken about each cell's own corner. The neighbor at offset d along the
    axis contributes its moments re-expressed about the receiving cell's
    corner (displacement t*d, the exact shift rule of
    voxel_map.neighborhood_moments):

        s'  = s + n d,   o' = o + d s^T + s d^T + n d d^T.

    Composing the three axis passes reproduces the full 27-cell sum exactly.
    """
    # channel layout: 0 n, 1..3 s, 4 oxx, 5 oxy, 6 oxz, 7 oyy, 8 oyz, 9 ozz
    diag = {0: 4, 1: 7, 2: 9}[axis]
    off = {0: (5, 6), 1: (5, 8), 2: (6, 8)}[axis]       # (a, other) pairs
    other = {0: (1, 2), 1: (0, 2), 2: (0, 1)}[axis]

    def shifted(delta: int) -> jax.Array:
        v = _shift0(a, delta, axis)
        if delta == 0:
            return v
        d = t * delta
        n_ = v[..., 0]
        s_a = v[..., 1 + axis]
        out = [v[..., 0]]
        for c in range(3):
            out.append(v[..., 1 + c] + (d * n_ if c == axis else 0.0))
        o = {k: v[..., k] for k in range(4, 10)}
        o[diag] = o[diag] + 2.0 * d * s_a + n_ * d * d
        o[off[0]] = o[off[0]] + d * v[..., 1 + other[0]]
        o[off[1]] = o[off[1]] + d * v[..., 1 + other[1]]
        return jnp.stack(out + [o[k] for k in range(4, 10)], axis=-1)

    return shifted(-1) + shifted(0) + shifted(1)


def _pack_neighbor_rows(rows16: jax.Array, dims: Tuple[int, int, int],
                        tier: int) -> jax.Array:
    """(G, 16) dense rows -> neighbor-packed (G, 144) or (G, 48) table.

    ``dims`` = (Wx, Wy, Wz) window shape of the x-major flattened rows
    (cell index = (x*Wy + y)*Wz + z). Neighbors are composed with jnp.roll
    on the flattened cell axis; rows that wrap across a window face are
    masked out at probe time by the per-axis bounds checks in
    _gather_nbr_rows, never read.
    """
    _, _, wz = dims
    zpack = jnp.concatenate([jnp.roll(rows16, 1, axis=0), rows16,
                             jnp.roll(rows16, -1, axis=0)], axis=1)
    if tier == 3:
        return zpack
    return jnp.concatenate([jnp.roll(zpack, wz, axis=0), zpack,
                            jnp.roll(zpack, -wz, axis=0)], axis=1)


def _ndt_field_dense(vmap: VoxelMap, spec: VoxelGridSpec, params: NDTParams,
                     center: Optional[jax.Array]) -> NDTField:
    """Dense-window field build: scatter -> separable 27-sum -> rows.

    Replaces the sparse build's per-voxel 27-neighbor gathers (searchsorted
    or lookup-table probes) and the batched eigh with dense W^3 array ops:
    one row scatter, three shift-add moment passes, closed-form floored
    inverses, and (cube windows) the roll-composed neighbor row packs.

    The window covers 2^window_bits cells per axis (or the rectangular
    params.window_dims). If the map grid is no bigger, the window IS the
    grid (origin_cell=None, static). Otherwise it is clamped inside the
    grid around ``center`` (or the map centroid), and Gaussians outside
    are not part of this field.
    """
    b = spec.dim_bits
    n = spec.cells_per_axis
    wb = min(b, params.window_bits)
    if params.window_dims is not None:
        dims = tuple(min(d, n) for d in params.window_dims)
        tier = 0                       # rect windows: frozen-bin rows only
    else:
        dims = (1 << wb,) * 3
        tier = _pack_tier(params, wb)
    wx, wy, wz = dims
    g = wx * wy * wz
    leaf = spec.leaf
    occ = vmap.occupied_mask()
    keys = vmap.keys
    gx = (keys >> (2 * b)) & (n - 1)
    gy = (keys >> b) & (n - 1)
    gz = keys & (n - 1)

    if wx >= n and wy >= n and wz >= n:
        c0 = None
        lx, ly, lz = gx, gy, gz
        inside = occ
    else:
        if center is None:
            # map centroid: corners weighted by count plus local sums
            total = jnp.maximum(jnp.sum(jnp.where(occ, vmap.count, 0.0)), 1.0)
            corners = decode_corner(keys, spec)
            wsum = jnp.sum(jnp.where(occ[:, None],
                                     corners * vmap.count[:, None]
                                     + vmap.sum_pts, 0.0), axis=0)
            center = wsum / total
        origin = jnp.asarray(spec.origin, jnp.float32)
        cc = jnp.floor((jnp.asarray(center, jnp.float32) - origin)
                       / leaf).astype(jnp.int32)
        half = jnp.asarray([wx // 2, wy // 2, wz // 2], jnp.int32)
        hi = jnp.asarray([n - wx, n - wy, n - wz], jnp.int32)
        c0 = jnp.clip(cc - half, 0, hi)
        lx, ly, lz = gx - c0[0], gy - c0[1], gz - c0[2]
        inside = (occ & (lx >= 0) & (lx < wx) & (ly >= 0) & (ly < wy)
                  & (lz >= 0) & (lz < wz))

    lidx = (lx * wy + ly) * wz + lz
    lidx = jnp.where(inside, lidx, g)                    # dropped

    # scatter [count, sum(3), outer triu(6), occupied(1)] rows; the triu
    # components come from slices, not fancy indexing
    so = vmap.sum_outer
    chan = jnp.concatenate([
        vmap.count[:, None], vmap.sum_pts,
        so[:, 0, 0:1], so[:, 0, 1:2], so[:, 0, 2:3],
        so[:, 1, 1:2], so[:, 1, 2:3], so[:, 2, 2:3],
        jnp.ones((vmap.capacity, 1), jnp.float32)], axis=1)
    chan = jnp.where(inside[:, None], chan, 0.0)
    dm = jnp.zeros((g + 1, 11), jnp.float32).at[lidx].set(chan, mode="drop")
    dm = dm[:g]
    occ_center = dm[:, 10]
    a = dm[:, :10].reshape(wx, wy, wz, 10)
    for axis in (2, 1, 0):
        a = _nbr_moment_pass(a, axis, leaf)
    a = a.reshape(g, 10)

    cnt = a[:, 0]
    safe = jnp.maximum(cnt, 1.0)
    mean_local = a[:, 1:4] / safe[:, None]
    mx, my, mz = mean_local[:, 0], mean_local[:, 1], mean_local[:, 2]
    inv = 1.0 / safe
    cov_tri = (a[:, 4] * inv - mx * mx, a[:, 5] * inv - mx * my,
               a[:, 6] * inv - mx * mz, a[:, 7] * inv - my * my,
               a[:, 8] * inv - my * mz, a[:, 9] * inv - mz * mz)
    info_tri = floored_info_sym3_tri(cov_tri, params.evec_floor_ratio)
    valid = (occ_center > 0.5) & (cnt >= params.min_voxel_count)

    # world-frame means: corner(cell) + local mean
    ci = jnp.arange(g, dtype=jnp.int32)
    cell = jnp.stack([ci // (wy * wz), (ci // wz) % wy, ci % wz], axis=1)
    if c0 is not None:
        cell = cell + c0[None, :]
    origin = jnp.asarray(spec.origin, jnp.float32)
    mean_world = cell.astype(jnp.float32) * leaf + origin + mean_local

    rows16 = jnp.concatenate(
        [mean_world] + [t[:, None] for t in info_tri]
        + [valid[:, None].astype(jnp.float32),
           jnp.zeros((g, 6), jnp.float32)], axis=1)
    rows16 = jnp.where(valid[:, None], rows16, 0.0)
    if params.window_dims is not None:
        # rows-only field for the frozen-bin pass: sparse per-slot views
        # are None, NOT dummies — any consumer that needs them
        # (_ndt_terms, _ndt_correspond) raises instead of silently
        # matching nothing against zero-rows
        return NDTField(
            keys=keys, means=None, info=None, valid=None, lookup=None,
            packed=None, nbr_rows=None,
            rows=rows16, origin_cell=c0, window_dims=dims)
    nbr_rows = _pack_neighbor_rows(rows16, dims, tier)

    # sparse per-slot views for fallback consumers (loop-closure scoring,
    # map_shard-style code): gather each map slot's row out of the window
    slot_rows = jnp.take(rows16, jnp.minimum(lidx, g - 1), axis=0)
    s_valid = inside & (slot_rows[:, 9] > 0.5)
    s_means = jnp.where(s_valid[:, None], slot_rows[:, 0:3], PAD_COORD)
    tri = slot_rows[:, 3:9]
    s_info = jnp.stack([
        jnp.stack([tri[:, 0], tri[:, 1], tri[:, 2]], -1),
        jnp.stack([tri[:, 1], tri[:, 3], tri[:, 4]], -1),
        jnp.stack([tri[:, 2], tri[:, 4], tri[:, 5]], -1)], -2)
    eye = jnp.eye(3, dtype=jnp.float32)
    s_info = jnp.where(s_valid[:, None, None], s_info, eye)
    packed = jnp.concatenate([
        s_means, tri, s_valid[:, None].astype(jnp.float32),
        jnp.zeros((vmap.capacity, 6), jnp.float32)], axis=1)
    return NDTField(keys=keys, means=s_means, info=s_info, valid=s_valid,
                    lookup=None, packed=packed, nbr_rows=nbr_rows,
                    origin_cell=c0, window_dims=dims)


def _probe_slots(field: NDTField, nkeys: jax.Array):
    """(..., 27) neighbor keys -> (slots, hit): dense-table gather when
    available, binary search otherwise."""
    if field.lookup is not None:
        safe = jnp.clip(nkeys, 0, field.lookup.shape[0] - 1)
        slots = jnp.take(field.lookup, safe)
        hit = (slots >= 0) & (nkeys != INVALID_KEY) & (nkeys >= 0)
        return jnp.maximum(slots, 0), hit
    c = field.keys.shape[0]
    pos = jnp.clip(jnp.searchsorted(field.keys, nkeys), 0, c - 1)
    hit = (jnp.take(field.keys, pos) == nkeys) & (nkeys != INVALID_KEY)
    return pos, hit


def _gather_nbr_rows(pts: jax.Array, field: NDTField, spec: VoxelGridSpec):
    """27-neighborhood packed rows for each point from the dense table.

    Returns (P (N, 27, 16) float32, ok (N, 27) bool) with the 27 cells
    ordered (dx, dy, dz) nested, dz fastest — matching the roll order used
    by _pack_neighbor_rows. ``ok`` combines per-axis window bounds (rolled
    rows that wrapped a face are masked here) with the per-cell valid flag.
    Window cell 0 is field.origin_cell (grid corner when None).
    """
    nbr_rows = field.nbr_rows
    n_pts = pts.shape[0]
    g = nbr_rows.shape[0]
    if field.window_dims is not None:
        wx, wy, wz = field.window_dims
    else:
        wb = (g.bit_length() - 1) // 3
        wx = wy = wz = 1 << wb
    cc = cell_coords(pts, spec)                               # (N, 3)
    if field.origin_cell is not None:
        cc = cc - field.origin_cell[None, :]
    cx, cy, cz = cc[:, 0], cc[:, 1], cc[:, 2]
    key = (cx * wy + cy) * wz + cz
    d3 = jnp.array([-1, 0, 1], dtype=jnp.int32)
    if nbr_rows.shape[1] == 144:
        starts = key[:, None] + d3 * (wy * wz)                # (N, 3) dx cols
        rows = jnp.take(nbr_rows, jnp.clip(starts, 0, g - 1), axis=0)
        P = rows.reshape(n_pts, 27, 16)                       # (3 dx, 9 dydz)
    else:
        dxy = (d3[:, None] * (wy * wz) + d3[None, :] * wz).reshape(-1)  # (9,)
        starts = key[:, None] + dxy                           # (N, 9)
        rows = jnp.take(nbr_rows, jnp.clip(starts, 0, g - 1), axis=0)
        P = rows.reshape(n_pts, 27, 16)                       # (9 dxdy, 3 dz)
    xok = (cx[:, None] + d3 >= 0) & (cx[:, None] + d3 < wx)   # (N, 3)
    yok = (cy[:, None] + d3 >= 0) & (cy[:, None] + d3 < wy)
    zok = (cz[:, None] + d3 >= 0) & (cz[:, None] + d3 < wz)
    ok = (xok[:, :, None, None] & yok[:, None, :, None]
          & zok[:, None, None, :]).reshape(n_pts, 27)
    return P, ok & (P[..., 9] > 0.5)


def _require_sparse_views(field: NDTField, who: str) -> None:
    """Rows-only fields (frozen-bin window path) carry no sparse views."""
    if field.means is None and field.packed is None:
        raise ValueError(
            f"{who} needs the sparse per-slot field views, but this NDTField "
            "is rows-only (a window_dims field for the frozen-bin terms "
            "pass). Build the field without window_dims for sparse "
            "consumers.")


def _ndt_correspond(pts: jax.Array, field: NDTField, spec: VoxelGridSpec):
    """Best Gaussian in each point's 27-neighborhood by Mahalanobis distance.

    Returns (mu (N,3), Lambda (N,3,3), matched (N,) bool, d2 (N,)).
    """
    _require_sparse_views(field, "_ndt_correspond")
    n = pts.shape[0]
    qkeys = pack_key(cell_coords(pts, spec), spec)
    nkeys = neighbor_offsets_keys(qkeys, spec)                # (N, 27)
    pos, hit = _probe_slots(field, nkeys)
    ok = hit & jnp.take(field.valid, pos)
    mus = jnp.take(field.means, pos, axis=0)                  # (N, 27, 3)
    lams = jnp.take(field.info, pos, axis=0)                  # (N, 27, 3, 3)
    d = pts[:, None, :] - mus
    d2 = jnp.einsum("nki,nkij,nkj->nk", d, lams, d)
    d2 = jnp.where(ok, d2, jnp.inf)
    best = jnp.argmin(d2, axis=1)
    take = lambda a: jnp.take_along_axis(
        a, best.reshape(n, 1, *([1] * (a.ndim - 2))), axis=1).squeeze(1)
    mu = take(mus)
    lam = take(lams)
    best_d2 = jnp.take_along_axis(d2, best[:, None], axis=1)[:, 0]
    matched = jnp.isfinite(best_d2)
    return mu, lam, matched, best_d2


def _ndt_terms(src: PointCloud, T: jax.Array, field: NDTField,
               spec: VoxelGridSpec, params: "NDTParams",
               gamma: Optional[jax.Array] = None,
               isotropic: bool = False, per_point_match: bool = False):
    """Smooth NDT objective + GN terms at pose T, summed over ALL valid
    Gaussians in each point's 27-neighborhood.

    Objective: cost(T) = -sum_n sum_k exp(-d2_nk / (2 gamma)) over gated
    (point, neighbor-Gaussian) pairs — Magnusson's score summed over
    neighboring cells. Summing (instead of best-cell selection) makes the
    cost a smooth function of T; best-cell switching was observed to
    produce spurious local minima ~20 cm off the optimum. ``gamma``
    (score_temperature) widens the attraction basin of thin planar
    Gaussians.

    GN linearization: H = sum s_nk J_n^T Lam_k J_n, b = sum s_nk J_n^T
    Lam_k r_nk, with s the tempered scores — the exact gradient direction
    of the objective (up to the fixed-weight GN approximation).
    """
    _require_sparse_views(field, "_ndt_terms")
    pts = se3.apply(T, src.points)
    n = pts.shape[0]

    if field.nbr_rows is not None:
        # Fastest tier: the dense neighbor-packed table. 3 (or 9) gather
        # indices per point fetch the full 27-cell neighborhood as wide
        # rows; validity comes from in-grid bounds + the per-cell flag.
        P, ok = _gather_nbr_rows(pts, field, spec)
    elif field.packed is not None:
        qkeys = pack_key(cell_coords(pts, spec), spec)
        nkeys = neighbor_offsets_keys(qkeys, spec)            # (N, 27)
        pos, hit = _probe_slots(field, nkeys)
        P = jnp.take(field.packed, pos, axis=0)               # (N, 27, 16)
        ok = hit & (P[..., 9] > 0.5)
    else:
        P = None

    if P is not None:
        # Mahalanobis math lane-wise on the packed rows.
        mus = P[..., 0:3]
        l00, l01, l02 = P[..., 3], P[..., 4], P[..., 5]
        l11, l12, l22 = P[..., 6], P[..., 7], P[..., 8]
        r = pts[:, None, :] - mus                             # (N, 27, 3)
        r0, r1, r2 = r[..., 0], r[..., 1], r[..., 2]
        # (Lambda r) components
        q0 = l00 * r0 + l01 * r1 + l02 * r2
        q1 = l01 * r0 + l11 * r1 + l12 * r2
        q2 = l02 * r0 + l12 * r1 + l22 * r2
        d2 = q0 * r0 + q1 * r1 + q2 * r2
        de2 = r0 * r0 + r1 * r1 + r2 * r2
        gate = ok & src.mask[:, None] & (de2 < params.max_corr_dist ** 2)
        g = params.score_temperature if gamma is None else gamma
        if isotropic:
            # point-to-mean alignment: thin Gaussians give no gradient when
            # the init error exceeds a few sigma (outdoor steps vs cm-thin
            # walls) — the isotropic stage pulls on Euclidean distance at
            # max_corr_dist scale regardless of covariance shape
            sig2 = (0.5 * params.max_corr_dist) ** 2
            q0, q1, q2 = r0 / sig2, r1 / sig2, r2 / sig2
            l00 = l11 = l22 = jnp.full_like(r0, 1.0 / sig2)
            l01 = l02 = l12 = jnp.zeros_like(r0)
            s = jnp.where(gate, jnp.exp(-0.5 * de2 / (sig2 * g)), 0.0)
        else:
            s = jnp.where(gate, jnp.exp(-0.5 * jnp.minimum(d2 / g, 30.0)),
                          0.0)
        # y_i = sum_k s (Lambda r)_i ; L = sum_k s Lambda (6 components)
        y = jnp.stack([jnp.sum(s * q0, 1), jnp.sum(s * q1, 1),
                       jnp.sum(s * q2, 1)], axis=1)           # (N, 3)
        c00 = jnp.sum(s * l00, 1); c01 = jnp.sum(s * l01, 1)
        c02 = jnp.sum(s * l02, 1); c11 = jnp.sum(s * l11, 1)
        c12 = jnp.sum(s * l12, 1); c22 = jnp.sum(s * l22, 1)
        L = jnp.stack([
            jnp.stack([c00, c01, c02], 1),
            jnp.stack([c01, c11, c12], 1),
            jnp.stack([c02, c12, c22], 1)], axis=1)           # (N, 3, 3)
    else:
        qkeys = pack_key(cell_coords(pts, spec), spec)
        nkeys = neighbor_offsets_keys(qkeys, spec)            # (N, 27)
        pos, hit = _probe_slots(field, nkeys)
        ok = hit & jnp.take(field.valid, pos)
        mus = jnp.take(field.means, pos, axis=0)              # (N, 27, 3)
        lams = jnp.take(field.info, pos, axis=0)              # (N, 27, 3, 3)
        r = pts[:, None, :] - mus                             # (N, 27, 3)
        d2 = jnp.einsum("nki,nkij,nkj->nk", r, lams, r)
        de2 = jnp.sum(r * r, axis=-1)
        gate = ok & src.mask[:, None] & (de2 < params.max_corr_dist ** 2)
        g = params.score_temperature if gamma is None else gamma
        if isotropic:
            sig2 = (0.5 * params.max_corr_dist) ** 2
            eye3 = jnp.eye(3, dtype=pts.dtype) / sig2
            lams = jnp.broadcast_to(eye3, lams.shape)
            s = jnp.where(gate, jnp.exp(-0.5 * de2 / (sig2 * g)), 0.0)
        else:
            s = jnp.where(gate,
                          jnp.exp(-0.5 * jnp.minimum(d2 / g, 30.0)), 0.0)
        L = jnp.einsum("nk,nkij->nij", s, lams)               # (N, 3, 3)
        y = jnp.einsum("nk,nkij,nkj->ni", s, lams, r)         # (N, 3)

    phat = jax.vmap(se3.hat)(pts)                             # (N, 3, 3)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=pts.dtype), (n, 3, 3))
    J = jnp.concatenate([eye, -phat], axis=2)                 # (N, 3, 6)
    H = jnp.einsum("nia,nij,njb->ab", J, L, J)                # (6, 6)
    b = jnp.einsum("nia,ni->a", J, y)                         # (6,)

    cost = -jnp.sum(s)
    matched = jnp.any(gate, axis=1)
    if per_point_match:
        # sharded registration: each device sees only its owned Gaussians;
        # the per-point indicator is psum'd so the matched fraction counts
        # a point once no matter how many shards gated it
        return H, b, cost, matched.astype(pts.dtype)
    frac = jnp.sum(matched.astype(pts.dtype)) / jnp.maximum(
        jnp.sum(src.mask.astype(pts.dtype)), 1.0)
    return H, b, cost, frac


@functools.partial(jax.jit, static_argnames=("spec", "params", "far_spec"))
def ndt_register(source: PointCloud, field: NDTField, spec: VoxelGridSpec,
                 init_T: Optional[jax.Array] = None,
                 params: NDTParams = NDTParams(),
                 far_field: Optional[NDTField] = None,
                 far_spec: Optional[VoxelGridSpec] = None) -> NDTResult:
    """Register a source cloud against an NDT field (scan-to-map).

    Levenberg-Marquardt with accept/reject on the true NDT objective:
    undamped Gauss-Newton on this cost oscillates between nearby minima
    (observed as max-iteration stalls), and a single oscillating estimate
    poisons downstream odometry through the constant-velocity prediction.
    Each iteration costs two correspondence passes (trial + current), both
    fully batched.

    ``far_field``/``far_spec`` (window path only): a coarser, wider
    companion field (the odometry pyramid's coarse level). Points OUTSIDE
    the fine window are binned into the far field's window and their
    coarse-Gaussian terms summed into the same H/b — street scans reach
    75 m while a 160x160x32 fine window covers +-40 m, so without this
    tier 17-21%% of every scan (carrying the long-baseline yaw
    information) is invisible to the fine objective. The coarse cells'
    wider covariances weight these terms down automatically; cost is one
    extra binning per stage and one far pass per LM evaluation.
    """
    if init_T is None:
        init_T = jnp.eye(4, dtype=source.points.dtype)
    src = source.sanitize()
    use_window = field.rows is not None
    n_src_pts = jnp.maximum(jnp.sum(src.mask.astype(jnp.float32)), 1.0)

    bin_scan = None
    if use_window:
        # frozen-bin path: bin the scan at each STAGE-entry pose
        # (kernels.ndt_terms — frozen bins, live gate), then every LM
        # evaluation of that stage is one point-major pass.  The coarse
        # GNC stage exists exactly to absorb inits more than a cell off,
        # so the fine stage re-bins at the coarse result: a binning per
        # stage is cheap against the silent accuracy loss of running the
        # fine solve on stale frozen 27-neighborhoods (points that
        # left/entered the window at the moved pose would otherwise never
        # enter the objective).
        from tpu_slam.kernels.ndt_terms import (bin_points, in_window,
                                                terms_pass, window_cells)
        ndt_terms = terms_pass(params.terms_impl)
        if params.isotropic_iterations > 0:
            raise ValueError(
                "isotropic_iterations > 0 needs the sparse field views; a "
                "window_dims field does not build them — use the coarse "
                "pyramid for large-init capture instead")
        dims = field.window_dims
        c0 = (field.origin_cell if field.origin_cell is not None
              else jnp.zeros((3,), jnp.int32))

        use_far = far_field is not None and far_field.rows is not None
        if use_far:
            far_dims = far_field.window_dims
            far_c0 = (far_field.origin_cell
                      if far_field.origin_cell is not None
                      else jnp.zeros((3,), jnp.int32))
            far_corr = params.max_corr_dist * (far_spec.leaf / spec.leaf)

        def bin_scan(T0):
            fine = bin_points(src.points, src.mask, T0, spec.origin,
                              spec.leaf, dims, params.raster_q, c0)
            if not use_far:
                return fine, None
            # far tier: ONLY the points whose fine-window cell at T0 is
            # out of range (in-window points are already in the fine
            # objective; coarse duplicates would double-count them)
            inside = in_window(window_cells(src.points, T0, spec.origin,
                                            spec.leaf, dims, c0), dims)
            far = bin_points(src.points, src.mask & ~inside, T0,
                             far_spec.origin, far_spec.leaf, far_dims,
                             params.raster_q, far_c0)
            return fine, far

    def lm_solve(T0, gamma, max_iters, tol, isotropic=False, bins=None):
        if use_window and not isotropic:
            (cells, keep), far_bins = bins

            def terms(T):
                H, b, cost, cnt = ndt_terms(
                    src.points, cells, keep, field.rows, T, gamma,
                    params.max_corr_dist, field.window_dims)
                if far_bins is not None:
                    Hf, bf, costf, cntf = ndt_terms(
                        src.points, far_bins[0], far_bins[1],
                        far_field.rows, T, gamma, far_corr,
                        far_field.window_dims)
                    H, b = H + Hf, b + bf
                    cost, cnt = cost + costf, cnt + cntf
                return H, b, cost, cnt / n_src_pts
        else:
            def terms(T):
                return _ndt_terms(src, T, field, spec, params, gamma,
                                  isotropic)

        if params.motion_prior_weight > 0.0:
            base_terms = terms
            w_prior = jnp.float32(params.motion_prior_weight)

            def terms(T):
                H, b, cost, frac = base_terms(T)
                xi_e = se3.log(se3.compose(T, se3.inverse(init_T)))
                H = H + w_prior * jnp.eye(6, dtype=H.dtype)
                b = b + w_prior * xi_e
                cost = cost + 0.5 * w_prior * jnp.sum(xi_e * xi_e)
                return H, b, cost, frac

        H0, b0, cost0, frac0 = terms(T0)

        def cond(state):
            T, lam_lm, cost, H, b, frac, it, dx = state
            return (it < max_iters) & (dx > tol) & (lam_lm < 1e6)

        def body(state):
            T, lam_lm, cost, H, b, frac, it, dx = state
            damp = lam_lm * jnp.maximum(jnp.trace(H) / 6.0, 1e-6)
            Hd = H + damp * jnp.eye(6, dtype=H.dtype)
            xi = -jnp.linalg.solve(Hd, b)
            xi = jnp.where(jnp.isfinite(xi), xi, 0.0)
            T_try = se3.retract(T, xi)
            H_t, b_t, cost_t, frac_t = terms(T_try)
            accept = cost_t < cost
            T_n = jnp.where(accept, T_try, T)
            lam_n = jnp.where(accept, jnp.maximum(lam_lm / 3.0, 1e-7),
                              lam_lm * 5.0)
            cost_n = jnp.where(accept, cost_t, cost)
            H_n = jnp.where(accept, H_t, H)
            b_n = jnp.where(accept, b_t, b)
            frac_n = jnp.where(accept, frac_t, frac)
            dx_n = jnp.where(accept, jnp.linalg.norm(xi), dx)
            return (T_n, lam_n, cost_n, H_n, b_n, frac_n, it + 1, dx_n)

        init = (T0, jnp.float32(1e-4), cost0, H0, b0, frac0, jnp.int32(0),
                jnp.float32(jnp.inf))
        return jax.lax.while_loop(cond, body, init)

    # Graduated non-convexity: a coarse high-temperature stage first —
    # the widened basin pulls in inits beyond the fine objective's comb of
    # local minima (discrete scan patterns alias in yaw) — then the fine
    # stage polishes at the nominal temperature.
    def staged_window_solve(T0, gamma, n_iters, iters_per_stage, tol):
        """Re-binned LM: bin at the CURRENT pose every few iterations.

        Frozen bins cannot express rotation (see NDTParams.rebin_iters);
        re-binning at stage entry is the NDT analog of ICP re-association.
        Convergence (dx <= tol) short-circuits remaining stages.
        """
        n_stages = -(-n_iters // iters_per_stage)

        def cond(c):
            s, T, it, frac, cost, dx = c
            return (s < n_stages) & (dx > tol)

        def body(c):
            s, T, it, frac, cost, dx = c
            T2, _, cost2, _, _, frac2, it2, dx2 = lm_solve(
                T, gamma, iters_per_stage, tol, bins=bin_scan(T))
            return (s + 1, T2, it + it2, frac2, cost2, dx2)

        init = (jnp.int32(0), T0, jnp.int32(0), jnp.float32(0.0),
                jnp.float32(jnp.inf), jnp.float32(jnp.inf))
        _, T, it, frac, cost, dx = jax.lax.while_loop(cond, body, init)
        return T, it, frac, cost, dx

    gamma_f = jnp.float32(params.score_temperature)
    T_c, it_c = init_T, jnp.int32(0)
    if use_window and params.yaw_candidates > 1:
        gamma_y = gamma_f * max(params.coarse_temperature_scale, 1.0)
        offs = jnp.linspace(-params.yaw_span, params.yaw_span,
                            params.yaw_candidates)

        def cost_at(dyaw):
            c, s = jnp.cos(dyaw), jnp.sin(dyaw)
            Rz = jnp.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0],
                            [0, 0, 0, 1.0]], jnp.float32)
            Rz = Rz.at[0, 0].set(c).at[0, 1].set(-s)
            Rz = Rz.at[1, 0].set(s).at[1, 1].set(c)
            Ty = T_c @ Rz                   # rotate heading, keep position
            cells, keep = bin_scan(Ty)[0]
            _, _, cost, _ = ndt_terms(src.points, cells, keep, field.rows,
                                      Ty, gamma_y, params.max_corr_dist,
                                      field.window_dims)
            return cost, Ty

        costs, Tys = [], []
        for k in range(params.yaw_candidates):
            cst, Ty = cost_at(offs[k])
            costs.append(cst)
            Tys.append(Ty)
        best = jnp.argmin(jnp.stack(costs))
        T_c = jnp.stack(Tys)[best]
    if params.isotropic_iterations > 0:
        # stage 0: point-to-mean pull — long-range basin independent of
        # the Gaussians' (often centimeter-thin) covariances
        T_c, _, _, _, _, _, it0, _ = lm_solve(
            T_c, gamma_f, params.isotropic_iterations,
            10.0 * params.tolerance, isotropic=True)
        it_c = it_c + it0
    if params.coarse_iterations > 0 and params.coarse_temperature_scale > 1.0:
        gamma_c = gamma_f * params.coarse_temperature_scale
        if use_window:
            # coarse absorbs the large (often rotational) init error:
            # re-bin every iteration — the coarse binning is cheap
            T_c, it1, _, _, _ = staged_window_solve(
                T_c, gamma_c, params.coarse_iterations, 1,
                10.0 * params.tolerance)
        else:
            T_c, _, _, _, _, _, it1, _ = lm_solve(
                T_c, gamma_c, params.coarse_iterations,
                10.0 * params.tolerance)
        it_c = it_c + it1

    if use_window:
        T, iters, frac, cost, dx = staged_window_solve(
            T_c, gamma_f, params.max_iterations,
            max(1, params.rebin_iters), params.tolerance)
    else:
        T, lam_lm, cost, H, b, frac, iters, dx = lm_solve(
            T_c, gamma_f, params.max_iterations, params.tolerance)
    n_src = jnp.maximum(jnp.sum(src.mask.astype(jnp.float32)), 1.0)
    return NDTResult(T=T, iterations=iters + it_c, score=-cost / n_src,
                     matched_fraction=frac, converged=dx <= params.tolerance)
