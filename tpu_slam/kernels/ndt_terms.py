"""NDT terms pass — the hot loop of scan-to-map registration.

Point-major frozen-bin pass over a dense field window:

  * the field is the window's x-major ``(G, 16)`` rows (cell index
    ``(x*Wy + y)*Wz + z``): channels 0-2 world mean, 3-8 information
    upper triangle, 9 valid;
  * once per solve stage, ``bin_points`` computes each scan point's
    window cell at the stage-entry pose T0 and a keep mask: inside the
    window, and rank < ``q_cap`` among the points of its cell (stable,
    in input order);
  * every pass (``ndt_terms``) transforms the kept points by the live
    pose T, gathers the 27 neighbour rows of each point's FROZEN cell
    (bounds-masked per axis), evaluates the tempered Mahalanobis scores
    lane-wise on (N, 27), and reduces to the 6x6 normal equations.

A scan registered against a window reads about N x 27 x 64 bytes per
pass (~32 MB at 18.6k points), independent of the window size.

Objective (the math of registration.ndt._ndt_terms, with bins frozen at
the stage-start pose T0):

    cost(T) = -sum_{p, k in nbr27(bin(p))} s_pk,
    s_pk = exp(-d2_pk / (2 gamma)) gated by |T p - mu_k| < max_corr_dist
    H = sum s J^T Lambda J,  b = sum s J^T Lambda r   (J = [I | -hat(Tp)])

Freezing the bin (not the gate — the Euclidean gate tracks the live pose)
keeps every LM iteration minimizing ONE well-defined objective; within a
stage the pose moves far less than a cell, so the frozen 27-neighborhood
loses nothing.  Each solve stage re-bins at its own entry pose.

``ndt_terms_reference`` is a float64 numpy statement of the same pass,
written independently of the jnp code, for parity checks.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

Dims = Tuple[int, int, int]


# ---------------------------------------------------------------------------
# Binning (once per solve stage, amortized over the stage's passes)
# ---------------------------------------------------------------------------

def window_cells(points: jax.Array, T0: jax.Array, grid_origin: jax.Array,
                 leaf: float, dims: Dims, origin_cell: jax.Array
                 ) -> jax.Array:
    """(N, 3) int32 window cell of each point at pose T0.

    The cell is taken on the global lattice (``grid_origin``, ``leaf``)
    and shifted by the window corner ``origin_cell`` in integers, so two
    windows on one lattice (a device's halo'd chunk and the whole window)
    bin every point identically. Coordinates are clipped before the
    integer conversion (padding points sit at 1e8), and cells to
    [-1, dims], which leaves every in-window cell and the outside test
    unchanged.
    """
    pts_w = points @ T0[:3, :3].T + T0[:3, 3]
    rel = jnp.clip((pts_w - jnp.asarray(grid_origin, jnp.float32)) / leaf,
                   -2.0 ** 24, 2.0 ** 24)
    cc = jnp.floor(rel).astype(jnp.int32) - origin_cell
    return jnp.clip(cc, -1, jnp.asarray(dims, jnp.int32))


def in_window(cells: jax.Array, dims: Dims) -> jax.Array:
    """(N,) bool: cell inside the window on every axis."""
    return jnp.all((cells >= 0) & (cells < jnp.asarray(dims, jnp.int32)),
                   axis=1)


def cell_ranks(points: jax.Array, mask: jax.Array, T0: jax.Array,
               grid_origin: jax.Array, leaf: float, dims: Dims, q_cap: int,
               origin_cell: jax.Array
               ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """(cells (N,3), flat cell (N,) with G = outside, rank (N,)) at T0.

    rank is each point's position among the valid points of its cell in
    input order, exact below ``q_cap`` and saturating at it.
    """
    wx, wy, wz = dims
    g = wx * wy * wz
    n = points.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    cells = window_cells(points, T0, grid_origin, leaf, dims, origin_cell)
    inside = mask & in_window(cells, dims)
    cell = (cells[:, 0] * wy + cells[:, 1]) * wz + cells[:, 2]
    cell = jnp.where(inside, cell, g)
    # group points of a cell contiguously; only ranks < q_cap matter, so
    # rank comes from q_cap shifted compares on the sorted keys
    order = jnp.argsort(cell, stable=True)
    sc = jnp.take(cell, order)
    rank = jnp.zeros((n,), jnp.int32)
    for j in range(1, q_cap + 1):
        prev = jnp.where(idx >= j, jnp.take(sc, jnp.maximum(idx - j, 0)),
                         jnp.int32(-1))
        rank = rank + (prev == sc).astype(jnp.int32)
    rank = jnp.zeros((n,), jnp.int32).at[order].set(rank,
                                                    unique_indices=True)
    return cells, cell, rank


@functools.partial(jax.jit, static_argnames=("dims", "q_cap"))
def bin_points(points: jax.Array, mask: jax.Array, T0: jax.Array,
               grid_origin: jax.Array, leaf: float, dims: Dims,
               q_cap: int, origin_cell: Optional[jax.Array] = None
               ) -> Tuple[jax.Array, jax.Array]:
    """Frozen cells and keep mask of a scan at the stage-entry pose T0.

    The window's cell (0, 0, 0) is lattice cell ``origin_cell`` (default
    0) of the grid whose cell (0, 0, 0) has its corner at ``grid_origin``.
    Returns (cells (N, 3) int32, keep (N,) bool). A point is kept when it
    is valid, inside the window at T0, and among the first ``q_cap``
    points of its cell in input order; points outside the window or past
    the per-cell capacity do not enter the objective.
    """
    wx, wy, wz = dims
    if origin_cell is None:
        origin_cell = jnp.zeros((3,), jnp.int32)
    cells, cell, rank = cell_ranks(points, mask, T0, grid_origin, leaf,
                                   dims, q_cap, origin_cell)
    return cells, (cell < wx * wy * wz) & (rank < q_cap)


# ---------------------------------------------------------------------------
# The pass
# ---------------------------------------------------------------------------

def neighbour_index(cells: jax.Array, dims: Dims
                    ) -> Tuple[jax.Array, jax.Array]:
    """(N, 27) flat row index of each cell's 3x3x3 neighbours and the
    (N, 27) per-axis in-window mask; (dx, dy, dz) nested, dz fastest.
    Out-of-window neighbours get a clamped (valid) index and ok=False."""
    wx, wy, wz = dims
    n = cells.shape[0]
    d3 = jnp.array([-1, 0, 1], jnp.int32)
    nx = cells[:, 0:1] + d3
    ny = cells[:, 1:2] + d3
    nz = cells[:, 2:3] + d3
    okx = (nx >= 0) & (nx < wx)
    oky = (ny >= 0) & (ny < wy)
    okz = (nz >= 0) & (nz < wz)
    lin = ((nx[:, :, None, None] * wy + ny[:, None, :, None]) * wz
           + nz[:, None, None, :]).reshape(n, 27)
    ok = (okx[:, :, None, None] & oky[:, None, :, None]
          & okz[:, None, None, :]).reshape(n, 27)
    return jnp.clip(lin, 0, wx * wy * wz - 1), ok


def normal_equations(p: jax.Array, y: jax.Array, c: jax.Array
                     ) -> Tuple[jax.Array, jax.Array]:
    """H (6,6), b (6,) from per-point factors, J = [I | -hat(p)].

    p (N, 3) transformed points; y (N, 3) = sum_k s Lambda_k r_k;
    c (N, 6) = upper triangle [00 01 02 11 12 22] of sum_k s Lambda_k.
    H = sum J^T L J and b = sum J^T y expand in closed form per point,
    so the whole reduction is one fused elementwise + sum.
    """
    px, py, pz = p[:, 0], p[:, 1], p[:, 2]
    y0, y1, y2 = y[:, 0], y[:, 1], y[:, 2]
    c00, c01, c02, c11, c12, c22 = (c[:, 0], c[:, 1], c[:, 2], c[:, 3],
                                    c[:, 4], c[:, 5])
    # M = L hat(p): hat(p) = [[0,-pz,py],[pz,0,-px],[-py,px,0]]
    m00 = c01 * pz - c02 * py
    m01 = -c00 * pz + c02 * px
    m02 = c00 * py - c01 * px
    m10 = c11 * pz - c12 * py
    m11 = -c01 * pz + c12 * px
    m12 = c01 * py - c11 * px
    m20 = c12 * pz - c22 * py
    m21 = -c02 * pz + c22 * px
    m22 = c02 * py - c12 * px
    # row-major upper triangle of H: H_tt = L, H_tr = -M, H_rr = -hat(p) M
    terms = jnp.stack([
        c00, c01, c02, -m00, -m01, -m02,
        c11, c12, -m10, -m11, -m12,
        c22, -m20, -m21, -m22,
        pz * m10 - py * m20, pz * m11 - py * m21, pz * m12 - py * m22,
        -pz * m01 + px * m21, -pz * m02 + px * m22,
        py * m02 - px * m12,
        y0, y1, y2,
        py * y2 - pz * y1, pz * y0 - px * y2, px * y1 - py * y0], axis=1)
    tot = jnp.sum(terms, axis=0)
    iu0, iu1 = np.triu_indices(6)
    H = jnp.zeros((6, 6), jnp.float32).at[iu0, iu1].set(tot[:21])
    H = H + jnp.triu(H, 1).T
    return H, tot[21:27]


@functools.partial(jax.jit, static_argnames=("dims", "owned_x"))
def ndt_terms(points: jax.Array, cells: jax.Array, keep: jax.Array,
              rows: jax.Array, T: jax.Array, gamma: jax.Array,
              max_corr_dist: float, dims: Dims,
              owned_x: Optional[Tuple[int, int]] = None):
    """Frozen-bin NDT terms pass at pose T.

    points (N, 3) source frame; (cells, keep) from ``bin_points``; rows
    (G, 16) field window rows. Returns (H (6,6), b (6,), cost (),
    matched ()), matched = number of kept points with at least one gated
    neighbour.

    ``owned_x`` (lo, hi): count only points whose frozen x-cell is in
    [lo, hi). The sharded path bins the scan into halo-extended local
    windows, so each device counts only points binned in its owned chunk
    (H/b/cost still sum every point: cross-chunk (point, Gaussian) pairs
    are partitioned by Gaussian ownership and psum exactly).
    """
    pts = points @ T[:3, :3].T + T[:3, 3]
    lin, ok = neighbour_index(cells, dims)
    P = jnp.take(rows, lin, axis=0)                           # (N, 27, 16)
    mus = P[..., 0:3]
    l00, l01, l02 = P[..., 3], P[..., 4], P[..., 5]
    l11, l12, l22 = P[..., 6], P[..., 7], P[..., 8]
    r = pts[:, None, :] - mus
    r0, r1, r2 = r[..., 0], r[..., 1], r[..., 2]
    q0 = l00 * r0 + l01 * r1 + l02 * r2
    q1 = l01 * r0 + l11 * r1 + l12 * r2
    q2 = l02 * r0 + l12 * r1 + l22 * r2
    d2 = q0 * r0 + q1 * r1 + q2 * r2
    de2 = r0 * r0 + r1 * r1 + r2 * r2
    gate = (ok & keep[:, None] & (P[..., 9] > 0.5)
            & (de2 < jnp.float32(max_corr_dist) ** 2))
    inv_2g = 0.5 / jnp.asarray(gamma, jnp.float32)
    s = jnp.where(gate, jnp.exp(-jnp.minimum(d2 * inv_2g, 30.0)), 0.0)
    y = jnp.stack([jnp.sum(s * q0, 1), jnp.sum(s * q1, 1),
                   jnp.sum(s * q2, 1)], axis=1)
    c = jnp.stack([jnp.sum(s * l, 1) for l in (l00, l01, l02, l11, l12,
                                                l22)], axis=1)
    H, b = normal_equations(pts, y, c)
    matched = jnp.any(gate, axis=1)
    if owned_x is not None:
        lo, hi = owned_x
        matched = matched & (cells[:, 0] >= lo) & (cells[:, 0] < hi)
    return H, b, -jnp.sum(s), jnp.sum(matched.astype(jnp.float32))


def terms_pass(impl: str = "auto"):
    """The frozen-bin terms pass by name: 'xla' (ndt_terms), 'triton'
    (kernels.ndt_terms_triton, GPU only) or 'auto' (the Triton kernel on a
    GPU — measured faster end to end on the H100, PERF.md — and the XLA
    pass elsewhere); all share ndt_terms' contract."""
    if impl == "auto":
        impl = "triton" if jax.default_backend() == "gpu" else "xla"
    if impl == "xla":
        return ndt_terms
    if impl == "triton":
        from tpu_slam.kernels.ndt_terms_triton import ndt_terms_triton
        return ndt_terms_triton
    raise ValueError(f"unknown terms_impl {impl!r} "
                     "(use 'auto', 'xla' or 'triton')")


# ---------------------------------------------------------------------------
# Plain float64 reference (tests and the on-card parity check)
# ---------------------------------------------------------------------------

def bin_points_reference(points, mask, T0, grid_origin, leaf, dims, q_cap,
                         origin_cell=(0, 0, 0)):
    """numpy statement of bin_points: (cells (N,3) int64, keep (N,))."""
    points = np.asarray(points, np.float64)
    T0 = np.asarray(T0, np.float64)
    pw = points @ T0[:3, :3].T + T0[:3, 3]
    rel = (pw - np.asarray(grid_origin, np.float64)) / leaf
    cells = np.floor(np.clip(rel, -2.0 ** 24, 2.0 ** 24)).astype(np.int64)
    cells = np.clip(cells - np.asarray(origin_cell), -1, np.asarray(dims))
    inside = (np.asarray(mask, bool)
              & np.all((cells >= 0) & (cells < np.asarray(dims)), axis=1))
    keep = np.zeros(len(points), bool)
    seen = {}
    for i in np.flatnonzero(inside):
        key = tuple(cells[i])
        seen[key] = seen.get(key, 0) + 1
        keep[i] = seen[key] <= q_cap
    return cells, keep


def ndt_terms_reference(points, cells, keep, rows, T, gamma, max_corr_dist,
                        dims):
    """float64 numpy frozen-bin NDT terms: (H, b, cost, matched)."""
    wx, wy, wz = dims
    pts = np.asarray(points, np.float64)
    T = np.asarray(T, np.float64)
    rows = np.asarray(rows, np.float64)
    cells = np.asarray(cells)
    keep = np.asarray(keep, bool)
    p = pts @ T[:3, :3].T + T[:3, 3]
    n = len(p)
    L = np.zeros((n, 3, 3))
    y = np.zeros((n, 3))
    ssum = 0.0
    matched = np.zeros(n, bool)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nb = cells + np.array([dx, dy, dz])
                ok = keep & np.all((nb >= 0) & (nb < np.asarray(dims)),
                                   axis=1)
                lin = np.where(ok, (nb[:, 0] * wy + nb[:, 1]) * wz
                               + nb[:, 2], 0)
                R = rows[lin]
                lam = np.empty((n, 3, 3))
                for (i, j), ch in zip(((0, 0), (0, 1), (0, 2), (1, 1),
                                       (1, 2), (2, 2)), range(3, 9)):
                    lam[:, i, j] = lam[:, j, i] = R[:, ch]
                r = p - R[:, 0:3]
                lr = np.einsum("nij,nj->ni", lam, r)
                d2 = np.einsum("ni,ni->n", r, lr)
                gate = (ok & (R[:, 9] > 0.5)
                        & (np.sum(r * r, axis=1) < max_corr_dist ** 2))
                s = np.where(gate, np.exp(-np.minimum(d2 / (2.0 * gamma),
                                                      30.0)), 0.0)
                L += s[:, None, None] * lam
                y += s[:, None] * lr
                ssum += s.sum()
                matched |= gate
    J = np.zeros((n, 3, 6))
    J[:, :, :3] = np.eye(3)
    hat = np.zeros((n, 3, 3))
    hat[:, 0, 1], hat[:, 0, 2] = -p[:, 2], p[:, 1]
    hat[:, 1, 0], hat[:, 1, 2] = p[:, 2], -p[:, 0]
    hat[:, 2, 0], hat[:, 2, 1] = -p[:, 1], p[:, 0]
    J[:, :, 3:] = -hat
    H = np.einsum("nia,nij,njb->ab", J, L, J)
    b = np.einsum("nia,ni->a", J, y)
    return H, b, -ssum, int(matched.sum())
