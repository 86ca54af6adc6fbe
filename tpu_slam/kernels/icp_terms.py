"""Pair-ICP terms pass on frozen cell bins — correspondence + GN reduction.

The target is binned once per solve into a cell-major table: row g holds
the world coordinates and validity of up to Qt target points of window
cell g (``target_table``). The source is binned at the stage-entry pose
with ``kernels.ndt_terms.bin_points`` (frozen cells, Qs per-cell cap).
Each pass is point-major: every kept source point gathers the 27 table
rows around its frozen cell (27 x Qt candidates), takes the nearest
candidate under the live pose T, and the Huber-weighted point-to-point
normal equations reduce in one fused sum:

    w   = inlier * huber(|r|) / |r|-slope      (robust.huber_weight)
    H  += w J^T J,  b += w J^T r,  J = [I | -hat(T p)]

Exact nearest neighbour within one leaf; correspondences beyond ~leaf
are not seen (the brute-force ``registration.icp.icp`` covers arbitrary
displacement at O(N^2) cost).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from tpu_slam.kernels.ndt_terms import (Dims, cell_ranks, neighbour_index,
                                        normal_equations)

_BIG = 3.0e38


@functools.partial(jax.jit, static_argnames=("dims", "q_cap"))
def target_table(points: jax.Array, mask: jax.Array, origin_world: jax.Array,
                 leaf: float, dims: Dims, q_cap: int) -> jax.Array:
    """(G, Qt*4) cell-major table of world-frame target points.

    Slot q of row g is [x, y, z, 1] of the rank-q target point of cell g
    (ranks in input order); empty slots are zero. Points outside the
    window or past the per-cell capacity are dropped.
    """
    wx, wy, wz = dims
    g = wx * wy * wz
    eye = jnp.eye(4, dtype=jnp.float32)
    _, cell, rank = cell_ranks(points, mask, eye, origin_world, leaf, dims,
                               q_cap, jnp.zeros((3,), jnp.int32))
    keep = (cell < g) & (rank < q_cap)
    slot = jnp.where(keep, cell * q_cap + rank, g * q_cap)
    vals = jnp.concatenate([points, jnp.ones_like(points[:, :1])], axis=1)
    table = jnp.zeros((g * q_cap, 4), jnp.float32).at[slot].set(
        vals, mode="drop", unique_indices=True)
    return table.reshape(g, q_cap * 4)


@functools.partial(jax.jit, static_argnames=("dims",))
def icp_terms(points: jax.Array, cells: jax.Array, keep: jax.Array,
              table: jax.Array, T: jax.Array, max_corr_dist: float,
              huber_delta: float, dims: Dims):
    """Frozen-bin pair-ICP terms at pose T.

    points (N, 3) source frame; (cells, keep) from bin_points; table from
    target_table. Returns (H (6,6), b (6,), err (), nmatch (), wsum ()).
    """
    n = points.shape[0]
    qt = table.shape[1] // 4
    pts = points @ T[:3, :3].T + T[:3, 3]
    lin, ok = neighbour_index(cells, dims)
    C = jnp.take(table, lin, axis=0).reshape(n, 27 * qt, 4)
    d = pts[:, None, :] - C[..., :3]
    d2 = jnp.sum(d * d, axis=-1)
    valid = jnp.repeat(ok, qt, axis=1) & (C[..., 3] > 0.5)
    d2 = jnp.where(valid, d2, _BIG)
    best = jnp.argmin(d2, axis=1)
    best_d2 = jnp.take_along_axis(d2, best[:, None], axis=1)[:, 0]
    q_best = jnp.take_along_axis(C[..., :3], best[:, None, None], axis=1)[:, 0]
    matched = keep & (best_d2 < jnp.float32(max_corr_dist) ** 2)
    dist = jnp.sqrt(jnp.maximum(best_d2, 1e-18))
    w = jnp.where(matched, jnp.where(dist <= huber_delta, 1.0,
                                     huber_delta / dist), 0.0)
    zero = jnp.zeros_like(w)
    y = w[:, None] * (pts - q_best)
    c = jnp.stack([w, zero, zero, w, zero, w], axis=1)
    H, b = normal_equations(pts, y, c)
    return (H, b, jnp.sum(jnp.where(matched, w * best_d2, 0.0)),
            jnp.sum(matched.astype(jnp.float32)), jnp.sum(w))


def icp_terms_reference(points, cells, keep, tgt_points, tgt_cells,
                        tgt_keep, T, max_corr_dist, huber_delta,
                        chunk=256):
    """float64 numpy frozen-bin pair-ICP terms (brute force over the kept
    target points of each source point's 27-neighbourhood)."""
    p = np.asarray(points, np.float64)
    T = np.asarray(T, np.float64)
    p = p @ T[:3, :3].T + T[:3, 3]
    cells = np.asarray(cells)
    keep = np.asarray(keep, bool)
    tk = np.asarray(tgt_keep, bool)
    tq = np.asarray(tgt_points, np.float64)[tk]
    tc = np.asarray(tgt_cells)[tk]
    best_d2 = np.full(len(p), np.inf)
    best_q = np.zeros((len(p), 3))
    for s in range(0, len(p), chunk):
        ps, cs = p[s:s + chunk], cells[s:s + chunk]
        near = np.all(np.abs(cs[:, None, :] - tc[None, :, :]) <= 1, axis=2)
        d2 = np.sum((ps[:, None, :] - tq[None, :, :]) ** 2, axis=2)
        d2 = np.where(near, d2, np.inf)
        if d2.shape[1] == 0:
            continue
        j = np.argmin(d2, axis=1)
        best_d2[s:s + chunk] = d2[np.arange(len(ps)), j]
        best_q[s:s + chunk] = tq[j]
    matched = keep & (best_d2 < max_corr_dist ** 2)
    dist = np.sqrt(np.maximum(np.where(matched, best_d2, 1.0), 1e-18))
    w = np.where(matched, np.where(dist <= huber_delta, 1.0,
                                   huber_delta / dist), 0.0)
    r = np.where(matched[:, None], p - best_q, 0.0)
    J = np.zeros((len(p), 3, 6))
    J[:, :, :3] = np.eye(3)
    J[:, 0, 4], J[:, 0, 5] = p[:, 2], -p[:, 1]
    J[:, 1, 3], J[:, 1, 5] = -p[:, 2], p[:, 0]
    J[:, 2, 3], J[:, 2, 4] = p[:, 1], -p[:, 0]
    H = np.einsum("nia,n,nib->ab", J, w, J)
    b = np.einsum("nia,ni->a", J, w[:, None] * r)
    err = float(np.sum(np.where(matched, w * best_d2, 0.0)))
    return H, b, err, int(matched.sum()), float(w.sum())
