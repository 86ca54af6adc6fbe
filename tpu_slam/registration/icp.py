"""Point-to-point and point-to-plane ICP as jit-compiled Gauss-Newton on SE(3).

Replacement for the reference SLAM core's CUDA ICP iteration kernels
(BASELINE.json north_star). Design:

  * the whole solve is one jit program: `lax.while_loop` over GN iterations,
    each iteration = NN correspondence (tiled brute force, or the frozen
    cell bins of ``icp_raster``) + masked residual/Jacobian build + a 6x6
    normal-equation reduction;
  * the reduction J^T J / J^T r is a single einsum over the point axis —
    a large batched matmul XLA fuses with the residual computation;
  * no dynamic shapes anywhere: rejected correspondences get weight 0.

Left-multiplicative convention: the update is T <- exp(xi) @ T and the
point Jacobian of exp(xi) @ p is [I | -hat(p)].
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from tpu_slam.core import se3
from tpu_slam.core.pointcloud import PointCloud
from tpu_slam.kernels.nn_search import nearest_neighbors
from tpu_slam.registration.robust import huber_weight


@dataclasses.dataclass(frozen=True)
class ICPParams:
    """Static ICP configuration (hashable -> usable as a jit static arg)."""

    max_iterations: int = 30
    tolerance: float = 1e-4          # stop when ||xi|| drops below this
    max_corr_dist: float = 1.0       # reject correspondences farther than this
    huber_delta: float = 0.5         # robust kernel width (meters)
    point_to_plane: bool = False
    damping: float = 1e-6            # Levenberg-style diagonal damping


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ICPResult:
    T: jax.Array                 # (4, 4) source -> target transform
    iterations: jax.Array        # int32, GN iterations executed
    error: jax.Array             # mean squared residual over inliers
    matched_fraction: jax.Array  # inliers / valid source points
    converged: jax.Array         # bool


def _gn_step_point_to_point(src_w, tgt_pts, weights):
    """Build H (6,6), b (6,) for r_i = p_i - q_i with J_i = [I | -hat(p_i)].

    With J = [I, -P] (P = hat(p)), the normal equations have closed form:
      H = [[ sum w I      ,  -sum w P      ],
           [ sum w P^T... ]]  — we just build J explicitly per point and
    einsum; at N ~ 1e4-1e5 this is one fused reduction.
    """
    n = src_w.shape[0]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=src_w.dtype), (n, 3, 3))
    phat = jax.vmap(se3.hat)(src_w)                       # (N, 3, 3)
    J = jnp.concatenate([eye, -phat], axis=2)             # (N, 3, 6)
    r = src_w - tgt_pts                                   # (N, 3)
    w = weights[:, None, None]
    H = jnp.einsum("nij,nik->jk", J * w, J)
    b = jnp.einsum("nij,ni->j", J * w, r)
    err = jnp.sum(weights * jnp.sum(r * r, axis=-1))
    return H, b, err


def _gn_step_point_to_plane(src_w, tgt_pts, tgt_normals, weights):
    """H, b for scalar residuals r_i = n_i . (p_i - q_i), J_i = n_i^T [I | -hat(p)]."""
    phat = jax.vmap(se3.hat)(src_w)                       # (N, 3, 3)
    Jr = -jnp.einsum("ni,nij->nj", tgt_normals, phat)     # (N, 3) rotational part
    J = jnp.concatenate([tgt_normals, Jr], axis=1)        # (N, 6)
    r = jnp.sum(tgt_normals * (src_w - tgt_pts), axis=-1)  # (N,)
    w = weights
    H = jnp.einsum("ni,nj->ij", J * w[:, None], J)
    b = jnp.sum(J * (w * r)[:, None], axis=0)
    err = jnp.sum(w * r * r)
    return H, b, err


@functools.partial(jax.jit, static_argnames=("params",))
def icp(source: PointCloud, target: PointCloud,
        init_T: Optional[jax.Array] = None,
        params: ICPParams = ICPParams(),
        target_normals: Optional[jax.Array] = None) -> ICPResult:
    """Register ``source`` onto ``target``; returns T with T@source ~= target.

    Correspondences are recomputed every iteration via brute-force NN
    (kernels.nn_search). For point-to-plane, pass per-target-point normals.
    """
    if init_T is None:
        init_T = jnp.eye(4, dtype=source.points.dtype)
    if params.point_to_plane and target_normals is None:
        raise ValueError("point_to_plane ICP requires target_normals")

    tgt_pts = target.sanitize().points
    src = source.sanitize()
    n_valid = jnp.maximum(jnp.sum(src.mask.astype(jnp.float32)), 1.0)

    def cond(state):
        T, it, dx, err, frac = state
        return jnp.logical_and(it < params.max_iterations,
                               dx > params.tolerance)

    def body(state):
        T, it, dx, _, _ = state
        src_w = se3.apply(T, src.points)
        idx, dist = nearest_neighbors(src_w, tgt_pts)
        matched = jnp.take(tgt_pts, idx, axis=0)
        inlier = jnp.logical_and(src.mask, dist < params.max_corr_dist)
        w = inlier.astype(src_w.dtype) * huber_weight(dist, params.huber_delta)

        if params.point_to_plane:
            nrm = jnp.take(target_normals, idx, axis=0)
            H, b, err = _gn_step_point_to_plane(src_w, matched, nrm, w)
        else:
            H, b, err = _gn_step_point_to_point(src_w, matched, w)

        wsum = jnp.maximum(jnp.sum(w), 1e-6)
        H = H + params.damping * jnp.trace(H) / 6.0 * jnp.eye(6, dtype=H.dtype)
        xi = -jnp.linalg.solve(H, b)
        # Guard against singular systems (too few inliers).
        xi = jnp.where(jnp.isfinite(xi), xi, 0.0)
        T_new = se3.retract(T, xi)
        frac = jnp.sum(inlier.astype(jnp.float32)) / n_valid
        return (T_new, it + 1, jnp.linalg.norm(xi), err / wsum, frac)

    init = (init_T, jnp.int32(0), jnp.float32(jnp.inf), jnp.float32(jnp.inf),
            jnp.float32(0.0))
    T, iters, dx, err, frac = jax.lax.while_loop(cond, body, init)
    return ICPResult(T=T, iterations=iters, error=err,
                     matched_fraction=frac,
                     converged=dx <= params.tolerance)


@functools.partial(jax.jit,
                   static_argnames=("params", "dims", "leaf", "qs", "qt",
                                    "axis_perm"))
def icp_raster(source: PointCloud, target: PointCloud,
               init_T: Optional[jax.Array] = None,
               params: ICPParams = ICPParams(),
               dims: tuple = (32, 32, 16), leaf: float = 0.5,
               qs: int = 8, qt: int = 8,
               origin_world: Optional[jax.Array] = None,
               axis_perm: Optional[tuple] = None) -> ICPResult:
    """Pair ICP on frozen cell bins (kernels.icp_terms).

    The target is binned once into a cell-major table (world frame), the
    source at each stage's entry pose; every GN iteration is then ONE
    point-major pass fusing 27-neighborhood correspondence search, Huber
    weighting, and the 6x6 reduction.  Exact NN within one ``leaf``;
    correspondences beyond ~leaf are not seen, so pick leaf >= the
    expected initial displacement (the brute-force ``icp`` covers
    arbitrary displacement at O(N^2) cost).

    ``dims`` x ``leaf`` must cover both clouds around ``origin_world``
    (default: centered on the target centroid); points outside the
    window or beyond the per-cell capacity ``qs``/``qt`` drop out of the
    objective (counted against matched_fraction honestly).
    """
    from tpu_slam.kernels.icp_terms import icp_terms, target_table
    from tpu_slam.kernels.ndt_terms import bin_points

    if init_T is None:
        init_T = jnp.eye(4, dtype=source.points.dtype)
    src = source.sanitize()
    tgt = target.sanitize()

    # Optional axis permutation: ``axis_perm`` (e.g. (2, 0, 1) = world z
    # on window x) is a proper rotation, so the solve runs in permuted
    # coordinates and the result is conjugated back. ``dims`` /
    # ``origin_world`` are in PERMUTED space.
    Pi = None
    if axis_perm is not None:
        Pm = jnp.zeros((4, 4), jnp.float32)
        for row, col in enumerate(axis_perm):
            Pm = Pm.at[row, col].set(1.0)
        Pm = Pm.at[3, 3].set(1.0)
        Pi = Pm
        perm = list(axis_perm)
        src = PointCloud(points=src.points[:, perm], mask=src.mask)
        tgt = PointCloud(points=tgt.points[:, perm], mask=tgt.mask)
        init_T = Pi @ init_T @ Pi.T
    n_valid = jnp.maximum(jnp.sum(src.mask.astype(jnp.float32)), 1.0)

    if origin_world is None:
        tw = jnp.sum(tgt.mask.astype(jnp.float32))
        cen = (jnp.sum(jnp.where(tgt.mask[:, None], tgt.points, 0.0), axis=0)
               / jnp.maximum(tw, 1.0))
        half = jnp.asarray([d * leaf / 2 for d in dims], jnp.float32)
        origin_world = jnp.round((cen - half) / leaf) * leaf
    table = target_table(tgt.points, tgt.mask, origin_world, leaf, dims, qt)

    def solve_stage(T0, max_iters, it0):
        cells, keep = bin_points(src.points, src.mask, T0, origin_world,
                                 leaf, dims, qs)

        def cond(state):
            T, it, dx, _, _ = state
            return jnp.logical_and(it < max_iters, dx > params.tolerance)

        def body(state):
            T, it, dx, _, _ = state
            H, b, err, nmatch, wsum = icp_terms(
                src.points, cells, keep, table, T, params.max_corr_dist,
                params.huber_delta, dims)
            H = (H + params.damping * jnp.trace(H) / 6.0
                 * jnp.eye(6, dtype=H.dtype))
            xi = -jnp.linalg.solve(H, b)
            xi = jnp.where(jnp.isfinite(xi), xi, 0.0)
            T_new = se3.retract(T, xi)
            frac = nmatch / n_valid
            return (T_new, it + 1, jnp.linalg.norm(xi),
                    err / jnp.maximum(wsum, 1e-6), frac)

        init = (T0, it0, jnp.float32(jnp.inf), jnp.float32(jnp.inf),
                jnp.float32(0.0))
        return jax.lax.while_loop(cond, body, init)

    # two stages with a re-bin between: the first absorbs the init error,
    # the second re-bins at the refined pose so the frozen 27-neighborhoods
    # and per-cell Q subsets track the converged alignment (one frozen bin
    # for the whole solve measured ~4 cm of residual bias at 0.15 m inits)
    half = max(1, params.max_iterations // 2)
    T_m, it_m, _, _, _ = solve_stage(init_T, half, jnp.int32(0))
    T, iters, dx, err, frac = solve_stage(T_m, params.max_iterations, it_m)
    if Pi is not None:
        T = Pi.T @ T @ Pi
    return ICPResult(T=T, iterations=iters, error=err,
                     matched_fraction=frac,
                     converged=dx <= params.tolerance)


def icp_auto(source: PointCloud, target: PointCloud,
             init_T: Optional[jax.Array] = None,
             params: ICPParams = ICPParams(),
             crossover: int = 12288, **raster_kwargs) -> ICPResult:
    """Size-routed pair ICP: brute-force under ``crossover`` points,
    the frozen-bin tier (icp_raster) above it.

    The brute tier's cost is O(N^2) per iteration (one distance sweep),
    the raster tier's is ~O(N) per pass plus one binning per stage;
    measured on an H100 (700 W): 8k points brute 1093/s vs raster 726/s,
    32k raster 487/s vs brute 100/s, which puts the crossover near 11-12k.
    The capacity is static, so the routing is a trace-time branch (no
    runtime cost). ``raster_kwargs`` (dims/leaf/origin_world/axis_perm)
    configure the raster tier; see icp_raster.
    """
    if source.capacity < crossover:
        return icp(source, target, init_T=init_T, params=params)
    return icp_raster(source, target, init_T=init_T, params=params,
                      **raster_kwargs)
