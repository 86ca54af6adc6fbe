"""Distributed Schur-complement pose-graph solve (keyframe-range sharding).

The SP-analog SURVEY.md §2.3/§7.3 commits to: a long trajectory's pose
graph is an *arrow* system — a block-tridiagonal odometry chain plus a few
long-range loop-closure couplings. This solver exploits that exactly:

  * poses are partitioned into D contiguous keyframe ranges (one per
    device on the ``graph`` mesh axis);
  * **separators** are the poses that couple ranges: range-boundary poses,
    loop-closure endpoints, and pose 0 (the gauge prior). Everything else
    is **interior** — coupled only to its chain neighbors;
  * each device eliminates its interior poses with a sequential
    block-tridiagonal forward pass (a ``lax.scan`` of 6x6 inverses — the
    exact LDL elimination, not an inner iterative solve), emitting Schur
    contributions onto the separator system as it goes;
  * the separator system (tiny: 2 per range boundary + loop endpoints) is
    combined with one ``psum`` and solved dense, replicated;
  * back-substitution is a reverse ``lax.scan`` per device.

Collective traffic per GN iteration: one ``psum_scatter`` distributing the
assembled block rows to their owner ranges, one ``psum`` of the
(nsep*6)^2 separator system, one ``all_gather`` of the (N, 6) update —
all riding ICI. The per-device work is O(N/D) tiny matrix ops; the
replicated work is O(E) edge linearization (cheap: vmapped 6x6 algebra)
plus the O((nsep*6)^3) separator solve.

This supersedes the edge-sharded PCG in ``pose_graph_dist`` for
long-trajectory graphs: elimination is exact (no CG iteration count to
tune) and the sequential depth per GN step is N/D instead of
cg_iterations x alltoall latency. The PCG path remains for graphs whose
loop density makes nearly every pose a separator.

The reference's (missing) SLAM core ran a single-process CPU graph solve
(SURVEY.md §2.2 [inferred]); this file is the from-scratch multi-device
design, sharing the residual/Jacobian conventions of graph.pose_graph so
both agree to float tolerance.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from tpu_slam.core import se3
from tpu_slam.graph.pose_graph import (GraphSolveParams, PoseGraph,
                                       _edge_residual_jac_batch)


def separator_mask(n_cap: int, range_size: int, edge_i: np.ndarray,
                   edge_j: np.ndarray, edge_mask: np.ndarray) -> np.ndarray:
    """Host-side separator classification.

    A pose is a separator iff it is pose 0 (gauge), a range-boundary pose
    (k mod K in {0, K-1}: chain edges crossing a boundary couple ranges),
    or an endpoint of a non-consecutive (loop) edge.
    """
    sep = np.zeros((n_cap,), bool)
    sep[0] = True
    k = np.arange(n_cap)
    sep |= (k % range_size == 0) | (k % range_size == range_size - 1)
    loop = edge_mask & (edge_j != edge_i + 1)
    sep[edge_i[loop]] = True
    sep[edge_j[loop]] = True
    return sep


def _robust_weights(r, info, params: GraphSolveParams, delta):
    """IRLS reweighting on edge chi (same kernels as graph.pose_graph)."""
    if params.robust_delta <= 0.0:
        return info
    chi = jnp.sqrt(jnp.maximum(jnp.einsum("ea,eab,eb->e", r, info, r), 1e-12))
    if params.robust_kernel == "huber":
        w = jnp.where(chi <= delta, 1.0, delta / chi)
    else:
        w = 1.0 / (1.0 + (chi / delta) ** 2)
    return info * w[:, None, None]


def _eliminate_scan(A, b, B, is_sep, slot, sentinel):
    """Forward block-tridiagonal elimination over one keyframe range.

    A: (K, 6, 6) diagonal blocks (damping/prior included).
    b: (K, 6) rhs. B: (K, 6, 6) chain coupling H[k, k+1] (zero at the
    range's last pose and wherever no in-range chain edge exists).
    is_sep/slot: separator flag and separator-system slot per pose.

    Returns per-step Schur emissions and the stored factors back-
    substitution needs. Interior pose k is eliminated exactly:

        S[sp, sp] -= G_k^T Ainv G_k        (sp = previous separator)
        rhs[sp]   -= G_k^T Ainv b_k
        M_{k+1}    = -B_k^T Ainv B_k       (message onto the next diag)
        G_{k+1}    = -B_k^T Ainv G_k       (fill onto the next pose)

    while separator pose k deposits its conditioned diagonal A_k + M_k,
    rhs, and the accumulated coupling G_k onto the separator system and
    resets the chain (G_{k+1} = B_k^T).
    """
    K = A.shape[0]
    zero6 = jnp.zeros((6, 6), A.dtype)

    def step(carry, inp):
        M, m, G, prev = carry
        A_k, b_k, B_k, sep_k, slot_k = inp
        A_eff = A_k + M
        b_eff = b_k + m
        Ainv = jnp.linalg.inv(A_eff)
        GtAinv = G.T @ Ainv
        BtAinv = B_k.T @ Ainv
        # next carry
        M_n = jnp.where(sep_k, zero6, -BtAinv @ B_k)
        m_n = jnp.where(sep_k, jnp.zeros((6,), A.dtype), -BtAinv @ b_eff)
        G_n = jnp.where(sep_k, B_k.T, -BtAinv @ G)
        prev_n = jnp.where(sep_k, slot_k, prev)
        # Schur emissions
        pa = jnp.where(sep_k, slot_k, prev)
        blk_a = jnp.where(sep_k, A_eff, -GtAinv @ G)
        pb = jnp.where(sep_k, prev, sentinel)
        qb = jnp.where(sep_k, slot_k, sentinel)
        blk_b = jnp.where(sep_k, G.T, zero6)
        rhs_c = jnp.where(sep_k, b_eff, -GtAinv @ b_eff)
        ys = (pa, blk_a, pb, qb, blk_b, rhs_c,
              Ainv, b_eff, G, prev)          # last four: back-sub factors
        return (M_n, m_n, G_n, prev_n), ys

    init = (zero6, jnp.zeros((6,), A.dtype), zero6,
            jnp.int32(sentinel))
    _, ys = jax.lax.scan(step, init, (A, b, B, is_sep, slot))
    return ys


def _backsub_scan(Ainv, b_eff, G, prev, B, is_sep, slot, x_sep):
    """Reverse substitution: x_k = Ainv (b_eff - B_k x_{k+1} - G_k x_sp)."""

    def step(x_next, inp):
        Ainv_k, b_k, G_k, prev_k, B_k, sep_k, slot_k = inp
        x_sp = x_sep[jnp.clip(prev_k, 0, x_sep.shape[0] - 1)]
        x_int = Ainv_k @ (b_k - B_k @ x_next - G_k @ x_sp)
        x_own = x_sep[jnp.clip(slot_k, 0, x_sep.shape[0] - 1)]
        x_k = jnp.where(sep_k, x_own, x_int)
        return x_k, x_k

    _, xs = jax.lax.scan(step, jnp.zeros((6,), Ainv.dtype),
                         (Ainv, b_eff, G, prev, B, is_sep, slot),
                         reverse=True)
    return xs


def _schur_gn(poses, n_nodes, edge_i, edge_j, edge_T, edge_info, edge_mask,
              sep_flags, slots, slot_node, params: GraphSolveParams,
              nsep_cap: int, range_size: int, axis_name: Optional[str]):
    """One full GN solve; runs per-device inside shard_map (or plain when
    axis_name is None). Edge arrays are the LOCAL shard; poses replicated.

    All matmuls run at HIGHEST precision: the elimination recurrence chains
    O(N/D) dependent 6x6 products, and reduced-precision matmul passes
    (bf16-class or TF32) amplify into large solution error on a 24-pose
    chain. The blocks are tiny, so full-f32 multiplies cost nothing.
    """
    with jax.default_matmul_precision("highest"):
        return _schur_gn_impl(poses, n_nodes, edge_i, edge_j, edge_T,
                              edge_info, edge_mask, sep_flags, slots,
                              slot_node, params, nsep_cap, range_size,
                              axis_name)


def _schur_gn_impl(poses, n_nodes, edge_i, edge_j, edge_T, edge_info,
                   edge_mask, sep_flags, slots, slot_node,
                   params: GraphSolveParams, nsep_cap: int, range_size: int,
                   axis_name: Optional[str]):
    n_cap = poses.shape[0]
    K = range_size
    sentinel = nsep_cap
    r_idx = (jax.lax.axis_index(axis_name) if axis_name is not None
             else jnp.int32(0))
    off = r_idx * K

    def psum(x):
        return jax.lax.psum(x, axis_name) if axis_name is not None else x

    deltas = _anneal_deltas(params)

    def gn_step(p, delta):
        Ti = jnp.take(p, edge_i, axis=0)
        Tj = jnp.take(p, edge_j, axis=0)
        r, Jj = _edge_residual_jac_batch(Ti, Tj, edge_T)
        w = edge_mask.astype(r.dtype)
        info = _robust_weights(r, edge_info * w[:, None, None], params,
                               delta)
        WJ = jnp.einsum("eab,ebc->eac", info, Jj)
        JtWJ = jnp.einsum("eba,ebc->eac", Jj, WJ)       # (E, 6, 6)
        JtWr = jnp.einsum("eba,ebc,ec->ea", Jj, info, r)

        # Assemble block rows (diag A, rhs b, chain coupling B) over the
        # local edge shard, then reduce-scatter each device its own range.
        A = jnp.zeros((n_cap, 6, 6), r.dtype)
        A = A.at[edge_i].add(JtWJ).at[edge_j].add(JtWJ)
        bvec = jnp.zeros((n_cap, 6), r.dtype)
        bvec = bvec.at[edge_i].add(JtWr).at[edge_j].add(-JtWr)
        chain = edge_mask & (edge_j == edge_i + 1) & (edge_i % K != K - 1)
        Bcpl = jnp.zeros((n_cap, 6, 6), r.dtype)
        Bcpl = Bcpl.at[jnp.where(chain, edge_i, n_cap - 1)].add(
            jnp.where(chain[:, None, None], -JtWJ, 0.0))
        if axis_name is not None:
            A = jax.lax.psum_scatter(A, axis_name, scatter_dimension=0,
                                     tiled=True)
            bvec = jax.lax.psum_scatter(bvec, axis_name,
                                        scatter_dimension=0, tiled=True)
            Bcpl = jax.lax.psum_scatter(Bcpl, axis_name,
                                        scatter_dimension=0, tiled=True)
        # local range slices + regularization
        eye6 = jnp.eye(6, dtype=r.dtype)
        A = A + params.damping * eye6
        gauge = (jnp.arange(K) + off == 0).astype(r.dtype)
        A = A + params.prior_weight * gauge[:, None, None] * eye6
        sep_l = jax.lax.dynamic_slice_in_dim(sep_flags, off, K)
        slot_l = jax.lax.dynamic_slice_in_dim(slots, off, K)

        (pa, blk_a, pb, qb, blk_b, rhs_c,
         Ainv_s, beff_s, G_s, prev_s) = _eliminate_scan(
            A, bvec, Bcpl, sep_l, slot_l, sentinel)

        # scatter emissions into the (padded) separator system
        S = jnp.zeros((nsep_cap + 1, nsep_cap + 1, 6, 6), r.dtype)
        S = S.at[pa, pa].add(blk_a)
        S = S.at[pb, qb].add(blk_b)
        S = S.at[qb, pb].add(jnp.swapaxes(blk_b, -1, -2))
        rhs = jnp.zeros((nsep_cap + 1, 6), r.dtype)
        rhs = rhs.at[pa].add(rhs_c)
        # direct separator-separator edges: loop closures and range-
        # crossing chain edges (off-diagonal blocks; diagonals already
        # flowed through A). H_ij = -JtWJ (symmetric).
        direct = edge_mask & ~chain
        si = jnp.where(direct, jnp.take(slots, edge_i), sentinel)
        sj = jnp.where(direct, jnp.take(slots, edge_j), sentinel)
        S = S.at[si, sj].add(jnp.where(direct[:, None, None], -JtWJ, 0.0))
        S = S.at[sj, si].add(jnp.where(direct[:, None, None], -JtWJ, 0.0))
        S = psum(S)
        rhs = psum(rhs)

        # Dense separator solve (replicated). Unused slots AND slots whose
        # node is graph padding (their diagonal is only the 1e-6 damping —
        # a 1e12 condition number against the 1e6 gauge prior, fatal in
        # float32) get identity diagonals; their rows/cols are zero so the
        # identity exactly decouples them.
        live_slot = slot_node < n_nodes
        Ssys = S[:nsep_cap, :nsep_cap].transpose(0, 2, 1, 3).reshape(
            nsep_cap * 6, nsep_cap * 6)
        pad_diag = jnp.repeat(~live_slot, 6).astype(r.dtype)
        Ssys = Ssys + jnp.diag(pad_diag)
        rhs_sep = jnp.where(live_slot[:, None], rhs[:nsep_cap], 0.0)
        x_sep = jnp.linalg.solve(
            Ssys, rhs_sep.reshape(-1)).reshape(nsep_cap, 6)

        xs = _backsub_scan(Ainv_s, beff_s, G_s, prev_s, Bcpl, sep_l,
                           slot_l, x_sep)                       # (K, 6)
        if axis_name is not None:
            xi = jax.lax.all_gather(xs, axis_name, tiled=True)  # (N, 6)
        else:
            xi = xs
        live = (jnp.arange(n_cap) < n_nodes)[:, None]
        xi = jnp.where(live, xi, 0.0)
        p_new = jax.vmap(se3.retract, in_axes=(0, 0))(p, xi)
        return p_new, None

    poses_out, _ = jax.lax.scan(gn_step, poses, deltas)

    Ti = jnp.take(poses_out, edge_i, axis=0)
    Tj = jnp.take(poses_out, edge_j, axis=0)
    r, _ = _edge_residual_jac_batch(Ti, Tj, edge_T)
    info = edge_info * edge_mask.astype(r.dtype)[:, None, None]
    chi2 = psum(jnp.sum(jnp.einsum("ea,eab,eb->e", r, info, r)))
    return poses_out, chi2


def _anneal_deltas(params: GraphSolveParams) -> jax.Array:
    K = params.gn_iterations
    if params.robust_delta > 0.0 and K > 1 and params.robust_anneal != 1.0:
        ratio = params.robust_anneal ** (1.0 / (K - 1))
        return jnp.asarray(
            [params.robust_delta * params.robust_anneal / ratio ** i
             for i in range(K)], jnp.float32)
    return jnp.full((K,), params.robust_delta, jnp.float32)


def optimize_pose_graph_schur(
    mesh: Optional[Mesh],
    graph: PoseGraph,
    params: GraphSolveParams = GraphSolveParams(),
    axis_name: Optional[str] = None,
) -> Tuple[PoseGraph, jax.Array]:
    """GN over the graph with the distributed Schur-complement elimination.

    ``mesh=None`` runs the identical arrow solve on one device (the
    separator structure still applies — useful for tests and as a fast
    exact solver for loop-sparse graphs).

    Requirements: node capacity divisible by the mesh extent; the number of
    separators (range boundaries + loop endpoints) is host-computed and the
    separator system capacity is bucketed to multiples of 16 to bound
    recompiles.
    """
    if mesh is not None and axis_name is None:
        axis_name = mesh.axis_names[0]
    n_dev = 1 if mesh is None else mesh.shape[axis_name]
    n_cap = graph.node_capacity
    if n_cap % n_dev != 0:
        raise ValueError(f"node capacity {n_cap} not divisible by mesh "
                         f"extent {n_dev}")
    K = n_cap // n_dev
    E = graph.edge_capacity
    if mesh is not None and E % n_dev != 0:
        raise ValueError(f"edge capacity {E} not divisible by mesh extent "
                         f"{n_dev}; pad the graph")

    ei = np.asarray(graph.edge_i)
    ej = np.asarray(graph.edge_j)
    em = np.asarray(graph.edge_mask)
    sep = separator_mask(n_cap, K, ei, ej, em)
    nsep = int(sep.sum())
    nsep_cap = max(16, -(-nsep // 16) * 16)
    slots = np.full((n_cap,), nsep_cap, np.int32)
    slots[sep] = np.arange(nsep, dtype=np.int32)
    # slot -> node map: lets the solve neutralize separator slots whose
    # node is graph padding (see the conditioning note in _schur_gn)
    slot_node = np.full((nsep_cap,), n_cap, np.int32)
    slot_node[:nsep] = np.nonzero(sep)[0].astype(np.int32)
    sep_flags = jnp.asarray(sep)
    slots = jnp.asarray(slots)
    slot_node = jnp.asarray(slot_node)

    if mesh is None:
        fn = jax.jit(functools.partial(
            _schur_gn, params=params, nsep_cap=nsep_cap, range_size=K,
            axis_name=None))
        poses, chi2 = fn(graph.poses, graph.n_nodes, graph.edge_i,
                         graph.edge_j, graph.edge_T, graph.edge_info,
                         graph.edge_mask, sep_flags, slots, slot_node)
        return dataclasses.replace(graph, poses=poses), chi2

    sharded = functools.partial(
        jax.shard_map, mesh=mesh, check_vma=False,
        in_specs=(P(), P(), P(axis_name), P(axis_name), P(axis_name),
                  P(axis_name), P(axis_name), P(), P(), P()),
        out_specs=(P(), P()))(
        functools.partial(_schur_gn, params=params, nsep_cap=nsep_cap,
                          range_size=K, axis_name=axis_name))
    poses, chi2 = sharded(graph.poses, graph.n_nodes, graph.edge_i,
                          graph.edge_j, graph.edge_T, graph.edge_info,
                          graph.edge_mask, sep_flags, slots, slot_node)
    return dataclasses.replace(graph, poses=poses), chi2
