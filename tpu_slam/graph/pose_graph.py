"""Pose-graph optimization: Gauss-Newton over SE(3) with a matrix-free PCG.

The reference's SLAM core ran a CPU graph-SLAM backend (g2o-style,
SURVEY.md §2.2 [inferred]). This design keeps the graph as flat
device arrays and never materializes the sparse Hessian:

  * edge residuals r_e = log(Z_e^-1 T_i^-1 T_j) and their exact Jacobians
    (via SE(3) adjoints + 2nd-order inverse left Jacobian, core.se3) are
    built for ALL edges at once — one vmapped batch;
  * the normal-equation product H @ v is two gathers, a batched 6x6 matmul,
    and two segment-sums — embarrassingly parallel over edges, the shape
    that later shards over a mesh (distributed/schur.py);
  * block-Jacobi preconditioned conjugate gradient solves each GN step; a
    dense solver is kept for small graphs / exactness tests;
  * gauge freedom is fixed by a prior on pose 0.

Edges are stored padded to a static capacity with a validity mask, so graph
growth never recompiles.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from tpu_slam.core import se3


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PoseGraph:
    """Flat pose-graph pytree (static capacities).

    Attributes:
      poses: (N, 4, 4) world<-node transforms; slots >= n_nodes are identity.
      n_nodes: () int32 — number of live nodes.
      edge_i, edge_j: (E,) int32 endpoint indices (i < j for odometry edges).
      edge_T: (E, 4, 4) measured relative transform Z = T_i^-1 T_j.
      edge_info: (E, 6, 6) information matrices (Lambda).
      edge_mask: (E,) bool — live edges.
    """

    poses: jax.Array
    n_nodes: jax.Array
    edge_i: jax.Array
    edge_j: jax.Array
    edge_T: jax.Array
    edge_info: jax.Array
    edge_mask: jax.Array

    @property
    def node_capacity(self) -> int:
        return self.poses.shape[0]

    @property
    def edge_capacity(self) -> int:
        return self.edge_i.shape[0]


def empty_graph(node_capacity: int, edge_capacity: int) -> PoseGraph:
    eye = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32),
                           (node_capacity, 4, 4))
    return PoseGraph(
        poses=eye,
        n_nodes=jnp.int32(0),
        edge_i=jnp.zeros((edge_capacity,), jnp.int32),
        edge_j=jnp.zeros((edge_capacity,), jnp.int32),
        edge_T=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32),
                                (edge_capacity, 4, 4)),
        edge_info=jnp.broadcast_to(jnp.eye(6, dtype=jnp.float32),
                                   (edge_capacity, 6, 6)),
        edge_mask=jnp.zeros((edge_capacity,), bool),
    )


@dataclasses.dataclass(frozen=True)
class GraphSolveParams:
    """Static solver configuration."""

    gn_iterations: int = 10
    cg_iterations: int = 50
    cg_tolerance: float = 1e-8
    damping: float = 1e-6          # Levenberg diagonal damping
    prior_weight: float = 1e6      # gauge prior on pose 0
    solver: str = "pcg"            # 'pcg' | 'dense'
    robust_delta: float = 0.0      # robust IRLS width on edge chi (0 = off):
                                   # a wrong loop closure gets its influence
                                   # cut instead of folding the trajectory
    robust_kernel: str = "cauchy"  # 'huber' (delta/chi, linear influence)
                                   # | 'cauchy' (1/(1+chi^2/delta^2),
                                   # redescending — rejects gross outliers)
    robust_anneal: float = 1.0     # optional GNC: first-iteration delta
                                   # multiplier, decayed geometrically to
                                   # robust_delta. Default off: with a
                                   # strongly-weighted wrong loop edge the
                                   # wide early iterations fold the graph
                                   # before rejection tightens; the fixed
                                   # redescending kernel recovers better
                                   # from a drifted init
    trust_loops: bool = False      # exempt loop edges (j - i > 1) from the
                                   # robust weight. At a drifted init a
                                   # CORRECT loop edge carries the whole
                                   # accumulated-drift residual while the
                                   # odometry edges (which built the init)
                                   # carry none — a tight kernel then
                                   # rejects exactly the edges that could
                                   # fix the trajectory (r5 diag: oracle
                                   # GT loop edges left ATE unchanged).
                                   # Enable when loops are geometrically
                                   # verified upstream (the symmetric
                                   # cycle gate of graph.loop_closure);
                                   # the robust weight then localizes
                                   # odometry slips instead.


# ---------------------------------------------------------------------------
# Residuals and Jacobians (batched over edges)
# ---------------------------------------------------------------------------

def _edge_residual_jac(Ti, Tj, Z):
    """Residual r = log(Z^-1 Ti^-1 Tj) and exact Jacobians wrt left-
    multiplicative perturbations exp(xi_i) Ti, exp(xi_j) Tj.

    With B = (Ti Z)^-1:  J_j = Jl^-1(r) Ad(B),  J_i = -J_j  (derivation in
    the module docstring of core.se3 adjoint identities).
    """
    E = se3.inverse(Z) @ se3.inverse(Ti) @ Tj
    r = se3.log(E)
    B = se3.inverse(Ti @ Z)
    Jj = se3.left_jacobian_inv_approx(r) @ se3.adjoint(B)
    return r, Jj


_edge_residual_jac_batch = jax.vmap(_edge_residual_jac)


def _gather_edge_terms(graph: PoseGraph):
    """Per-edge (r, J_j, weighted blocks). Masked edges contribute zeros."""
    Ti = jnp.take(graph.poses, graph.edge_i, axis=0)
    Tj = jnp.take(graph.poses, graph.edge_j, axis=0)
    r, Jj = _edge_residual_jac_batch(Ti, Tj, graph.edge_T)
    w = graph.edge_mask.astype(r.dtype)
    info = graph.edge_info * w[:, None, None]
    return r, Jj, info


def _build_rhs_and_diag(graph: PoseGraph, params: GraphSolveParams,
                        delta: Optional[jax.Array] = None):
    """-J^T W r (the GN rhs) and the block-diagonal of H (preconditioner).

    ``delta`` is the robust width for THIS iteration (graduated
    non-convexity anneals it across GN iterations: at the drifted initial
    estimate even correct loop closures carry large chi, so a fixed tight
    kernel would reject them along with the outliers).
    """
    n = graph.node_capacity
    r, Jj, info = _gather_edge_terms(graph)
    if params.robust_delta > 0.0:
        d = params.robust_delta if delta is None else delta
        chi = jnp.sqrt(jnp.maximum(
            jnp.einsum("ea,eab,eb->e", r, info, r), 1e-12))
        if params.robust_kernel == "huber":
            w = jnp.where(chi <= d, 1.0, d / chi)
        else:  # cauchy (redescending)
            w = 1.0 / (1.0 + (chi / d) ** 2)
        if params.trust_loops:
            w = jnp.where(graph.edge_j - graph.edge_i > 1, 1.0, w)
        info = info * w[:, None, None]
    WJ = jnp.einsum("eab,ebc->eac", info, Jj)         # (E, 6, 6)
    Wr = jnp.einsum("eab,eb->ea", info, r)            # (E, 6)
    JtWr_j = jnp.einsum("eba,eb->ea", Jj, Wr)         # J_j^T W r
    # rhs = -J^T W r with J_i = -J_j
    b = jnp.zeros((n, 6), r.dtype)
    b = b.at[graph.edge_i].add(JtWr_j)
    b = b.at[graph.edge_j].add(-JtWr_j)

    JtWJ = jnp.einsum("eba,ebc->eac", Jj, WJ)         # J_j^T W J_j (= i block)
    diag = jnp.zeros((n, 6, 6), r.dtype)
    diag = diag.at[graph.edge_i].add(JtWJ)
    diag = diag.at[graph.edge_j].add(JtWJ)
    # gauge prior on pose 0 and damping
    diag = diag.at[0].add(params.prior_weight * jnp.eye(6, dtype=r.dtype))
    diag = diag + params.damping * jnp.eye(6, dtype=r.dtype)
    return b, diag, (r, Jj, info)


def _hv(graph: PoseGraph, params: GraphSolveParams, edge_terms, v):
    """H @ v without materializing H. v: (N, 6)."""
    r, Jj, info = edge_terms
    vi = jnp.take(v, graph.edge_i, axis=0)
    vj = jnp.take(v, graph.edge_j, axis=0)
    # u_e = J_i v_i + J_j v_j = J_j (v_j - v_i)
    u = jnp.einsum("eab,eb->ea", Jj, vj - vi)
    Wu = jnp.einsum("eab,eb->ea", info, u)
    JtWu = jnp.einsum("eba,eb->ea", Jj, Wu)
    out = jnp.zeros_like(v)
    out = out.at[graph.edge_i].add(-JtWu)
    out = out.at[graph.edge_j].add(JtWu)
    out = out.at[0].add(params.prior_weight * v[0])
    return out + params.damping * v


def _solve_pcg(graph, params, b, diag, edge_terms):
    """Block-Jacobi preconditioned CG for H x = b."""
    Minv = jnp.linalg.inv(diag)                        # (N, 6, 6)

    def precond(x):
        return jnp.einsum("nab,nb->na", Minv, x)

    def dot(a, c):
        return jnp.sum(a * c)

    x0 = jnp.zeros_like(b)
    r0 = b - _hv(graph, params, edge_terms, x0)
    z0 = precond(r0)
    p0 = z0
    rz0 = dot(r0, z0)

    def body(state):
        x, r, p, rz, it = state
        Hp = _hv(graph, params, edge_terms, p)
        alpha = rz / jnp.maximum(dot(p, Hp), 1e-30)
        x = x + alpha * p
        r = r - alpha * Hp
        z = precond(r)
        rz_new = dot(r, z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        p = z + beta * p
        return (x, r, p, rz_new, it + 1)

    def cond(state):
        _, r, _, _, it = state
        return jnp.logical_and(it < params.cg_iterations,
                               dot(r, r) > params.cg_tolerance)

    x, _, _, _, _ = jax.lax.while_loop(cond, body, (x0, r0, p0, rz0,
                                                    jnp.int32(0)))
    return x


def _solve_dense(graph, params, b, diag, edge_terms):
    """Exact dense solve (small graphs and tests)."""
    n = graph.node_capacity
    r, Jj, info = edge_terms
    WJ = jnp.einsum("eab,ebc->eac", info, Jj)
    JtWJ = jnp.einsum("eba,ebc->eac", Jj, WJ)         # (E, 6, 6)

    H = jnp.zeros((n, 6, n, 6), b.dtype)
    H = H.at[graph.edge_i, :, graph.edge_i, :].add(JtWJ)
    H = H.at[graph.edge_j, :, graph.edge_j, :].add(JtWJ)
    H = H.at[graph.edge_i, :, graph.edge_j, :].add(-JtWJ)
    H = H.at[graph.edge_j, :, graph.edge_i, :].add(-JtWJ)
    Hd = H.reshape(6 * n, 6 * n)
    Hd = Hd + params.damping * jnp.eye(6 * n, dtype=b.dtype)
    Hd = Hd.at[jnp.arange(6), jnp.arange(6)].add(params.prior_weight)
    x = jnp.linalg.solve(Hd, b.reshape(-1))
    return x.reshape(n, 6)


def graph_error(graph: PoseGraph) -> jax.Array:
    """Total weighted squared residual over live edges (chi^2)."""
    r, _, info = _gather_edge_terms(graph)
    return jnp.sum(jnp.einsum("ea,eab,eb->e", r, info, r))


@functools.partial(jax.jit, static_argnames=("params",))
def optimize_pose_graph(graph: PoseGraph,
                        params: GraphSolveParams = GraphSolveParams()
                        ) -> Tuple[PoseGraph, jax.Array]:
    """Run GN iterations; returns (optimized graph, final chi^2).

    With a robust kernel active, the kernel width is annealed (graduated
    non-convexity): delta starts at robust_anneal x the target and decays
    geometrically to the target over the iterations, so correct-but-
    drift-strained loop edges pull the solution in before outlier
    rejection tightens.
    """
    solve = _solve_dense if params.solver == "dense" else _solve_pcg
    K = params.gn_iterations
    if params.robust_delta > 0.0 and K > 1:
        ratio = params.robust_anneal ** (1.0 / (K - 1))
        deltas = jnp.asarray(
            [params.robust_delta * params.robust_anneal / ratio ** i
             for i in range(K)], jnp.float32)
    else:
        deltas = jnp.full((K,), params.robust_delta, jnp.float32)

    def gn_step(g, delta):
        b, diag, edge_terms = _build_rhs_and_diag(g, params, delta)
        xi = solve(g, params, b, diag, edge_terms)
        # freeze padding nodes (indices >= n_nodes)
        live = (jnp.arange(g.node_capacity) < g.n_nodes)[:, None]
        xi = jnp.where(live, xi, 0.0)
        new_poses = jax.vmap(se3.retract, in_axes=(0, 0))(g.poses, xi)
        g = dataclasses.replace(g, poses=new_poses)
        return g, jnp.sum(xi * xi)

    graph, _ = jax.lax.scan(gn_step, graph, deltas)
    return graph, graph_error(graph)


# ---------------------------------------------------------------------------
# Host-side graph construction helpers
# ---------------------------------------------------------------------------

def add_node(graph: PoseGraph, pose: jax.Array) -> Tuple[PoseGraph, int]:
    """Append a node (host-side; returns concrete index)."""
    idx = int(graph.n_nodes)
    if idx >= graph.node_capacity:
        raise ValueError(f"node capacity {graph.node_capacity} exhausted")
    poses = graph.poses.at[idx].set(pose)
    return dataclasses.replace(graph, poses=poses,
                               n_nodes=jnp.int32(idx + 1)), idx


def n_edges(graph: PoseGraph) -> int:
    """Number of live edges (edges are always packed in a prefix)."""
    return int(jnp.sum(graph.edge_mask.astype(jnp.int32)))


def drop_node_prefix(graph: PoseGraph, m: int) -> PoseGraph:
    """Drop the first ``m`` nodes — sliding-window eviction (host-side).

    Surviving nodes shift down by m; edges touching a dropped node are
    removed and the rest repacked into a prefix (``add_edge`` appends at the
    packed count). Dropped edges are NOT marginalized into a dense prior —
    the gauge prior on the new node 0 anchors the window at its current
    optimized pose, keeping the live trajectory consistent at the cost of
    forgetting old constraints (the standard fixed-lag approximation
    without marginals; the evicted poses should be exported by the caller
    before dropping).
    """
    import numpy as np
    n = int(graph.n_nodes)
    if not 0 < m < n:
        raise ValueError(f"need 0 < m < n_nodes, got m={m}, n={n}")
    ei = np.asarray(graph.edge_i)
    ej = np.asarray(graph.edge_j)
    keep = np.asarray(graph.edge_mask) & (ei >= m) & (ej >= m)
    order = np.argsort(~keep, kind="stable")          # kept edges first
    shift = np.where(keep[order], m, 0).astype(np.int32)
    order_j = jnp.asarray(order)
    eye = jnp.broadcast_to(jnp.eye(4, dtype=graph.poses.dtype), (m, 4, 4))
    return dataclasses.replace(
        graph,
        poses=jnp.concatenate([graph.poses[m:], eye]),
        n_nodes=jnp.int32(n - m),
        edge_i=jnp.asarray(ei[order] - shift),
        edge_j=jnp.asarray(ej[order] - shift),
        edge_T=jnp.take(graph.edge_T, order_j, axis=0),
        edge_info=jnp.take(graph.edge_info, order_j, axis=0),
        edge_mask=jnp.asarray(keep[order]),
    )


def add_edge(graph: PoseGraph, i: int, j: int, Z: jax.Array,
             info: Optional[jax.Array] = None) -> PoseGraph:
    """Append an edge with measurement Z = T_i^-1 T_j (host-side)."""
    e = n_edges(graph)
    if e >= graph.edge_capacity:
        raise ValueError(f"edge capacity {graph.edge_capacity} exhausted")
    if info is None:
        info = jnp.eye(6, dtype=jnp.float32)
    return dataclasses.replace(
        graph,
        edge_i=graph.edge_i.at[e].set(i),
        edge_j=graph.edge_j.at[e].set(j),
        edge_T=graph.edge_T.at[e].set(Z),
        edge_info=graph.edge_info.at[e].set(info),
        edge_mask=graph.edge_mask.at[e].set(True),
    )
