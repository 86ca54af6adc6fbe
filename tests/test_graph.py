import math

import jax
import jax.numpy as jnp
import numpy as np

from tpu_slam.core import se3
from tpu_slam.graph.loop_closure import (LoopClosureParams, propose_candidates,
                                         verify_candidates)
from tpu_slam.graph.pose_graph import (GraphSolveParams, add_edge, add_node,
                                       drop_node_prefix, empty_graph,
                                       graph_error, n_edges,
                                       optimize_pose_graph)


def _make_noisy_circle_graph(rng, n=24, radius=3.0, drift=0.02,
                             node_cap=32, edge_cap=64, with_loop=True):
    """Ground-truth circle; odometry edges get multiplicative noise so the
    chain drifts; one loop edge ties the last pose back to the first."""
    gt = []
    for k in range(n):
        a = 2 * math.pi * k / n
        T = np.eye(4, dtype=np.float32)
        c, s = math.cos(a), math.sin(a)
        T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        T[:3, 3] = [radius * c, radius * s, 0.1 * math.sin(3 * a)]
        gt.append(jnp.asarray(T))

    g = empty_graph(node_cap, edge_cap)
    # initial estimates integrate noisy odometry
    est = [gt[0]]
    noisy_Z = []
    for k in range(n - 1):
        Z = se3.inverse(gt[k]) @ gt[k + 1]
        xi_noise = jnp.asarray(rng.normal(0, drift, 6), jnp.float32)
        Zn = se3.exp(xi_noise) @ Z
        noisy_Z.append(Zn)
        est.append(est[-1] @ Zn)

    for k in range(n):
        g, _ = add_node(g, est[k])
    for k in range(n - 1):
        g = add_edge(g, k, k + 1, noisy_Z[k])
    if with_loop:
        # loop edge with the TRUE relative transform (a good loop closure)
        Z_loop = se3.inverse(gt[0]) @ gt[n - 1]
        g = add_edge(g, 0, n - 1, Z_loop,
                     info=10.0 * jnp.eye(6, dtype=jnp.float32))
    return g, gt


def _ate(graph, gt, n):
    err = 0.0
    for k in range(n):
        e = np.asarray(graph.poses[k, :3, 3] - gt[k][:3, 3])
        err += float(np.dot(e, e))
    return math.sqrt(err / n)


def test_pose_graph_reduces_error_dense():
    rng = np.random.default_rng(0)
    g, gt = _make_noisy_circle_graph(rng)
    ate0 = _ate(g, gt, 24)
    g2, chi2 = optimize_pose_graph(
        g, GraphSolveParams(gn_iterations=8, solver="dense"))
    ate1 = _ate(g2, gt, 24)
    assert ate1 < 0.5 * ate0, (ate0, ate1)
    assert float(chi2) < float(graph_error(g))


def test_pcg_matches_dense():
    rng = np.random.default_rng(1)
    g, gt = _make_noisy_circle_graph(rng)
    gd, _ = optimize_pose_graph(
        g, GraphSolveParams(gn_iterations=6, solver="dense"))
    gp, _ = optimize_pose_graph(
        g, GraphSolveParams(gn_iterations=6, solver="pcg",
                            cg_iterations=200, cg_tolerance=1e-12))
    np.testing.assert_allclose(np.asarray(gp.poses[:24]),
                               np.asarray(gd.poses[:24]), atol=2e-3)


def test_gauge_fixed_at_pose0():
    rng = np.random.default_rng(2)
    g, gt = _make_noisy_circle_graph(rng)
    p0 = np.asarray(g.poses[0])
    g2, _ = optimize_pose_graph(g, GraphSolveParams(gn_iterations=5))
    np.testing.assert_allclose(np.asarray(g2.poses[0]), p0, atol=1e-3)


def test_perfect_graph_stays_put():
    rng = np.random.default_rng(3)
    g, gt = _make_noisy_circle_graph(rng, drift=0.0, with_loop=True)
    before = np.asarray(g.poses[:24])
    g2, chi2 = optimize_pose_graph(g, GraphSolveParams(gn_iterations=3))
    np.testing.assert_allclose(np.asarray(g2.poses[:24]), before, atol=1e-4)
    assert float(chi2) < 1e-8


def test_propose_candidates_gating():
    # poses around a circle: first and last are close in space, far in index
    n = 40
    pos = np.stack([np.cos(np.linspace(0, 2 * np.pi, n, endpoint=False)),
                    np.sin(np.linspace(0, 2 * np.pi, n, endpoint=False)),
                    np.zeros(n)], axis=1) * 3.0
    params = LoopClosureParams(max_distance=1.0, min_index_gap=10,
                               max_candidates=8)
    ci, cj = propose_candidates(jnp.asarray(pos), n, params)
    assert len(ci) > 0
    assert ((cj - ci) >= 10).all()
    d = np.linalg.norm(pos[ci] - pos[cj], axis=1)
    assert (d <= 1.0).all()


def test_verify_candidates_accepts_true_overlap():
    rng = np.random.default_rng(4)
    n3 = 200
    base = np.concatenate([
        np.stack([rng.uniform(-4, 4, n3), rng.uniform(-4, 4, n3),
                  np.zeros(n3)], 1),
        np.stack([rng.uniform(-4, 4, n3), np.full(n3, 4.0),
                  rng.uniform(0, 2, n3)], 1),
        np.stack([np.full(n3, -4.0), rng.uniform(-4, 4, n3),
                  rng.uniform(0, 2, n3)], 1),
    ]).astype(np.float32)

    # two keyframes observing the same world from different poses
    T0 = np.eye(4, dtype=np.float32)
    xi = jnp.array([0.3, -0.2, 0.05, 0.02, 0.01, 0.3], jnp.float32)
    T1 = np.asarray(se3.exp(xi))
    cloud0 = base                                   # world == body of kf0
    cloud1 = (base - T1[:3, 3]) @ T1[:3, :3]        # world -> body of kf1

    P = 640
    pts = np.full((2, P, 3), 1.0e8, np.float32)
    msk = np.zeros((2, P), bool)
    pts[0, :600] = cloud0; msk[0, :600] = True
    pts[1, :600] = cloud1; msk[1, :600] = True

    # pose estimates slightly off (odometry drift)
    poses = jnp.stack([jnp.asarray(T0),
                       se3.exp(jnp.array([0.05, -0.03, 0.0, 0.0, 0.0, 0.02],
                                         jnp.float32)) @ jnp.asarray(T1)])
    params = LoopClosureParams(
        icp=ICPParams_for_test(), min_matched_fraction=0.6, max_error=0.05)
    res, accept = verify_candidates(jnp.asarray(pts), jnp.asarray(msk),
                                    poses, np.array([0]), np.array([1]),
                                    params)
    assert bool(accept[0])
    # the verified edge must match the true relative transform
    err = se3.log(se3.inverse(jnp.asarray(T1)) @ res.T[0])
    assert float(jnp.linalg.norm(err)) < 0.03


def ICPParams_for_test():
    from tpu_slam.registration.icp import ICPParams
    return ICPParams(max_iterations=30, max_corr_dist=1.5, huber_delta=0.3)


def test_robust_kernel_rejects_bad_loop():
    """A WRONG loop-closure edge must not fold the trajectory when the
    robust kernel is on."""
    rng = np.random.default_rng(5)
    g, gt = _make_noisy_circle_graph(rng, with_loop=True)
    # inject a grossly wrong loop edge (1.5 m / 40 deg off)
    bad_Z = se3.exp(jnp.array([1.5, -1.0, 0.5, 0.3, 0.2, 0.6],
                              jnp.float32)) @ (
        se3.inverse(gt[3]) @ gt[18])
    g_bad = add_edge(g, 3, 18, bad_Z,
                     info=10.0 * jnp.eye(6, dtype=jnp.float32))

    plain, _ = optimize_pose_graph(
        g_bad, GraphSolveParams(gn_iterations=12))
    robust, _ = optimize_pose_graph(
        g_bad, GraphSolveParams(gn_iterations=12, robust_delta=0.3))
    ate_plain = _ate(plain, gt, 24)
    ate_robust = _ate(robust, gt, 24)
    # the redescending kernel must cut the bad edge's damage several-fold
    # (full recovery needs the loop-verification gate upstream — the
    # robust kernel is the second line of defense)
    assert ate_robust < 0.5 * ate_plain, (ate_plain, ate_robust)
    # and the robust kernel must not hurt the clean graph
    clean_r, _ = optimize_pose_graph(
        g, GraphSolveParams(gn_iterations=12, robust_delta=0.3))
    clean, _ = optimize_pose_graph(g, GraphSolveParams(gn_iterations=12))
    assert _ate(clean_r, gt, 24) < 1.5 * _ate(clean, gt, 24) + 0.02


def test_drop_node_prefix_sliding_window():
    """Fixed-lag eviction: nodes shift, edges remap/repack, solve still works."""
    rng = np.random.default_rng(6)
    g, gt = _make_noisy_circle_graph(rng, with_loop=True)
    n0, e0 = int(g.n_nodes), n_edges(g)
    m = 5
    g2 = drop_node_prefix(g, m)
    assert int(g2.n_nodes) == n0 - m
    # poses shifted
    np.testing.assert_allclose(np.asarray(g2.poses[: n0 - m]),
                               np.asarray(g.poses[m:n0]))
    # every surviving edge references live nodes and matches an original
    ei, ej = np.asarray(g2.edge_i), np.asarray(g2.edge_j)
    msk = np.asarray(g2.edge_mask)
    assert msk.sum() < e0                    # edges into the prefix dropped
    assert (ei[msk] >= 0).all() and (ej[msk] < n0 - m).all()
    # edges stay packed in a prefix so add_edge appends correctly
    k = int(msk.sum())
    assert msk[:k].all() and not msk[k:].any()
    g3 = add_edge(g2, 0, 1, jnp.eye(4, dtype=jnp.float32))
    assert n_edges(g3) == k + 1
    # the shrunk graph still optimizes (gauge re-anchored at new node 0)
    g4, chi = optimize_pose_graph(g3, GraphSolveParams(gn_iterations=6))
    assert np.isfinite(float(chi))
    assert np.isfinite(np.asarray(g4.poses)).all()
