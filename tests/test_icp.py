import jax.numpy as jnp
import numpy as np

from tpu_slam.core import se3
from tpu_slam.core.pointcloud import PointCloud
from tpu_slam.registration.icp import ICPParams, icp


def make_scene(rng, n=600):
    """Synthetic structured scene (two walls + floor) — gives ICP full 6-DoF
    constraint, unlike a random blob."""
    n3 = n // 3
    floor = np.stack([rng.uniform(-5, 5, n3), rng.uniform(-5, 5, n3),
                      np.zeros(n3)], axis=1)
    wall1 = np.stack([rng.uniform(-5, 5, n3), np.full(n3, 5.0),
                      rng.uniform(0, 3, n3)], axis=1)
    wall2 = np.stack([np.full(n - 2 * n3, -5.0), rng.uniform(-5, 5, n - 2 * n3),
                      rng.uniform(0, 3, n - 2 * n3)], axis=1)
    return np.concatenate([floor, wall1, wall2]).astype(np.float32)


def test_icp_recovers_known_transform():
    rng = np.random.default_rng(0)
    tgt = make_scene(rng)
    xi_true = jnp.array([0.3, -0.2, 0.1, 0.05, -0.04, 0.08], dtype=jnp.float32)
    T_true = se3.exp(xi_true)
    # source = T_true^-1 applied to target, so icp(source->target) == T_true
    src = se3.apply(se3.inverse(T_true), jnp.asarray(tgt))

    source = PointCloud.from_points(src, capacity=768)
    target = PointCloud.from_points(jnp.asarray(tgt), capacity=768)
    params = ICPParams(max_iterations=50, max_corr_dist=2.0)
    res = icp(source, target, params=params)

    err_xi = se3.log(se3.compose(se3.inverse(T_true), res.T))
    assert float(jnp.linalg.norm(err_xi[:3])) < 0.02, res
    assert float(jnp.linalg.norm(err_xi[3:])) < 0.01, res
    assert float(res.matched_fraction) > 0.9


def test_icp_identity_on_same_cloud():
    rng = np.random.default_rng(1)
    pts = make_scene(rng, 300)
    cloud = PointCloud.from_points(jnp.asarray(pts), capacity=384)
    res = icp(cloud, cloud, params=ICPParams(max_iterations=10))
    np.testing.assert_allclose(np.asarray(res.T), np.eye(4), atol=1e-4)
    assert bool(res.converged)


def test_icp_point_to_plane():
    rng = np.random.default_rng(2)
    tgt = make_scene(rng)
    n = tgt.shape[0]
    n3 = n // 3
    normals = np.zeros((n, 3), dtype=np.float32)
    normals[:n3] = [0, 0, 1]
    normals[n3:2 * n3] = [0, 1, 0]
    normals[2 * n3:] = [1, 0, 0]

    xi_true = jnp.array([0.2, -0.1, 0.15, 0.03, 0.05, -0.04], dtype=jnp.float32)
    T_true = se3.exp(xi_true)
    src = se3.apply(se3.inverse(T_true), jnp.asarray(tgt))

    source = PointCloud.from_points(src)
    target = PointCloud.from_points(jnp.asarray(tgt))
    params = ICPParams(max_iterations=30, max_corr_dist=2.0,
                       point_to_plane=True)
    res = icp(source, target, params=params,
              target_normals=jnp.asarray(normals))
    err_xi = se3.log(se3.compose(se3.inverse(T_true), res.T))
    assert float(jnp.linalg.norm(err_xi)) < 0.02


def test_icp_robust_to_outliers():
    rng = np.random.default_rng(3)
    tgt = make_scene(rng)
    xi_true = jnp.array([0.1, 0.05, -0.08, 0.02, -0.03, 0.04], dtype=jnp.float32)
    T_true = se3.exp(xi_true)
    src = np.array(se3.apply(se3.inverse(T_true), jnp.asarray(tgt)))
    # corrupt 10% of source with junk
    n_out = len(src) // 10
    src[:n_out] = rng.uniform(-20, 20, size=(n_out, 3))

    source = PointCloud.from_points(jnp.asarray(src))
    target = PointCloud.from_points(jnp.asarray(tgt))
    params = ICPParams(max_iterations=40, max_corr_dist=1.0,
                       huber_delta=0.2)
    res = icp(source, target, params=params)
    err_xi = se3.log(se3.compose(se3.inverse(T_true), res.T))
    assert float(jnp.linalg.norm(err_xi)) < 0.05
