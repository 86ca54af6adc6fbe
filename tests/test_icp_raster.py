"""Frozen-bin pair-ICP: terms pass == float64 reference; solve parity
with icp()."""

import jax.numpy as jnp
import numpy as np

from tpu_slam.core import se3
from tpu_slam.core.pointcloud import PointCloud
from tpu_slam.ingest import synthetic as syn
from tpu_slam.kernels.icp_terms import (icp_terms, icp_terms_reference,
                                        target_table)
from tpu_slam.kernels.ndt_terms import bin_points
from tpu_slam.registration.icp import ICPParams, icp, icp_raster
import pytest

DIMS = (16, 16, 8)
LEAF = 0.5


def _clouds(seed=0):
    world = syn.default_office()
    T0 = np.eye(4)
    T0[:3, 3] = [0, 0, 1.5]
    rng = np.random.default_rng(seed)
    pts, valid = syn.simulate_vlp16_revolution(world, T0, n_azimuth=256,
                                               noise_std=0.005, rng=rng)
    keep = pts[valid]
    keep = keep[np.all(np.abs(keep[:, :2]) < 3.6, axis=1)]  # fit the window
    return PointCloud.from_points(jnp.asarray(keep), capacity=4096)


def test_icp_terms_kernel_matches_reference():
    tgt = _clouds()
    xi = jnp.array([0.08, -0.05, 0.03, 0.02, -0.01, 0.03], jnp.float32)
    src = tgt.transform(se3.inverse(se3.exp(xi)))
    origin = jnp.asarray([-4.0, -4.0, -2.0], jnp.float32)
    eye = jnp.eye(4, dtype=jnp.float32)
    table = target_table(tgt.points, tgt.mask, origin, LEAF, DIMS, 8)
    t_cells, t_keep = bin_points(tgt.points, tgt.mask, eye, origin, LEAF,
                                 DIMS, 8)
    cells, keep = bin_points(src.points, src.mask, eye, origin, LEAF,
                             DIMS, 8)
    T = se3.exp(0.5 * xi)
    got = icp_terms(src.points, cells, keep, table, T, 1.0, 0.4, DIMS)
    want = icp_terms_reference(src.points, cells, keep, tgt.points, t_cells,
                               t_keep, T, 1.0, 0.4)
    names = ["H", "b", "err", "nmatch", "wsum"]
    for g, w, name in zip(got, want, names):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=2e-4, atol=2e-3, err_msg=name)
    assert int(got[3]) == want[3]
    assert float(got[3]) > 0.5 * float(jnp.sum(src.mask))


@pytest.mark.slow
def test_icp_raster_recovers_transform_like_brute():
    tgt = _clouds()
    xi = jnp.array([0.12, -0.08, 0.04, 0.02, -0.02, 0.03], jnp.float32)
    src = tgt.transform(se3.inverse(se3.exp(xi)))
    params = ICPParams(max_iterations=25, max_corr_dist=1.0,
                       huber_delta=0.4)
    res_b = icp(src, tgt, params=params)
    res_r = icp_raster(src, tgt, params=params, dims=DIMS, leaf=LEAF,
                       origin_world=jnp.asarray([-4.0, -4.0, -2.0],
                                                jnp.float32))
    err_b = float(jnp.linalg.norm(se3.log(
        se3.compose(se3.inverse(se3.exp(xi)), res_b.T))))
    err_r = float(jnp.linalg.norm(se3.log(
        se3.compose(se3.inverse(se3.exp(xi)), res_r.T))))
    # at ~380 points the brute-force solve itself sits at ~0.044 — the
    # bar is PARITY with it, plus a sane absolute cap
    assert err_r < 0.06, f"raster ICP off by {err_r}"
    assert err_r < max(1.2 * err_b, 0.01), (err_r, err_b)
    assert float(res_r.matched_fraction) > 0.6


def test_icp_raster_axis_perm_matches_unpermuted():
    tgt = _clouds()
    xi = jnp.array([0.1, -0.06, 0.03, 0.015, -0.01, 0.02], jnp.float32)
    src = tgt.transform(se3.inverse(se3.exp(xi)))
    params = ICPParams(max_iterations=20, max_corr_dist=1.0,
                       huber_delta=0.4)
    res_a = icp_raster(src, tgt, params=params, dims=DIMS, leaf=LEAF,
                       origin_world=jnp.asarray([-4.0, -4.0, -2.0],
                                                jnp.float32))
    # permuted: world z on kernel x -> dims (8, 16, 16), origin (z, x, y)
    res_p = icp_raster(src, tgt, params=params, dims=(8, 16, 16), leaf=LEAF,
                       origin_world=jnp.asarray([-2.0, -4.0, -4.0],
                                                jnp.float32),
                       axis_perm=(2, 0, 1))
    np.testing.assert_allclose(np.asarray(res_p.T), np.asarray(res_a.T),
                               atol=5e-3)
    err = float(jnp.linalg.norm(se3.log(
        se3.compose(se3.inverse(se3.exp(xi)), res_p.T))))
    assert err < 0.06, err
