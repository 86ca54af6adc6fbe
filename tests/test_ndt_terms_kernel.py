"""NDT terms pass: frozen-bin binning, point-major pass vs the float64
reference, the owned-x matched count, parity with registration.ndt's
_ndt_terms at the stage-start pose, and the integrated register path."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpu_slam.kernels.ndt_terms import (bin_points, bin_points_reference,
                                        ndt_terms, ndt_terms_reference)

DIMS = (8, 8, 16)
Q = 2
LEAF = 0.5


def _synthetic_field(seed=0, occupancy=0.7, dims=DIMS):
    """Random rows16 over the window: mean near cell center, SPD Lambda."""
    rng = np.random.default_rng(seed)
    wx, wy, wz = dims
    g = wx * wy * wz
    cell = np.stack(np.meshgrid(np.arange(wx), np.arange(wy), np.arange(wz),
                                indexing="ij"), -1).reshape(g, 3)
    mean = (cell + 0.5) * LEAF + rng.normal(0, 0.08, (g, 3))
    a = rng.normal(0, 1, (g, 3, 3))
    cov = a @ a.transpose(0, 2, 1) * 0.01 + 0.02 * np.eye(3)
    lam = np.linalg.inv(cov)
    valid = rng.uniform(size=g) < occupancy
    iu = np.triu_indices(3)
    rows = np.zeros((g, 16), np.float32)
    rows[:, 0:3] = mean
    rows[:, 3:9] = lam[:, iu[0], iu[1]]
    rows[:, 9] = valid
    rows[~valid] = 0.0
    return jnp.asarray(rows)


def _scan(n=200, seed=1, dims=DIMS):
    rng = np.random.default_rng(seed)
    wx, wy, wz = dims
    pts = rng.uniform([0.7, 0.7, 0.7],
                      [wx * LEAF - 0.7, wy * LEAF - 0.7, wz * LEAF - 0.7],
                      (n, 3)).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-20:] = False
    return jnp.asarray(pts), jnp.asarray(mask)


def _raster_slots(pts, mask, T0, dims, q_cap):
    """The former raster build's semantics, stated directly: stable sort by
    cell, first q_cap valid in-window points of each cell fill slots."""
    pw = np.asarray(pts, np.float64) @ np.asarray(T0)[:3, :3].T \
        + np.asarray(T0)[:3, 3]
    cc = np.floor(pw / LEAF).astype(np.int64)
    inside = np.asarray(mask) & np.all((cc >= 0) & (cc < np.asarray(dims)),
                                       axis=1)
    wx, wy, wz = dims
    cell = np.where(inside, (cc[:, 0] * wy + cc[:, 1]) * wz + cc[:, 2],
                    wx * wy * wz)
    order = np.argsort(cell, kind="stable")
    slots = {}
    for i in order:
        if cell[i] < wx * wy * wz:
            slots.setdefault(cell[i], [])
            if len(slots[cell[i]]) < q_cap:
                slots[cell[i]].append(i)
    return {i for v in slots.values() for i in v}


@pytest.mark.parametrize("shift", [0.0, 0.9])
def test_binning_matches_raster_semantics(shift):
    """bin_points keeps exactly the points the cell raster held."""
    pts, mask = _scan(300)
    T0 = jnp.eye(4).at[0, 3].set(shift)
    cells, keep = bin_points(pts, mask, T0, jnp.zeros(3), LEAF, DIMS, Q)
    kept = set(np.flatnonzero(np.asarray(keep)).tolist())
    assert kept == _raster_slots(pts, mask, T0, DIMS, Q)
    assert 0 < len(kept) < int(mask.sum())        # the cap bites
    c_ref, k_ref = bin_points_reference(pts, mask, T0, np.zeros(3), LEAF,
                                        DIMS, Q)
    np.testing.assert_array_equal(np.asarray(cells), c_ref)
    np.testing.assert_array_equal(np.asarray(keep), k_ref)


def test_binning_drops_points_leaving_the_window():
    far = jnp.asarray([[DIMS[0] * LEAF - 0.05, 1.0, 1.0],
                       [1.0e8, 1.0e8, 1.0e8]], jnp.float32)
    shift = jnp.eye(4).at[0, 3].set(0.9)
    _, keep = bin_points(far, jnp.ones(2, bool), shift, jnp.zeros(3), LEAF,
                         DIMS, Q)
    assert not bool(jnp.any(keep))


@pytest.mark.parametrize("dims", [DIMS, (5, 7, 6)])
def test_pass_matches_reference(dims):
    rows = _synthetic_field(dims=dims)
    pts, mask = _scan(300, dims=dims)
    cells, keep = bin_points(pts, mask, jnp.eye(4), jnp.zeros(3), LEAF,
                             dims, Q)
    xi = jnp.asarray([0.03, -0.02, 0.01, 0.02, -0.01, 0.015], jnp.float32)
    from tpu_slam.core import se3
    T = se3.exp(xi)
    Hk, bk, ck, mk = ndt_terms(pts, cells, keep, rows, T, jnp.float32(4.0),
                               1.0, dims)
    Hr, br, cr, mr = ndt_terms_reference(pts, cells, keep, rows, T, 4.0,
                                         1.0, dims)
    np.testing.assert_allclose(np.asarray(Hk), Hr, rtol=2e-5,
                               atol=2e-5 * np.abs(Hr).max())
    np.testing.assert_allclose(np.asarray(bk), br, rtol=2e-5,
                               atol=2e-5 * np.abs(br).max())
    np.testing.assert_allclose(float(ck), cr, rtol=1e-5)
    assert int(mk) == mr
    assert int(mk) > 100                      # the scan actually matched


def test_owned_x_counts_only_owned_points():
    rows = _synthetic_field()
    pts, mask = _scan(300)
    cells, keep = bin_points(pts, mask, jnp.eye(4), jnp.zeros(3), LEAF,
                             DIMS, Q)
    T = jnp.eye(4, dtype=jnp.float32)
    g = jnp.float32(4.0)
    H, b, c, m_all = ndt_terms(pts, cells, keep, rows, T, g, 1.0, DIMS)
    parts = [ndt_terms(pts, cells, keep, rows, T, g, 1.0, DIMS,
                       owned_x=(lo, lo + 2)) for lo in range(0, DIMS[0], 2)]
    # the count partitions over x-chunks; H/b/cost are not restricted
    assert sum(int(p[3]) for p in parts) == int(m_all)
    assert 0 < int(parts[0][3]) < int(m_all)
    for p in parts:
        np.testing.assert_allclose(np.asarray(p[0]), np.asarray(H))
        assert float(p[2]) == float(c)


def test_matches_ndt_terms_at_stage_start():
    """At T == T0 the frozen bins equal the live bins: the frozen-bin pass
    must reproduce registration.ndt._ndt_terms on a real dense field."""
    from tpu_slam.core.pointcloud import PointCloud
    from tpu_slam.kernels.voxel_hash import VoxelGridSpec
    from tpu_slam.mapping.voxel_map import empty_map, insert_cloud
    from tpu_slam.registration.ndt import (NDTParams, _ndt_terms, ndt_field)

    rng = np.random.default_rng(3)
    # structured scene: floor + wall patches
    floor = np.stack([rng.uniform(0.5, 7.5, 400), rng.uniform(0.5, 3.5, 400),
                      rng.normal(0.6, 0.02, 400)], 1)
    wall = np.stack([rng.normal(4.0, 0.02, 400), rng.uniform(0.5, 3.5, 400),
                     rng.uniform(0.5, 7.0, 400)], 1)
    pts = jnp.asarray(np.concatenate([floor, wall]), jnp.float32)
    cloud = PointCloud.from_points(pts, capacity=1024)

    spec = VoxelGridSpec(leaf=0.5, origin=(0.0, 0.0, 0.0), dim_bits=4)
    vmap = insert_cloud(empty_map(4096), cloud, spec, 0.0)
    params = NDTParams(window_bits=4, pack_budget_mb=512,
                       min_voxel_count=3.0)
    field = ndt_field(vmap, spec, params)
    assert field.nbr_rows is not None

    scan = PointCloud.from_points(pts[::3] + 0.05, capacity=512).sanitize()
    T0 = jnp.eye(4, dtype=jnp.float32)
    H0, b0, c0, frac0 = _ndt_terms(scan, T0, field, spec, params)

    # same objective through the frozen-bin pass on the window rows (the
    # nbr_rows center column is exactly rows16); q_cap 8 drops nothing
    rows16 = field.nbr_rows[:, 4 * 16:5 * 16]
    dims = field.window_dims
    cells, keep = bin_points(scan.points, scan.mask, T0,
                             jnp.zeros(3, jnp.float32), spec.leaf, dims, 8)
    assert int(keep.sum()) == int(scan.mask.sum())
    Hr, br, cr, mr = ndt_terms(scan.points, cells, keep, rows16, T0,
                               jnp.float32(params.score_temperature),
                               params.max_corr_dist, dims)
    np.testing.assert_allclose(np.asarray(Hr), np.asarray(H0),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(br), np.asarray(b0),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(float(cr), float(c0), rtol=1e-4)
    n_src = float(jnp.sum(scan.mask))
    np.testing.assert_allclose(float(mr) / n_src, float(frac0), atol=1e-6)


def test_ndt_register_window_path_recovers_transform():
    """ndt_register on a window_dims field (the frozen-bin path) recovers
    a known perturbation and agrees with the live-binned packed path."""
    import dataclasses

    from tpu_slam.core import se3
    from tpu_slam.core.pointcloud import PointCloud
    from tpu_slam.kernels.voxel_hash import VoxelGridSpec
    from tpu_slam.mapping.voxel_map import empty_map, insert_cloud
    from tpu_slam.registration.ndt import (NDTParams, ndt_field,
                                           ndt_register)

    rng = np.random.default_rng(5)
    floor = np.stack([rng.uniform(0.5, 7.5, 1500),
                      rng.uniform(0.5, 7.5, 1500),
                      rng.normal(0.5, 0.02, 1500)], 1)
    wallx = np.stack([rng.normal(6.0, 0.02, 700),
                      rng.uniform(0.5, 7.5, 700),
                      rng.uniform(0.5, 5.0, 700)], 1)
    wally = np.stack([rng.uniform(0.5, 7.5, 700),
                      rng.normal(6.5, 0.02, 700),
                      rng.uniform(0.5, 5.0, 700)], 1)
    pts = jnp.asarray(np.concatenate([floor, wallx, wally]), jnp.float32)
    cloud = PointCloud.from_points(pts, capacity=4096)

    spec = VoxelGridSpec(leaf=0.5, origin=(0.0, 0.0, 0.0), dim_bits=4)
    vmap = insert_cloud(empty_map(8192), cloud, spec, 0.0)

    xi = jnp.asarray([0.12, -0.09, 0.05, 0.03, -0.02, 0.04], jnp.float32)
    T_true = se3.exp(xi)
    src = cloud.transform(se3.inverse(T_true))

    base = NDTParams(window_bits=4, max_iterations=25, coarse_iterations=5,
                     min_voxel_count=3.0, raster_q=8)
    p_win = dataclasses.replace(base, window_dims=(16, 16, 16))
    p_pack = dataclasses.replace(base, pack_budget_mb=512)

    f_win = ndt_field(vmap, spec, p_win)
    assert f_win.rows is not None and f_win.nbr_rows is None
    res_win = ndt_register(src, f_win, spec, params=p_win)
    err = se3.log(se3.compose(se3.inverse(T_true), res_win.T))
    assert float(jnp.linalg.norm(err[:3])) < 0.03, np.asarray(err)
    assert float(jnp.linalg.norm(err[3:])) < 0.02, np.asarray(err)
    assert float(res_win.matched_fraction) > 0.8

    f_pack = ndt_field(vmap, spec, p_pack)
    res_pack = ndt_register(src, f_pack, spec, params=p_pack)
    d = se3.log(se3.compose(se3.inverse(res_pack.T), res_win.T))
    # the paths differ by design: frozen bins freeze at each stage-entry
    # pose while the packed path re-bins live every pass — they agree to
    # the optimum's basin width, not bit-exactly
    assert float(jnp.linalg.norm(d)) < 0.035, np.asarray(d)


@pytest.mark.parametrize("owned_x", [None, (2, 6)])
def test_triton_pass_interpret_matches_xla(owned_x):
    """The Triton kernel's body, run by the Pallas interpreter."""
    from tpu_slam.kernels.ndt_terms_triton import ndt_terms_triton

    dims = (5, 7, 6)
    rows = _synthetic_field(dims=dims)
    pts, mask = _scan(300, dims=dims)
    cells, keep = bin_points(pts, mask, jnp.eye(4), jnp.zeros(3), LEAF,
                             dims, Q)
    from tpu_slam.core import se3
    T = se3.exp(jnp.asarray([0.03, -0.02, 0.01, 0.02, -0.01, 0.015],
                            jnp.float32))
    want = ndt_terms(pts, cells, keep, rows, T, jnp.float32(4.0), 1.0, dims,
                     owned_x=owned_x)
    got = ndt_terms_triton(pts, cells, keep, rows, T, jnp.float32(4.0), 1.0,
                           dims, owned_x=owned_x, interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-5,
                                   atol=1e-6 * float(jnp.abs(w).max()) + 1e-6)


def test_terms_pass_names():
    from tpu_slam.kernels.ndt_terms import terms_pass
    from tpu_slam.kernels.ndt_terms_triton import ndt_terms_triton

    assert terms_pass("xla") is ndt_terms
    assert terms_pass("triton") is ndt_terms_triton
    assert terms_pass("auto") is ndt_terms            # no GPU here
    with pytest.raises(ValueError):
        terms_pass("pallas")
