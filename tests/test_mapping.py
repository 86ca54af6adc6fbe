import math

import jax.numpy as jnp
import numpy as np

from tpu_slam.core import se3
from tpu_slam.core.pointcloud import PointCloud
from tpu_slam.kernels.voxel_hash import INVALID_KEY, VoxelGridSpec
from tpu_slam.mapping.voxel_map import (empty_map, insert_cloud,
                                        voxel_covariances, voxel_means,
                                        voxel_normals, lookup_voxels,
                                        scan_to_voxel_stats)
from tpu_slam.registration.ndt import NDTParams, ndt_field, ndt_register
from tpu_slam.ingest import synthetic as syn


SPEC = VoxelGridSpec.centered(leaf=0.5, half_extent=16.0)


def _plane_cloud(rng, n=2000, z=0.0, extent=5.0, noise=0.01):
    pts = np.stack([rng.uniform(-extent, extent, n),
                    rng.uniform(-extent, extent, n),
                    z + rng.normal(0, noise, n)], axis=1).astype(np.float32)
    return PointCloud.from_points(jnp.asarray(pts), capacity=max(2048, n))


def test_insert_and_means():
    rng = np.random.default_rng(0)
    cloud = _plane_cloud(rng)
    m = empty_map(4096)
    m = insert_cloud(m, cloud, SPEC, stamp=0.0)
    occ = int(m.n_occupied())
    assert occ > 50
    # total integrated points equals valid input points
    assert int(jnp.sum(m.count)) == int(cloud.count())
    # keys are sorted with INVALID tail
    keys = np.asarray(m.keys)
    valid = keys != int(INVALID_KEY)
    assert (np.diff(keys[valid]) > 0).all()
    # all means lie near z=0 plane
    means = np.asarray(voxel_means(m, SPEC))[valid]
    assert np.abs(means[:, 2]).max() < 0.05


def test_incremental_merge_equals_batch():
    rng = np.random.default_rng(1)
    a = _plane_cloud(rng, 800)
    b = _plane_cloud(rng, 800, z=1.0)
    m1 = insert_cloud(insert_cloud(empty_map(4096), a, SPEC, 0.0), b, SPEC, 1.0)

    from tpu_slam.core.pointcloud import merge
    m2 = insert_cloud(empty_map(4096), merge(a, b), SPEC, 1.0)
    assert int(m1.n_occupied()) == int(m2.n_occupied())
    np.testing.assert_array_equal(np.asarray(m1.keys), np.asarray(m2.keys))
    np.testing.assert_allclose(np.asarray(m1.count), np.asarray(m2.count))
    np.testing.assert_allclose(np.asarray(voxel_means(m1, SPEC)),
                               np.asarray(voxel_means(m2, SPEC)), atol=1e-4)


def test_eviction_keeps_recent():
    rng = np.random.default_rng(2)
    cap = 64  # force eviction
    m = empty_map(cap)
    m = insert_cloud(m, _plane_cloud(rng, 500, z=0.0), SPEC, stamp=0.0)
    m = insert_cloud(m, _plane_cloud(rng, 500, z=2.0), SPEC, stamp=1.0)
    means = np.asarray(voxel_means(m, SPEC))
    occ = np.asarray(m.occupied_mask())
    # the newer (z=2) voxels must dominate after eviction
    frac_new = (np.abs(means[occ][:, 2] - 2.0) < 0.3).mean()
    assert frac_new > 0.9


def test_normals_on_plane():
    rng = np.random.default_rng(3)
    m = insert_cloud(empty_map(4096), _plane_cloud(rng, 4000, noise=0.005),
                     SPEC, 0.0)
    normals, valid = voxel_normals(m, min_count=5.0)
    nz = np.abs(np.asarray(normals)[np.asarray(valid)][:, 2])
    assert np.asarray(valid).sum() > 20
    assert (nz > 0.99).mean() > 0.95  # normals along z for an xy-plane


def test_lookup_voxels():
    rng = np.random.default_rng(4)
    cloud = _plane_cloud(rng, 300)
    m = insert_cloud(empty_map(1024), cloud, SPEC, 0.0)
    # every occupied key must be found at its own slot
    keys = m.keys
    slots = lookup_voxels(m, keys)
    occ = np.asarray(m.occupied_mask())
    np.testing.assert_array_equal(np.asarray(slots)[occ],
                                  np.arange(m.capacity)[occ])
    # an absent key returns -1
    assert int(lookup_voxels(m, jnp.asarray([12345679], jnp.int32))[0]) in (-1,)


def test_ndt_register_recovers_transform():
    world = syn.default_office()
    T = np.eye(4); T[:3, 3] = [0, 0, 1.5]
    pts, valid = syn.simulate_vlp16_revolution(world, T, n_azimuth=360)
    cloud = PointCloud.from_points(jnp.asarray(pts[valid]), capacity=8192)

    spec = VoxelGridSpec.centered(leaf=0.5, half_extent=16.0)
    m = insert_cloud(empty_map(8192), cloud, spec, 0.0)
    params = NDTParams(max_iterations=40)
    field = ndt_field(m, spec, params)

    xi_true = jnp.array([0.2, -0.15, 0.1, 0.03, -0.02, 0.05], jnp.float32)
    T_true = se3.exp(xi_true)
    src = cloud.transform(se3.inverse(T_true))

    res = ndt_register(src, field, spec, params=params)
    err = se3.log(se3.compose(se3.inverse(T_true), res.T))
    assert float(jnp.linalg.norm(err[:3])) < 0.05, np.asarray(res.T)
    assert float(jnp.linalg.norm(err[3:])) < 0.02
    assert float(res.matched_fraction) > 0.7


def test_ndt_identity():
    world = syn.default_office()
    T = np.eye(4); T[:3, 3] = [0, 0, 1.5]
    pts, valid = syn.simulate_vlp16_revolution(world, T, n_azimuth=240)
    cloud = PointCloud.from_points(jnp.asarray(pts[valid]), capacity=4096)
    spec = VoxelGridSpec.centered(leaf=0.5, half_extent=16.0)
    m = insert_cloud(empty_map(8192), cloud, spec, 0.0)
    res = ndt_register(cloud, ndt_field(m, spec), spec)
    # NDT pulls points toward voxel means; ~1% of leaf drift is inherent
    np.testing.assert_allclose(np.asarray(res.T), np.eye(4), atol=6e-3)


def test_ndt_terms_nbr_rows_tiers_match_lookup_tier():
    """The packed-row probe tiers (G,144)/(G,48) must reproduce the
    lookup-tier GN terms exactly (same Gaussians, same gating)."""
    from tpu_slam.registration.ndt import _ndt_terms

    world = syn.default_office()
    T = np.eye(4); T[:3, 3] = [0, 0, 1.5]
    pts, valid = syn.simulate_vlp16_revolution(world, T, n_azimuth=240)
    cloud = PointCloud.from_points(jnp.asarray(pts[valid]), capacity=4096)
    spec = VoxelGridSpec.centered(leaf=0.5, half_extent=8.0)  # 32^3 cells
    m = insert_cloud(empty_map(8192), cloud, spec, 0.0)

    base = NDTParams(pack_budget_mb=0)
    f0 = ndt_field(m, spec, base)
    assert f0.nbr_rows is None
    p144 = NDTParams(pack_budget_mb=512)
    f144 = ndt_field(m, spec, p144)
    assert f144.nbr_rows is not None and f144.nbr_rows.shape[1] == 144
    # budget that fits (G,48) but not (G,144)
    g = 1 << (3 * spec.dim_bits)
    mb48 = (g * 48 * 4) // (1 << 20) + 1
    p48 = NDTParams(pack_budget_mb=mb48)
    f48 = ndt_field(m, spec, p48)
    assert f48.nbr_rows is not None and f48.nbr_rows.shape[1] == 48

    T_q = se3.exp(jnp.array([0.1, -0.05, 0.02, 0.02, -0.01, 0.03],
                            jnp.float32))
    src = cloud.transform(se3.inverse(T_q))
    ref = _ndt_terms(src, T_q, f0, spec, base)
    for f, p in ((f144, p144), (f48, p48)):
        for iso in (False, True):
            got = _ndt_terms(src, T_q, f, spec, p, isotropic=iso)
            want = _ndt_terms(src, T_q, f0, spec, base, isotropic=iso)
            for a, b in zip(got, want):
                np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                           rtol=1e-4, atol=1e-3)
    # end-to-end: registration result identical across tiers
    xi = jnp.array([0.15, -0.1, 0.05, 0.02, -0.02, 0.04], jnp.float32)
    src2 = cloud.transform(se3.inverse(se3.exp(xi)))
    r0 = ndt_register(src2, f0, spec, params=base)
    r1 = ndt_register(src2, f144, spec, params=p144)
    np.testing.assert_allclose(np.asarray(r0.T), np.asarray(r1.T),
                               rtol=1e-4, atol=1e-4)


def test_ndt_field_windowed_matches_full_grid():
    """A field windowed into a large map grid must register identically to
    a full-grid field when the scan fits inside the window."""
    from tpu_slam.registration.ndt import _ndt_terms

    world = syn.default_office()
    T = np.eye(4); T[:3, 3] = [0, 0, 1.5]
    pts, valid = syn.simulate_vlp16_revolution(world, T, n_azimuth=240)
    cloud = PointCloud.from_points(jnp.asarray(pts[valid]), capacity=4096)
    # big grid: 100 m half extent at 0.5 leaf -> dim_bits 9 >> window_bits
    big = VoxelGridSpec.centered(leaf=0.5, half_extent=100.0)
    m = insert_cloud(empty_map(16384), cloud, big, 0.0)

    p = NDTParams(pack_budget_mb=512, window_bits=6)
    center = jnp.asarray([0.0, 0.0, 1.5], jnp.float32)
    f_win = ndt_field(m, big, p, center=center)
    assert f_win.origin_cell is not None
    assert f_win.nbr_rows is not None and f_win.nbr_rows.shape[0] == 2 ** 18

    # reference: same scene in a small grid where the window IS the grid
    small = VoxelGridSpec.centered(leaf=0.5, half_extent=16.0)
    m2 = insert_cloud(empty_map(16384), cloud, small, 0.0)
    f_ref = ndt_field(m2, small, p)
    assert f_ref.origin_cell is None

    T_q = se3.exp(jnp.array([0.1, -0.05, 0.02, 0.02, -0.01, 0.03],
                            jnp.float32))
    src = cloud.transform(se3.inverse(T_q))
    got = _ndt_terms(src, T_q, f_win, big, p)
    want = _ndt_terms(src, T_q, f_ref, small, p)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-3)

    # default centroid centering (no center arg) also works
    f_auto = ndt_field(m, big, p)
    got2 = _ndt_terms(src, T_q, f_auto, big, p)
    np.testing.assert_allclose(np.asarray(got2[0]), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-3)

    r = ndt_register(src, f_win, big, params=p)
    err = se3.log(se3.compose(se3.inverse(T_q), r.T))
    assert float(jnp.linalg.norm(err[:3])) < 0.02


def test_insert_incremental_matches_full_merge():
    """insert_cloud(incremental=True) must equal the full sort-merge for
    hit-accumulation, new-key interleaving, and stamps."""
    rng = np.random.default_rng(7)
    m_inc = empty_map(4096)
    m_full = empty_map(4096)
    for k, z in enumerate([0.0, 0.0, 1.0, 2.0]):
        c = _plane_cloud(rng, 700, z=z)
        m_inc = insert_cloud(m_inc, c, SPEC, stamp=float(k),
                             incremental=True)
        m_full = insert_cloud(m_full, c, SPEC, stamp=float(k),
                              incremental=False)
    np.testing.assert_array_equal(np.asarray(m_inc.keys),
                                  np.asarray(m_full.keys))
    np.testing.assert_allclose(np.asarray(m_inc.count),
                               np.asarray(m_full.count), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(m_inc.sum_pts),
                               np.asarray(m_full.sum_pts), atol=1e-4)
    np.testing.assert_allclose(np.asarray(m_inc.sum_outer),
                               np.asarray(m_full.sum_outer), atol=1e-4)
    occ = np.asarray(m_inc.occupied_mask())
    np.testing.assert_array_equal(np.asarray(m_inc.stamp)[occ],
                                  np.asarray(m_full.stamp)[occ])


def test_insert_incremental_overflow_fallback():
    """Over-capacity inserts must still evict-by-stamp exactly like the
    full merge (the lax.cond fallback)."""
    rng = np.random.default_rng(8)
    m_inc = empty_map(96)
    m_full = empty_map(96)
    for k, z in enumerate([0.0, 2.0]):
        c = _plane_cloud(rng, 600, z=z)
        m_inc = insert_cloud(m_inc, c, SPEC, stamp=float(k),
                             incremental=True)
        m_full = insert_cloud(m_full, c, SPEC, stamp=float(k),
                              incremental=False)
    np.testing.assert_array_equal(np.asarray(m_inc.keys),
                                  np.asarray(m_full.keys))
    np.testing.assert_allclose(np.asarray(m_inc.count),
                               np.asarray(m_full.count), rtol=1e-6)


def test_build_map_host_matches_insert_cloud():
    """The host bulk constructor must agree with the device insert path."""
    import numpy as np
    import jax.numpy as jnp
    from tpu_slam.core.pointcloud import PointCloud
    from tpu_slam.kernels.voxel_hash import VoxelGridSpec
    from tpu_slam.mapping.voxel_map import (build_map_host, empty_map,
                                            insert_cloud)

    rng = np.random.default_rng(11)
    pts = rng.uniform(0.2, 7.5, (3000, 3)).astype(np.float32)
    spec = VoxelGridSpec(leaf=0.5, origin=(0.0, 0.0, 0.0), dim_bits=4)
    host = build_map_host(pts, spec, capacity=4096)
    dev = insert_cloud(empty_map(4096),
                       PointCloud.from_points(jnp.asarray(pts),
                                              capacity=4096),
                       spec, 0.0, incremental=False)
    np.testing.assert_array_equal(np.asarray(host.keys), np.asarray(dev.keys))
    np.testing.assert_allclose(np.asarray(host.count), np.asarray(dev.count))
    np.testing.assert_allclose(np.asarray(host.sum_pts),
                               np.asarray(dev.sum_pts), atol=1e-4)
    np.testing.assert_allclose(np.asarray(host.sum_outer),
                               np.asarray(dev.sum_outer), atol=1e-4)
