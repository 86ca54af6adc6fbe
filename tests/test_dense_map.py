"""Dense moment-window map: equivalence to the sparse path + engine smoke.

The DenseMomentGrid must agree with the sparse VoxelMap pipeline it
replaces at odometry rate: same per-cell moments as scan_to_voxel_stats,
same coarse moments as coarsen_map, and the SAME NDT plane tensor as
ndt_field's sparse->dense build — then the dense odometry engine must
track a synthetic trajectory end to end.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_slam.core.pointcloud import PointCloud
from tpu_slam.ingest import synthetic as syn
from tpu_slam.kernels.voxel_hash import INVALID_KEY, VoxelGridSpec
from tpu_slam.mapping.dense_map import (DenseMomentGrid, centered_origin_cell,
                                        empty_grid, grid_coarsen, grid_insert,
                                        grid_ndt_field, grid_recenter_shift,
                                        grid_scroll,
                                        grid_to_sparse_aggregates)
from tpu_slam.mapping.voxel_map import (build_map_host, coarse_spec_of,
                                        coarsen_map, empty_map, insert_cloud,
                                        scan_to_voxel_stats)


def _scene_cloud(seed=0, n=2000, extent=6.0, cap=2048):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-extent, extent, n),
                    rng.uniform(-extent, extent, n),
                    rng.uniform(0.0, 3.0, n)], 1).astype(np.float32)
    return PointCloud.from_points(jnp.asarray(pts), capacity=cap)


SPEC = VoxelGridSpec.centered(leaf=0.5, half_extent=16.0)
DIMS = (32, 32, 16)


def _grid_with(cloud, origin_cell=(16, 16, 20)):
    g = empty_grid(DIMS, jnp.asarray(origin_cell, jnp.int32))
    return grid_insert(g, cloud, SPEC)


def test_grid_insert_matches_sparse_aggregates():
    cloud = _scene_cloud()
    grid = _grid_with(cloud)
    keys, cnt, ssum, souter = scan_to_voxel_stats(cloud, SPEC)
    k2, c2, s2, o2 = grid_to_sparse_aggregates(grid, SPEC)

    def as_dict(k, c, s, o):
        out = {}
        for i in range(len(k)):
            if int(k[i]) != INVALID_KEY and float(c[i]) > 0:
                out[int(k[i])] = (float(c[i]), np.asarray(s[i]),
                                  np.asarray(o[i]))
        return out

    a = as_dict(np.asarray(keys), np.asarray(cnt), np.asarray(ssum),
                np.asarray(souter))
    b = as_dict(np.asarray(k2), np.asarray(c2), np.asarray(s2),
                np.asarray(o2))
    # the window covers cells [16,48)x[16,48)x[20,36) = +-8 m in x/y,
    # [ -6, 2 ) m in z of the +-16 m grid — keep only in-window cells of a
    bbits = SPEC.dim_bits
    n = SPEC.cells_per_axis

    def inside(key):
        cx = (key >> (2 * bbits)) & (n - 1)
        cy = (key >> bbits) & (n - 1)
        cz = key & (n - 1)
        return (16 <= cx < 48) and (16 <= cy < 48) and (20 <= cz < 36)

    a = {k: v for k, v in a.items() if inside(k)}
    assert set(a) == set(b)
    for k in a:
        assert a[k][0] == pytest.approx(b[k][0])
        np.testing.assert_allclose(a[k][1], b[k][1], atol=1e-4)
        np.testing.assert_allclose(a[k][2], b[k][2], atol=1e-4)


def test_grid_insert_weight_zero_is_noop():
    cloud = _scene_cloud()
    grid = _grid_with(cloud)
    rows0 = np.array(grid.rows)          # snapshot — grid is donated below
    grid2 = grid_insert(grid, _scene_cloud(seed=1), SPEC, weight=0.0)
    np.testing.assert_array_equal(np.asarray(grid2.rows), rows0)


def test_grid_coarsen_matches_coarsen_map():
    cloud = _scene_cloud()
    grid = _grid_with(cloud)
    cg = grid_coarsen(grid, SPEC, 4)
    # sparse reference: insert the same in-window points into a VoxelMap,
    # coarsen, compare per-coarse-cell moments
    vmap = insert_cloud(empty_map(4096), cloud, SPEC, 0.0)
    cmap = coarsen_map(vmap, SPEC, 4)
    cspec = coarse_spec_of(SPEC, 4)
    k2, c2, s2, o2 = grid_to_sparse_aggregates(cg, cspec)
    ref = {}
    ck = np.asarray(cmap.keys)
    for i in range(len(ck)):
        if int(ck[i]) != INVALID_KEY:
            ref[int(ck[i])] = (float(cmap.count[i]),
                               np.asarray(cmap.sum_pts[i]),
                               np.asarray(cmap.sum_outer[i]))
    got = {}
    k2n = np.asarray(k2)
    for i in range(len(k2n)):
        if int(k2n[i]) != INVALID_KEY and float(c2[i]) > 0:
            got[int(k2n[i])] = (float(c2[i]), np.asarray(s2[i]),
                                np.asarray(o2[i]))
    # coarse window = fine window/4 = cells [4,12)x[4,12)x[5,9)
    bb = cspec.dim_bits
    nn = cspec.cells_per_axis

    def inside(key):
        cx = (key >> (2 * bb)) & (nn - 1)
        cy = (key >> bb) & (nn - 1)
        cz = key & (nn - 1)
        return (4 <= cx < 12) and (4 <= cy < 12) and (5 <= cz < 9)

    ref = {k: v for k, v in ref.items() if inside(k)}
    assert set(ref) == set(got)
    for k in ref:
        assert ref[k][0] == pytest.approx(got[k][0])
        np.testing.assert_allclose(ref[k][1], got[k][1], atol=2e-3)
        np.testing.assert_allclose(ref[k][2], got[k][2], atol=1e-2)


def test_grid_field_matches_sparse_field_planes():
    """grid_ndt_field rows == ndt_field rows for the same window."""
    from tpu_slam.registration.ndt import NDTParams, ndt_field

    cloud = _scene_cloud()
    # sparse build path: window == the whole 64-cell grid is too big; use
    # a field window equal to the dense grid's window via window_dims and
    # center; align origin cells by centering both on the same point
    grid = _grid_with(cloud)
    f_dense = grid_ndt_field(grid, SPEC)

    vmap = insert_cloud(empty_map(8192), cloud, SPEC, 0.0)
    center = (jnp.asarray(SPEC.origin, jnp.float32)
              + (grid.origin_cell.astype(jnp.float32)
                 + jnp.asarray([d / 2 for d in DIMS])) * SPEC.leaf)
    params = NDTParams(window_dims=DIMS)
    f_sparse = ndt_field(vmap, SPEC, params, center=center)
    assert tuple(np.asarray(f_sparse.origin_cell)) == tuple(
        np.asarray(grid.origin_cell))
    np.testing.assert_allclose(np.asarray(f_dense.rows),
                               np.asarray(f_sparse.rows),
                               rtol=2e-4, atol=2e-4)


def test_grid_scroll_moves_content_and_origin():
    cloud = _scene_cloud()
    grid = _grid_with(cloud)
    a = np.array(grid.rows).reshape(*DIMS, 10)   # snapshot before donation
    k_old, c_old, _, _ = jax.block_until_ready(
        grid_to_sparse_aggregates(grid, SPEC))
    shift = jnp.asarray([4, -4, 0], jnp.int32)
    g2 = grid_scroll(grid, shift)
    assert tuple(np.asarray(g2.origin_cell)) == (20, 12, 20)
    b = np.asarray(g2.rows).reshape(*DIMS, 10)
    # content at new local (x, y) = old local (x+4, y-4)
    np.testing.assert_allclose(b[:-4, 4:, :], a[4:, :-4, :])
    assert np.all(b[-4:, :, :] == 0)
    assert np.all(b[:, :4, :] == 0)
    # aggregate keys agree with a fresh insert at the scrolled origin
    k_new, c_new, _, _ = grid_to_sparse_aggregates(g2, SPEC)
    keep_old = {int(k): float(c) for k, c in zip(np.asarray(k_old),
                                                 np.asarray(c_old))
                if int(k) != INVALID_KEY and float(c) > 0}
    keep_new = {int(k): float(c) for k, c in zip(np.asarray(k_new),
                                                 np.asarray(c_new))
                if int(k) != INVALID_KEY and float(c) > 0}
    assert set(keep_new) <= set(keep_old)       # only evictions
    for k, v in keep_new.items():
        assert keep_old[k] == pytest.approx(v)


def test_recenter_shift_alignment():
    grid = empty_grid(DIMS, jnp.asarray([16, 16, 20], jnp.int32))
    s = grid_recenter_shift(grid, jnp.asarray([5.3, -2.1, 0.4]), SPEC,
                            align=4)
    assert np.all(np.asarray(s) % 4 == 0)
    c0 = centered_origin_cell(jnp.asarray([5.3, -2.1, 0.4]), SPEC, DIMS, 4)
    assert np.all((np.asarray(c0) % 4) == 0)


@pytest.mark.slow
def test_dense_odometry_tracks_trajectory():
    """End-to-end: the dense engine tracks a synthetic office loop."""
    import math

    from tpu_slam.pipeline.config import OdometryConfig
    from tpu_slam.pipeline.odometry_dense import DenseLidarOdometry
    from tpu_slam.registration.ndt import NDTParams

    world = syn.default_office()
    rng = np.random.default_rng(0)
    clouds, gt = [], []
    for k in range(6):
        T = syn.se2_pose(0.25 * k - 0.6, 0.1 * k - 0.3, 0.06 * k, z=1.2)
        pts, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=600, noise_std=0.005, rng=rng)
        clouds.append(PointCloud.from_points(jnp.asarray(pts[valid]),
                                             capacity=12288))
        gt.append(T)

    cfg = OdometryConfig(
        scan_capacity=8192, downsample_leaf=0.2,
        map_leaf=0.4, map_half_extent=16.0, map_capacity=16384,
        ndt=NDTParams(max_iterations=10, coarse_iterations=2,
                      window_dims=(48, 48, 16)),
        pyramid_factor=2)
    odo = DenseLidarOdometry(cfg)
    poses, log = odo.run(clouds, init_pose=jnp.asarray(gt[0], jnp.float32))
    for k in range(1, 6):
        err = np.linalg.norm(poses[k][:3, 3] - gt[k][:3, 3])
        assert err < 0.08, f"scan {k}: {err:.3f} m off"
