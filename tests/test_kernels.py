import jax.numpy as jnp
import numpy as np
import pytest

from tpu_slam.core.pointcloud import PAD_COORD, PointCloud, exclusion_box_filter
from tpu_slam.kernels.downsample import voxel_downsample
from tpu_slam.kernels.nn_search import (
    nearest_neighbors,
    nearest_neighbors_hash,
)
from tpu_slam.kernels.voxel_hash import (
    INVALID_KEY,
    VoxelGridSpec,
    pack_key,
    cell_coords,
    neighbor_offsets_keys,
    sort_by_key,
    voxel_keys,
)


def make_cloud(rng, n, cap=None, scale=10.0):
    pts = rng.uniform(-scale, scale, size=(n, 3)).astype(np.float32)
    return pts, PointCloud.from_points(jnp.asarray(pts), capacity=cap)


# ---------------------------------------------------------------- pointcloud

def test_pointcloud_padding():
    rng = np.random.default_rng(0)
    pts, cloud = make_cloud(rng, 50, cap=64)
    assert cloud.capacity == 64
    assert int(cloud.count()) == 50
    assert bool(jnp.all(cloud.points[50:] == PAD_COORD))


def test_exclusion_box_keeps_outside():
    # Reference semantics: points INSIDE the box are removed (self-filter),
    # m3d_aggregator.cpp:65-73.
    pts = jnp.array([[0.0, 0.0, 0.0], [5.0, 5.0, 5.0], [0.1, 0.1, 0.1]])
    cloud = PointCloud.from_points(pts)
    out = exclusion_box_filter(cloud, jnp.array([-1.0] * 3), jnp.array([1.0] * 3))
    np.testing.assert_array_equal(np.asarray(out.mask), [False, True, False])


def test_compact_moves_valid_to_front():
    pts = jnp.array([[1.0, 0, 0], [2.0, 0, 0], [3.0, 0, 0], [4.0, 0, 0]])
    cloud = PointCloud(points=pts, mask=jnp.array([False, True, False, True]))
    c = cloud.compact().sanitize()
    np.testing.assert_array_equal(np.asarray(c.mask), [True, True, False, False])
    np.testing.assert_allclose(np.asarray(c.points[:2, 0]), [2.0, 4.0])


# ---------------------------------------------------------------- voxel hash

def test_pack_key_unique_in_bounds():
    spec = VoxelGridSpec(leaf=1.0, origin=(0.0, 0.0, 0.0), dim_bits=4)
    coords = jnp.array([[0, 0, 0], [1, 2, 3], [15, 15, 15], [16, 0, 0]])
    keys = pack_key(coords, spec)
    assert keys[0] == 0
    assert keys[3] == INVALID_KEY  # out of bounds is masked, never wrapped
    assert len(set(np.asarray(keys[:3]).tolist())) == 3


def test_same_voxel_same_key():
    spec = VoxelGridSpec(leaf=0.5, origin=(-8.0, -8.0, -8.0), dim_bits=6)
    pts = jnp.array([[0.1, 0.1, 0.1], [0.3, 0.4, 0.2], [1.1, 0.1, 0.1]])
    cloud = PointCloud.from_points(pts)
    keys = voxel_keys(cloud, spec)
    assert keys[0] == keys[1]
    assert keys[0] != keys[2]


def test_neighbor_offsets_contains_self():
    spec = VoxelGridSpec(leaf=1.0, origin=(0.0, 0.0, 0.0), dim_bits=5)
    coords = jnp.array([[3, 3, 3]])
    key = pack_key(coords, spec)
    nk = neighbor_offsets_keys(key, spec)
    assert nk.shape == (1, 27)
    assert int(key[0]) in np.asarray(nk[0]).tolist()
    # corner cell: some neighbors out of bounds
    corner = pack_key(jnp.array([[0, 0, 0]]), spec)
    nk2 = neighbor_offsets_keys(corner, spec)
    assert np.sum(np.asarray(nk2[0]) == INVALID_KEY) == 27 - 8


def test_sort_by_key_invalid_to_tail():
    rng = np.random.default_rng(1)
    _, cloud = make_cloud(rng, 40, cap=64, scale=5.0)
    spec = VoxelGridSpec.centered(leaf=0.5, half_extent=8.0)
    skeys, scloud = sort_by_key(cloud, spec)
    assert bool(jnp.all(skeys[:-1] <= skeys[1:]))
    assert bool(jnp.all(~scloud.mask[40:]))


# ---------------------------------------------------------------- downsample

def test_voxel_downsample_centroids():
    spec = VoxelGridSpec(leaf=1.0, origin=(0.0, 0.0, 0.0), dim_bits=4)
    pts = jnp.array([
        [0.2, 0.2, 0.2], [0.4, 0.4, 0.4],   # voxel (0,0,0)
        [2.5, 2.5, 2.5],                     # voxel (2,2,2)
    ])
    cloud = PointCloud.from_points(pts, capacity=8)
    out = voxel_downsample(cloud, spec)
    assert int(out.count()) == 2
    got = np.asarray(out.points[:2])
    got = got[np.argsort(got[:, 0])]
    np.testing.assert_allclose(got[0], [0.3, 0.3, 0.3], atol=1e-6)
    np.testing.assert_allclose(got[1], [2.5, 2.5, 2.5], atol=1e-6)


def test_voxel_downsample_vs_numpy():
    rng = np.random.default_rng(2)
    pts, cloud = make_cloud(rng, 500, cap=512, scale=4.0)
    spec = VoxelGridSpec.centered(leaf=0.8, half_extent=8.0)
    out = voxel_downsample(cloud, spec)
    # numpy reference
    origin = np.asarray(spec.origin)
    cells = np.floor((pts - origin) / spec.leaf).astype(np.int64)
    uniq = set(map(tuple, cells.tolist()))
    assert int(out.count()) == len(uniq)


# ---------------------------------------------------------------- NN search

def test_nn_brute_matches_numpy():
    rng = np.random.default_rng(3)
    q, _ = make_cloud(rng, 100)
    t, _ = make_cloud(rng, 200)
    idx, dist = nearest_neighbors(jnp.asarray(q), jnp.asarray(t))
    d2 = ((q[:, None, :] - t[None, :, :]) ** 2).sum(-1)
    ref_idx = d2.argmin(1)
    np.testing.assert_array_equal(np.asarray(idx), ref_idx)
    np.testing.assert_allclose(np.asarray(dist), np.sqrt(d2.min(1)), atol=1e-4)


def test_nn_brute_ignores_padding_targets():
    rng = np.random.default_rng(4)
    q = jnp.asarray(rng.normal(size=(10, 3)), dtype=jnp.float32)
    t_real = rng.normal(size=(5, 3)).astype(np.float32)
    tcloud = PointCloud.from_points(jnp.asarray(t_real), capacity=32)
    idx, dist = nearest_neighbors(q, tcloud.points)
    assert bool(jnp.all(idx < 5))


def test_nn_hash_matches_brute_within_leaf():
    rng = np.random.default_rng(5)
    t, tcloud = make_cloud(rng, 300, cap=512, scale=5.0)
    q = (t[:50] + rng.normal(scale=0.05, size=(50, 3))).astype(np.float32)
    spec = VoxelGridSpec.centered(leaf=0.5, half_extent=8.0)
    skeys, scloud = sort_by_key(tcloud, spec)
    idx_h, dist_h = nearest_neighbors_hash(
        jnp.asarray(q), skeys, scloud.points, spec, k_per_cell=4)
    idx_b, dist_b = nearest_neighbors(jnp.asarray(q), scloud.points)
    # wherever hash found a neighbor within one leaf, it must agree with brute
    close = np.asarray(dist_b) < spec.leaf
    assert close.mean() > 0.9
    np.testing.assert_allclose(np.asarray(dist_h)[close],
                               np.asarray(dist_b)[close], atol=1e-4)


@pytest.mark.parametrize("nq,nt,chunk", [(300, 700, 128), (1, 5, 512),
                                         (513, 64, 512)])
def test_nn_brute_matches_numpy_padded(nq, nt, chunk):
    """Query counts that are not a chunk multiple, and padded targets."""
    rng = np.random.default_rng(6)
    q = rng.normal(size=(nq, 3)).astype(np.float32)
    t_real = rng.normal(size=(nt, 3)).astype(np.float32)
    tcloud = PointCloud.from_points(jnp.asarray(t_real), capacity=nt + 37)
    idx, dist = nearest_neighbors(jnp.asarray(q), tcloud.points, chunk=chunk)
    d = np.linalg.norm(q[:, None, :].astype(np.float64)
                       - t_real[None, :, :], axis=2)
    np.testing.assert_array_equal(np.asarray(idx), np.argmin(d, axis=1))
    np.testing.assert_allclose(np.asarray(dist), d.min(axis=1), atol=1e-5)
