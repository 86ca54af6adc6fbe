"""Benchmark suite: the five BASELINE.json configs at realistic workloads.

The reference publishes no numbers (BASELINE.md; its CUDA core is an empty
submodule). The vs_baseline denominator is the scan-matching rate of
single-GPU CUDA ICP/NDT pipelines of the reference's era, ~10 scans/s.

Configs (BASELINE.md:32-35):
  1. single-pair point-to-point ICP;
  2. sequential frame-to-map odometry, outdoor VLP-16 revolutions
     (>=64k-ray scans), end-to-end scans/s;
  3. NDT scan-to-map registration against a >=100k-voxel outdoor map —
     the HEADLINE metric — with per-stage timings (field build / terms
     pass / binning / map insert) and the terms pass's share of the
     device's published peaks (DEVICE_PEAKS);
  4. full 6D SLAM (keyframes + loop closure + pose-graph GN), indoor
     sequence, end-to-end scans/s;
  5. multi-device sharded NDT scaling curve (runs when >1 device is
     visible; on one device it reports "not measured").

Runs on a GPU only: with no GPU visible it exits non-zero. Prints ONE
JSON line: {"metric", "value", "unit", "vs_baseline", "device",
"configs": {...per-config results...}}; "device" names the platform,
device_kind and device count. Detail goes to stderr.
"""

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

BASELINE_SCANS_PER_SEC = 10.0

# Published peaks by jax device_kind (NVIDIA H100 data sheet, SXM5 part,
# dense rates at the 700 W limit): HBM3 bandwidth and float32 outside the
# tensor cores (the terms pass is float32 elementwise work).
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "fp32_flops_per_s": 67e12},
}


def device_peaks(kind):
    """Peak table row of ``kind``; a device not in the table is an error."""
    if kind not in DEVICE_PEAKS:
        raise KeyError(f"no published peaks for device_kind {kind!r}; add "
                       "them to bench.DEVICE_PEAKS with their source")
    return DEVICE_PEAKS[kind]


def _log(msg):
    print(f"# {msg}", file=sys.stderr, flush=True)


def _time(fn, reps, ready):
    """Mean seconds per call; ``ready(out)`` blocks on the result.

    Includes per-call dispatch; stage timings below use device-side slope
    loops (tpu_slam.utils.devtime) to time the device work alone.
    """
    ready(fn())               # warm-up / compile
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    ready(out)
    return (time.perf_counter() - t0) / reps


# ---------------------------------------------------------------------------
# Shared workload builders
# ---------------------------------------------------------------------------

def _outdoor_scans(n_poses, n_azimuth=4096, radius=26.0, step=1.0,
                   max_range=75.0, seed=0):
    """VLP-16 revolutions along a ring road in the city-block world.

    n_azimuth=4096 -> 65,536 rays per revolution (>= the 64k-point
    realistic-scan bar; a real VLP-16 at 600 RPM fires ~28.9k/rev, so this
    is ~2.3 revolutions of work per scan). ``step`` is the inter-scan
    motion in meters (1 m/scan = 10 m/s urban driving at 10 Hz); the range
    gate keeps every return inside the benchmark map grid."""
    import jax.numpy as jnp
    import math
    from tpu_slam.core.pointcloud import PointCloud
    from tpu_slam.ingest import synthetic as syn

    world = syn.outdoor_block(n_buildings=10, extent=90.0, seed=3)
    rng = np.random.default_rng(seed)
    clouds, gt = [], []
    for k in range(n_poses):
        a = step * k / radius
        T = syn.se2_pose(radius * math.cos(a), radius * math.sin(a),
                         a + math.pi / 2, z=1.8)
        pts, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=n_azimuth, max_range=max_range,
            noise_std=0.01, rng=rng)
        clouds.append(PointCloud.from_points_host(pts[valid],
                                                  capacity=n_azimuth * 16))
        gt.append(T)
    return clouds, np.stack(gt)


def _city_route(n_poses, step=1.6, turn_radius=8.0):
    """The city street route: two legs joined by a quarter-circle corner.

    Streets run along x,y = -100 + 24i (dense_city block pitch); the
    route drives east along y=-4, arcs left at the (-4,-4) intersection,
    then north along x=-4.
    """
    import math

    r = turn_radius
    n_arc = max(1, int(round((math.pi / 2) * r / step)))
    n1 = max(2, (n_poses - n_arc) // 2)
    poses = []
    for k in range(n_poses):
        s = step * k                       # arc length along the route
        s1 = step * (n1 - 1)               # end of leg 1
        s2 = s1 + (math.pi / 2) * r        # end of the corner arc
        if s <= s1:
            poses.append(syn_se2(-4.0 - r - (s1 - s), -4.0, 0.0))
        elif s <= s2:
            th = (s - s1) / r              # 0..pi/2 swept heading
            poses.append(syn_se2(-4.0 - r + r * math.sin(th),
                                 -4.0 + r * (1.0 - math.cos(th)), th))
        else:
            poses.append(syn_se2(-4.0, -4.0 + r + (s - s2), math.pi / 2))
    return poses


def syn_se2(x, y, yaw):
    from tpu_slam.ingest import synthetic as syn
    return syn.se2_pose(x, y, yaw, z=1.8)


def _city_scans(n_poses, n_azimuth=4096, step=1.6, max_range=75.0, seed=0,
                turn_radius=8.0):
    """VLP-16 revolutions along a street route through the dense grid-city.

    Two street legs joined by a quarter-circle corner turn: the L-shape
    breaks the forward translation/yaw degeneracy a single straight street
    leaves.  The corner is an ARC, not a pose jump — round 3 placed a
    90-degree yaw discontinuity between consecutive scans (900 deg/s at
    10 Hz, kinematically impossible), and the registration locked onto the
    90-degree-symmetric street grid instead, compounding 2.3 m per scan.
    At ``turn_radius`` 8 m and 1.6 m steps the turn sweeps 0.2 rad/scan
    (115 deg/s, a hard but physical urban corner).  Workload is unchanged:
    65,536 rays/scan, dense_city, ``step`` inter-scan motion.
    """
    import jax.numpy as jnp
    import math
    from tpu_slam.core.pointcloud import PointCloud
    from tpu_slam.ingest import synthetic as syn

    world = syn.dense_city(extent=200.0, seed=0)
    rng = np.random.default_rng(seed)
    poses = _city_route(n_poses, step=step, turn_radius=turn_radius)
    clouds = []
    for T in poses:
        pts, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=n_azimuth, max_range=max_range,
            noise_std=0.01, rng=rng)
        clouds.append(PointCloud.from_points_host(pts[valid],
                                                  capacity=n_azimuth * 16))
    return world, clouds, np.stack(poses)


# ---------------------------------------------------------------------------
# Config 1: single-pair point-to-point ICP
# ---------------------------------------------------------------------------

def bench_icp_pair(reps=20):
    """Pair ICP at 8192 and 32768 points, two tiers: the frozen-bin tier
    (kernels.icp_terms — 27-cell correspondence + Huber GN reduction in
    one point-major pass) and the brute-force O(N^2) tier."""
    import jax
    import jax.numpy as jnp
    from tpu_slam.core import se3
    from tpu_slam.core.pointcloud import PointCloud
    from tpu_slam.ingest import synthetic as syn
    from tpu_slam.registration.icp import ICPParams, icp, icp_raster

    world = syn.default_office()
    T0 = np.eye(4); T0[:3, 3] = [0, 0, 1.5]
    pts, valid = syn.simulate_vlp16_revolution(world, T0, n_azimuth=512)
    tgt = PointCloud.from_points_host(pts[valid], capacity=8192)
    xi = jnp.array([0.15, -0.1, 0.05, 0.02, -0.02, 0.04], jnp.float32)
    src = tgt.transform(se3.inverse(se3.exp(xi)))
    params = ICPParams(max_iterations=30, max_corr_dist=1.5)
    from tpu_slam.utils.devtime import slope_time

    # a coarse leaf-1.0 stage absorbs the init before a short fine
    # leaf-0.5 polish; world z (the thin axis) rides window x (axis_perm)
    perm = (2, 0, 1)
    origin_p = jnp.asarray([-4.0, -8.0, -8.0], jnp.float32)  # (z, x, y)
    cparams = dataclasses.replace(params, max_iterations=8, tolerance=1e-3)
    fparams1 = dataclasses.replace(params, max_iterations=8,
                                   tolerance=5e-4)

    @jax.jit
    def loop_raster(K):
        def body(i, carry):
            Tc, acc = carry
            Ti = Tc.at[0, 3].add(jnp.sin(i.astype(jnp.float32)) * 0.05)
            r0 = icp_raster(src, tgt, init_T=Ti, params=cparams,
                            dims=(8, 16, 16), leaf=1.0,
                            origin_world=origin_p, axis_perm=perm)
            r = icp_raster(src, tgt, init_T=r0.T, params=fparams1,
                           dims=(16, 32, 32), leaf=0.5,
                           origin_world=origin_p, axis_perm=perm)
            return (r.T, acc + r.error)
        Tf, acc = jax.lax.fori_loop(
            0, K, body, (jnp.eye(4, dtype=jnp.float32), jnp.float32(0)))
        return Tf[0, 3] + acc

    @jax.jit
    def loop_brute(K):
        def body(i, carry):
            Tc, acc = carry
            Ti = Tc.at[0, 3].add(jnp.sin(i.astype(jnp.float32)) * 0.05)
            r = icp(src, tgt, init_T=Ti, params=params)
            return (r.T, acc + r.error)
        Tf, acc = jax.lax.fori_loop(
            0, K, body, (jnp.eye(4, dtype=jnp.float32), jnp.float32(0)))
        return Tf[0, 3] + acc

    dt_r = slope_time(loop_raster, 5, 55)
    dt_b = slope_time(loop_brute, 3, 23)

    # tier crossover: the same solve at 32k points (brute is O(N^2)/iter,
    # raster ~O(N+G)/solve — registration.icp.icp_auto routes by size)
    pts32, valid32 = syn.simulate_vlp16_revolution(world, T0,
                                                   n_azimuth=2048)
    tgt32 = PointCloud.from_points_host(pts32[valid32], capacity=32768)
    src32 = tgt32.transform(se3.inverse(se3.exp(xi)))

    @jax.jit
    def loop_raster32(K):
        def body(i, carry):
            Tc, acc = carry
            Ti = Tc.at[0, 3].add(jnp.sin(i.astype(jnp.float32)) * 0.05)
            r0 = icp_raster(src32, tgt32, init_T=Ti, params=cparams,
                            dims=(8, 16, 16), leaf=1.0,
                            origin_world=origin_p, axis_perm=perm)
            r = icp_raster(src32, tgt32, init_T=r0.T, params=fparams1,
                           dims=(16, 32, 32), leaf=0.5,
                           origin_world=origin_p, axis_perm=perm)
            return (r.T, acc + r.error)
        Tf, acc = jax.lax.fori_loop(
            0, K, body, (jnp.eye(4, dtype=jnp.float32), jnp.float32(0)))
        return Tf[0, 3] + acc

    @jax.jit
    def loop_brute32(K):
        def body(i, carry):
            Tc, acc = carry
            Ti = Tc.at[0, 3].add(jnp.sin(i.astype(jnp.float32)) * 0.05)
            r = icp(src32, tgt32, init_T=Ti, params=params)
            return (r.T, acc + r.error)
        Tf, acc = jax.lax.fori_loop(
            0, K, body, (jnp.eye(4, dtype=jnp.float32), jnp.float32(0)))
        return Tf[0, 3] + acc

    dt_r32 = slope_time(loop_raster32, 3, 23)
    dt_b32 = slope_time(loop_brute32, 2, 8)
    r0 = icp_raster(src, tgt, params=cparams, dims=(8, 16, 16), leaf=1.0,
                    origin_world=origin_p, axis_perm=perm)
    res_r = icp_raster(src, tgt, init_T=r0.T, params=fparams1,
                       dims=(16, 32, 32), leaf=0.5,
                       origin_world=origin_p, axis_perm=perm)
    res_b = icp(src, tgt, params=params)
    err_r = float(jnp.linalg.norm(se3.log(
        se3.compose(se3.inverse(se3.exp(xi)), res_r.T))))
    err_b = float(jnp.linalg.norm(se3.log(
        se3.compose(se3.inverse(se3.exp(xi)), res_b.T))))
    iters = int(res_r.iterations)
    _log(f"config1 icp: 8k raster {1/dt_r:.0f}/s vs brute {1/dt_b:.1f}/s "
         f"(err {err_r*1e3:.1f}/{err_b*1e3:.1f} mm); "
         f"32k raster {1/dt_r32:.0f}/s vs brute {1/dt_b32:.1f}/s "
         f"(icp_auto routes at 12k)")
    return {"registrations_per_sec": round(1 / dt_r, 2),
            "iters_per_sec": round(iters / dt_r, 1),
            "recovery_err_mm": round(err_r * 1e3, 2),
            "brute_registrations_per_sec": round(1 / dt_b, 2),
            "brute_recovery_err_mm": round(err_b * 1e3, 2),
            "raster_32k_registrations_per_sec": round(1 / dt_r32, 2),
            "brute_32k_registrations_per_sec": round(1 / dt_b32, 2),
            "auto_tier_8k": "brute", "auto_tier_32k": "raster",
            "points": int(tgt.capacity)}


# ---------------------------------------------------------------------------
# Config 2: sequential frame-to-map odometry (outdoor, >=64k-ray scans)
# ---------------------------------------------------------------------------

def bench_odometry(n_poses=24):
    """Dense-window odometry (pipeline.odometry_dense): the whole per-scan
    update — scroll, coarse+fine NDT register, gating, insert — is ONE
    donated-state dispatch.  Measured twice: per-scan-synced (end-to-end
    with metrics) and fully async (the PP-analog serving overlap)."""
    import jax
    import jax.numpy as jnp
    from tpu_slam.pipeline.config import OdometryConfig
    from tpu_slam.pipeline.metrics import ate_rmse
    from tpu_slam.pipeline.odometry_dense import DenseLidarOdometry
    from tpu_slam.registration.ndt import NDTParams

    from tpu_slam.pipeline.metrics import MetricsLog

    _, clouds, gt = _city_scans(n_poses)
    cfg = OdometryConfig(
        scan_capacity=32768, downsample_leaf=0.3,
        map_leaf=0.5, map_half_extent=128.0, map_capacity=262144,
        scan_max_range=45.0, insert_downsampled=True,
        ndt=NDTParams(max_iterations=10, coarse_iterations=2,
                      tolerance=3e-4, min_voxel_count=3.0,
                      window_dims=(192, 192, 32)),
        pyramid_factor=4,
        max_pred_translation=2.0)   # urban 10 Hz steps are ~1.6 m; the
    #                                 indoor 0.7 m clamp would chop the CV
    #                                 prediction every scan
    # warm-up on the SAME engine instance (the jitted step is per-instance;
    # a fresh instance would recompile inside the timed run)
    odo = DenseLidarOdometry(cfg)
    odo.run(clouds[:3], init_pose=jnp.asarray(gt[0], jnp.float32))
    odo.metrics = MetricsLog()

    t0 = time.perf_counter()
    poses, log = odo.run(clouds, init_pose=jnp.asarray(gt[0], jnp.float32))
    dt = time.perf_counter() - t0
    ate = ate_rmse(poses, gt, align=False)
    s = log.summary()
    _log(f"config2 odometry: {n_poses/dt:.1f} scans/s end-to-end, "
         f"ate={ate:.3f} m, mean_frac={s['mean_matched_fraction']:.2f}, "
         f"window={cfg.ndt.window_dims} at {cfg.map_leaf} m")

    # serving path: same engine, no per-scan sync — dispatches pipeline
    # behind host scan prep (PP-analog overlap)
    t0 = time.perf_counter()
    jposes, _ = odo.run(clouds, init_pose=jnp.asarray(gt[0], jnp.float32),
                        sync_every=0)
    jdt = time.perf_counter() - t0
    jate = ate_rmse(jposes, gt, align=False)
    jerr = float(np.linalg.norm(jposes[-1][:3, 3] - gt[-1][:3, 3]))
    _log(f"config2 async odometry (overlapped): {n_poses/jdt:.1f} scans/s, "
         f"ate={jate:.3f} m, final position err={jerr:.3f} m")
    return {"scans_per_sec": round(n_poses / dt, 2),
            "jit_overlapped_scans_per_sec": round(n_poses / jdt, 2),
            "jit_final_position_err_m": round(jerr, 4),
            "jit_ate_m": round(float(jate), 4),
            "ate_m": round(float(ate), 4),
            "mean_matched_fraction": round(s["mean_matched_fraction"], 3),
            "n_scans": n_poses,
            "raw_rays_per_scan": 65536,
            "mean_iterations": round(s["mean_iterations"], 1)}


# ---------------------------------------------------------------------------
# Config 3: NDT scan-to-map registration (HEADLINE) + per-stage timings
# ---------------------------------------------------------------------------

def config3_workload():
    """The config-3 registration workload and its production solve.

    Dense grid-city map (>= 100k occupied 0.5 m voxels), one street-pose
    VLP-16 scan downsampled to >= 16,384 points, the coarse 2 m pyramid
    field for capture and the fine 0.5 m 160x160x32 window. Workload
    floors are ASSERTED. Returns a dict of the pieces; ``register(src,
    csrc, init_T)`` runs the two-level solve.
    """
    import jax
    import jax.numpy as jnp
    from tpu_slam.core.pointcloud import PointCloud
    from tpu_slam.ingest import synthetic as syn
    from tpu_slam.kernels.downsample import voxel_downsample
    from tpu_slam.kernels.voxel_hash import VoxelGridSpec
    from tpu_slam.mapping.voxel_map import (build_map_host, coarse_spec_of,
                                            coarsen_map)
    from tpu_slam.registration.ndt import NDTParams, ndt_field, ndt_register

    world = syn.dense_city(extent=200.0, seed=0)
    surf = syn.sample_world_surface(world, spacing=0.15, noise_std=0.01,
                                    seed=1)
    map_spec = VoxelGridSpec.centered(leaf=0.5, half_extent=128.0)
    vmap = build_map_host(surf, map_spec, capacity=524288)
    n_vox = int(vmap.n_occupied())
    assert n_vox >= 100_000, f"workload floor: {n_vox} voxels < 100k"

    T_pose = syn.se2_pose(-4.0, -4.0, 0.3, z=1.8)
    rng = np.random.default_rng(0)
    pts, valid = syn.simulate_vlp16_revolution(
        world, T_pose, n_azimuth=8192, max_range=75.0, noise_std=0.01,
        rng=rng)
    cloud = PointCloud.from_points(jnp.asarray(pts[valid]), capacity=131072)
    scan = voxel_downsample(
        cloud, VoxelGridSpec.centered(leaf=0.2, half_extent=102.0),
        capacity=65536)
    # the downsample compacts valid points to the buffer front — slice to
    # the smallest capacity that holds them all (binning is O(buffer))
    scan = PointCloud(points=scan.points[:20480], mask=scan.mask[:20480])
    n_scan = int(scan.count())
    assert n_scan >= 16_384, f"workload floor: {n_scan} scan pts < 16384"
    # coarse-stage scan at half the coarse leaf, production policy
    # (pipeline/odometry_dense.py coarse_scan_spec): the coarse level
    # absorbs init error and does not need the fine point density
    cscan = voxel_downsample(
        cloud, VoxelGridSpec.centered(leaf=1.0, half_extent=102.0),
        capacity=16384)
    Tw = jnp.asarray(T_pose, jnp.float32)

    fine_dims = (160, 160, 32)          # +-40 x +-40 x +-8 m at 0.5 m
    fparams = NDTParams(max_iterations=5, coarse_iterations=0,
                        tolerance=1e-3, min_voxel_count=3.0,
                        rebin_iters=5,      # one bin for the whole fine
                        #                     stage: the coarse level hands
                        #                     over sub-cell inits
                        window_dims=fine_dims)
    cparams = NDTParams(max_iterations=3, coarse_iterations=2,
                        max_corr_dist=4.0, window_dims=(64, 64, 16))
    cspec = coarse_spec_of(map_spec, 4)
    cmap = coarsen_map(vmap, map_spec, 4)
    cfield = ndt_field(cmap, cspec, cparams, center=Tw[:3, 3])
    field = ndt_field(vmap, map_spec, fparams, center=Tw[:3, 3])
    jax.block_until_ready(field.rows)

    def register(src, csrc, init_T, impl="auto"):
        fp = dataclasses.replace(fparams, terms_impl=impl)
        cp = dataclasses.replace(cparams, terms_impl=impl)
        r0 = ndt_register(csrc, cfield, cspec, init_T=init_T, params=cp)
        return ndt_register(src, field, map_spec, init_T=r0.T, params=fp,
                            far_field=cfield, far_spec=cspec)

    return dict(vmap=vmap, n_vox=n_vox, map_spec=map_spec, cloud=cloud,
                scan=scan, n_scan=n_scan, cscan=cscan, Tw=Tw,
                fine_dims=fine_dims, fparams=fparams, cparams=cparams,
                cspec=cspec, field=field, cfield=cfield, register=register)


def bench_ndt_register():
    """Headline: scan-to-map NDT registration on the honest city workload
    (config3_workload): the production two-level solve, with every
    timing a device-side slope (tpu_slam.utils.devtime)."""
    import jax
    import jax.numpy as jnp
    from tpu_slam.core import se3
    from tpu_slam.core.pointcloud import PointCloud
    from tpu_slam.kernels.ndt_terms import bin_points, terms_pass
    from tpu_slam.mapping.voxel_map import insert_cloud
    from tpu_slam.registration.ndt import ndt_field
    from tpu_slam.utils.devtime import slope_time

    w = config3_workload()
    vmap, map_spec, cloud = w["vmap"], w["map_spec"], w["cloud"]
    scan, cscan, Tw = w["scan"], w["cscan"], w["Tw"]
    n_vox, n_scan, fine_dims = w["n_vox"], w["n_scan"], w["fine_dims"]
    field, fparams, register = w["field"], w["fparams"], w["register"]

    # accuracy + coverage at a known perturbation
    xi = jnp.asarray([0.2, -0.15, 0.08, 0.025, -0.015, 0.04], jnp.float32)
    src = scan.transform(se3.inverse(se3.exp(xi)))
    csrc = cscan.transform(se3.inverse(se3.exp(xi)))
    T_true = se3.compose(Tw, se3.exp(xi))
    res = register(src, csrc, Tw)
    err = se3.log(se3.compose(se3.inverse(T_true), res.T))
    err_mm = float(jnp.linalg.norm(err[:3])) * 1e3
    # window coverage: scan points whose cell (at truth) is inside the
    # fine window — the matched fraction is bounded by it (street scans
    # reach 75 m; the fine window is +-40 m; the coarse stage sees +-64 m)
    sane = scan.sanitize()
    pw = sane.points @ T_true[:3, :3].T + T_true[:3, 3]
    half = jnp.asarray([fine_dims[0] / 2 * 0.5, fine_dims[1] / 2 * 0.5,
                        fine_dims[2] / 2 * 0.5])
    inwin = (jnp.all(jnp.abs(pw - Tw[:3, 3]) < half, axis=1)
             & sane.mask)
    coverage = float(jnp.sum(inwin)) / max(n_scan, 1)
    # effective OBJECTIVE coverage: the far tier adds out-of-window points
    # through the coarse field (64x64x16 at 2 m = +-64 x +-64 x +-16 m)
    cdims = (64, 64, 16)
    chalf = jnp.asarray([cdims[0], cdims[1], cdims[2]], jnp.float32)
    infar = (jnp.all(jnp.abs(pw - Tw[:3, 3]) < chalf, axis=1)
             & sane.mask)
    objective_coverage = float(jnp.sum(inwin | infar)) / max(n_scan, 1)
    frac = float(res.matched_fraction)

    # ---- device-side slope timings --------------------------------------
    @jax.jit
    def reg_loop(K):
        def body(i, carry):
            Tc, acc = carry
            f = i.astype(jnp.float32)
            Ti = (Tc.at[0, 3].add(jnp.sin(f) * 0.15)
                  .at[1, 3].add(jnp.cos(f) * 0.1))
            r = register(scan, cscan, Ti)
            return (r.T, acc + r.score)
        Tf, acc = jax.lax.fori_loop(0, K, body, (Tw, jnp.float32(0)))
        return Tf[0, 3] + acc

    t_reg = slope_time(reg_loop, 3, 23)

    dims = field.window_dims
    c0 = field.origin_cell
    cells, keep = bin_points(sane.points, sane.mask, Tw, map_spec.origin,
                             map_spec.leaf, dims, 4, c0)
    n_drop = int(jnp.sum(sane.mask)) - int(jnp.sum(keep))
    ndt_terms = terms_pass()                 # the production pass

    @jax.jit
    def terms_loop(K):
        def body(i, carry):
            acc, t = carry
            Ti = Tw.at[0, 3].add(1e-6 * i.astype(jnp.float32) + t * 1e-12)
            H, b, c, m = ndt_terms(sane.points, cells, keep, field.rows, Ti,
                                   jnp.float32(4.0), 1.0, dims)
            return (acc + c + H[0, 0] * 1e-9, t + c * 1e-12)
        acc, t = jax.lax.fori_loop(0, K, body,
                                   (jnp.float32(0), jnp.float32(0)))
        return acc + t
    t_terms = slope_time(terms_loop, 10, 110)

    @jax.jit
    def bin_loop(K):
        def body(i, carry):
            acc, t = carry
            Ti = Tw.at[0, 3].add(1e-4 * i.astype(jnp.float32) + t * 1e-12)
            cc, kk = bin_points(sane.points, sane.mask, Ti, map_spec.origin,
                                map_spec.leaf, dims, 4, c0)
            n_k = jnp.sum(kk.astype(jnp.float32))
            return (acc + n_k + cc[0, 0].astype(jnp.float32),
                    t + n_k * 1e-12 + 0.001)
        acc, t = jax.lax.fori_loop(0, K, body,
                                   (jnp.float32(0), jnp.float32(0)))
        return acc + t
    t_raster = slope_time(bin_loop, 3, 43)

    @jax.jit
    def field_loop(K):
        def body(i, carry):
            acc, c = carry
            f = ndt_field(vmap, map_spec, fparams, center=c)
            return (acc + f.rows[32, 0],
                    c + f.rows[0, 0] * 1e-12 + 0.001)
        acc, c = jax.lax.fori_loop(0, K, body,
                                   (jnp.float32(0), Tw[:3, 3]))
        return acc + c[0]
    t_field = slope_time(field_loop, 3, 23)

    wcloud = cloud.transform(Tw)

    # production odometry insert: the dense moment window (grid_insert);
    # the sparse sorted-map merge remains as the ARCHIVE path and is
    # reported separately
    from tpu_slam.mapping.dense_map import (DenseMomentGrid,
                                            centered_origin_cell,
                                            empty_grid, grid_insert)
    g_c0 = np.array(centered_origin_cell(Tw[:3, 3], map_spec, dims, align=4))
    grid0 = jax.block_until_ready(grid_insert(
        empty_grid(dims, jnp.asarray(g_c0)), wcloud, map_spec))

    @jax.jit
    def dense_ins_loop(K, rows):
        def body(i, rows):
            g = DenseMomentGrid(rows=rows,
                                origin_cell=jnp.asarray(g_c0), dims=dims)
            c2 = PointCloud(points=wcloud.points
                            + i.astype(jnp.float32) * 1e-6,
                            mask=wcloud.mask)
            return grid_insert(g, c2, map_spec).rows
        return jax.lax.fori_loop(0, K, body, rows)[0, 0]
    t_ins = slope_time(lambda K: dense_ins_loop(K, grid0.rows), 2, 12)

    @jax.jit
    def archive_loop(K, vm):
        def body(i, vm):
            c2 = PointCloud(
                points=wcloud.points
                + i.astype(jnp.float32) * 1e-6, mask=wcloud.mask)
            return insert_cloud(vm, c2, map_spec,
                                i.astype(jnp.float32))
        return jax.lax.fori_loop(0, K, body, vm).count[0]
    t_arch = slope_time(lambda K: archive_loop(K, vmap), 2, 12)

    # ---- the terms pass against the device's published peaks ----------
    # bytes: 27 gathered 64-byte rows per scan slot + the point, cell and
    # keep arrays; flops: ~38 float32 operations per (point, neighbour)
    peaks = device_peaks(jax.devices()[0].device_kind)
    n_slots = sane.points.shape[0]
    bytes_moved = n_slots * (27 * 64 + 12 + 12 + 1)
    t_hbm = bytes_moved / peaks["hbm_bytes_per_s"]
    t_fp32 = n_slots * 27 * 38 / peaks["fp32_flops_per_s"]
    sol = max(t_hbm, t_fp32)            # the binding floor
    pct_sol = 100 * sol / t_terms
    pct_hbm = 100 * t_hbm / t_terms

    _log(f"config3 ndt: map={n_vox} voxels, scan={n_scan} pts, "
         f"err={err_mm:.0f} mm, frac={frac:.2f} (window covers "
         f"{coverage:.2f}, objective {objective_coverage:.2f}); "
         f"register={t_reg*1e3:.1f} ms "
         f"({1/t_reg:.0f}/s), terms={t_terms*1e3:.3f} ms "
         f"({pct_sol:.0f}% of binding peak floor, {pct_hbm:.0f}% of HBM "
         f"floor), binning={t_raster*1e3:.2f} ms, "
         f"field={t_field*1e3:.1f} ms, "
         f"insert={t_ins*1e3:.1f} ms (archive merge {t_arch*1e3:.1f} ms)")
    return {"registrations_per_sec": round(1 / t_reg, 2),
            "map_voxels": n_vox,
            "scan_points": n_scan,
            "register_err_mm": round(err_mm, 1),
            "matched_fraction": round(frac, 3),
            "fine_window_coverage": round(coverage, 3),
            "objective_coverage": round(objective_coverage, 3),
            "fine_window_dims": list(fine_dims),
            "raster_dropped": int(n_drop),
            "stage_field_build_ms": round(t_field * 1e3, 2),
            "stage_terms_pass_ms": round(t_terms * 1e3, 3),
            "stage_raster_build_ms": round(t_raster * 1e3, 3),
            "stage_map_insert_ms": round(t_ins * 1e3, 2),
            "stage_archive_merge_ms": round(t_arch * 1e3, 2),
            "terms_bytes_moved": int(bytes_moved),
            "terms_pct_speed_of_light": round(pct_sol, 1),
            "terms_pct_hbm_speed_of_light": round(pct_hbm, 1)}


# ---------------------------------------------------------------------------
# Config 4: full 6D SLAM with loop closure
# ---------------------------------------------------------------------------

def _config4_workload(n_poses=230):
    """Two ring-corridor laps (see bench_full_slam): every segment of lap
    1 is revisited in lap 2, so loop closures bracket the whole
    trajectory and the robust graph can localize slip edges."""
    from tpu_slam.core.pointcloud import PointCloud
    from tpu_slam.ingest import synthetic as syn

    world = syn.ring_corridor()
    gt = syn.corridor_route(n_poses, step=0.6, speed_var=0.35)
    rng = np.random.default_rng(0)
    clouds = []
    for T in gt:
        pts, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=900, max_range=20.0, noise_std=0.02,
            rng=rng)
        clouds.append(PointCloud.from_points_host(pts[valid],
                                                  capacity=16384))
    return world, clouds, gt


def _config4_cfg():
    from tpu_slam.graph.loop_closure import LoopClosureParams
    from tpu_slam.graph.pose_graph import GraphSolveParams
    from tpu_slam.pipeline.config import OdometryConfig, SLAMConfig
    from tpu_slam.registration.icp import ICPParams
    from tpu_slam.registration.ndt import NDTParams

    return SLAMConfig(
        odometry=OdometryConfig(scan_capacity=8192, downsample_leaf=0.25,
                                map_leaf=0.5, map_half_extent=32.0,
                                map_capacity=32768,
                                insert_downsampled=True,
                                # (32,32,16): fine +-8 m / wide +-16 m —
                                # the corridor end walls sit at the wide
                                # window's edge, so odometry accumulates
                                # an honest smooth ~0.7 m lap drift that
                                # the graph must pull out; (48,48,16)
                                # anchors them fully and drifts only
                                # 0.1 m (measured r5)
                                ndt=NDTParams(max_iterations=12,
                                              coarse_iterations=2,
                                              min_voxel_count=3.0,
                                              window_dims=(32, 32, 16)),
                                pyramid_factor=2),
        odometry_engine="dense",
        # loosely coupled: the graph maintains the optimized trajectory;
        # odometry free-runs (re-anchor + window rebuild measured a
        # one-scan ~1 m misregistration two scans after each correction)
        reanchor_after_loop=False, rebuild_map_after_loop=False,
        keyframe_translation=0.4, keyframe_rotation=0.12,
        keyframe_capacity=288,
        keyframe_cloud_capacity=4096, loop_every=4,
        loop=LoopClosureParams(
            # loop closure = place REVISIT: a corridor lap is ~166
            # keyframes, so gap >= 60 keeps candidates on the revisit
            # segment; point-to-plane verification with the symmetric
            # cycle gate rejects corridor-section aliases (r5)
            max_distance=2.0, min_index_gap=60, max_candidates=6,
            max_error=0.05, min_matched_fraction=0.85,
            max_correction_t=2.5, max_correction_r=0.6,
            # corr dist 2.0: the loosely-coupled drift at a lap revisit
            # (~1 m) must sit inside the verification basin
            icp=ICPParams(max_iterations=40, tolerance=5e-4,
                          max_corr_dist=2.0, huber_delta=0.3)),
        edge_capacity=1024,
        graph=GraphSolveParams(gn_iterations=12, cg_iterations=200,
                               robust_delta=0.3, robust_kernel="cauchy",
                               trust_loops=True),
        # a verified same-spot revisit constraint is cm-accurate while the
        # odometry chain carries the accumulated drift — weight it above
        # the chain (the robust kernel + consistency gates bound the risk)
        loop_edge_info=400.0)


def bench_full_slam(n_poses=230):
    """Full 6D SLAM on the dense odometry engine: two laps of a
    ring-corridor building floor. The straight corridor legs are
    feature-poor along-track (the fine window covers +-8 m; end walls
    ride the wide window's edge), so odometry honestly accumulates
    ~0.75 m of smooth lap drift; loop closures (symmetric plane-ICP
    verified, cm-accurate) bracket every lap-2 segment against lap 1 and
    the trust-loops robust graph pulls the trajectory back — measured
    0.744 -> 0.23-0.29 m (r5). The residual is lap-1's own mid-lap
    drift: with a single anchor at the trajectory start and no revisit
    WITHIN lap 1, no pose-graph backend can observe where along lap 1
    the drift accrued — the optimum ties lap 2 to lap 1, bounding the
    optimized ATE at roughly lap-1's drift RMS (verified by the
    GT-loop-edge oracle in benchmarks/diag_config4.py, which plateaus at
    the same level)."""
    import jax
    import jax.numpy as jnp
    from tpu_slam.pipeline.metrics import MetricsLog, ate_rmse
    from tpu_slam.pipeline.slam import SLAMSystem

    world, clouds, gt = _config4_workload(n_poses)
    cfg = _config4_cfg()

    def run_tracked(slam):
        state = slam.init_state(jnp.asarray(gt[0], jnp.float32))
        poses, kf_scan = [], []
        for k, c in enumerate(clouds):
            state, _ = slam.step(state, c)
            poses.append(np.asarray(state.odom.pose))
            if len(kf_scan) < state.n_keyframes:
                kf_scan.append(k)
        return np.stack(poses), state, np.asarray(kf_scan)

    slam = SLAMSystem(cfg)
    # warm-up on the SAME system (compile every stage incl. loop verify +
    # graph solve; a fresh instance would recompile the dense step)
    slam.run(clouds[:18], init_pose=jnp.asarray(gt[0], jnp.float32))
    slam.metrics = MetricsLog()

    t0 = time.perf_counter()
    poses, state, kf_scan = run_tracked(slam)
    # final batch refinement: keyframes appended after the last accepted
    # loop have never been optimized (loosely-coupled mode)
    from tpu_slam.graph.pose_graph import GraphSolveParams, optimize_pose_graph
    graph, _ = optimize_pose_graph(state.graph, GraphSolveParams(
        gn_iterations=40, cg_iterations=800, robust_delta=0.15,
        robust_kernel="cauchy", trust_loops=True))
    jax.block_until_ready(graph.poses)
    dt = time.perf_counter() - t0
    odom_ate = ate_rmse(poses, gt, align=False)
    n = state.n_keyframes
    kf_poses = np.asarray(graph.poses[:n])
    kf_ate = ate_rmse(kf_poses, gt[kf_scan[:n]], align=False)
    _log(f"config4 slam: {n_poses/dt:.1f} scans/s, "
         f"optimized-kf ate={kf_ate:.3f} m ({n} kf), "
         f"odometry ate={odom_ate:.3f} m, "
         f"{state.n_loop_closures} loops, {n_poses} scans")
    return {"scans_per_sec": round(n_poses / dt, 2),
            "ate_m": round(float(kf_ate), 4),
            "odometry_ate_m": round(float(odom_ate), 4),
            "n_scans": n_poses,
            "n_loop_closures": int(state.n_loop_closures),
            "n_keyframes": int(n)}


# ---------------------------------------------------------------------------
# Config 5: multi-device sharded NDT scaling
# ---------------------------------------------------------------------------

def bench_multichip(reps=5):
    import jax

    if len(jax.devices()) < 2:
        _log("config5: not measured (1 device visible)")
        return {"registrations_per_sec_by_devices": "not measured"}

    import jax.numpy as jnp
    from tpu_slam.core import se3
    from tpu_slam.distributed.map_shard import (empty_sharded_map,
                                                insert_cloud_sharded,
                                                ndt_register_sharded)
    from tpu_slam.distributed.mesh import make_mesh
    from tpu_slam.kernels.voxel_hash import VoxelGridSpec
    from tpu_slam.registration.ndt import NDTParams

    # Small shapes: 64-cell grid, 8k-voxel shards, 8k-ray scans.
    clouds, gt = _outdoor_scans(2, n_azimuth=256, radius=5.0, seed=7,
                                max_range=20.0)
    spec = VoxelGridSpec.centered(leaf=0.5, half_extent=8.0)
    xi = jnp.array([0.15, -0.1, 0.05, 0.02, -0.02, 0.04], jnp.float32)
    T0 = jnp.asarray(gt[0], jnp.float32)
    src = clouds[0].transform(se3.compose(T0, se3.inverse(se3.exp(xi))))
    params = NDTParams(max_iterations=10, pack_budget_mb=512)

    curve = {}
    n_dev = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8) if n <= n_dev]
    for n in sizes:
        mesh = make_mesh(n)
        smap = empty_sharded_map(n, 4096)
        for c, T in zip(clouds, gt):
            smap = insert_cloud_sharded(
                mesh, smap, c.transform(jnp.asarray(T, jnp.float32)), spec,
                0.0)

        def run():
            return ndt_register_sharded(mesh, src, smap, spec, params=params,
                                        center=T0[:3, 3])

        jax.block_until_ready(run().T)
        t0 = time.perf_counter()
        for _ in range(reps):
            res = run()
        jax.block_until_ready(res.T)
        curve[str(n)] = round(reps / (time.perf_counter() - t0), 2)
        _log(f"config5: {n} devices -> {curve[str(n)]} regs/s")
    _log(f"config5 sharded ndt regs/s by device count: {curve}")
    return {"registrations_per_sec_by_devices": curve}


# ---------------------------------------------------------------------------
# Config 6: offline replay — VLP-16 packets -> pcap -> rosbag -> CLI
# ---------------------------------------------------------------------------

# run_odometry arguments of the city dense-engine deployment (config-2's
# engine settings): 65,536-ray scans, 192x192x32 window at 0.5 m, x4 pyramid
CITY_DENSE_CLI = [
    "--engine", "dense",
    "--input-capacity", "65536",
    "--set", "scan_capacity=32768",
    "--set", "downsample_leaf=0.3",
    "--set", "map_leaf=0.5",
    "--set", "map_half_extent=128.0",
    "--set", "map_capacity=262144",
    "--set", "scan_max_range=45.0",
    "--set", "insert_downsampled=true",
    "--set", "ndt.max_iterations=10",
    "--set", "ndt.coarse_iterations=2",
    "--set", "ndt.tolerance=3e-4",
    "--set", "ndt.min_voxel_count=3.0",
    "--set", "ndt.window_dims=192,192,32",
    "--set", "pyramid_factor=4",
    "--set", "max_pred_translation=2.0"]


def bench_bag_replay(n_scans=25):  # one extra: the packet stream loses a partial rev at the end
    """The reference's replay workflow wall-to-wall, ROS-free, at the
    CITY workload (the same dense_city + arc-corner route and 65,536
    rays/scan as config 2 — r4 verdict next #7 scaled this up from a
    6-scan office toy): synthesize VLP-16 packets, write a pcap,
    assemble revolutions, write a rosbag (PointCloud2 + TF ground
    truth), then ONE command — the run_odometry CLI with --bag and the
    production dense engine — produces a trajectory, its ATE, and the
    measured wall-clock replay rate."""
    import contextlib
    import io
    import json as _json
    import math
    import tempfile

    import jax.numpy as jnp
    from tpu_slam.core import se3
    from tpu_slam.ingest import rosbag as rb
    from tpu_slam.ingest import synthetic as syn
    from tpu_slam.ingest import velodyne as vlp

    world = syn.dense_city(extent=200.0, seed=0)
    route = _city_route(n_scans)           # the config-2 arc route
    el = np.radians(vlp.VLP16_ELEVATIONS_DEG)          # (16,)
    n_az = 4096                                        # 65,536 rays/scan
    az = np.arange(n_az) * (360.0 / n_az)              # deg, one revolution
    az_r = np.radians(az)[:, None]
    dirs = np.stack([np.cos(el)[None, :] * np.cos(az_r),
                     np.cos(el)[None, :] * np.sin(az_r),
                     np.broadcast_to(np.sin(el)[None, :], (n_az, 16))],
                    axis=2)                            # (S, 16, 3)
    rng = np.random.default_rng(0)
    tmp = tempfile.mkdtemp(prefix="slam_bag_bench_")
    all_pkts, pkt_times, gts = [], [], []
    for k in range(n_scans):
        T = route[k]
        dirs_w = dirs.reshape(-1, 3) @ T[:3, :3].T
        origins = np.broadcast_to(T[:3, 3], dirs_w.shape)
        r = world.raycast(origins, dirs_w, 75.0).reshape(n_az, 16)
        r = np.where(np.isfinite(r), r + rng.normal(0, 0.01, r.shape), 0.0)
        pkts = vlp.encode_packets(az, r, start_time_s=100.0 + k)
        all_pkts.append(pkts)
        pkt_times.append(100.0 + k
                         + np.arange(pkts.shape[0]) * 1e-3)
        gts.append(T)
    pkts = np.concatenate(all_pkts)
    pcap_path = f"{tmp}/seq.pcap"
    vlp.write_pcap(pcap_path, pkts, timestamps_s=np.concatenate(pkt_times))

    # pcap -> revolutions -> bag with TF ground truth
    stream = vlp.VelodyneStream(min_range=0.4, max_range=40.0)
    revs = []
    for _ts, payload in vlp.read_pcap(pcap_path):
        stream.push(np.frombuffer(payload, np.uint8)[None])
        while (rev := stream.pop()) is not None:
            revs.append(rev)
    if (rev := stream.flush()) is not None:
        revs.append(rev)
    revs = revs[:len(gts)]
    bag_path = f"{tmp}/seq.bag"
    with rb.BagWriter(bag_path) as w:
        for k, (rev, T) in enumerate(zip(revs, gts)):
            t = 100.0 + k
            q = np.asarray(se3.quat_from_matrix(
                jnp.asarray(T[:3, :3], jnp.float32)))
            tf = rb.TransformStamped(
                stamp=t - 0.01, frame_id="odom", child_frame_id="velodyne",
                translation=T[:3, 3].copy(), rotation=q.astype(np.float64))
            w.write("/tf", "tf2_msgs/TFMessage",
                    rb.serialize_tf_message([tf]), t - 0.01)
            w.write("/velodyne_points", "sensor_msgs/PointCloud2",
                    rb.serialize_pointcloud2(rev.points, t, "velodyne"), t)

    # ONE command: the CLI replays the bag on the production dense
    # engine (config-2's settings) and reports ATE; wall-clock includes
    # the whole ingest stack (bag -> dataset conversion + replay)
    from tpu_slam.cli.run_odometry import main as run_odo
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        run_odo(["--bag", bag_path, "--bag-gt-frame", "odom", "--json"]
                + CITY_DENSE_CLI)
    wall = time.perf_counter() - t0
    rec = _json.loads(buf.getvalue().strip().splitlines()[-1])
    _log(f"config6 bag replay (city workload): {len(revs)} revolutions "
         f"from pcap, ate={rec.get('ate_rmse_m', float('nan')):.3f} m, "
         f"{rec['n_scans']} scans in {wall:.1f} s "
         f"({rec['n_scans'] / wall:.2f} scans/s wall incl. bag convert + "
         f"compile) via run_odometry --bag --engine dense")
    return {"n_scans": rec["n_scans"],
            "ate_m": round(float(rec.get("ate_rmse_m", -1.0)), 4),
            "rpe_trans_m": round(float(rec.get("rpe_trans_m", -1.0)), 4),
            "wall_s": round(wall, 1),
            "scans_per_sec_wall": round(rec["n_scans"] / wall, 2),
            "raw_rays_per_scan": 65536,
            "source": "vlp16 packets -> pcap -> rosbag -> run_odometry"}


# ---------------------------------------------------------------------------

def device_record():
    """{"platform", "kind", "count"} of the devices JAX sees."""
    import jax
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--configs", default="1,2,3,4,5,6",
                   help="comma-separated subset to run (headline = 3)")
    args = p.parse_args()
    want = set(args.configs.split(","))

    from tpu_slam.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    _log(f"devices: {jax.devices()}")
    device = device_record()
    if device["platform"] != "gpu":
        sys.exit(f"bench.py: no GPU found (JAX platform "
                 f"{device['platform']!r}); device times come from a card")

    results = {}
    if "1" in want:
        results["1_icp_pair"] = bench_icp_pair()
    if "2" in want:
        results["2_odometry"] = bench_odometry()
    if "3" in want:
        results["3_ndt_register"] = bench_ndt_register()
    if "4" in want:
        results["4_full_slam"] = bench_full_slam()
    if "5" in want:
        results["5_multichip"] = bench_multichip()
    if "6" in want:
        results["6_bag_replay"] = bench_bag_replay()

    headline = results.get("3_ndt_register", {}).get(
        "registrations_per_sec", 0.0)
    c3 = results.get("3_ndt_register", {})
    unit = (f"regs/s (1 device, {c3.get('scan_points', 0)}-pt scan, "
            f"{c3.get('map_voxels', 0)}-voxel 0.5 m city map)")
    print(json.dumps({
        "metric": "ndt_scan_to_map_registrations_per_sec",
        "value": headline,
        "unit": unit,
        "vs_baseline": round(headline / BASELINE_SCANS_PER_SEC, 3),
        "device": device,
        "configs": results,
    }))


if __name__ == "__main__":
    main()
