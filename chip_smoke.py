"""Bring-up check of the SLAM engine's main path on NVIDIA GPUs.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the sharded dense step only

One card, one process, in order:

  parity    the frozen-bin NDT terms pass (fine 160x160x32 and coarse
            64x64x16 city windows, Q=4, ~18.6k-point scan), the frozen-bin
            pair-ICP pass and brute-force NN at 8192 points, each compiled
            for the card and compared at precision "highest" with a float64
            numpy reference;
  tests     the tests marked ``gpu`` (tests/test_gpu.py), in this process;
  odometry  24 city VLP-16 scans (65,536 rays each) written as a dataset and
            replayed through ``run_odometry --engine dense``; ATE <= 0.15 m;
  register  the two-level scan-to-map registration against the >= 100k
            voxel city map; error <= 5 mm;
  slam      SLAMSystem on the dense engine over two corridor laps; at least
            one accepted loop closure and optimized keyframe ATE below the
            odometry ATE.

``--four`` runs ``dense_step_sharded`` on a 4-card mesh against the
single-card dense engine step, pose parity 1e-4, and nothing else.

Any failure exits non-zero with no result line. On success the last line
of stdout is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))


def _check(ok, msg):
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {msg}")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def device_check(count):
    """Fail unless JAX sees >= ``count`` GPUs; print them and the cards."""
    import jax

    devs = jax.devices()
    print(f"devices: {devs}", flush=True)
    _check(devs[0].platform == "gpu",
           f"no GPU found (JAX platform {devs[0].platform!r})")
    _check(len(devs) >= count, f"need {count} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    cards = smi.stdout.strip()
    print(cards, flush=True)
    return devs, cards.splitlines()[0]


def phase_parity(w, card):
    """Kernel parity at real widths against the float64 references."""
    import jax.numpy as jnp
    from tpu_slam.core import se3
    from tpu_slam.core.pointcloud import PointCloud
    from tpu_slam.ingest import synthetic as syn
    from tpu_slam.kernels.icp_terms import (icp_terms, icp_terms_reference,
                                            target_table)
    from tpu_slam.kernels.ndt_terms import (bin_points, bin_points_reference,
                                            ndt_terms_reference, terms_pass)
    from tpu_slam.kernels.nn_search import nearest_neighbors

    fails = []

    def report(name, err, limit):
        print(f"parity {name}: {err:.3e} (limit {limit:.0e})", flush=True)
        if not err <= limit:
            fails.append(name)

    scan = w["scan"].sanitize()
    Tw = w["Tw"]
    T = se3.compose(Tw, se3.exp(jnp.asarray(
        [0.05, -0.04, 0.02, 0.004, -0.003, 0.008], jnp.float32)))
    for level, field, spec, gamma, corr in (
            ("fine", w["field"], w["map_spec"], 4.0, 1.0),
            ("coarse", w["cfield"], w["cspec"], 64.0, 4.0)):
        dims = field.window_dims
        oc = field.origin_cell
        cells, keep = bin_points(scan.points, scan.mask, Tw, spec.origin,
                                 spec.leaf, dims, 4, oc)
        c_ref, k_ref = bin_points_reference(
            scan.points, scan.mask, Tw, spec.origin, spec.leaf, dims, 4,
            np.asarray(oc))
        # float32 vs float64 binning may differ only for points within
        # float32 reach of a cell face (and the ranks of their cells)
        pw = (np.asarray(scan.points, np.float64) @ np.asarray(Tw)[:3, :3].T
              + np.asarray(Tw)[:3, 3])
        rel = (pw - np.asarray(spec.origin)) / spec.leaf
        face = np.any(np.abs(rel - np.round(rel)) < 1e-4, axis=1)
        cmis = np.any(np.asarray(cells) != c_ref, axis=1)
        kmis = np.asarray(keep) != k_ref
        report(f"bin_points {level}: cell mismatches off cell faces",
               float(np.sum(cmis & ~face)), 0)
        report(f"bin_points {level}: keep mismatches beyond face points",
               float(max(0, np.sum(kmis) - 4 * np.sum(face))), 0)
        ref = ndt_terms_reference(scan.points, cells, keep, field.rows, T,
                                  gamma, corr, dims)
        for impl in ("xla", "triton"):
            H, b, c, m = terms_pass(impl)(scan.points, cells, keep,
                                          field.rows, T, jnp.float32(gamma),
                                          corr, dims)
            tag = f"ndt_terms[{impl}] {level} {dims}"
            report(f"{tag} H rel", _rel(H, ref[0]), 1e-4)
            report(f"{tag} b rel", _rel(b, ref[1]), 1e-4)
            report(f"{tag} cost rel", _rel(c, ref[2]), 1e-5)
            report(f"{tag} matched |diff| ({int(m)} points)",
                   abs(float(m) - ref[3]), 0)

    # pair ICP and NN at 8192 points (the office revolution of config 1)
    world = syn.default_office()
    T0 = np.eye(4)
    T0[:3, 3] = [0, 0, 1.5]
    pts, valid = syn.simulate_vlp16_revolution(world, T0, n_azimuth=512)
    tgt = PointCloud.from_points_host(pts[valid], capacity=8192)
    xi = jnp.asarray([0.15, -0.1, 0.05, 0.02, -0.02, 0.04], jnp.float32)
    src = tgt.transform(se3.inverse(se3.exp(xi))).sanitize()
    tgt = tgt.sanitize()
    dims, leaf = (32, 32, 16), 0.5
    origin = jnp.asarray([-8.0, -8.0, -4.0], jnp.float32)
    eye = jnp.eye(4, dtype=jnp.float32)
    table = target_table(tgt.points, tgt.mask, origin, leaf, dims, 8)
    t_cells, t_keep = bin_points(tgt.points, tgt.mask, eye, origin, leaf,
                                 dims, 8)
    cells, keep = bin_points(src.points, src.mask, eye, origin, leaf, dims, 8)
    Ti = se3.exp(0.9 * xi)
    got = icp_terms(src.points, cells, keep, table, Ti, 1.5, 0.5, dims)
    ref = icp_terms_reference(src.points, cells, keep, tgt.points, t_cells,
                              t_keep, Ti, 1.5, 0.5)
    for name, g, r, lim in zip(("H rel", "b rel", "err rel"), got, ref,
                               (1e-4, 1e-4, 1e-5)):
        report(f"icp_terms {dims} {name}", _rel(g, r), lim)
    report(f"icp_terms matched |diff| ({int(got[3])} points)",
           abs(float(got[3]) - ref[3]), 0)

    q = np.asarray(src.points)[np.asarray(src.mask)]
    t = np.asarray(tgt.points)[np.asarray(tgt.mask)]
    idx, dist = nearest_neighbors(jnp.asarray(q), jnp.asarray(t))
    idx, dist = np.asarray(idx), np.asarray(dist)
    q64, t64 = q.astype(np.float64), t.astype(np.float64)
    dmin = np.concatenate([
        np.sqrt(((q64[s:s + 512, None] - t64[None]) ** 2).sum(-1)).min(1)
        for s in range(0, len(q64), 512)])
    d_pick = np.linalg.norm(q64 - t64[idx], axis=1)
    report(f"nearest_neighbors {len(q)}x{len(t)} max |dist - min|",
           float(np.abs(dist - dmin).max()), 1e-5)
    report("nearest_neighbors chosen target max excess distance",
           float((d_pick - dmin).max()), 1e-5)
    _check(not fails, f"parity: {fails}")


def phase_tests():
    import jax
    import pytest

    # the test configuration forces the CPU unless JAX_PLATFORMS names
    # another platform; this process already runs on the card
    os.environ["JAX_PLATFORMS"] = jax.devices()[0].platform
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                      os.path.join(REPO, "tests", "test_gpu.py")])
    _check(rc == 0, f"gpu-marked tests exited {rc}")


def phase_odometry(card):
    import bench
    from tpu_slam.cli import run_odometry
    from tpu_slam.ingest.dataset import DatasetWriter, ScanRecord

    _, clouds, gt = bench._city_scans(24)
    with tempfile.TemporaryDirectory() as d:
        writer = DatasetWriter(d)
        for k, (c, T) in enumerate(zip(clouds, gt)):
            m = np.asarray(c.mask)
            writer.append(ScanRecord(
                points=np.asarray(c.points)[m], mask=np.ones(m.sum(), bool),
                intensity=None, stamp=0.1 * k, gt_pose=T))
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            run_odometry.main(["--dataset", d, "--json"]
                              + bench.CITY_DENSE_CLI)
        wall = time.perf_counter() - t0
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    ate = rec["ate_rmse_m"]
    print(f"odometry (config 2): {rec['n_scans']} scans, "
          f"{1.0 / rec['p50_wall_time_s']:.2f} scans/s (1 / median scan "
          f"time), {len(clouds) / wall:.2f} scans/s over the whole CLI run "
          f"incl. compile, ATE {ate:.4f} m (limit 0.15 m) on {card}",
          flush=True)
    _check(ate <= 0.15, f"odometry ATE {ate:.4f} m > 0.15 m")


def phase_register(w, card):
    import jax
    import jax.numpy as jnp
    from tpu_slam.core import se3

    xi = jnp.asarray([0.2, -0.15, 0.08, 0.025, -0.015, 0.04], jnp.float32)
    src = w["scan"].transform(se3.inverse(se3.exp(xi)))
    csrc = w["cscan"].transform(se3.inverse(se3.exp(xi)))
    T_true = se3.compose(w["Tw"], se3.exp(xi))
    res = w["register"](src, csrc, w["Tw"])
    err_mm = float(jnp.linalg.norm(se3.log(
        se3.compose(se3.inverse(T_true), res.T))[:3])) * 1e3
    n = 10
    t0 = time.perf_counter()
    for k in range(n):
        r = w["register"](src, csrc, w["Tw"].at[0, 3].add(0.01 * k))
    jax.block_until_ready(r.T)
    dt = (time.perf_counter() - t0) / n
    print(f"register (config 3): map {w['n_vox']} voxels, scan "
          f"{w['n_scan']} points, error {err_mm:.2f} mm (limit 5 mm), "
          f"matched {float(res.matched_fraction):.3f}, "
          f"{dt * 1e3:.2f} ms per registration (host clock, incl. "
          f"dispatch) on {card}", flush=True)
    _check(err_mm <= 5.0, f"register error {err_mm:.2f} mm > 5 mm")


def phase_slam(card):
    import jax
    import jax.numpy as jnp
    import bench
    from tpu_slam.graph.pose_graph import (GraphSolveParams,
                                           optimize_pose_graph)
    from tpu_slam.pipeline.metrics import ate_rmse
    from tpu_slam.pipeline.slam import SLAMSystem

    _, clouds, gt = bench._config4_workload()
    slam = SLAMSystem(bench._config4_cfg())
    state = slam.init_state(jnp.asarray(gt[0], jnp.float32))
    poses, kf_scan = [], []
    t0 = time.perf_counter()
    for k, c in enumerate(clouds):
        state, _ = slam.step(state, c)
        poses.append(np.asarray(state.odom.pose))
        if len(kf_scan) < state.n_keyframes:
            kf_scan.append(k)
    graph, _ = optimize_pose_graph(state.graph, GraphSolveParams(
        gn_iterations=40, cg_iterations=800, robust_delta=0.15,
        robust_kernel="cauchy", trust_loops=True))
    jax.block_until_ready(graph.poses)
    dt = time.perf_counter() - t0
    odom_ate = ate_rmse(np.stack(poses), gt, align=False)
    n = state.n_keyframes
    kf_ate = ate_rmse(np.asarray(graph.poses[:n]), gt[np.asarray(kf_scan)],
                      align=False)
    loops = int(state.n_loop_closures)
    print(f"slam (config 4): {len(clouds)} scans in {dt:.1f} s incl. "
          f"compile ({len(clouds) / dt:.2f} scans/s), {loops} loop "
          f"closures, {n} keyframes, optimized keyframe ATE {kf_ate:.4f} m "
          f"vs odometry ATE {odom_ate:.4f} m on {card}", flush=True)
    _check(loops >= 1, "no loop closure accepted")
    _check(kf_ate < odom_ate,
           f"keyframe ATE {kf_ate:.4f} m not below odometry {odom_ate:.4f} m")


def phase_four(card):
    """dense_step_sharded on a 4-card mesh vs the single-card engine."""
    import jax.numpy as jnp
    from tpu_slam.core.pointcloud import PointCloud
    from tpu_slam.distributed.dense_shard import dense_step_sharded
    from tpu_slam.distributed.mesh import make_mesh
    from tpu_slam.ingest import synthetic as syn
    from tpu_slam.kernels.downsample import voxel_downsample
    from tpu_slam.pipeline.config import OdometryConfig
    from tpu_slam.pipeline.odometry_dense import DenseLidarOdometry
    from tpu_slam.registration.ndt import NDTParams

    world = syn.default_office()
    rng = np.random.default_rng(0)
    n_steps = 4
    clouds, gt = [], []
    for k in range(n_steps + 1):
        T = syn.se2_pose(0.3 * k - 0.4, 0.05 * k, 0.06 * k, z=1.2)
        pts, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=1024, noise_std=0.005, rng=rng)
        clouds.append(PointCloud.from_points_host(pts[valid],
                                                  capacity=16384))
        gt.append(np.asarray(T, np.float32))
    dims = (64, 64, 16)
    # full iteration budget on both sides (tests/test_distributed.py:
    # the convergence test at |xi| ~ tol flips on summation order)
    params = NDTParams(max_iterations=6, coarse_iterations=0,
                       min_voxel_count=3.0, window_dims=dims,
                       rebin_iters=3, tolerance=1e-6)
    cfg = OdometryConfig(scan_capacity=8192, downsample_leaf=0.25,
                         map_leaf=0.4, map_half_extent=16.0,
                         insert_downsampled=True, deskew=False,
                         scan_max_range=0.0, min_insert_fraction=0.3,
                         ndt=params, pyramid_factor=1, rebase_fraction=10.0)
    od = DenseLidarOdometry(cfg)
    state = od.init_state(clouds[0], jnp.asarray(gt[0]))
    mesh = make_mesh(4)
    spec = cfg.map_spec()
    rows = jnp.array(state.grid.rows, copy=True)
    oc = jnp.array(state.grid.origin_cell, copy=True)
    pose, delta = jnp.asarray(gt[0]), jnp.eye(4, dtype=jnp.float32)
    worst = 0.0
    for k in range(1, n_steps + 1):
        scan = voxel_downsample(clouds[k], od.scan_spec,
                                capacity=cfg.scan_capacity)
        rows, pose, delta, _ = dense_step_sharded(
            mesh, rows, oc, pose, delta, scan, spec, dims, params=params)
        state = od.step(state, clouds[k])
        worst = max(worst, float(np.abs(np.asarray(pose)
                                        - np.asarray(state.pose)).max()))
    err = float(np.linalg.norm(np.asarray(pose)[:3, 3] - gt[-1][:3, 3]))
    print(f"four-card dense_step_sharded vs single-card step: {n_steps} "
          f"steps, max |pose diff| {worst:.3e} (limit 1e-04), final "
          f"position error {err:.4f} m on 4x {card}", flush=True)
    _check(worst <= 1e-4, f"sharded pose parity {worst:.3e} > 1e-4")


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--four", action="store_true",
                   help="run only the 4-card sharded dense step vs the "
                        "single-card step")
    args = p.parse_args()

    from tpu_slam.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax

    count = 4 if args.four else 1
    devs, card = device_check(count)
    t_start = time.perf_counter()
    with jax.default_matmul_precision("highest"):
        if args.four:
            phase_four(card)
        else:
            import bench
            w = bench.config3_workload()
            for name, fn in (("parity", lambda: phase_parity(w, card)),
                             ("tests", phase_tests),
                             ("odometry", lambda: phase_odometry(card)),
                             ("register", lambda: phase_register(w, card)),
                             ("slam", lambda: phase_slam(card))):
                t0 = time.perf_counter()
                fn()
                print(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s",
                      flush=True)
    print(f"chip_smoke: all phases ok in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
