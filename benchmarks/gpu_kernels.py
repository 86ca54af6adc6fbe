"""Kernel and end-to-end timings on one GPU, for the bring-up findings.

    python benchmarks/gpu_kernels.py [--out gpu_kernels.json]

  * NDT terms pass alone at the config-3 widths (fine 160x160x32, coarse
    64x64x16, Q=4, ~18.6k-point scan): the XLA pass vs the Triton kernel
    at several block sizes (device-side slopes, tpu_slam.utils.devtime);
  * end to end with each terms implementation, in the order xla, triton,
    triton, xla: config-3 two-level registration (slope) and config-2
    dense odometry over 24 city scans (scans/s, per-scan synced);
  * pair ICP brute force vs the frozen-bin tier at 8k and 32k points
    (bench.bench_icp_pair) — the icp_auto crossover;
  * brute-force NN alone at 8k x 8k and 32k x 32k;
  * a profiler trace of config-3 registrations reduced to the device's busy
    share and its top kernels.

Every number is printed beside the card's name and power limit. Exits
non-zero without a GPU.
"""

import argparse
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import bench  # noqa: E402


def _card():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def terms_alone(w, results):
    import jax
    import jax.numpy as jnp
    from tpu_slam.kernels.ndt_terms import bin_points, ndt_terms
    from tpu_slam.kernels.ndt_terms_triton import ndt_terms_triton
    from tpu_slam.utils.devtime import slope_time

    scan = w["scan"].sanitize()
    Tw = w["Tw"]
    for level, field, spec, corr in (("fine", w["field"], w["map_spec"], 1.0),
                                     ("coarse", w["cfield"], w["cspec"],
                                      4.0)):
        dims = field.window_dims
        cells, keep = bin_points(scan.points, scan.mask, Tw, spec.origin,
                                 spec.leaf, dims, 4, field.origin_cell)
        variants = [("xla", ndt_terms)]
        for block, warps in ((64, 2), (128, 4), (256, 4), (256, 8)):
            variants.append((f"triton_b{block}_w{warps}", functools.partial(
                ndt_terms_triton, block=block, num_warps=warps)))
        for name, fn in variants:
            @jax.jit
            def loop(K, fn=fn):
                def body(i, carry):
                    acc, t = carry
                    Ti = Tw.at[0, 3].add(1e-6 * i.astype(jnp.float32)
                                         + t * 1e-12)
                    H, b, c, m = fn(scan.points, cells, keep, field.rows, Ti,
                                    jnp.float32(4.0), corr, dims)
                    return (acc + c + H[0, 0] * 1e-9, t + c * 1e-12)
                acc, t = jax.lax.fori_loop(0, K, body, (jnp.float32(0),
                                                        jnp.float32(0)))
                return acc + t
            ms = slope_time(loop, 10, 110) * 1e3
            results[f"terms_{level}_{name}_ms"] = ms
            print(f"terms pass {level} {dims} {name}: {ms:.4f} ms "
                  f"({int(keep.sum())} kept of {scan.points.shape[0]} slots)",
                  flush=True)


def end_to_end(w, results):
    import jax
    import jax.numpy as jnp
    from tpu_slam.pipeline.config import OdometryConfig
    from tpu_slam.pipeline.metrics import MetricsLog, ate_rmse
    from tpu_slam.pipeline.odometry_dense import DenseLidarOdometry
    from tpu_slam.registration.ndt import NDTParams
    from tpu_slam.utils.devtime import slope_time

    scan, cscan, Tw = w["scan"], w["cscan"], w["Tw"]
    _, clouds, gt = bench._city_scans(24)
    for rep, impl in enumerate(("xla", "triton", "triton", "xla")):
        @jax.jit
        def reg_loop(K, impl=impl):
            def body(i, carry):
                Tc, acc = carry
                f = i.astype(jnp.float32)
                Ti = (Tc.at[0, 3].add(jnp.sin(f) * 0.15)
                      .at[1, 3].add(jnp.cos(f) * 0.1))
                r = w["register"](scan, cscan, Ti, impl=impl)
                return (r.T, acc + r.score)
            Tf, acc = jax.lax.fori_loop(0, K, body, (Tw, jnp.float32(0)))
            return Tf[0, 3] + acc
        ms = slope_time(reg_loop, 3, 23) * 1e3
        results[f"register_{impl}_ms_run{rep}"] = ms
        print(f"config-3 register [{impl}] run {rep}: {ms:.3f} ms",
              flush=True)

        cfg = OdometryConfig(
            scan_capacity=32768, downsample_leaf=0.3,
            map_leaf=0.5, map_half_extent=128.0, map_capacity=262144,
            scan_max_range=45.0, insert_downsampled=True,
            ndt=NDTParams(max_iterations=10, coarse_iterations=2,
                          tolerance=3e-4, min_voxel_count=3.0,
                          window_dims=(192, 192, 32), terms_impl=impl),
            pyramid_factor=4, max_pred_translation=2.0)
        odo = DenseLidarOdometry(cfg)
        odo.run(clouds[:3], init_pose=jnp.asarray(gt[0], jnp.float32))
        odo.metrics = MetricsLog()
        t0 = time.perf_counter()
        poses, _ = odo.run(clouds, init_pose=jnp.asarray(gt[0], jnp.float32))
        rate = len(clouds) / (time.perf_counter() - t0)
        ate = ate_rmse(poses, gt, align=False)
        t0 = time.perf_counter()
        odo.run(clouds, init_pose=jnp.asarray(gt[0], jnp.float32),
                sync_every=0)
        arate = len(clouds) / (time.perf_counter() - t0)
        results[f"odometry_{impl}_scans_per_s_run{rep}"] = rate
        results[f"odometry_{impl}_async_scans_per_s_run{rep}"] = arate
        results[f"odometry_{impl}_ate_m_run{rep}"] = ate
        print(f"config-2 odometry [{impl}] run {rep}: {rate:.3f} scans/s "
              f"synced, {arate:.3f} scans/s async, ATE {ate:.4f} m",
              flush=True)


def icp_and_nn(results):
    import jax
    import jax.numpy as jnp
    from tpu_slam.kernels.nn_search import nearest_neighbors
    from tpu_slam.utils.devtime import slope_time

    r = bench.bench_icp_pair()
    results["icp"] = r
    print(f"pair ICP: {json.dumps(r)}", flush=True)
    rng = np.random.default_rng(0)
    for n in (8192, 32768):
        q = jnp.asarray(rng.uniform(-20, 20, (n, 3)), jnp.float32)
        t = jnp.asarray(rng.uniform(-20, 20, (n, 3)), jnp.float32)

        @jax.jit
        def loop(K, q=q, t=t):
            def body(i, acc):
                idx, d = nearest_neighbors(q + acc * 1e-12, t)
                return acc + d[0] + idx[1].astype(jnp.float32)
            return jax.lax.fori_loop(0, K, body, jnp.float32(0))
        ms = slope_time(loop, 2, 12) * 1e3
        results[f"nn_brute_{n}_ms"] = ms
        print(f"nearest_neighbors brute {n}x{n}: {ms:.3f} ms", flush=True)


def trace(w, results):
    """Device busy share and top kernels over config-3 registrations."""
    import tempfile

    import jax
    import jax.numpy as jnp

    scan, cscan, Tw = w["scan"], w["cscan"], w["Tw"]
    reg = jax.jit(lambda dx: w["register"](scan, cscan,
                                           Tw.at[0, 3].add(dx)).T)
    jax.block_until_ready(reg(jnp.float32(0.0)))      # compile outside
    path = tempfile.mkdtemp(prefix="trace_config3_")
    t0 = time.perf_counter()
    with jax.profiler.trace(path):
        for k in range(5):
            T = reg(jnp.float32(0.01 * (k + 1)))
        jax.block_until_ready(T)
    wall = time.perf_counter() - t0
    files = []
    for root, _, names in os.walk(path):
        files += [os.path.join(root, n) for n in names
                  if n.endswith(".xplane.pb")]
    if not files:
        print("trace: no xplane file", flush=True)
        return
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(files[0])
    ivals, per_name = [], {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                ivals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                per_name[ev.name] = per_name.get(ev.name, 0) + ev.duration_ns
    if not ivals:
        print("trace: no GPU events", flush=True)
        return
    ivals.sort()
    busy, cur_s, cur_e = 0, *ivals[0]
    for s, e in ivals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = ivals[-1][1] - ivals[0][0]
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:12]
    results["trace_config3"] = {
        "device_busy_ns": busy, "device_span_ns": span,
        "idle_share_of_span": 1 - busy / span, "host_wall_s": wall,
        "n_events": len(ivals), "top_kernels_ns": top}
    print(f"trace config-3 x5: device busy {busy / 1e6:.2f} ms of "
          f"{span / 1e6:.2f} ms span (idle {100 * (1 - busy / span):.1f}%), "
          f"{len(ivals)} device events", flush=True)
    for name, ns in top:
        print(f"  {ns / 1e6:9.3f} ms  {name[:110]}", flush=True)


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="gpu_kernels.json")
    p.add_argument("--skip", default="", help="comma list of parts to skip: "
                   "terms,e2e,icp,trace")
    args = p.parse_args()
    skip = set(args.skip.split(","))

    from tpu_slam.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    import jax
    d = jax.devices()
    if d[0].platform != "gpu":
        sys.exit(f"gpu_kernels: no GPU found (JAX platform {d[0].platform!r})")
    card = _card()
    print(f"card: {card}; devices: {d}", flush=True)
    results = {"card": card, "device_kind": d[0].device_kind}
    out_dir = os.path.dirname(args.out) or "."
    os.makedirs(out_dir, exist_ok=True)
    with jax.default_matmul_precision("highest"):
        w = bench.config3_workload()
        for part, fn in (("terms", lambda: terms_alone(w, results)),
                         ("trace", lambda: trace(w, results)),
                         ("e2e", lambda: end_to_end(w, results)),
                         ("icp", lambda: icp_and_nn(results))):
            if part in skip:
                continue
            try:
                fn()
            finally:
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1, default=str)
    print(json.dumps(results, default=str))


if __name__ == "__main__":
    main()
