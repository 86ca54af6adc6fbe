"""Full 6D SLAM: odometry + keyframes + loop closure + pose-graph backend.

The complete stand-in for the reference's gpu_6dslam_node
(SURVEY.md §1 L6 [inferred]): keyframe clouds and poses live in fixed-
capacity device arrays; loop closures are verified as one vmapped ICP batch
(graph.loop_closure); the pose graph is optimized with the matrix-free GN
(graph.pose_graph); after an accepted loop the map is rebuilt from the
optimized keyframe poses.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_slam.core import se3
from tpu_slam.core.pointcloud import PAD_COORD, PointCloud
from tpu_slam.graph.loop_closure import propose_candidates, verify_candidates
from tpu_slam.graph.pose_graph import (PoseGraph, add_edge, add_node,
                                       drop_node_prefix, empty_graph,
                                       n_edges, optimize_pose_graph)
from tpu_slam.kernels.downsample import voxel_downsample
from tpu_slam.mapping.voxel_map import empty_map, insert_cloud
from tpu_slam.pipeline.config import SLAMConfig
from tpu_slam.pipeline.metrics import MetricsLog, ScanMetrics, Stopwatch
from tpu_slam.pipeline.odometry import LidarOdometry, OdometryState


@dataclasses.dataclass
class SLAMState:
    """Host-side handle onto the full SLAM state."""

    odom: OdometryState
    graph: PoseGraph
    kf_points: jax.Array       # (K, P, 3) keyframe clouds (body frame)
    kf_mask: jax.Array         # (K, P)
    kf_intensity: jax.Array    # (K, P) per-point intensity (0 when absent)
    kf_normals: jax.Array      # (K, P, 3) per-point normals (plane verify)
    kf_desc: jax.Array         # (K, R, S) scan-context descriptors
    n_keyframes: int
    last_kf_pose: jax.Array    # (4, 4) pose of the newest keyframe
    last_kf_pose_np: object = None   # host mirror (avoids a device sync
                                     # per keyframe test)
    n_loop_closures: int = 0
    # poses of keyframes evicted by the fixed-lag sliding window, in
    # trajectory order (host list of (4, 4) arrays); full trajectory =
    # archived_poses + graph.poses[:n_keyframes]
    archived_poses: List[np.ndarray] = dataclasses.field(
        default_factory=list)
    n_evictions: int = 0
    # (i, j) pairs already admitted as loop edges: each detection sweep
    # re-proposes the nearest pairs, and without this set the SAME edge is
    # re-verified and re-added every sweep — duplicate weight on a few
    # constraints instead of coverage along the trajectory
    loop_pairs: set = dataclasses.field(default_factory=set)
    # (i, j) -> n_keyframes when last VERIFIED and rejected: rejected pairs
    # sit out retry_cooldown sweeps so the per-sweep candidate budget
    # explores fresh revisits instead of re-trying the same near-misses
    # (r4: 80 proposals collapsed onto ~20 distinct pairs)
    tried_pairs: dict = dataclasses.field(default_factory=dict)


@functools.partial(jax.jit, static_argnames=("plane_verify", "use_sc",
                                             "sc", "odom_edge_info"))
def _store_kf_device(kf_points, kf_mask, kf_intensity, kf_normals, kf_desc,
                     g_poses, g_ei, g_ej, g_eT, g_einfo, g_emask,
                     k, e, pts_in, msk_in, inten_in, pose, last_kf_pose,
                     *, plane_verify, use_sc, sc, odom_edge_info):
    """The whole keyframe store as one compiled dispatch (see caller)."""
    P = kf_points.shape[1]
    n_in = pts_in.shape[0]
    if inten_in is None:
        inten_in = jnp.zeros((n_in,), jnp.float32)
    if n_in >= P:
        pts, msk, inten = pts_in[:P], msk_in[:P], inten_in[:P]
    else:
        pts = jnp.concatenate([
            pts_in, jnp.full((P - n_in, 3), PAD_COORD, pts_in.dtype)])
        msk = jnp.concatenate([msk_in, jnp.zeros((P - n_in,), bool)])
        inten = jnp.concatenate([inten_in,
                                 jnp.zeros((P - n_in,), jnp.float32)])

    def upd(buf, val):
        return jax.lax.dynamic_update_index_in_dim(buf, val, k, 0)

    kf_points = upd(kf_points, pts)
    kf_mask = upd(kf_mask, msk)
    kf_intensity = upd(kf_intensity, inten)
    if plane_verify:
        from tpu_slam.registration.normals import estimate_normals
        kf_normals = upd(kf_normals, estimate_normals(pts, msk))
    if use_sc:
        from tpu_slam.graph.scan_context import scan_context
        kf_desc = upd(kf_desc, scan_context(
            PointCloud(points=pts, mask=msk, attrs=inten[:, None]), sc))

    pose_copy = pose + 0.0
    g_poses = upd(g_poses, pose_copy)
    # odometry edge (k-1, k) from consecutive RAW odometry poses (using
    # graph.poses[k-1] here mixed frames once a sweep had optimized it);
    # at k == 0 the write is masked out but still lands in slot e
    Z = se3.inverse(last_kf_pose) @ pose
    has_edge = k > 0
    g_ei = jax.lax.dynamic_update_index_in_dim(
        g_ei, jnp.where(has_edge, k - 1, g_ei[e]), e, 0)
    g_ej = jax.lax.dynamic_update_index_in_dim(
        g_ej, jnp.where(has_edge, k, g_ej[e]), e, 0)
    g_eT = jax.lax.dynamic_update_index_in_dim(
        g_eT, jnp.where(has_edge, Z, g_eT[e]), e, 0)
    g_einfo = jax.lax.dynamic_update_index_in_dim(
        g_einfo,
        jnp.where(has_edge, odom_edge_info * jnp.eye(6, dtype=jnp.float32),
                  g_einfo[e]), e, 0)
    g_emask = jax.lax.dynamic_update_index_in_dim(
        g_emask, jnp.where(has_edge, True, g_emask[e]), e, 0)
    return (kf_points, kf_mask, kf_intensity, kf_normals, kf_desc, g_poses,
            g_ei, g_ej, g_eT, g_einfo, g_emask, pose_copy)


@functools.partial(jax.jit, static_argnames=("spec", "capacity"))
def _rebuild_map_batched(poses, kf_points, kf_mask, n, *, spec, capacity):
    """Map rebuild from keyframes in one jitted dispatch (see _rebuild_map)."""
    K, P = kf_points.shape[:2]
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    world = jnp.einsum("kij,kpj->kpi", R, kf_points) + t[:, None, :]
    live = kf_mask & (jnp.arange(K, dtype=jnp.int32)[:, None] < n)
    flat = PointCloud(points=world.reshape(K * P, 3),
                      mask=live.reshape(K * P))
    return insert_cloud(empty_map(capacity), flat, spec,
                        stamp=n.astype(jnp.float32))


@functools.partial(jax.jit, static_argnames=("spec", "dims", "align"))
def _rebuild_grid_batched(poses, kf_points, kf_mask, n, center,
                          *, spec, dims, align):
    """Dense-window rebuild from keyframes at optimized poses (one dispatch).

    The dense-engine analog of _rebuild_map_batched: re-center the window
    on the corrected pose, then one flat grid_insert of every live
    keyframe point at its optimized pose.
    """
    from tpu_slam.mapping.dense_map import (centered_origin_cell, empty_grid,
                                            grid_insert)

    K, P = kf_points.shape[:2]
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    world = jnp.einsum("kij,kpj->kpi", R, kf_points) + t[:, None, :]
    live = kf_mask & (jnp.arange(K, dtype=jnp.int32)[:, None] < n)
    flat = PointCloud(points=world.reshape(K * P, 3),
                      mask=live.reshape(K * P))
    c0 = centered_origin_cell(center, spec, dims, align=align)
    return grid_insert(empty_grid(dims, c0), flat, spec)


class SLAMSystem:
    """The full pipeline. Feed aggregated 3D scans; read poses + map."""

    def __init__(self, config: SLAMConfig = SLAMConfig()):
        if config.odometry.scrolling_window:
            raise ValueError(
                "SLAMSystem needs a world-fixed map (keyframe clouds are "
                "re-integrated at optimized world poses after loop "
                "closures); the scrolling window is LidarOdometry's "
                "unbounded-world mode — SLAM bounds memory with the "
                "fixed-lag keyframe window instead")
        self.config = config
        if config.odometry_engine == "dense":
            from tpu_slam.pipeline.odometry_dense import DenseLidarOdometry
            self.odometry = DenseLidarOdometry(config.odometry)
        else:
            self.odometry = LidarOdometry(config.odometry)
        self.metrics = MetricsLog()
        # per-sweep loop-closure diagnostics: list of dicts with the
        # proposed pairs and each gate's outcome (filled when
        # ``collect_loop_debug`` is True — bench/diagnosis only)
        self.collect_loop_debug = False
        self.loop_debug: List[dict] = []

    @property
    def _dense(self) -> bool:
        return self.config.odometry_engine == "dense"

    # -- state ------------------------------------------------------------

    def init_state(self, init_pose: Optional[jax.Array] = None) -> SLAMState:
        cfg = self.config
        K, P = cfg.keyframe_capacity, cfg.keyframe_cloud_capacity
        sc = cfg.loop.sc
        if self._dense:
            # the dense engine bootstraps from the first scan — defer
            odom = None
            self._pending_init_pose = init_pose
        else:
            odom = self.odometry.init_state(init_pose)
        return SLAMState(
            odom=odom,
            graph=empty_graph(cfg.keyframe_capacity, cfg.edge_capacity),
            kf_points=jnp.full((K, P, 3), PAD_COORD, jnp.float32),
            kf_mask=jnp.zeros((K, P), bool),
            kf_intensity=jnp.zeros((K, P), jnp.float32),
            kf_normals=jnp.zeros((K, P, 3), jnp.float32),
            kf_desc=jnp.zeros((K, sc.n_rings, sc.n_sectors), jnp.float32),
            n_keyframes=0,
            last_kf_pose=jnp.eye(4, dtype=jnp.float32),
        )

    # -- keyframe policy --------------------------------------------------

    def _is_keyframe(self, state: SLAMState,
                     pose_np: Optional[np.ndarray] = None) -> bool:
        if state.n_keyframes == 0:
            return True
        if pose_np is not None and state.last_kf_pose_np is not None:
            # host-side test from the already-fetched pose: no extra sync
            d = np.linalg.inv(state.last_kf_pose_np) @ pose_np
            t = float(np.linalg.norm(d[:3, 3]))
            cosang = np.clip((np.trace(d[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
            r = float(np.arccos(cosang))
        else:
            xi = se3.log(se3.inverse(state.last_kf_pose) @ state.odom.pose)
            t = float(jnp.linalg.norm(xi[:3]))
            r = float(jnp.linalg.norm(xi[3:]))
        return (t >= self.config.keyframe_translation
                or r >= self.config.keyframe_rotation)

    def _slide_window(self, state: SLAMState) -> SLAMState:
        """Fixed-lag eviction: archive + drop the oldest keyframes.

        Runs when the keyframe or edge capacity fills (instead of the
        round-1 ``raise``). Evicted keyframe poses go to
        ``state.archived_poses`` so the full trajectory stays recoverable;
        the graph window is re-anchored at its (optimized) first surviving
        pose by the gauge prior.
        """
        cfg = self.config
        n = state.n_keyframes
        m = max(1, min(n - 2, int(round(cfg.keyframe_capacity
                                        * cfg.window_evict_fraction))))
        archived = state.archived_poses + [
            np.asarray(state.graph.poses[k]) for k in range(m)]
        graph = drop_node_prefix(state.graph, m)
        pad_pts = jnp.full((m,) + state.kf_points.shape[1:], PAD_COORD,
                           state.kf_points.dtype)
        pad_msk = jnp.zeros((m,) + state.kf_mask.shape[1:], bool)
        pad_int = jnp.zeros((m,) + state.kf_intensity.shape[1:], jnp.float32)
        pad_desc = jnp.zeros((m,) + state.kf_desc.shape[1:], jnp.float32)
        pad_nrm = jnp.zeros((m,) + state.kf_normals.shape[1:], jnp.float32)
        return dataclasses.replace(
            state, graph=graph,
            kf_points=jnp.concatenate([state.kf_points[m:], pad_pts]),
            kf_mask=jnp.concatenate([state.kf_mask[m:], pad_msk]),
            kf_intensity=jnp.concatenate([state.kf_intensity[m:], pad_int]),
            kf_desc=jnp.concatenate([state.kf_desc[m:], pad_desc]),
            kf_normals=jnp.concatenate([state.kf_normals[m:], pad_nrm]),
            n_keyframes=n - m, archived_poses=archived,
            loop_pairs={(i - m, j - m) for i, j in state.loop_pairs
                        if i >= m and j >= m},
            tried_pairs={(i - m, j - m): v - m
                         for (i, j), v in state.tried_pairs.items()
                         if i >= m and j >= m},
            n_evictions=state.n_evictions + m)

    def _store_keyframe(self, state: SLAMState, scan_ds: PointCloud
                        ) -> SLAMState:
        cfg = self.config
        if (state.n_keyframes >= cfg.keyframe_capacity
                or n_edges(state.graph) + 1 > cfg.edge_capacity):
            state = self._slide_window(state)
        k = state.n_keyframes
        e = n_edges(state.graph)
        # ONE device dispatch for the whole store (pad + normals + scan
        # context + dynamic-slice writes + odometry edge): each separate
        # eager op pays its own dispatch and host round-trip
        (kf_points, kf_mask, kf_intensity, kf_normals, kf_desc, g_poses,
         g_ei, g_ej, g_eT, g_einfo, g_emask, pose_copy) = _store_kf_device(
            state.kf_points, state.kf_mask, state.kf_intensity,
            state.kf_normals, state.kf_desc, state.graph.poses,
            state.graph.edge_i, state.graph.edge_j, state.graph.edge_T,
            state.graph.edge_info, state.graph.edge_mask,
            jnp.int32(k), jnp.int32(e), scan_ds.points, scan_ds.mask,
            (scan_ds.attrs[:, 0] if scan_ds.attrs is not None else None),
            state.odom.pose, state.last_kf_pose,
            plane_verify=cfg.loop.plane_verify,
            use_sc=cfg.loop.use_scan_context, sc=cfg.loop.sc,
            odom_edge_info=cfg.odom_edge_info)
        graph = dataclasses.replace(
            state.graph, poses=g_poses, n_nodes=jnp.int32(k + 1),
            edge_i=g_ei, edge_j=g_ej, edge_T=g_eT, edge_info=g_einfo,
            edge_mask=g_emask)
        return dataclasses.replace(state, graph=graph, kf_points=kf_points,
                                   kf_mask=kf_mask,
                                   kf_intensity=kf_intensity,
                                   kf_normals=kf_normals,
                                   kf_desc=kf_desc,
                                   n_keyframes=k + 1,
                                   last_kf_pose=pose_copy,
                                   last_kf_pose_np=np.asarray(pose_copy))

    # -- loop closure -----------------------------------------------------

    def _close_loops(self, state: SLAMState) -> Tuple[SLAMState, int]:
        cfg = self.config
        n = state.n_keyframes
        positions = state.graph.poses[:, :3, 3]
        ci, cj = propose_candidates(positions, n, cfg.loop)
        # drop pairs already admitted as loop edges, and pairs verified and
        # REJECTED within the last retry_cooldown keyframes (the budget
        # should explore fresh revisits, not re-try the same near-misses)
        cool = cfg.loop.retry_cooldown * max(1, cfg.loop_every)

        def _fresh(i, j):
            p = (int(i), int(j))
            if p in state.loop_pairs:
                return False
            return n - state.tried_pairs.get(p, -10**9) >= cool

        keep = [(j - i) >= cfg.loop.min_index_gap and _fresh(i, j)
                for i, j in zip(ci, cj)]
        keep = np.asarray(keep, bool) if len(keep) else np.zeros(0, bool)
        ci, cj = ci[keep], cj[keep]
        if cfg.loop.use_scan_context and n > cfg.loop.min_index_gap + 1:
            # appearance channel: proposes revisits the (drifted) proximity
            # gate cannot see; same ICP verification downstream
            from tpu_slam.graph.scan_context import propose_sc_candidates
            si, sj = propose_sc_candidates(
                state.kf_desc[n - 1], state.kf_desc, n - 1, n,
                cfg.loop.sc_max_distance, cfg.loop.min_index_gap,
                cfg.loop.sc_top_k)
            if si.size:
                pairs = {(int(a), int(b)) for a, b in zip(ci, cj)}
                pos_np = np.asarray(positions)
                fresh = [(a, b) for a, b in zip(si, sj)
                         if (int(a), int(b)) not in pairs
                         and _fresh(a, b)
                         # appearance matches beyond the drift budget are
                         # place-aliases (r5 diag: ungated 4.6 m sc pairs
                         # seeded the graph-folding cascade)
                         and np.linalg.norm(pos_np[int(a)] - pos_np[int(b)])
                         <= cfg.loop.sc_max_pose_distance]
                if fresh:
                    fi, fj = zip(*fresh)
                    ci = np.concatenate([ci, np.asarray(fi, np.int32)])
                    cj = np.concatenate([cj, np.asarray(fj, np.int32)])
                    ci, cj = (ci[: cfg.loop.max_candidates],
                              cj[: cfg.loop.max_candidates])
        if ci.size == 0:
            if self.collect_loop_debug:
                self.loop_debug.append({"n": n, "pairs": []})
            return state, 0

        # PAD the batch to the static max_candidates: the vmapped
        # symmetric-ICP verify recompiles for every distinct K, and a
        # fresh compile of the 40-iteration solve takes seconds. Dummy
        # slots re-verify pair 0 and are dropped after.
        K = cfg.loop.max_candidates
        n_real = len(ci)
        if n_real < K:
            ci = np.concatenate([ci, np.full(K - n_real, ci[0], np.int32)])
            cj = np.concatenate([cj, np.full(K - n_real, cj[0], np.int32)])

        res, accept = verify_candidates(
            state.kf_points, state.kf_mask, state.graph.poses, ci, cj,
            cfg.loop,
            clouds_normals=(state.kf_normals if cfg.loop.plane_verify
                            else None))
        accept_np = np.array(accept)       # np.asarray of a jax array is
        accept_np[n_real:] = False         # read-only; this one mutates
        ci, cj = ci[:n_real], cj[:n_real]
        accept_np = accept_np[:n_real]
        # record every verified pair's outcome for the retry cooldown
        tried = dict(state.tried_pairs)
        for k in range(len(ci)):
            if not accept_np[k]:
                tried[(int(ci[k]), int(cj[k]))] = n
        state = dataclasses.replace(state, tried_pairs=tried)
        if self.collect_loop_debug:
            from tpu_slam.core import se3 as _se3
            Ti = jnp.take(state.graph.poses, jnp.asarray(ci), axis=0)
            Tj = jnp.take(state.graph.poses, jnp.asarray(cj), axis=0)
            init = jax.vmap(lambda a, b: _se3.inverse(a) @ b)(Ti, Tj)
            dev = np.asarray(jax.vmap(
                lambda Z, T0: _se3.log(_se3.inverse(Z) @ T0))(res.T, init))
            self.loop_debug.append({
                "n": n,
                "pairs": [
                    {"i": int(a), "j": int(b),
                     "frac": float(res.matched_fraction[k]),
                     "err": float(res.error[k]),
                     "dev_t": float(np.linalg.norm(dev[k, :3])),
                     "dev_r": float(np.linalg.norm(dev[k, 3:])),
                     "converged": bool(res.converged[k]),
                     "accepted": bool(accept_np[k])}
                    for k, (a, b) in enumerate(zip(ci, cj))]})
        if not accept_np.any():
            return state, 0

        graph = state.graph
        free = cfg.edge_capacity - n_edges(graph)
        accepted = np.nonzero(accept_np)[0]
        if len(accepted) > free:
            # edge capacity nearly full — the NEXT keyframe store will
            # slide the window; keep only what fits now
            accepted = accepted[:free]
        new_pairs = set()
        for k in accepted:
            graph = add_edge(graph, int(ci[k]), int(cj[k]), res.T[k],
                             info=cfg.loop_edge_info
                             * jnp.eye(6, dtype=jnp.float32))
            new_pairs.add((int(ci[k]), int(cj[k])))
        # fresh set, not in-place mutation: a retained snapshot of an
        # earlier state (checkpoint/rollback) must not inherit pairs added
        # after it was taken (r4 advisor finding #4)
        loop_pairs = state.loop_pairs | new_pairs
        graph, _ = optimize_pose_graph(graph, cfg.graph)

        if not cfg.reanchor_after_loop:
            # loosely coupled: the optimized trajectory lives in the graph;
            # odometry (and its window) is left untouched
            state = dataclasses.replace(
                state, graph=graph, loop_pairs=loop_pairs,
                n_loop_closures=state.n_loop_closures + len(accepted))
            return state, len(accepted)

        # re-anchor odometry at the optimized latest keyframe:
        # current pose = optimized_kf_pose @ (old_kf_pose^-1 @ current)
        old_kf = state.last_kf_pose
        new_kf = graph.poses[n - 1]
        rel = se3.inverse(old_kf) @ state.odom.pose
        new_pose = new_kf @ rel

        odom = state.odom
        if self._dense:
            if cfg.rebuild_map_after_loop:
                grid = _rebuild_grid_batched(
                    graph.poses, state.kf_points, state.kf_mask,
                    jnp.int32(n), new_pose[:3, 3],
                    spec=self.odometry.map_spec, dims=self.odometry.dims,
                    align=self.odometry.factor)
                wide = odom.wide
                if wide is not None:
                    wide = _rebuild_grid_batched(
                        graph.poses, state.kf_points, state.kf_mask,
                        jnp.int32(n), new_pose[:3, 3],
                        spec=self.odometry.coarse_spec,
                        dims=self.odometry.dims, align=1)
                odom = dataclasses.replace(odom, grid=grid, pose=new_pose,
                                           wide=wide)
            else:
                odom = dataclasses.replace(odom, pose=new_pose)
        elif cfg.rebuild_map_after_loop:
            vmap = self._rebuild_map(graph, state.kf_points, state.kf_mask, n)
            # field=None: the cached NDT field is stale after a rebuild
            odom = dataclasses.replace(odom, vmap=vmap, pose=new_pose,
                                       field=None)
        else:
            odom = dataclasses.replace(odom, pose=new_pose)

        state = dataclasses.replace(state, graph=graph, odom=odom,
                                    last_kf_pose=new_kf,
                                    last_kf_pose_np=np.asarray(new_kf),
                                    loop_pairs=loop_pairs,
                                    n_loop_closures=state.n_loop_closures
                                    + len(accepted))
        return state, len(accepted)

    def _rebuild_map(self, graph: PoseGraph, kf_points, kf_mask, n: int):
        """Re-integrate every keyframe cloud at its optimized pose.

        One device dispatch for ALL keyframes (round-1 did K separate
        insert_cloud calls): transform every stored cloud by its optimized
        pose, flatten to one (K*P,) cloud with dead slots masked, and run
        the sort-merge insert once. All K slots are always processed
        (masked beyond n) so the jit never recompiles as the trajectory
        grows. The rebuilt voxels share one stamp (= n): recency-based
        eviction restarts from the rebuild, which is the conservative
        choice after a global pose correction.
        """
        cfg = self.config.odometry
        return _rebuild_map_batched(graph.poses, kf_points, kf_mask,
                                    jnp.int32(n), spec=cfg.map_spec(),
                                    capacity=cfg.map_capacity)

    # -- main entry -------------------------------------------------------

    def step(self, state: SLAMState, cloud: PointCloud
             ) -> Tuple[SLAMState, ScanMetrics]:
        cfg = self.config
        with Stopwatch() as sw:
            pose_np = None
            if self._dense:
                if state.odom is None:
                    odom_state = self.odometry.init_state(
                        cloud, self._pending_init_pose)
                    mm = np.zeros((5,), np.float32)
                    mm[1:4] = 1.0
                    pose_np = np.asarray(odom_state.pose)
                else:
                    odom_state = self.odometry.step(state.odom, cloud)
                    # ONE device->host sync for pose + metrics together
                    fused = np.asarray(jnp.concatenate(
                        [odom_state.pose.reshape(-1),
                         odom_state.last_metrics]))
                    pose_np = fused[:16].reshape(4, 4)
                    mm = fused[16:]
                m = ScanMetrics(scan_index=len(self.metrics.records),
                                iterations=int(mm[0]), residual=0.0,
                                matched_fraction=float(mm[1]),
                                wall_time_s=0.0)
                self.last_pose_np = pose_np
            else:
                odom_state, m = self.odometry.step(state.odom, cloud)
            state = dataclasses.replace(state, odom=odom_state)

            n_loops = 0
            if self._is_keyframe(state, pose_np):
                scan_ds = self.odometry.downsample(cloud)
                state = self._store_keyframe(state, scan_ds)
                m.is_keyframe = True
                if (state.n_keyframes % cfg.loop_every == 0
                        and state.n_keyframes > cfg.loop.min_index_gap):
                    state, n_loops = self._close_loops(state)
        m.wall_time_s = sw.elapsed
        m.n_loop_closures = n_loops
        self.metrics.append(m)
        return state, m

    def run(self, clouds, init_pose: Optional[jax.Array] = None
            ) -> Tuple[np.ndarray, "SLAMState"]:
        state = self.init_state(init_pose)
        poses = []
        for cloud in clouds:
            state, _ = self.step(state, cloud)
            poses.append(np.asarray(state.odom.pose))
        return np.stack(poses), state
