"""Scan-to-map LiDAR odometry — the hot loop of the SLAM engine.

Host-driven loop with device-resident state (SURVEY.md §7.3: a lax.scan
over a whole sequence would pin every intermediate map in memory; instead
the map stays resident on device and only poses/metrics round-trip).

Per scan:
  1. voxel-downsample the incoming cloud (kernels.downsample),
  2. predict an initial pose (constant-velocity motion model),
  3. register against the map — NDT (registration.ndt) or ICP against voxel
     means/normals (registration.icp),
  4. update the pose and integrate the scan into the map
     (mapping.voxel_map).

The reference's equivalent loop lived in the CUDA gpu_6dslam node
(SURVEY.md §1 L6 [inferred]); its host/device split (host loop, device
iterations) is the same shape CUDA ICP engines use.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_slam.core import se3
from tpu_slam.core.pointcloud import PointCloud
from tpu_slam.kernels.downsample import voxel_downsample
from tpu_slam.mapping.voxel_map import (VoxelMap, empty_map, insert_cloud,
                                        voxel_means,
                                        voxel_normals_neighborhood)
from tpu_slam.pipeline.config import OdometryConfig
from tpu_slam.pipeline.metrics import MetricsLog, ScanMetrics, Stopwatch
from tpu_slam.registration.icp import icp
from tpu_slam.registration.ndt import ndt_field, ndt_register


@dataclasses.dataclass
class OdometryState:
    """Mutable host-side handle onto device-resident odometry state."""

    pose: jax.Array            # (4, 4) world<-body
    last_delta: jax.Array      # (4, 4) previous relative motion
    vmap: VoxelMap
    scan_index: int = 0
    # cached NDT field (rebuilt only when the map changes — the eigh over
    # all voxels is the most expensive per-scan op and skipping it on
    # no-insert scans is free accuracy-wise)
    field: object = None
    # log-odds occupancy grid (only with config.use_occupancy)
    occ: object = None
    # scrolling window: world = local + map_offset. Host-side numpy (exact
    # leaf multiples; changes only on host-triggered rebase). None when
    # config.scrolling_window is off — the map grid is then world-fixed.
    map_offset: Optional[np.ndarray] = None


class LidarOdometry:
    """Frame-to-map odometry engine."""

    def __init__(self, config: OdometryConfig = OdometryConfig()):
        self.config = config
        self.map_spec = config.map_spec()
        self.scan_spec = config.scan_spec()
        self.metrics = MetricsLog()

    def init_state(self, init_pose: Optional[jax.Array] = None
                   ) -> OdometryState:
        pose = (jnp.eye(4, dtype=jnp.float32) if init_pose is None
                else jnp.asarray(init_pose, jnp.float32))
        occ = None
        if self.config.use_occupancy:
            from tpu_slam.mapping.occupancy import empty_occupancy
            occ = empty_occupancy(self.config.occupancy_capacity)
        offset = None
        if self.config.scrolling_window:
            # start with the window centered on the initial pose (local
            # coordinates of the start are ~0 = the window center)
            t0 = np.asarray(pose)[:3, 3]
            leaf = self.config.map_leaf
            offset = np.round(t0 / leaf) * leaf
        return OdometryState(pose=pose,
                             last_delta=jnp.eye(4, dtype=jnp.float32),
                             vmap=empty_map(self.config.map_capacity),
                             occ=occ, map_offset=offset)

    def _to_local(self, T: jax.Array, offset) -> jax.Array:
        """World -> map-local pose (scrolling window; identity when off)."""
        if offset is None:
            return T
        return T.at[:3, 3].add(-jnp.asarray(offset, jnp.float32))

    def _to_world(self, T: jax.Array, offset) -> jax.Array:
        if offset is None:
            return T
        return T.at[:3, 3].add(jnp.asarray(offset, jnp.float32))

    def _maybe_rebase(self, vmap, occ, field, offset, t_local: np.ndarray):
        """Re-center the window when the sensor leaves its core (host)."""
        cfg = self.config
        half = 0.5 * self.map_spec.extent
        if np.max(np.abs(t_local)) <= half * (1.0 - 2.0 * cfg.rebase_fraction):
            return vmap, occ, field, offset
        from tpu_slam.mapping.voxel_map import shift_map_cells
        shift = np.round(t_local / cfg.map_leaf).astype(np.int32)
        vmap = shift_map_cells(vmap, self.map_spec,
                               jnp.asarray(shift, jnp.int32))
        if occ is not None:
            from tpu_slam.mapping.occupancy import shift_occupancy_cells
            occ = shift_occupancy_cells(occ, self.map_spec,
                                        jnp.asarray(shift, jnp.int32))
        offset = offset + shift.astype(np.float64) * cfg.map_leaf
        return vmap, occ, None, offset   # field cache is stale

    def _maintain_occupancy(self, state_occ, vmap, T, scan):
        """Free-space update + seen-through voxel eviction (one dispatch)."""
        from tpu_slam.mapping.occupancy import occupancy_maintain
        cfg = self.config
        world_scan = scan.transform(T)
        return occupancy_maintain(
            state_occ, vmap, T[:3, 3], world_scan, self.map_spec,
            n_steps=cfg.occupancy_steps, max_range=cfg.occupancy_max_range,
            evict_below=cfg.occupancy_evict_below)

    def downsample(self, cloud: PointCloud) -> PointCloud:
        return voxel_downsample(cloud, self.scan_spec,
                                capacity=self.config.scan_capacity)

    def _clamped_delta(self, delta: jax.Array) -> jax.Array:
        """Clamp the constant-velocity extrapolation.

        A single misconverged registration inflates last_delta; unchecked,
        the next prediction lands outside the registration basin and the
        error compounds multiplicatively.
        """
        cfg = self.config
        xi = se3.log(delta)
        t_n = jnp.linalg.norm(xi[:3])
        r_n = jnp.linalg.norm(xi[3:])
        scale = jnp.minimum(
            jnp.minimum(1.0, cfg.max_pred_translation / jnp.maximum(t_n, 1e-9)),
            jnp.minimum(1.0, cfg.max_pred_rotation / jnp.maximum(r_n, 1e-9)))
        return se3.exp(xi * scale)

    def _build_fields(self, vmap: VoxelMap, center=None):
        """(fine_field, coarse_field_or_None) for the NDT method."""
        cfg = self.config
        fine = ndt_field(vmap, self.map_spec, cfg.ndt, center=center)
        coarse = None
        if cfg.pyramid_factor > 1:
            from tpu_slam.mapping.voxel_map import coarse_spec_of, coarsen_map
            cspec = coarse_spec_of(self.map_spec, cfg.pyramid_factor)
            cmap = coarsen_map(vmap, self.map_spec, cfg.pyramid_factor)
            coarse = ndt_field(cmap, cspec, self._coarse_params(),
                               center=center)
        return fine, coarse

    def _coarse_params(self):
        cfg = self.config
        # the coarse window covers pyramid_factor x the metric extent of the
        # fine one at 1/factor^3 the cells — cap it at half the fine dims so
        # the coarse register costs a fraction of a fine pass
        wdims = cfg.ndt.window_dims
        if wdims is not None:
            wdims = tuple(max(16, (d // 2 + 7) // 8 * 8) for d in wdims)
        return dataclasses.replace(
            cfg.ndt, max_iterations=max(10, cfg.ndt.max_iterations // 2),
            window_dims=wdims,
            max_corr_dist=cfg.ndt.max_corr_dist * cfg.pyramid_factor)

    def _register(self, scan: PointCloud, init_T: jax.Array,
                  vmap: VoxelMap, field=None):
        cfg = self.config
        if cfg.method == "ndt":
            if field is None:
                field = self._build_fields(vmap, center=init_T[:3, 3])
            fine, coarse = field
            if coarse is not None:
                from tpu_slam.mapping.voxel_map import coarse_spec_of
                cspec = coarse_spec_of(self.map_spec, cfg.pyramid_factor)
                cres = ndt_register(scan, coarse, cspec, init_T=init_T,
                                    params=self._coarse_params())
                init_T = cres.T
            res = ndt_register(scan, fine, self.map_spec, init_T=init_T,
                               params=cfg.ndt)
            return res.T, res.iterations, res.score, res.matched_fraction
        # ICP flavors use the map's voxel means as the target cloud
        means = voxel_means(vmap, self.map_spec)
        tgt = PointCloud(points=means, mask=vmap.occupied_mask())
        normals = None
        if cfg.method == "icp_plane":
            # neighborhood normals: single-voxel covariance is too sparse
            # right after insertion (a scan leaves few points per voxel)
            normals, n_valid = voxel_normals_neighborhood(vmap, self.map_spec)
            # only planar voxels make valid point-to-plane targets; voxels
            # with degenerate covariance get garbage eigenvectors
            tgt = PointCloud(points=means,
                             mask=vmap.occupied_mask() & n_valid).sanitize()
            params = dataclasses.replace(cfg.icp, point_to_plane=True)
        else:
            params = cfg.icp
        res = icp(scan, tgt, init_T=init_T, params=params,
                  target_normals=normals)
        return res.T, res.iterations, res.error, res.matched_fraction

    def step(self, state: OdometryState, cloud: PointCloud
             ) -> Tuple[OdometryState, ScanMetrics]:
        """Process one aggregated 3D scan (body-frame points)."""
        cfg = self.config
        with Stopwatch() as sw:
            if cfg.deskew and state.scan_index > 0:
                # undistort with the predicted sweep motion: the relative
                # start->end transform is the (clamped) last delta
                from tpu_slam.ingest.deskew import (deskew_cloud,
                                                    vlp16_time_fractions)
                pred = self._clamped_delta(state.last_delta)
                frac = vlp16_time_fractions(cloud.points)
                cloud = deskew_cloud(cloud, frac,
                                     T_start=se3.inverse(pred),
                                     T_end=jnp.eye(4, dtype=jnp.float32))
            scan = self.downsample(cloud)

            if state.scan_index == 0:
                # bootstrap: place the first scan at the initial pose.
                # The RAW cloud feeds the map — coarse-downsampled scans
                # starve per-voxel statistics (NDT Gaussians and normals
                # need >= min_count points per voxel).
                T0_loc = self._to_local(state.pose, state.map_offset)
                world = cloud.transform(T0_loc)
                vmap = insert_cloud(state.vmap, world, self.map_spec,
                                    stamp=0.0)
                occ = state.occ
                if cfg.use_occupancy:
                    occ, vmap, _ = self._maintain_occupancy(
                        occ, vmap, T0_loc, scan)
                new_state = OdometryState(pose=state.pose,
                                          last_delta=state.last_delta,
                                          vmap=vmap, scan_index=1, occ=occ,
                                          map_offset=state.map_offset)
                m = ScanMetrics(scan_index=0, iterations=0, residual=0.0,
                                matched_fraction=1.0, wall_time_s=0.0)
                jax.block_until_ready(vmap.keys)
                m.wall_time_s = sw.elapsed if hasattr(sw, "elapsed") else 0.0
                self.metrics.append(m)
                return new_state, m

            offset = state.map_offset
            pose_loc = self._to_local(state.pose, offset)

            # (re)build the cached NDT field(s) only when the map changed
            field = state.field
            if cfg.method == "ndt" and field is None:
                field = self._build_fields(state.vmap,
                                           center=pose_loc[:3, 3])

            init_T = (pose_loc @ self._clamped_delta(state.last_delta)
                      if cfg.use_constant_velocity else pose_loc)
            T, iters, resid, frac = self._register(scan, init_T, state.vmap,
                                                   field)

            # ONE device->host sync per scan: every gating decision reads
            # from this batch (scattered float() syncs each pay a full
            # device->host round-trip). T / init_T are map-local here; the
            # relative delta is frame-invariant (the offset is a pure
            # translation).
            delta_reg = se3.inverse(pose_loc) @ T
            xi_reg = se3.log(delta_reg)
            stats = np.asarray(jnp.concatenate([
                jnp.stack([frac.astype(jnp.float32),
                           iters.astype(jnp.float32),
                           resid.astype(jnp.float32)]),
                jnp.stack([jnp.linalg.norm(xi_reg[:3]),
                           jnp.linalg.norm(xi_reg[3:])]),
                T[:3, 3], init_T[:3, 3],
            ]))
            frac_h, iters_h, resid_h, dt_h, dr_h = (
                float(stats[0]), float(stats[1]), float(stats[2]),
                float(stats[3]), float(stats[4]))

            # Divergence guard: a collapsed match fraction means the solve
            # left the map's support — coast on the prediction instead of
            # poisoning pose and map with a runaway estimate.
            rejected = frac_h < cfg.min_accept_fraction
            if rejected:
                T = init_T
                delta = se3.inverse(pose_loc) @ T
                t_local = stats[8:11]
            else:
                delta = delta_reg
                t_local = stats[5:8]

            vmap = state.vmap
            if (state.scan_index % cfg.insert_every == 0 and not rejected
                    and frac_h >= cfg.min_insert_fraction):
                world = cloud.transform(T)          # map-local frame
                vmap = insert_cloud(vmap, world, self.map_spec,
                                    stamp=float(state.scan_index))
                field = None  # map changed; invalidate the field cache

            occ = state.occ
            if cfg.use_occupancy and not rejected:
                occ, vmap, n_evict = self._maintain_occupancy(
                    occ, vmap, T, scan)
                if int(n_evict) > 0:   # one extra sync, feature-gated
                    field = None       # evictions changed the map

            # scrolling window: re-center once the sensor leaves the core
            if offset is not None:
                vmap, occ, field, offset = self._maybe_rebase(
                    vmap, occ, field, offset, t_local)

            # back to world + f32 composition drift guard (see
            # odometry_dense._step_impl)
            T = se3.orthonormalize(self._to_world(T, state.map_offset))

        m = ScanMetrics(
            scan_index=state.scan_index,
            iterations=int(iters_h),
            residual=resid_h,
            matched_fraction=frac_h,
            wall_time_s=sw.elapsed,
            translation_delta=dt_h,
            rotation_delta=dr_h,
        )
        self.metrics.append(m)
        new_state = OdometryState(pose=T, last_delta=delta, vmap=vmap,
                                  scan_index=state.scan_index + 1,
                                  field=field, occ=occ, map_offset=offset)
        return new_state, m

    def run(self, clouds, init_pose: Optional[jax.Array] = None
            ) -> Tuple[np.ndarray, MetricsLog]:
        """Process an iterable of PointClouds; returns (poses (N,4,4), log)."""
        state = self.init_state(init_pose)
        poses = []
        for cloud in clouds:
            state, _ = self.step(state, cloud)
            poses.append(np.asarray(state.pose))
        return np.stack(poses), self.metrics
