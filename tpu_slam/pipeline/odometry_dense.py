"""Dense-window odometry: the whole per-scan update as ONE device program.

Merging every scan into the sparse voxel map and rebuilding the NDT field
from it cost far more than the registration itself.  This engine removes
both: the odometry-rate map IS a scrolling dense moment window
(mapping.dense_map.DenseMomentGrid), so

  * insert      = segment-sum + one unique scatter-add,
  * field build = three shift-add passes + inverses,
  * coarse pyramid = block-sum of the same moments,

and the entire step — scroll, coarse+fine NDT register, gating, insert —
is a single donated-state jit dispatch.  Run it synchronously for
per-scan metrics or asynchronously for serving (the PP-analog overlap:
host scan prep runs under device compute, SURVEY.md §2.3).

The reference's equivalent loop lived in the CUDA gpu_6dslam node
(SURVEY.md §1 L6 [inferred]); keeping the working set dense and resident
in device memory mirrors how GPU SLAM engines bound their local map.
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
from tpu_slam.kernels.voxel_hash import VoxelGridSpec
from tpu_slam.mapping.dense_map import (DenseMomentGrid, centered_origin_cell,
                                        empty_grid, grid_coarsen,
                                        grid_insert, grid_ndt_field,
                                        grid_recenter_shift, grid_scroll)
from tpu_slam.pipeline.config import OdometryConfig
from tpu_slam.pipeline.metrics import MetricsLog, ScanMetrics, Stopwatch
from tpu_slam.registration.ndt import ndt_register


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DenseOdomState:
    """Device-resident odometry state (a single pytree)."""

    pose: jax.Array          # (4, 4) world<-body
    last_delta: jax.Array    # (4, 4)
    grid: DenseMomentGrid
    scan_index: jax.Array    # () int32
    last_metrics: jax.Array  # (5,) [iterations, frac, accepted, inserted,
                             #       coarse_frac]
    # wide coarse moment window: same cell dims at the coarse leaf, so it
    # covers pyramid_factor x the fine window's extent. The coarse stage
    # and the fine solve's far tier register against ITS field — distant
    # structure (corridor end walls, far facades) that the fine window
    # cannot hold stays in the objective. None when pyramid_factor == 1.
    wide: Optional[DenseMomentGrid] = None
    # dense log-odds layer aligned with the fine window (rows (G, 1));
    # free-space evidence evicts dynamic-object cells from the moment map
    # (config.use_occupancy). None when the feature is off.
    occ: Optional[DenseMomentGrid] = None


class DenseLidarOdometry:
    """One-dispatch-per-scan dense-window odometry engine."""

    def __init__(self, config: OdometryConfig = OdometryConfig()):
        if config.method != "ndt":
            raise ValueError("DenseLidarOdometry supports method='ndt'")
        if config.ndt.window_dims is None:
            raise ValueError("config.ndt.window_dims must be set (the dense "
                             "window shape)")
        self.config = config
        self.map_spec = config.map_spec()
        self.scan_spec = config.scan_spec()
        self.dims = config.ndt.window_dims
        self.factor = max(1, config.pyramid_factor)
        if self.factor > 1:
            from tpu_slam.mapping.voxel_map import coarse_spec_of
            self.coarse_spec = coarse_spec_of(self.map_spec, self.factor)
            self.coarse_params = self._coarse_params()
            # coarse-stage scan: downsampled at half the coarse leaf, so
            # each coarse cell sees <= ~2 Q slots' worth of points
            self.coarse_scan_spec = VoxelGridSpec.centered(
                leaf=config.map_leaf * self.factor / 2,
                half_extent=config.map_half_extent)
            self.coarse_scan_capacity = max(2048, config.scan_capacity // 4)
        self.metrics = MetricsLog()
        self._step = jax.jit(self._step_impl, donate_argnums=0)

    def _coarse_params(self):
        cfg = self.config
        f = self.factor
        return dataclasses.replace(
            cfg.ndt,
            max_iterations=max(6, cfg.ndt.max_iterations // 2),
            coarse_iterations=max(2, cfg.ndt.coarse_iterations),
            max_corr_dist=cfg.ndt.max_corr_dist * f,
            # the coarse stage registers a coarser-downsampled scan (see
            # _step_impl) so ~2x per-cell capacity absorbs the per-cell
            # occupancy
            raster_q=min(8, cfg.ndt.raster_q * 2),
            # yaw search at the coarse level: turns are the one motion the
            # constant-velocity prediction misses on their first scan
            yaw_candidates=max(5, cfg.ndt.yaw_candidates),
            yaw_span=max(0.3, cfg.ndt.yaw_span),
            window_dims=tuple(d // f for d in self.dims))

    # -- lifecycle --------------------------------------------------------

    def init_state(self, first_cloud: PointCloud,
                   init_pose: Optional[jax.Array] = None) -> DenseOdomState:
        pose = (jnp.eye(4, dtype=jnp.float32) if init_pose is None
                else jnp.asarray(init_pose, jnp.float32))
        c0 = centered_origin_cell(pose[:3, 3], self.map_spec, self.dims,
                                  align=self.factor)
        grid = empty_grid(self.dims, c0)
        occ = None
        if self.config.use_occupancy:
            from tpu_slam.mapping.dense_map import empty_occupancy_grid
            # COPY the corner before grid_insert donates `grid` (whose
            # origin_cell shares c0's buffer)
            occ = empty_occupancy_grid(self.dims, jnp.array(c0, copy=True))
        world_first = first_cloud.transform(pose)
        grid = grid_insert(grid, world_first, self.map_spec)
        wide = None
        if self.factor > 1:
            c0w = centered_origin_cell(pose[:3, 3], self.coarse_spec,
                                       self.dims, align=1)
            wide = grid_insert(empty_grid(self.dims, c0w), world_first,
                               self.coarse_spec)
        return DenseOdomState(
            pose=pose, last_delta=jnp.eye(4, dtype=jnp.float32), grid=grid,
            scan_index=jnp.int32(1),
            last_metrics=jnp.zeros((5,), jnp.float32), wide=wide, occ=occ)

    def step(self, state: DenseOdomState, cloud: PointCloud
             ) -> DenseOdomState:
        """One scan; old state is donated (async — does not sync)."""
        return self._step(state, cloud)

    def downsample(self, cloud: PointCloud) -> PointCloud:
        return voxel_downsample(cloud, self.scan_spec,
                                capacity=self.config.scan_capacity)

    # -- the compiled step ------------------------------------------------

    def _clamped_delta(self, delta):
        cfg = self.config
        xi = se3.log(delta)
        t_n = jnp.linalg.norm(xi[:3])
        r_n = jnp.linalg.norm(xi[3:])
        scale = jnp.minimum(
            jnp.minimum(1.0, cfg.max_pred_translation
                        / jnp.maximum(t_n, 1e-9)),
            jnp.minimum(1.0, cfg.max_pred_rotation / jnp.maximum(r_n, 1e-9)))
        return se3.exp(xi * scale)

    def _step_impl(self, state: DenseOdomState, cloud: PointCloud
                   ) -> DenseOdomState:
        cfg = self.config

        pred = self._clamped_delta(state.last_delta)
        if cfg.deskew:
            from tpu_slam.ingest.deskew import (deskew_cloud,
                                                vlp16_time_fractions)
            frac = vlp16_time_fractions(cloud.points)
            cloud = deskew_cloud(cloud, frac, T_start=se3.inverse(pred),
                                 T_end=jnp.eye(4, dtype=jnp.float32))
        scan = voxel_downsample(cloud, self.scan_spec,
                                capacity=cfg.scan_capacity)
        if cfg.scan_max_range > 0:
            rng2 = jnp.sum(scan.points[:, :2] ** 2, axis=1)
            scan = PointCloud(
                points=scan.points,
                mask=scan.mask & (rng2 < cfg.scan_max_range ** 2),
                attrs=scan.attrs).sanitize()
        init_T = state.pose @ pred

        # scroll the window when the predicted pose leaves its core
        shift = grid_recenter_shift(state.grid, init_T[:3, 3], self.map_spec,
                                    align=self.factor,
                                    deadband_fraction=cfg.rebase_fraction)
        grid = grid_scroll(state.grid, shift)
        occ = state.occ
        if occ is not None:
            occ = grid_scroll(occ, shift)   # stays aligned with the window

        # coarse pyramid capture (block-summed moments), then fine polish
        coarse_frac = jnp.float32(1.0)
        T1 = init_T
        wide = state.wide
        if self.factor > 1:
            # the coarse field comes from the WIDE moment window (factor x
            # the fine extent), not a coarsening of the fine window: the
            # far structure it uniquely holds is the along-track anchor
            wshift = grid_recenter_shift(wide, init_T[:3, 3],
                                         self.coarse_spec, align=1,
                                         deadband_fraction=cfg.rebase_fraction)
            wide = grid_scroll(wide, wshift)
            cfield = grid_ndt_field(wide, self.coarse_spec,
                                    min_voxel_count=cfg.ndt.min_voxel_count,
                                    evec_floor_ratio=cfg.ndt.evec_floor_ratio)
            cscan = voxel_downsample(cloud, self.coarse_scan_spec,
                                     capacity=self.coarse_scan_capacity)
            rc = ndt_register(cscan, cfield, self.coarse_spec, init_T=init_T,
                              params=self.coarse_params)
            T1, coarse_frac = rc.T, rc.matched_fraction
        field = grid_ndt_field(grid, self.map_spec,
                               min_voxel_count=cfg.ndt.min_voxel_count,
                               evec_floor_ratio=cfg.ndt.evec_floor_ratio)
        # far tier: scan points beyond the fine window register against
        # the coarse pyramid field. In a corridor the end walls sit
        # outside the +-(dims*leaf/2) fine window while being the ONLY
        # along-track constraint — without this tier the estimate froze
        # mid-leg for ~10 scans (a 4.4 m cliff, r5 corridor workload)
        far_kw = {}
        if self.factor > 1:
            far_kw = dict(far_field=cfield, far_spec=self.coarse_spec)
        res = ndt_register(scan, field, self.map_spec, init_T=T1,
                           params=cfg.ndt, **far_kw)

        accepted = res.matched_fraction >= cfg.min_accept_fraction
        # one polar-Newton step per scan: keeps the rotation orthonormal
        # over arbitrarily long runs (f32 composition drift guard)
        T = se3.orthonormalize(jnp.where(accepted, res.T, init_T))
        delta = se3.inverse(state.pose) @ T

        do_insert = accepted & (res.matched_fraction
                                >= cfg.min_insert_fraction)
        src_map = scan if cfg.insert_downsampled else cloud
        world_scan = src_map.transform(T)
        grid = grid_insert(grid, world_scan, self.map_spec,
                           weight=do_insert.astype(jnp.float32))
        if wide is not None:
            wide = grid_insert(wide, world_scan, self.coarse_spec,
                               weight=do_insert.astype(jnp.float32))
        if occ is not None:
            from tpu_slam.mapping.dense_map import grid_occupancy_update
            grid, occ, _ = grid_occupancy_update(
                grid, occ, T[:3, 3], world_scan, self.map_spec,
                n_steps=cfg.occupancy_steps,
                max_range=cfg.occupancy_max_range,
                evict_below=cfg.occupancy_evict_below,
                weight=do_insert.astype(jnp.float32))

        metrics = jnp.stack([
            res.iterations.astype(jnp.float32), res.matched_fraction,
            accepted.astype(jnp.float32), do_insert.astype(jnp.float32),
            coarse_frac])
        return DenseOdomState(pose=T, last_delta=delta, grid=grid,
                              scan_index=state.scan_index + 1,
                              last_metrics=metrics, wide=wide, occ=occ)

    # -- host conveniences ------------------------------------------------

    def run(self, clouds, init_pose: Optional[jax.Array] = None,
            sync_every: int = 1) -> Tuple[np.ndarray, MetricsLog]:
        """Process an iterable of clouds; returns (poses (N,4,4), log).

        ``sync_every`` = 1 reads pose+metrics per scan (diagnostic mode);
        larger values only sync every k scans (serving mode — poses of
        un-synced scans are still collected, asynchronously).
        """
        it = iter(clouds)
        first = next(it)
        state = self.init_state(first, init_pose)
        # pose buffers are donated by the next step — keep device COPIES
        # (dispatched before the donating step, so this stays async)
        poses = [jnp.array(state.pose, copy=True)]
        for k, cloud in enumerate(it, start=1):
            with Stopwatch() as sw:
                state = self.step(state, cloud)
                if sync_every and k % sync_every == 0:
                    jax.block_until_ready(state.pose)
            m_dev = state.last_metrics
            poses.append(jnp.array(state.pose, copy=True))
            if sync_every and k % sync_every == 0:
                m = np.asarray(m_dev)
                self.metrics.append(ScanMetrics(
                    scan_index=k, iterations=int(m[0]),
                    residual=0.0, matched_fraction=float(m[1]),
                    wall_time_s=sw.elapsed))
        jax.block_until_ready(state.pose)
        return np.stack([np.asarray(p) for p in poses]), self.metrics
