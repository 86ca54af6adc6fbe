"""Laser-to-axis extrinsic calibration (5-DoF) — reference-parity solvers.

Re-implements the m3d_calibration capability (SURVEY.md §3.3) in JAX:

  * the **cost** is the reference's half-space overlap count
    (m3d_calibration_twiddle.cpp:199-308): apply the candidate extrinsic to
    every captured segment through its rotation transform, split points by
    the sign of their LASER-frame up-axis coordinate (the two half-rotation
    clouds that should coincide), voxel-downsample both at 0.1 m, and count
    second-half points with no first-half neighbor within 0.05 m. Here the
    whole evaluation is one jit (grid-hash NN instead of KdTreeFLANN);
  * **twiddle**: coordinate descent with multiplicative step adaptation
    1.1 / 0.9 and convergence at sum(steps) < 1e-6
    (m3d_calibration_twiddle.cpp:345-396);
  * **simulated annealing**: T 1.0 -> <0.001, alpha = 0.99, +-0.001
    perturbations, Metropolis accept exp((best - cand)/T)
    (m3d_calibration_sa.cpp:313-356);
  * **gradient solver** (an upgrade): a smooth sigmoid relaxation of
    the count cost optimized with Adam — differentiating through the whole
    pipeline, something the CPU reference could not do.

The 5 DoF are [ty, tz, rx, ry, rz]; tx is fixed at 0 exactly as the
reference's call sites do (testData(0, p[0..4]),
m3d_calibration_twiddle.cpp:345). The extrinsic composes as
p_base = T_segment @ (R p_laser + R t) — matching Eigen's
rotate-then-translate order in testData (:217-220).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from tpu_slam.core import se3
from tpu_slam.core.pointcloud import PAD_COORD, PointCloud
from tpu_slam.ingest.frames import Calibration
from tpu_slam.kernels.downsample import voxel_downsample
from tpu_slam.kernels.nn_search import nearest_neighbors_hash
from tpu_slam.kernels.voxel_hash import VoxelGridSpec, sort_by_key


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CalibrationData:
    """Captured segments: laser-frame points + unit transform per segment.

    points: (S, L, 3); valid: (S, L); transforms: (S, 4, 4) — the
    ``original_Transform`` of each segment (base <- rotating link at the
    capture instant, m3d_calibration_twiddle.cpp:56-82).
    """

    points: jax.Array
    valid: jax.Array
    transforms: jax.Array


@dataclasses.dataclass(frozen=True)
class CalibConfig:
    """Static cost configuration (reference constants)."""

    leaf: float = 0.1               # VoxelGrid leaf (:281)
    radius: float = 0.05            # match radius (:299)
    up_axis: int = 1                # laserUpAxis param default (:176); 2 for Velodyne
    half_extent: float = 30.0       # world extent for the match grid
    capacity: int = 65536           # padded size of each half cloud


def extrinsic_matrix(params5: jax.Array) -> jax.Array:
    """[ty, tz, rx, ry, rz] -> 4x4 extrinsic, Eigen rotate-then-translate.

    Rotation = Rx(rx) @ Ry(ry) @ Rz(rz) (AngleAxis composition in
    testData:212-214); the translation enters as R @ t.
    """
    t = jnp.array([0.0, params5[0], params5[1]], params5.dtype)
    rx, ry, rz = params5[2], params5[3], params5[4]

    def rot(axis, a):
        c, s = jnp.cos(a), jnp.sin(a)
        if axis == 0:
            return jnp.array([[1, 0, 0], [0, c, -s], [0, s, c]], params5.dtype)
        if axis == 1:
            return jnp.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], params5.dtype)
        return jnp.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], params5.dtype)

    R = rot(0, rx) @ rot(1, ry) @ rot(2, rz)
    return se3.from_rt(R, R @ t)


def _half_clouds(data: CalibrationData, M: jax.Array, cfg: CalibConfig
                 ) -> Tuple[PointCloud, PointCloud]:
    """Transform all segments and split by laser-frame up-axis sign."""
    def one(seg_pts, seg_valid, seg_T):
        return se3.apply(seg_T @ M, seg_pts)

    world = jax.vmap(one)(data.points, data.valid, data.transforms)
    world = world.reshape(-1, 3)
    valid = data.valid.reshape(-1)
    up = data.points.reshape(-1, 3)[:, cfg.up_axis]

    first_mask = valid & (up > 0)
    second_mask = valid & (up <= 0)
    first = PointCloud(points=jnp.where(first_mask[:, None], world,
                                        PAD_COORD), mask=first_mask)
    second = PointCloud(points=jnp.where(second_mask[:, None], world,
                                         PAD_COORD), mask=second_mask)
    return first, second


@functools.partial(jax.jit, static_argnames=("cfg",))
def overlap_cost(data: CalibrationData, params5: jax.Array,
                 cfg: CalibConfig = CalibConfig()) -> jax.Array:
    """The reference's outlier count: second-half points (downsampled) with
    no first-half neighbor within ``radius``. Lower is better."""
    M = extrinsic_matrix(params5)
    first, second = _half_clouds(data, M, cfg)
    spec = VoxelGridSpec.centered(leaf=cfg.leaf, half_extent=cfg.half_extent)
    first_ds = voxel_downsample(first, spec, capacity=cfg.capacity)
    second_ds = voxel_downsample(second, spec, capacity=cfg.capacity)
    skeys, stgt = sort_by_key(first_ds, spec)
    idx, dist = nearest_neighbors_hash(second_ds.points, skeys, stgt.points,
                                       spec, k_per_cell=2)
    unmatched = second_ds.mask & ~(dist <= cfg.radius)
    return jnp.sum(unmatched.astype(jnp.int32))


@functools.partial(jax.jit, static_argnames=("cfg",))
def soft_overlap_cost(data: CalibrationData, params5: jax.Array,
                      cfg: CalibConfig = CalibConfig(),
                      sharpness: float = 60.0) -> jax.Array:
    """Differentiable relaxation: sigmoid((d - radius) * sharpness) summed —
    approaches the count as sharpness grows, admits jax.grad."""
    M = extrinsic_matrix(params5)
    first, second = _half_clouds(data, M, cfg)
    spec = VoxelGridSpec.centered(leaf=cfg.leaf, half_extent=cfg.half_extent)
    first_ds = voxel_downsample(first, spec, capacity=cfg.capacity)
    second_ds = voxel_downsample(second, spec, capacity=cfg.capacity)
    skeys, stgt = sort_by_key(first_ds, spec)
    idx, dist = nearest_neighbors_hash(second_ds.points, skeys, stgt.points,
                                       spec, k_per_cell=2)
    # recompute the matched distance differentiably through the points
    matched = jnp.take(stgt.points, jnp.clip(idx, 0), axis=0)
    d = jnp.linalg.norm(second_ds.points - matched, axis=-1)
    d = jnp.where(idx >= 0, d, 10.0 * cfg.radius)
    soft = jax.nn.sigmoid((d - cfg.radius) * sharpness)
    return jnp.sum(jnp.where(second_ds.mask, soft, 0.0))


class CalibrationCapture:
    """Collect (line cloud, rotation transform) segments from the rotating
    stream until the axis sweeps ``sweep_rad``.

    The live twin of the reference's segment collection
    (m3d_calibration_twiddle.cpp:56-82 addSegment, :312-317 N*pi gate;
    2pi default, 6pi for Velodyne per velodyne_calibration.launch:6-7).
    Lines are stored RAW (laser frame) with the PURE rotation transform
    T_rot(angle) — the candidate extrinsic under optimization stands in
    for the calibration/sensor tail of the live TF chain, exactly like the
    reference's laserOffsetMatrix.
    """

    def __init__(self, line_capacity: int = 1024,
                 max_segments: int = 4096,
                 sweep_rad: float = 2.0 * math.pi,
                 encoder_offset: float = math.pi):
        self.line_capacity = line_capacity
        self.max_segments = max_segments
        self.sweep_rad = sweep_rad
        self.encoder_offset = encoder_offset
        self._pts: list = []
        self._val: list = []
        self._T: list = []
        self._last_angle: Optional[float] = None
        self._swept = 0.0

    @property
    def complete(self) -> bool:
        return self._swept >= self.sweep_rad

    @property
    def progress(self) -> float:
        """Percent of the required sweep (the reference's progress topic)."""
        return 100.0 * self._swept / self.sweep_rad

    @property
    def n_segments(self) -> int:
        return len(self._pts)

    def add_line(self, points: np.ndarray, valid: np.ndarray,
                 encoder_angle: float) -> bool:
        """Store one laser line at its encoder angle; returns ``complete``."""
        from tpu_slam.ingest.frames import rotation_link_transform

        if self.complete or len(self._pts) >= self.max_segments:
            return True
        L = self.line_capacity
        p = np.zeros((L, 3), np.float32)
        v = np.zeros((L,), bool)
        n = min(len(points), L)
        p[:n], v[:n] = points[:n], valid[:n]
        a = float(encoder_angle) - self.encoder_offset
        self._pts.append(p)
        self._val.append(v)
        self._T.append(np.asarray(rotation_link_transform(jnp.float32(a)),
                                  np.float32))
        if self._last_angle is not None:
            # rotation about a fixed axis: quaternion angular distance
            # between consecutive line transforms == |delta angle|,
            # shortest-arc (an encoder wrap is a tiny step, not ~2pi)
            d = abs(a - self._last_angle) % (2.0 * math.pi)
            self._swept += min(d, 2.0 * math.pi - d)
        self._last_angle = a
        return self.complete

    def data(self, pad_to: int = 64) -> CalibrationData:
        """Freeze into CalibrationData (segment count padded for jit-shape
        stability across captures of similar length)."""
        S = len(self._pts)
        if S == 0:
            raise ValueError("no segments captured")
        Sp = -(-S // pad_to) * pad_to
        L = self.line_capacity
        pts = np.zeros((Sp, L, 3), np.float32)
        val = np.zeros((Sp, L), bool)
        Ts = np.broadcast_to(np.eye(4, dtype=np.float32),
                             (Sp, 4, 4)).copy()
        pts[:S] = np.stack(self._pts)
        val[:S] = np.stack(self._val)
        Ts[:S] = np.stack(self._T)
        return CalibrationData(points=jnp.asarray(pts),
                               valid=jnp.asarray(val),
                               transforms=jnp.asarray(Ts))


def capture_from_lms(lms, angle_source: Callable[[], float],
                     capture: CalibrationCapture,
                     start_angle_deg: float = -45.0,
                     range_min: float = 0.01, range_max: float = 100.0,
                     max_lines: int = 100000,
                     poll_timeout_ms: int = 2000) -> CalibrationCapture:
    """Drive a CalibrationCapture from a connected NativeLms stream.

    The capture-side twin of the reference's live subscription
    (m3d_calibration_twiddle.cpp:430 rotLaserPointCloudCallback): poll
    telegrams, expand to laser-frame points, tag with the encoder angle.
    """
    dirs = None
    for _ in range(max_lines):
        out = lms.poll(timeout_ms=poll_timeout_ms)
        if out is None:
            break
        meta, ranges, _ = out
        if dirs is None or dirs.shape[0] != ranges.shape[0]:
            ang = (math.radians(start_angle_deg)
                   + math.radians(meta.ang_step_deg)
                   * np.arange(ranges.shape[0]))
            dirs = np.stack([np.cos(ang), np.sin(ang),
                             np.zeros_like(ang)], axis=1).astype(np.float32)
        pts = dirs * ranges[:, None]
        valid = (ranges >= range_min) & (ranges <= range_max)
        if capture.add_line(pts, valid, angle_source()):
            break
    return capture


@dataclasses.dataclass
class CalibResult:
    params5: np.ndarray
    cost: float
    evaluations: int
    history: list

    def to_calibration(self) -> Calibration:
        M = np.asarray(extrinsic_matrix(jnp.asarray(self.params5,
                                                    jnp.float32)))
        q = np.asarray(se3.quat_from_matrix(jnp.asarray(M[:3, :3])))
        return Calibration(translation=tuple(float(v) for v in M[:3, 3]),
                           orientation_xyzw=tuple(float(v) for v in q))


def calibrate_twiddle(data: CalibrationData,
                      cfg: CalibConfig = CalibConfig(),
                      init: Optional[np.ndarray] = None,
                      initial_step: float = 0.01,
                      tolerance: float = 1e-6,
                      max_evaluations: int = 2000) -> CalibResult:
    """Coordinate-descent twiddle (m3d_calibration_twiddle.cpp:345-396)."""
    p = np.zeros(5, np.float32) if init is None else np.array(init, np.float32)
    dp = np.full(5, initial_step, np.float32)
    evals = 0
    history = []

    def cost(v):
        nonlocal evals
        evals += 1
        return int(overlap_cost(data, jnp.asarray(v, jnp.float32), cfg))

    best = cost(p)
    history.append(best)
    while dp.sum() > tolerance and evals < max_evaluations:
        for i in range(5):
            p[i] += dp[i]
            c = cost(p)
            if c < best:
                best = c
                dp[i] *= 1.1
            else:
                p[i] -= 2 * dp[i]
                c = cost(p)
                if c < best:
                    best = c
                    dp[i] *= 1.1
                else:
                    p[i] += dp[i]
                    dp[i] *= 0.9
        history.append(best)
    return CalibResult(params5=p, cost=float(best), evaluations=evals,
                       history=history)


def calibrate_sa(data: CalibrationData,
                 cfg: CalibConfig = CalibConfig(),
                 init: Optional[np.ndarray] = None,
                 t_start: float = 1.0,
                 t_end: float = 0.001,
                 alpha: float = 0.99,
                 step: float = 0.001,
                 seed: int = 0) -> CalibResult:
    """Simulated annealing (m3d_calibration_sa.cpp:313-356)."""
    rng = np.random.default_rng(seed)
    p = np.zeros(5, np.float32) if init is None else np.array(init, np.float32)
    evals = 0

    def cost(v):
        nonlocal evals
        evals += 1
        return float(overlap_cost(data, jnp.asarray(v, jnp.float32), cfg))

    best_p = p.copy()
    best = cost(p)
    cur = best
    history = [best]
    T = t_start
    while T > t_end:
        cand = p + rng.uniform(-step, step, 5).astype(np.float32)
        c = cost(cand)
        if c < cur or rng.random() < math.exp(min((cur - c) / max(T, 1e-9),
                                                  0.0)):
            p, cur = cand, c
            if c < best:
                best, best_p = c, cand.copy()
        T *= alpha
        history.append(best)
    return CalibResult(params5=best_p, cost=best, evaluations=evals,
                       history=history)


def calibrate_gradient(data: CalibrationData,
                       cfg: CalibConfig = CalibConfig(),
                       init: Optional[np.ndarray] = None,
                       steps: int = 200,
                       learning_rate: float = 3e-3) -> CalibResult:
    """Adam on the sigmoid-relaxed cost — the differentiable upgrade."""
    import optax

    p = (jnp.zeros(5, jnp.float32) if init is None
         else jnp.asarray(init, jnp.float32))
    opt = optax.adam(learning_rate)
    opt_state = opt.init(p)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda v: soft_overlap_cost(data, v, cfg)))

    history = []
    for _ in range(steps):
        c, g = grad_fn(p)
        updates, opt_state = opt.update(g, opt_state)
        p = optax.apply_updates(p, updates)
        history.append(float(c))
    final = int(overlap_cost(data, p, cfg))
    return CalibResult(params5=np.asarray(p), cost=float(final),
                       evaluations=steps, history=history)


def export_verification(data: CalibrationData, params5,
                        cfg: CalibConfig = CalibConfig(),
                        ply_path: Optional[str] = None) -> dict:
    """Verification artifact for a calibration solve.

    The reference closed its calibration loop with a human check: the PCL
    visualizer rendered the two half-rotation clouds red/green and the
    operator accepted with 'A' (m3d_calibration_twiddle.cpp:384-424,
    140-164). Headless equivalent: export the aligned half-clouds as a
    red/green .ply (any viewer opens it) plus residual statistics the
    caller can gate on before persisting the solve.

    Returns {"n_first", "n_second", "matched_fraction", "mean_nn_dist_m",
    "outlier_count", "ply_path"}: matched_fraction is the share of
    second-half points with a first-half neighbor within cfg.radius — a
    good solve on overlapping geometry scores > 0.9.
    """
    import jax.numpy as _jnp

    M = extrinsic_matrix(_jnp.asarray(params5, _jnp.float32))
    first, second = _half_clouds(data, M, cfg)
    spec = VoxelGridSpec.centered(leaf=cfg.leaf, half_extent=cfg.half_extent)
    first_ds = voxel_downsample(first, spec, capacity=cfg.capacity)
    second_ds = voxel_downsample(second, spec, capacity=cfg.capacity)
    skeys, stgt = sort_by_key(first_ds, spec)
    idx, dist = nearest_neighbors_hash(second_ds.points, skeys, stgt.points,
                                       spec, k_per_cell=2)
    m2 = np.asarray(second_ds.mask)
    d = np.asarray(dist)
    matched = m2 & (d <= cfg.radius)
    n2 = max(int(m2.sum()), 1)
    stats = {
        "n_first": int(np.asarray(first_ds.mask).sum()),
        "n_second": int(m2.sum()),
        "matched_fraction": round(float(matched.sum()) / n2, 4),
        "mean_nn_dist_m": round(float(d[matched].mean())
                                if matched.any() else float("inf"), 4),
        "outlier_count": int((m2 & ~matched).sum()),
        "ply_path": None,
    }
    if ply_path is not None:
        from tpu_slam.utils.ply import write_ply
        p1 = np.asarray(first_ds.points)[np.asarray(first_ds.mask)]
        p2 = np.asarray(second_ds.points)[m2]
        pts = np.concatenate([p1, p2])
        col = np.concatenate([
            np.tile(np.array([[220, 40, 40]], np.uint8), (len(p1), 1)),
            np.tile(np.array([[40, 200, 40]], np.uint8), (len(p2), 1))])
        stats["ply_path"] = write_ply(ply_path, pts, col)
    return stats
