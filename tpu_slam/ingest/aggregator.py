"""Full-rotation scan aggregation as a functional, jit-compiled state machine.

Functional re-design of the reference aggregator
(m3d/m3d_aggregator/src/m3d_aggregator.cpp). The reference is a mutable
accumulator fed one point at a time by ROS callbacks; here the unit of work
is one *scan line* (all beams sharing one TF transform), and the state is a
fixed-capacity pytree advanced by a pure, jittable step function — so the
whole assembly of a 3D scan stays on-device, with no per-point host traffic.

Behavioral invariants preserved (SURVEY.md §7.4 items 1-2):
  * completeness = integrated quaternion shortest-path angular distance of
    the rotation transform exceeding a threshold (default 1.1*pi)
    (m3d_aggregator.cpp:30,74-87,95-103) — NOT wall time;
  * the bounding box is an *exclusion* zone: points inside the box around
    the robot are discarded, everything outside is kept
    (m3d_aggregator.cpp:65-73);
  * progress is percent-of-rotation with 0.1 resolution, -1 when disarmed
    (m3d_aggregator.cpp:119-124);
  * emitting a cloud disarms the aggregator until re-armed by a request
    (m3d_aggregator.cpp:224-229 requestCallback; ``auto_rearm`` offers the
    continuous-SLAM convenience mode).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from tpu_slam.core import se3
from tpu_slam.core.pointcloud import PAD_COORD, PointCloud


@dataclasses.dataclass(frozen=True)
class AggregatorConfig:
    """Static aggregator configuration (hashable; a jit static arg).

    ``bbox_*`` follow the reference's param names (m3d_aggregator.cpp:164-171,
    defaults +-1 m): the robot self-filter exclusion box in the base frame.
    """

    capacity: int = 262144           # max points per aggregated 3D scan
    line_length: int = 1024          # beams per scan line (padded)
    angular_threshold: float = 1.1 * math.pi
    bb_x_up: float = 1.0
    bb_x_down: float = -1.0
    bb_y_up: float = 1.0
    bb_y_down: float = -1.0
    bb_z_up: float = 1.0
    bb_z_down: float = -1.0
    auto_rearm: bool = True


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class AggregatorState:
    """Device-resident aggregation state."""

    points: jax.Array        # (capacity, 3) float32, PAD_COORD when invalid
    intensity: jax.Array     # (capacity,) float32
    mask: jax.Array          # (capacity,) bool
    write_idx: jax.Array     # () int32 — next free slot
    angular_distance: jax.Array  # () float32 — integrated rotation sweep
    last_quat: jax.Array     # (4,) float32 xyzw of the previous line's rotation
    has_last: jax.Array      # () bool — False until the first line lands
    creating: jax.Array      # () bool — armed / disarmed
    dropped: jax.Array       # () int32 — points lost to capacity overflow


class ScanAggregator:
    """Factory + jitted step functions around :class:`AggregatorState`."""

    def __init__(self, config: AggregatorConfig = AggregatorConfig()):
        self.config = config
        self._add_line = jax.jit(partial(_add_line, config=config),
                                 static_argnames=("config",), donate_argnums=0)

    def init_state(self, armed: bool = True) -> AggregatorState:
        c = self.config
        return AggregatorState(
            points=jnp.full((c.capacity, 3), PAD_COORD, jnp.float32),
            intensity=jnp.zeros((c.capacity,), jnp.float32),
            mask=jnp.zeros((c.capacity,), bool),
            write_idx=jnp.int32(0),
            angular_distance=jnp.float32(0.0),
            last_quat=jnp.array([0.0, 0.0, 0.0, 1.0], jnp.float32),
            has_last=jnp.asarray(False),
            creating=jnp.asarray(armed),
            dropped=jnp.int32(0),
        )

    def add_line(self, state: AggregatorState, points: jax.Array,
                 valid: jax.Array, T_base_sensor: jax.Array,
                 intensity: Optional[jax.Array] = None) -> AggregatorState:
        """Integrate one scan line.

        Args:
          state: current state (donated — do not reuse after the call).
          points: (line_length, 3) float32 sensor-frame points.
          valid: (line_length,) bool — real beams (False for padding and
            out-of-range returns).
          T_base_sensor: (4, 4) base<-sensor transform at the line's stamp
            (the ingest-side analog of the TF lookup,
            m3d_aggregator.cpp:261-262).
          intensity: optional (line_length,) float32.
        """
        if intensity is None:
            intensity = jnp.zeros(points.shape[0], jnp.float32)
        return self._add_line(state, points, valid, T_base_sensor, intensity)

    def ready(self, state: AggregatorState) -> jax.Array:
        return state.angular_distance > self.config.angular_threshold

    def progress(self, state: AggregatorState) -> jax.Array:
        """Percent of rotation, 0.1 resolution; -1 when disarmed
        (m3d_aggregator.cpp:119-124)."""
        pct = 0.1 * jnp.floor(
            state.angular_distance * 1000.0 / self.config.angular_threshold)
        return jnp.where(state.creating, pct, -1.0)

    def emit(self, state: AggregatorState
             ) -> Tuple[PointCloud, AggregatorState]:
        """Snapshot the aggregated cloud and clear.

        Mirrors publishPointcloud + clearPointCloud
        (m3d_aggregator.cpp:188-223,108-114). The returned state is disarmed
        unless ``auto_rearm``.
        """
        cloud = PointCloud(points=state.points, mask=state.mask,
                           attrs=state.intensity[:, None])
        return cloud, self.init_state(armed=self.config.auto_rearm)

    def request(self, state: AggregatorState) -> AggregatorState:
        """Re-arm (clear + create), the reference's request topic semantics."""
        return self.init_state(armed=True)


def _add_line(state: AggregatorState, points: jax.Array, valid: jax.Array,
              T: jax.Array, intensity: jax.Array,
              config: AggregatorConfig) -> AggregatorState:
    L = points.shape[0]
    pts_base = se3.apply(T, points)

    # Exclusion box: keep points OUTSIDE (m3d_aggregator.cpp:65-73).
    inside = ((pts_base[:, 0] <= config.bb_x_up)
              & (pts_base[:, 0] >= config.bb_x_down)
              & (pts_base[:, 1] <= config.bb_y_up)
              & (pts_base[:, 1] >= config.bb_y_down)
              & (pts_base[:, 2] <= config.bb_z_up)
              & (pts_base[:, 2] >= config.bb_z_down))
    keep = valid & ~inside & state.creating

    # Compact the kept points of this line to its front so capacity is spent
    # on real points only (sort-based, static shape).
    order = jnp.argsort(~keep, stable=True)
    pts_c = jnp.take(pts_base, order, axis=0)
    keep_c = jnp.take(keep, order)
    int_c = jnp.take(intensity, order)
    n_keep = jnp.sum(keep_c.astype(jnp.int32))

    # Scatter into the ring buffer; slots past capacity are dropped
    # (mode="drop" keeps the write in-bounds and the shapes static).
    idx = state.write_idx + jnp.arange(L, dtype=jnp.int32)
    slot = jnp.where(keep_c, idx, config.capacity)   # invalid -> OOB drop
    new_points = state.points.at[slot].set(
        jnp.where(keep_c[:, None], pts_c, PAD_COORD), mode="drop")
    new_intensity = state.intensity.at[slot].set(int_c, mode="drop")
    new_mask = state.mask.at[slot].set(keep_c, mode="drop")
    new_write = jnp.minimum(state.write_idx + n_keep, config.capacity)
    n_dropped = state.write_idx + n_keep - new_write

    # Integrate quaternion angular distance of the line's rotation
    # (m3d_aggregator.cpp:74-87). Only when armed; first line just latches.
    q = se3.quat_from_matrix(T[:3, :3])
    d = se3.quat_angle_between(q, state.last_quat)
    d = jnp.where(jnp.isnan(d), 0.0, d)
    inc = jnp.where(state.creating & state.has_last, d, 0.0)

    return AggregatorState(
        points=new_points,
        intensity=new_intensity,
        mask=new_mask,
        write_idx=new_write,
        angular_distance=state.angular_distance + inc,
        last_quat=jnp.where(state.creating, q, state.last_quat),
        has_last=state.has_last | state.creating,
        creating=state.creating,
        dropped=state.dropped + n_dropped,
    )
