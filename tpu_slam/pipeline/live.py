"""The composed live pipeline: device stream -> 3D scans -> SLAM.

The runtime twin of the reference's full bringup (SURVEY.md §3.1/§3.4,
universal.launch:4-49 + m3d_husky_bringup.launch:1-15): where the
reference wires lms_poller -> (TF from encoder_node_li) -> m3d_aggregator
-> gpu_6dslam_node through ROS topics, this pipeline wires

    NativeLms (C++ TCP poller)  --producer thread-->  NativeFeeder (C++
    ring)  --consumer-->  polar->cartesian  ->  FrameChain (encoder TF)
    ->  ScanAggregator (jitted accumulation)  ->  SLAMSystem

in one process, with the per-line hot path in native code and everything
from the aggregator down on-device. The encoder angle is sampled at line
arrival (the producer side), standing in for the reference's
time-interpolated TF lookup (m3d_aggregator.cpp:261-262).
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from tpu_slam.ingest.aggregator import AggregatorConfig, ScanAggregator
from tpu_slam.ingest.frames import FrameChain, SensorModel
from tpu_slam.ingest.native import NativeFeeder, NativeLms


@dataclasses.dataclass(frozen=True)
class LiveConfig:
    """Static configuration of the live chain."""

    sensor_model: str = "LMS100"
    line_capacity: int = 1024        # padded beams per line (static shape)
    range_min: float = 0.01          # lms_poller.cpp:26-29 params
    range_max: float = 100.0
    start_angle_deg: float = -45.0   # startAngle param (lms_poller.cpp:74)
    invert_scan: bool = False        # mirror-mounted scanner
    feeder_slots: int = 128
    poll_timeout_ms: int = 2000
    aggregator: AggregatorConfig = AggregatorConfig(line_length=1024)


class LivePipeline:
    """Feed from a connected NativeLms; produce 3D scans (and SLAM poses).

    ``angle_source`` is called once per scan line (producer side) and must
    return the current encoder angle in radians — live hardware passes
    ``NativeM3d.angle``; tests/simulation pass a profile.
    """

    def __init__(self, config: LiveConfig, chain: Optional[FrameChain] = None,
                 slam=None):
        if config.aggregator.line_length != config.line_capacity:
            raise ValueError("aggregator.line_length must equal "
                             "line_capacity")
        self.config = config
        self.chain = chain or FrameChain(
            sensor=SensorModel.by_name(config.sensor_model))
        self.slam = slam
        self.aggregator = ScanAggregator(config.aggregator)
        self._dirs = None            # (L, 3) beam direction table
        self._producer_done = threading.Event()
        self._producer_error: Optional[BaseException] = None
        self._enc_hist = None        # EncoderHistory when interpolating
        self.line_angles: List[Tuple[float, float]] = []  # (t, angle) used

    # -- producer ----------------------------------------------------------

    def _produce(self, lms: NativeLms, feeder: NativeFeeder,
                 angle_source: Optional[Callable[[], float]],
                 max_lines: Optional[int]) -> None:
        n = 0
        interp = self._enc_hist is not None
        try:
            while max_lines is None or n < max_lines:
                out = lms.poll(timeout_ms=self.config.poll_timeout_ms)
                if out is None:                      # poll timeout
                    break
                meta, ranges, intens = out
                if self._dirs is None:
                    self._meta0 = meta
                if intens.size != ranges.size:
                    intens = np.zeros_like(ranges)
                # interpolated mode: the feeder's angle slot carries the
                # line's host ARRIVAL time RELATIVE to run start — the slot
                # is float32, and absolute monotonic time (~1e4 s) would
                # lose ~50 ms of precision in it. The consumer interpolates
                # the encoder history at it (the reference's
                # time-interpolated TF join, m3d_aggregator.cpp:261-262).
                # Legacy mode: sample the angle source at arrival.
                a = (time.monotonic() - self._t_ref if interp
                     else float(angle_source()))
                feeder.push(ranges, intens,
                            stamp=meta.time_since_startup_us * 1e-6,
                            angle=a)
                n += 1
        except ConnectionError:
            pass                                     # device closed: drain
        except BaseException as e:                   # surface in run()
            self._producer_error = e
        finally:
            self._producer_done.set()

    # -- consumer ----------------------------------------------------------

    def _directions(self, n_beams: int) -> np.ndarray:
        """Beam direction table from the first telegram's metadata
        (polar->cartesian of m3d_aggregator.cpp:269-286 with the
        startAngle override of lms_poller.cpp:74-100)."""
        if self._dirs is not None and self._dirs.shape[0] == n_beams:
            return self._dirs
        meta = getattr(self, "_meta0", None)
        step = math.radians(meta.ang_step_deg) if meta else math.radians(0.5)
        a0 = math.radians(self.config.start_angle_deg)
        ang = a0 + step * np.arange(n_beams)
        if self.config.invert_scan:
            ang = ang[::-1].copy()
        self._dirs = np.stack([np.cos(ang), np.sin(ang),
                               np.zeros(n_beams)], axis=1).astype(np.float32)
        return self._dirs

    def run(self, lms: NativeLms,
            angle_source: Callable[[], float],
            max_scans: Optional[int] = None,
            max_lines: Optional[int] = None,
            on_scan: Optional[Callable] = None,
            encoder_rate_hz: float = 0.0) -> List[Tuple]:
        """Drive the chain until the stream ends or ``max_scans`` emitted.

        Returns a list of (cloud, slam_metrics_or_None) per emitted 3D
        scan; when a SLAMSystem was supplied each emitted cloud is also
        fed through it.

        ``encoder_rate_hz`` > 0 enables the time-interpolated encoder
        join: a sampler thread polls ``angle_source`` at that rate into an
        EncoderHistory, and each line's angle is INTERPOLATED at the
        line's arrival time (the reference's TF-buffer lookup,
        m3d_aggregator.cpp:261-262) instead of sampled once per line.
        The angles actually used are recorded in ``self.line_angles``.
        """
        import jax
        import jax.numpy as jnp

        cfg = self.config
        sampler = None
        self._enc_hist = None
        self._sampler_stop = threading.Event()
        self.line_angles = []
        if encoder_rate_hz > 0:
            from tpu_slam.ingest.frames import EncoderHistory
            hist = EncoderHistory()
            self._enc_hist = hist

            def _sample():
                # unwrap correctness needs consecutive samples < pi apart:
                # encoder_rate_hz must exceed rotation_speed / pi (500 Hz
                # covers any physical unit speed). The sampler outlives the
                # PRODUCER on purpose: lines backlogged in the device
                # socket during jit warm-up are burst-drained in ~10 ms,
                # and the consumer must still find bracketing samples for
                # them while it works through the feeder queue.
                period = 1.0 / encoder_rate_hz
                while not self._sampler_stop.is_set():
                    hist.push(time.monotonic() - self._t_ref,
                              float(angle_source()))
                    time.sleep(period)

            sampler = threading.Thread(target=_sample, daemon=True)
        feeder = NativeFeeder(cfg.feeder_slots, cfg.line_capacity)
        producer = threading.Thread(
            target=self._produce, args=(lms, feeder, angle_source, max_lines),
            daemon=True)
        # warm up the jitted accumulation BEFORE the stream opens: the
        # first compile takes seconds, during which the feeder ring would
        # overflow and drop real lines
        warm = self.aggregator.init_state()
        L = cfg.line_capacity
        warm = self.aggregator.add_line(
            warm, jnp.zeros((L, 3), jnp.float32), jnp.zeros((L,), bool),
            jnp.eye(4, dtype=jnp.float32), jnp.zeros((L,), jnp.float32))
        jax.block_until_ready(warm.write_idx)
        del warm
        agg_state = self.aggregator.init_state()
        slam_state = self.slam.init_state() if self.slam is not None else None
        results: List[Tuple] = []
        if sampler is not None:
            # t_ref AFTER the warm-up compile: a reference sample taken
            # minutes earlier would be > pi of rotation away from the
            # sampler's first sample and fold the unwrap by 2 pi
            self._t_ref = time.monotonic()
            self._enc_hist.push(0.0, float(angle_source()))
            sampler.start()
        producer.start()
        try:
            while max_scans is None or len(results) < max_scans:
                out = feeder.pop(timeout_ms=100)
                if out is None:
                    if self._producer_done.is_set() and feeder.depth == 0:
                        break
                    continue
                ranges, intens, stamp, angle = out
                if self._enc_hist is not None:
                    q = float(angle)              # line arrival, rel. t_ref
                    t_arr = self._t_ref + q
                    # bounded bracket wait: interpolation is only exact
                    # between two samples; a query past the newest sample
                    # would clamp/extrapolate. The sampler pushes every
                    # 1/encoder_rate_hz, so one fresh sample is at most a
                    # period away — wait up to ~5 periods for it.
                    deadline = time.monotonic() + 5.0 / encoder_rate_hz
                    while (self._enc_hist.newest_t() < q
                           and time.monotonic() < deadline):
                        time.sleep(0.25 / encoder_rate_hz)
                    angle = self._enc_hist.at(q)
                    self.line_angles.append((t_arr, angle))
                n = ranges.shape[0]
                dirs = self._directions(n)
                pts = dirs * ranges[:, None]
                valid = (ranges >= cfg.range_min) & (ranges <= cfg.range_max)
                L = cfg.line_capacity
                pts_p = np.zeros((L, 3), np.float32)
                val_p = np.zeros((L,), bool)
                int_p = np.zeros((L,), np.float32)
                pts_p[:n], val_p[:n], int_p[:n] = pts, valid, intens
                T = self.chain.base_from_laser(jnp.float32(angle))
                agg_state = self.aggregator.add_line(
                    agg_state, jnp.asarray(pts_p), jnp.asarray(val_p), T,
                    jnp.asarray(int_p))
                if bool(self.aggregator.ready(agg_state)):
                    cloud, agg_state = self.aggregator.emit(agg_state)
                    metrics = None
                    if self.slam is not None:
                        slam_state, metrics = self.slam.step(slam_state,
                                                             cloud)
                    results.append((cloud, metrics))
                    if on_scan is not None:
                        on_scan(cloud, metrics)
        finally:
            self._producer_done.wait(timeout=cfg.poll_timeout_ms / 1e3 + 1.0)
            producer.join(timeout=2.0)
            self._sampler_stop.set()
            feeder.close()
        if self._producer_error is not None:
            raise self._producer_error
        self.slam_state = slam_state
        return results

    # -- second (front) static laser ----------------------------------------

    def run_front(self, lms: NativeLms,
                  on_line: Callable[[np.ndarray, np.ndarray, float], None],
                  max_lines: Optional[int] = None,
                  sensor_model: Optional[str] = None) -> int:
        """Stream the front-facing STATIC laser (universal.launch's second
        SICK; TF at encoder_node_li.cpp:83-85) into base-frame planar scans.

        Each polled line is expanded to cartesian points and transformed by
        the fixed front-link chain; ``on_line(points_base, valid, stamp)``
        receives them (navigation/obstacle consumers in the reference).
        Returns the number of lines delivered. Run in its own thread
        alongside ``run`` for the full two-scanner bringup.
        """
        from tpu_slam.ingest.frames import front_laser_transform

        cfg = self.config
        sm = SensorModel.by_name(sensor_model or cfg.sensor_model)
        T = np.asarray(front_laser_transform(sm))
        dirs = None
        n = 0
        while max_lines is None or n < max_lines:
            out = lms.poll(timeout_ms=cfg.poll_timeout_ms)
            if out is None:
                break
            meta, ranges, _ = out
            if dirs is None or dirs.shape[0] != ranges.shape[0]:
                step = math.radians(meta.ang_step_deg)
                ang = (math.radians(cfg.start_angle_deg)
                       + step * np.arange(ranges.shape[0]))
                if cfg.invert_scan:
                    ang = ang[::-1].copy()
                dirs = np.stack([np.cos(ang), np.sin(ang),
                                 np.zeros_like(ang)], axis=1)
            pts = (dirs * ranges[:, None]) @ T[:3, :3].T + T[:3, 3]
            valid = (ranges >= cfg.range_min) & (ranges <= cfg.range_max)
            on_line(pts.astype(np.float32), valid,
                    meta.time_since_startup_us * 1e-6)
            n += 1
        return n
