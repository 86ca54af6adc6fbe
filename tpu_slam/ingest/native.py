"""ctypes bindings for the native runtime (native/src, libtpu_slam_native).

The C++ library carries the device-facing runtime — CoLa-A parsing, the
SICK TCP client, the rotating-unit motor protocol, and the scan-line
feeder (see native/src/tpu_slam_native.h, runtime twin of the reference's
C++ driver stack). Python stays out of the per-line hot path; these
bindings exist for pipeline orchestration and tests.

``load()`` returns None when the library isn't built — callers fall back
to the pure-Python parsers (ingest.sick_cola) which are behaviorally
identical (asserted by tests/test_native.py parity tests).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_PATHS = [
    os.path.join(_REPO_ROOT, "native", "build", "libtpu_slam_native.so"),
    "libtpu_slam_native.so",
]


class ScanMeta(ctypes.Structure):
    _fields_ = [
        ("telegram_no", ctypes.c_uint32),
        ("scan_no", ctypes.c_uint32),
        ("time_since_startup_us", ctypes.c_uint32),
        ("time_of_transmission_us", ctypes.c_uint32),
        ("scan_frequency_hz", ctypes.c_float),
        ("scale_factor", ctypes.c_float),
        ("start_angle_deg", ctypes.c_float),
        ("ang_step_deg", ctypes.c_float),
        ("n_dist", ctypes.c_int32),
        ("n_rssi", ctypes.c_int32),
    ]


def load(path: Optional[str] = None) -> Optional[ctypes.CDLL]:
    """Load the native library; returns None when unavailable."""
    global _LIB, _TRIED
    if _LIB is not None:
        return _LIB
    if _TRIED and path is None:
        return None
    _TRIED = True
    candidates = [path] if path else DEFAULT_PATHS
    for p in candidates:
        try:
            lib = ctypes.CDLL(p)
        except OSError:
            continue
        _configure(lib)
        _LIB = lib
        return lib
    return None


def _configure(lib: ctypes.CDLL):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    szp = ctypes.POINTER(ctypes.c_size_t)

    lib.ts_cola_next_frame.restype = ctypes.c_int
    lib.ts_cola_next_frame.argtypes = [u8p, ctypes.c_size_t, szp, szp, szp]
    lib.ts_cola_parse_scan.restype = ctypes.c_int
    lib.ts_cola_parse_scan.argtypes = [u8p, ctypes.c_size_t,
                                       ctypes.POINTER(ScanMeta), f32p, f32p,
                                       ctypes.c_int32]
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.ts_cola_parse_scan_multi.restype = ctypes.c_int
    lib.ts_cola_parse_scan_multi.argtypes = [
        u8p, ctypes.c_size_t, ctypes.POINTER(ScanMeta), f32p, f32p,
        ctypes.c_int32, ctypes.c_int32, i32p, i32p]

    lib.ts_lms_create.restype = ctypes.c_void_p
    lib.ts_lms_destroy.argtypes = [ctypes.c_void_p]
    lib.ts_lms_connect.restype = ctypes.c_int
    lib.ts_lms_connect.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                   ctypes.c_int, ctypes.c_int]
    lib.ts_lms_start_scan.restype = ctypes.c_int
    lib.ts_lms_start_scan.argtypes = [ctypes.c_void_p]
    lib.ts_lms_poll.restype = ctypes.c_int
    lib.ts_lms_poll.argtypes = [ctypes.c_void_p, ctypes.POINTER(ScanMeta),
                                f32p, f32p, ctypes.c_int32, ctypes.c_int]

    lib.ts_m3d_create.restype = ctypes.c_void_p
    lib.ts_m3d_destroy.argtypes = [ctypes.c_void_p]
    lib.ts_m3d_connect_tcp.restype = ctypes.c_int
    lib.ts_m3d_connect_tcp.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_int, ctypes.c_int]
    lib.ts_m3d_connect_serial.restype = ctypes.c_int
    lib.ts_m3d_connect_serial.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_int, ctypes.c_int]
    for name in ["ts_m3d_write_param"]:
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int]
    lib.ts_m3d_get_param.restype = ctypes.c_int
    lib.ts_m3d_get_param.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int,
                                     ctypes.POINTER(ctypes.c_int)]
    lib.ts_m3d_set_speed.restype = ctypes.c_int
    lib.ts_m3d_set_speed.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ts_m3d_set_position.restype = ctypes.c_int
    lib.ts_m3d_set_position.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                        ctypes.c_int, ctypes.c_int]
    lib.ts_m3d_get_encoder_res.restype = ctypes.c_int
    lib.ts_m3d_get_encoder_res.argtypes = [ctypes.c_void_p,
                                           ctypes.POINTER(ctypes.c_int)]
    lib.ts_m3d_get_angle.restype = ctypes.c_int
    lib.ts_m3d_get_angle.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_double)]
    lib.ts_m3d_get_voltage.restype = ctypes.c_int
    lib.ts_m3d_get_voltage.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int)]
    lib.ts_m3d_set_homing_offset.restype = ctypes.c_int
    lib.ts_m3d_set_homing_offset.argtypes = [ctypes.c_void_p, ctypes.c_int]

    lib.ts_vlp16_decode.restype = ctypes.c_int
    lib.ts_vlp16_decode.argtypes = [u8p, ctypes.c_int32, ctypes.c_double,
                                    ctypes.c_double, f32p, f32p,
                                    ctypes.POINTER(ctypes.c_int32), f32p,
                                    ctypes.POINTER(ctypes.c_double),
                                    ctypes.c_int32]

    lib.ts_feeder_create.restype = ctypes.c_void_p
    lib.ts_feeder_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ts_feeder_destroy.argtypes = [ctypes.c_void_p]
    lib.ts_feeder_push.restype = ctypes.c_int
    lib.ts_feeder_push.argtypes = [ctypes.c_void_p, f32p, f32p, ctypes.c_int,
                                   ctypes.c_double, ctypes.c_double]
    lib.ts_feeder_pop.restype = ctypes.c_int
    lib.ts_feeder_pop.argtypes = [ctypes.c_void_p, f32p, f32p, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_double),
                                  ctypes.POINTER(ctypes.c_double),
                                  ctypes.c_int]
    lib.ts_feeder_dropped.restype = ctypes.c_long
    lib.ts_feeder_dropped.argtypes = [ctypes.c_void_p]
    lib.ts_feeder_depth.restype = ctypes.c_int
    lib.ts_feeder_depth.argtypes = [ctypes.c_void_p]


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def parse_telegram_native(payload: bytes, cap: int = 4096
                          ) -> Tuple[ScanMeta, np.ndarray, np.ndarray]:
    """Parse an LMDscandata payload through the C++ parser."""
    lib = load()
    if lib is None:
        raise RuntimeError("native library not built (make native)")
    buf = np.frombuffer(payload, dtype=np.uint8)
    meta = ScanMeta()
    ranges = np.zeros(cap, np.float32)
    intens = np.zeros(cap, np.float32)
    rc = lib.ts_cola_parse_scan(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(payload),
        ctypes.byref(meta), _f32p(ranges), _f32p(intens), cap)
    if rc != 0:
        raise ValueError(f"native parse failed: {rc}")
    return meta, ranges[:meta.n_dist].copy(), intens[:meta.n_rssi].copy()


def parse_telegram_native_multi(payload: bytes, cap: int = 4096,
                                max_echoes: int = 5):
    """Parse an LMDscandata payload with ALL echo channels (DIST1..5 /
    RSSI1..5, reference lms_mini_lib.cpp:170-208) through the C++ parser.

    Returns (meta, dist_echoes, rssi_echoes): lists of per-echo float32
    arrays, one entry per PRESENT channel (echo order, gaps dropped).
    """
    lib = load()
    if lib is None:
        raise RuntimeError("native library not built (make native)")
    buf = np.frombuffer(payload, dtype=np.uint8)
    meta = ScanMeta()
    ranges = np.zeros((max_echoes, cap), np.float32)
    intens = np.zeros((max_echoes, cap), np.float32)
    n_dist = np.zeros(max_echoes, np.int32)
    n_rssi = np.zeros(max_echoes, np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    rc = lib.ts_cola_parse_scan_multi(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(payload),
        ctypes.byref(meta), _f32p(ranges), _f32p(intens), cap, max_echoes,
        n_dist.ctypes.data_as(i32p), n_rssi.ctypes.data_as(i32p))
    if rc != 0:
        raise ValueError(f"native multi-echo parse failed: {rc}")
    dists = [ranges[e, :n_dist[e]].copy() for e in range(max_echoes)
             if n_dist[e] > 0]
    rssis = [intens[e, :n_rssi[e]].copy() for e in range(max_echoes)
             if n_rssi[e] > 0]
    return meta, dists, rssis


class NativeLms:
    """SICK LMS client over the native TCP driver."""

    def __init__(self, cap: int = 4096):
        self.lib = load()
        if self.lib is None:
            raise RuntimeError("native library not built (make native)")
        self.h = self.lib.ts_lms_create()
        self.cap = cap

    def connect(self, host: str, port: int = 2111, timeout_ms: int = 2000):
        rc = self.lib.ts_lms_connect(self.h, host.encode(), port, timeout_ms)
        if rc != 0:
            raise ConnectionError(f"lms connect failed: {rc}")

    def start_scan(self):
        rc = self.lib.ts_lms_start_scan(self.h)
        if rc != 0:
            raise ConnectionError(f"start_scan failed: {rc}")

    def poll(self, timeout_ms: int = 1000):
        meta = ScanMeta()
        ranges = np.zeros(self.cap, np.float32)
        intens = np.zeros(self.cap, np.float32)
        rc = self.lib.ts_lms_poll(self.h, ctypes.byref(meta), _f32p(ranges),
                                  _f32p(intens), self.cap, timeout_ms)
        if rc == -4:
            return None
        if rc != 0:
            raise ConnectionError(f"poll failed: {rc}")
        return meta, ranges[:meta.n_dist].copy(), intens[:meta.n_rssi].copy()

    def close(self):
        if self.h:
            self.lib.ts_lms_destroy(self.h)
            self.h = None


class NativeM3d:
    """Rotating-unit motor controller client over the native driver."""

    def __init__(self):
        self.lib = load()
        if self.lib is None:
            raise RuntimeError("native library not built (make native)")
        self.h = self.lib.ts_m3d_create()

    def connect_tcp(self, host: str, port: int = 10001,
                    timeout_ms: int = 2000):
        rc = self.lib.ts_m3d_connect_tcp(self.h, host.encode(), port,
                                         timeout_ms)
        if rc != 0:
            raise ConnectionError(f"m3d connect failed: {rc}")

    def connect_serial(self, device: str, baud: int = 57600,
                       timeout_ms: int = 2000):
        """Serial transport (driverLib.cpp:10-32, default 57600 baud)."""
        rc = self.lib.ts_m3d_connect_serial(self.h, device.encode(), baud,
                                            timeout_ms)
        if rc != 0:
            raise ConnectionError(f"m3d serial connect failed: {rc}")

    def write_param(self, index: int, sub: int, value: int):
        rc = self.lib.ts_m3d_write_param(self.h, index, sub, value)
        if rc != 0:
            raise ConnectionError(f"write_param failed: {rc}")

    def get_param(self, index: int, sub: int) -> int:
        v = ctypes.c_int()
        rc = self.lib.ts_m3d_get_param(self.h, index, sub, ctypes.byref(v))
        if rc != 0:
            raise ConnectionError(f"get_param failed: {rc}")
        return v.value

    def set_speed(self, speed: int):
        rc = self.lib.ts_m3d_set_speed(self.h, speed)
        if rc != 0:
            raise ConnectionError(f"set_speed failed: {rc}")

    def set_position(self, pos_rad: float, speed: int, relative: bool):
        rc = self.lib.ts_m3d_set_position(self.h, pos_rad, speed,
                                          1 if relative else 0)
        if rc != 0:
            raise ConnectionError(f"set_position failed: {rc}")

    def encoder_res(self) -> int:
        v = ctypes.c_int()
        rc = self.lib.ts_m3d_get_encoder_res(self.h, ctypes.byref(v))
        if rc != 0:
            raise ConnectionError(f"get_encoder_res failed: {rc}")
        return v.value

    def angle(self) -> float:
        v = ctypes.c_double()
        rc = self.lib.ts_m3d_get_angle(self.h, ctypes.byref(v))
        if rc != 0:
            raise ConnectionError(f"get_angle failed: {rc}")
        return v.value

    def set_homing_offset(self, offset: int):
        rc = self.lib.ts_m3d_set_homing_offset(self.h, offset)
        if rc != 0:
            raise ConnectionError(f"set_homing_offset failed: {rc}")

    def close(self):
        if self.h:
            self.lib.ts_m3d_destroy(self.h)
            self.h = None


class NativeFeeder:
    """Double-buffered scan-line ring between producer thread and device feed."""

    def __init__(self, n_slots: int, line_cap: int):
        self.lib = load()
        if self.lib is None:
            raise RuntimeError("native library not built (make native)")
        self.h = self.lib.ts_feeder_create(n_slots, line_cap)
        self.cap = line_cap

    def push(self, ranges: np.ndarray, intens: Optional[np.ndarray],
             stamp: float, angle: float) -> bool:
        r = np.ascontiguousarray(ranges, np.float32)
        i = (None if intens is None
             else np.ascontiguousarray(intens, np.float32))
        rc = self.lib.ts_feeder_push(
            self.h, _f32p(r), _f32p(i) if i is not None else None,
            len(r), stamp, angle)
        return rc == 0

    def pop(self, timeout_ms: int = 1000):
        ranges = np.zeros(self.cap, np.float32)
        intens = np.zeros(self.cap, np.float32)
        stamp = ctypes.c_double()
        angle = ctypes.c_double()
        n = self.lib.ts_feeder_pop(self.h, _f32p(ranges), _f32p(intens),
                                   self.cap, ctypes.byref(stamp),
                                   ctypes.byref(angle), timeout_ms)
        if n == -4:
            return None
        if n < 0:
            raise RuntimeError(f"feeder pop failed: {n}")
        return ranges[:n], intens[:n], stamp.value, angle.value

    @property
    def dropped(self) -> int:
        return self.lib.ts_feeder_dropped(self.h)

    @property
    def depth(self) -> int:
        return self.lib.ts_feeder_depth(self.h)

    def close(self):
        if self.h:
            self.lib.ts_feeder_destroy(self.h)
            self.h = None


def vlp16_decode_native(packets: np.ndarray, min_range: float = 0.4,
                        max_range: float = 130.0,
                        cap: Optional[int] = None):
    """Decode VLP-16 packets through the C++ hot path (ts_vlp16_decode).

    Same output contract as the pure-Python
    velodyne.parse_packet_batch -> sequences_to_points chain (parity test
    in tests/test_native.py). Returns (points (N, 3) f32, intensity (N,),
    ring (N,) i32, azimuth_rad (N,) f32, time_s (N,) f64).
    """
    lib = load()
    if lib is None:
        raise RuntimeError("native library not built (make native)")
    pkts = np.ascontiguousarray(np.atleast_2d(packets), np.uint8)
    n_pkts = pkts.shape[0]
    if cap is None:
        cap = n_pkts * 24 * 16
    xyz = np.zeros((cap, 3), np.float32)
    inten = np.zeros(cap, np.float32)
    ring = np.zeros(cap, np.int32)
    az = np.zeros(cap, np.float32)
    t = np.zeros(cap, np.float64)
    n = lib.ts_vlp16_decode(
        pkts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n_pkts,
        min_range, max_range, _f32p(xyz), _f32p(inten),
        ring.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _f32p(az),
        t.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), cap)
    if n < 0:
        raise ValueError(f"native VLP-16 decode failed: {n}")
    return (xyz[:n].copy(), inten[:n].copy(), ring[:n].copy(),
            np.radians(az[:n]).astype(np.float32), t[:n].copy())
