/* tpu_slam native runtime — C API.
 *
 * The reference keeps every device-facing component in C++ (SURVEY.md §2.1
 * native-code census): the SICK CoLa-A scanner driver
 * (m3d/sick_minimal_driver/src/lms_mini_lib.{hpp,cpp}, lms_poller.cpp), the
 * rotating-unit motor protocol (m3d/m3dunit_base/src/driverLib.{hpp,cpp}),
 * and the per-beam parse hot loops. This library provides the same runtime
 * capabilities for the JAX stack, behind a plain C ABI consumed from Python
 * via ctypes (no pybind11 in the image):
 *
 *   - ts_cola_*:  CoLa-A framing + LMDscandata telegram parsing
 *   - ts_lms_*:   TCP scanner client (connect, continuous scan, poll)
 *   - ts_m3d_*:   rotating-unit motor controller client (sp/gp parameter
 *                 protocol, speed/position/angle/encoder semantics)
 *   - ts_feeder_*: double-buffered scan-line ring feeder (the host-side
 *                 data loader that keeps the device fed without Python in the
 *                 per-line path)
 */

#ifndef TPU_SLAM_NATIVE_H_
#define TPU_SLAM_NATIVE_H_

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* ------------------------------------------------------------------ */
/* CoLa-A telegram parsing                                            */
/* ------------------------------------------------------------------ */

typedef struct {
  uint32_t telegram_no;
  uint32_t scan_no;
  uint32_t time_since_startup_us;
  uint32_t time_of_transmission_us;
  float scan_frequency_hz;      /* wire unit 1/100 Hz */
  float scale_factor;           /* DIST1 scale (hex float on the wire) */
  float start_angle_deg;        /* 1e-4 deg wire units */
  float ang_step_deg;
  int32_t n_dist;               /* samples in DIST1 */
  int32_t n_rssi;               /* samples in RSSI1 (0 if absent) */
} ts_scan_meta;

/* Extract complete STX..ETX frames from a byte stream.
 * Scans buf[0..len); on success returns 1 and sets *start/*end to the
 * payload range of the FIRST complete frame (exclusive of framing bytes)
 * and *consumed to the index one past its ETX. Returns 0 when no complete
 * frame is present (consumed = index of the pending STX, or len). */
int ts_cola_next_frame(const uint8_t* buf, size_t len, size_t* start,
                       size_t* end, size_t* consumed);

/* Parse one LMDscandata payload. ranges_m / intensities are caller buffers
 * of capacity cap; ranges are scaled to meters (0.001 * scale factor,
 * lms_poller.cpp:84-92). Returns 0 on success, negative error code
 * otherwise (-1 malformed, -2 not LMDscandata, -3 capacity). */
int ts_cola_parse_scan(const uint8_t* payload, size_t len, ts_scan_meta* meta,
                       float* ranges_m, float* intensities, int32_t cap);

/* Multi-echo variant: parses DIST1..DIST{max_echoes} / RSSI1..RSSI{max_
 * echoes} (reference lms_mini_lib.cpp:170-208). ranges_m / intensities are
 * echo-major (max_echoes x cap) buffers; n_dist_per_echo / n_rssi_per_echo
 * (int32[max_echoes], may be NULL) receive per-echo sample counts (0 =
 * channel absent). DIST1 is mandatory; meta describes echo 1. */
int ts_cola_parse_scan_multi(const uint8_t* payload, size_t len,
                             ts_scan_meta* meta, float* ranges_m,
                             float* intensities, int32_t cap,
                             int32_t max_echoes, int32_t* n_dist_per_echo,
                             int32_t* n_rssi_per_echo);

/* ------------------------------------------------------------------ */
/* SICK LMS TCP client                                                */
/* ------------------------------------------------------------------ */

typedef struct ts_lms ts_lms;

ts_lms* ts_lms_create(void);
void ts_lms_destroy(ts_lms* h);
/* Connect to host:port (default CoLa port 2111). Returns 0 on success. */
int ts_lms_connect(ts_lms* h, const char* host, int port, int timeout_ms);
/* Request continuous scan streaming ("sEN LMDscandata 1"). */
int ts_lms_start_scan(ts_lms* h);
/* Block up to timeout_ms for the next complete telegram; parse into the
 * caller buffers. Returns 0 on success, -4 timeout, else parse errors. */
int ts_lms_poll(ts_lms* h, ts_scan_meta* meta, float* ranges_m,
                float* intensities, int32_t cap, int timeout_ms);

/* ------------------------------------------------------------------ */
/* m3d rotating-unit motor controller                                 */
/* ------------------------------------------------------------------ */

typedef struct ts_m3d ts_m3d;

ts_m3d* ts_m3d_create(void);
void ts_m3d_destroy(ts_m3d* h);
/* TCP transport (driverLib.cpp:34-47, port 10001). */
int ts_m3d_connect_tcp(ts_m3d* h, const char* host, int port,
                       int timeout_ms);
/* Serial transport (driverLib.cpp:10-32; reference baud 57600, 8N1 raw).
 * device: tty path, e.g. /dev/ttyUSB0. */
int ts_m3d_connect_serial(ts_m3d* h, const char* device, int baud,
                          int timeout_ms);
/* Write parameter: "sp <idx>h.<sub>h <val>" -> expects echo ack
 * (driverLib.cpp:64-105). Returns 0 on ack. */
int ts_m3d_write_param(ts_m3d* h, int index, int subindex, int value);
/* Read parameter: "gp <idx>h.<sub>h"; parses "... <idx>h.<sub>h <val>"
 * (driverLib.cpp:107-171). Returns 0 and sets *value. */
int ts_m3d_get_param(ts_m3d* h, int index, int subindex, int* value);
/* Velocity mode + speed + restart (driverLib.cpp:242-261: 0x3003.0=3,
 * 0x3000.10=speed, 0x3000.1=0 then 49). */
int ts_m3d_set_speed(ts_m3d* h, int speed);
/* Position mode (driverLib.cpp:173-199: mode 7, speed, target ticks =
 * pos/2pi * enc_res, stop, start 51 relative / 52 absolute). */
int ts_m3d_set_position(ts_m3d* h, double pos_rad, int speed, int relative);
/* Encoder resolution = 4 * controller value (driverLib.cpp:230-241). */
int ts_m3d_get_encoder_res(ts_m3d* h, int* enc_res);
/* Angle = -2*pi*(ticks mod enc_res)/enc_res (driverLib.cpp:202-217).
 * Requires a prior ts_m3d_get_encoder_res. */
int ts_m3d_get_angle(ts_m3d* h, double* angle_rad);
/* Supply voltage telemetry (driverLib.cpp:219-229). */
int ts_m3d_get_voltage(ts_m3d* h, int* value);
/* Homing offset write + EEPROM save (setoffset.cpp:61-70: 0x37B3.0=offset,
 * 0x1010.1=0x65766173 "save"). */
int ts_m3d_set_homing_offset(ts_m3d* h, int offset);

/* ------------------------------------------------------------------ */
/* VLP-16 packet decoding                                             */
/* ------------------------------------------------------------------ */

/* Decode n_pkts raw 1206-byte VLP-16 data packets into range-gated
 * cartesian points (sensor frame, azimuth-major then ring order).
 * Caller buffers: xyz (cap*3), intensity/azimuth_deg (cap), ring (cap),
 * time_s (cap, absolute device seconds). Returns the point count,
 * -1 on a corrupt block flag, -3 when cap is too small. Parity-tested
 * against the pure-Python decoder (tpu_slam/ingest/velodyne.py). */
int ts_vlp16_decode(const uint8_t* pkts, int32_t n_pkts, double min_range,
                    double max_range, float* xyz, float* intensity,
                    int32_t* ring, float* azimuth_deg, double* time_s,
                    int32_t cap);

/* ------------------------------------------------------------------ */
/* Double-buffered scan-line feeder                                   */
/* ------------------------------------------------------------------ */

typedef struct ts_feeder ts_feeder;

/* n_slots ring slots, each holding up to line_cap beams
 * (ranges + intensities + a stamp + an encoder angle). */
ts_feeder* ts_feeder_create(int n_slots, int line_cap);
void ts_feeder_destroy(ts_feeder* f);
/* Producer side: push one scan line (copies). Returns 0, or -1 when the
 * ring is full (consumer fell behind; line dropped and counted). */
int ts_feeder_push(ts_feeder* f, const float* ranges, const float* intens,
                   int n, double stamp, double encoder_angle);
/* Consumer side: pop the oldest line into caller buffers; blocks up to
 * timeout_ms. Returns beam count, -4 on timeout. */
int ts_feeder_pop(ts_feeder* f, float* ranges, float* intens, int cap,
                  double* stamp, double* encoder_angle, int timeout_ms);
/* Number of lines dropped because the ring was full. */
long ts_feeder_dropped(const ts_feeder* f);
/* Lines currently queued. */
int ts_feeder_depth(const ts_feeder* f);

#ifdef __cplusplus
}
#endif

#endif /* TPU_SLAM_NATIVE_H_ */
