// VLP-16 data-packet decoding: raw UDP payloads -> cartesian points.
//
// The reference consumed the external velodyne_driver/velodyne_pointcloud
// C++ nodelets (m3d/m3dunit_base/launch/universal_velodyne.launch:59-81);
// this is the equivalent native hot path for the JAX stack: one pass over
// a batch of 1206-byte packets producing gated points + metadata, with the
// per-beam trig done against precomputed elevation tables. Bit-compatible
// with the pure-Python reference decoder (tpu_slam/ingest/velodyne.py),
// asserted by the parity test in tests/test_native.py.

#include "tpu_slam_native.h"

#include <cmath>
#include <cstring>
#include <vector>

namespace {

constexpr int kPacketSize = 1206;
constexpr int kBlocks = 12;
constexpr int kSeqsPerPacket = 24;
constexpr int kLasers = 16;
constexpr double kDistRes = 0.002;
constexpr double kAzScale = 0.01;          // deg per LSB
constexpr double kSeqPeriodUs = 55.296;
constexpr double kChanPeriodUs = 2.304;
constexpr double kDegToRad = 0.017453292519943295;

// VLP-16 elevation table in firing order (== ring id).
constexpr double kElevDeg[kLasers] = {-15, 1,  -13, 3,  -11, 5,  -9, 7,
                                      -7,  9,  -5,  11, -3,  13, -1, 15};

struct ElevTables {
  double ce[kLasers], se[kLasers];
  ElevTables() {
    for (int i = 0; i < kLasers; ++i) {
      ce[i] = std::cos(kElevDeg[i] * kDegToRad);
      se[i] = std::sin(kElevDeg[i] * kDegToRad);
    }
  }
};
const ElevTables kElev;

inline uint16_t rd16(const uint8_t* p) {
  return static_cast<uint16_t>(p[0] | (p[1] << 8));
}
inline uint32_t rd32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

}  // namespace

extern "C" int ts_vlp16_decode(const uint8_t* pkts, int32_t n_pkts,
                               double min_range, double max_range,
                               float* xyz, float* intensity, int32_t* ring,
                               float* azimuth_deg, double* time_s,
                               int32_t cap) {
  if (n_pkts <= 0) return 0;
  const int n_blocks = n_pkts * kBlocks;

  // pass 1: block azimuths (the x-pass of the interpolation needs the
  // NEXT block's azimuth, which may live in the next packet)
  std::vector<double> az(n_blocks);
  for (int p = 0; p < n_pkts; ++p) {
    const uint8_t* pkt = pkts + static_cast<size_t>(p) * kPacketSize;
    for (int b = 0; b < kBlocks; ++b) {
      const uint8_t* blk = pkt + b * 100;
      if (blk[0] != 0xFF || blk[1] != 0xEE) return -1;  // corrupt flag
      az[p * kBlocks + b] = rd16(blk + 2) * kAzScale;
    }
  }

  int n = 0;
  double gap = 0.0;
  for (int p = 0; p < n_pkts; ++p) {
    const uint8_t* pkt = pkts + static_cast<size_t>(p) * kPacketSize;
    const double stamp_s = rd32(pkt + 1200) * 1e-6;
    for (int b = 0; b < kBlocks; ++b) {
      const int bi = p * kBlocks + b;
      if (bi + 1 < n_blocks) {
        gap = std::fmod(az[bi + 1] - az[bi], 360.0);
        if (gap < 0) gap += 360.0;
      }  // last block reuses the previous gap (matches the Python decoder)
      const uint8_t* ch = pkt + b * 100 + 4;
      for (int seq = 0; seq < 2; ++seq) {
        double a = az[bi] + (seq ? 0.5 * gap : 0.0);
        if (a >= 360.0) a -= 360.0;
        const double ar = a * kDegToRad;
        const double ca = std::cos(ar), sa = std::sin(ar);
        const double t_seq =
            stamp_s + (b * 2 + seq) * kSeqPeriodUs * 1e-6;
        for (int l = 0; l < kLasers; ++l, ch += 3) {
          const double r = rd16(ch) * kDistRes;
          if (r < min_range || r > max_range) continue;
          if (n >= cap) return -3;  // caller buffer too small
          const double rc = r * kElev.ce[l];
          xyz[3 * n + 0] = static_cast<float>(rc * ca);
          xyz[3 * n + 1] = static_cast<float>(rc * sa);
          xyz[3 * n + 2] = static_cast<float>(r * kElev.se[l]);
          intensity[n] = static_cast<float>(ch[2]);
          ring[n] = l;
          azimuth_deg[n] = static_cast<float>(a);
          time_s[n] = t_seq + l * kChanPeriodUs * 1e-6;
          ++n;
        }
      }
    }
  }
  return n;
}
