// Double-buffered scan-line feeder: the host-side data loader.
//
// The reference's per-line path runs through ROS message passing; here a
// lock-guarded ring of preallocated slots carries scan lines from the
// device/replay producer thread to the device feed (the PP-analog
// double-buffered scan queue of SURVEY.md §2.3). Preallocated slots, no
// per-line malloc; full-ring pushes drop the line and count it (matching
// the reference's queue_size=1 subscriber semantics of dropping stale
// data rather than stalling the device).

#include <chrono>
#include <condition_variable>
#include <cstring>
#include <mutex>
#include <vector>

#include "tpu_slam_native.h"

struct Slot {
  std::vector<float> ranges;
  std::vector<float> intens;
  int n = 0;
  double stamp = 0.0;
  double angle = 0.0;
};

struct ts_feeder {
  std::vector<Slot> slots;
  int head = 0;  // next pop
  int tail = 0;  // next push
  int count = 0;
  long dropped = 0;
  int line_cap;
  std::mutex mu;
  std::condition_variable cv;
};

extern "C" ts_feeder* ts_feeder_create(int n_slots, int line_cap) {
  if (n_slots <= 0 || line_cap <= 0) return nullptr;
  auto* f = new ts_feeder();
  f->slots.resize(static_cast<size_t>(n_slots));
  for (auto& s : f->slots) {
    s.ranges.resize(static_cast<size_t>(line_cap));
    s.intens.resize(static_cast<size_t>(line_cap));
  }
  f->line_cap = line_cap;
  return f;
}

extern "C" void ts_feeder_destroy(ts_feeder* f) { delete f; }

extern "C" int ts_feeder_push(ts_feeder* f, const float* ranges,
                              const float* intens, int n, double stamp,
                              double encoder_angle) {
  if (n < 0 || n > f->line_cap) return -2;
  {
    std::lock_guard<std::mutex> lk(f->mu);
    if (f->count == static_cast<int>(f->slots.size())) {
      ++f->dropped;
      return -1;
    }
    Slot& s = f->slots[static_cast<size_t>(f->tail)];
    memcpy(s.ranges.data(), ranges, sizeof(float) * static_cast<size_t>(n));
    if (intens) {
      memcpy(s.intens.data(), intens, sizeof(float) * static_cast<size_t>(n));
    } else {
      memset(s.intens.data(), 0, sizeof(float) * static_cast<size_t>(n));
    }
    s.n = n;
    s.stamp = stamp;
    s.angle = encoder_angle;
    f->tail = (f->tail + 1) % static_cast<int>(f->slots.size());
    ++f->count;
  }
  f->cv.notify_one();
  return 0;
}

extern "C" int ts_feeder_pop(ts_feeder* f, float* ranges, float* intens,
                             int cap, double* stamp, double* encoder_angle,
                             int timeout_ms) {
  std::unique_lock<std::mutex> lk(f->mu);
  if (!f->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                      [f] { return f->count > 0; })) {
    return -4;
  }
  Slot& s = f->slots[static_cast<size_t>(f->head)];
  if (s.n > cap) return -3;
  memcpy(ranges, s.ranges.data(), sizeof(float) * static_cast<size_t>(s.n));
  if (intens) {
    memcpy(intens, s.intens.data(), sizeof(float) * static_cast<size_t>(s.n));
  }
  if (stamp) *stamp = s.stamp;
  if (encoder_angle) *encoder_angle = s.angle;
  int n = s.n;
  f->head = (f->head + 1) % static_cast<int>(f->slots.size());
  --f->count;
  return n;
}

extern "C" long ts_feeder_dropped(const ts_feeder* f) { return f->dropped; }

extern "C" int ts_feeder_depth(const ts_feeder* f) { return f->count; }
