// Native covisibility / observation-table engine (copy of
// orb_slam3_modified_tpu/native/covis.cc, kept in the port so it needs
// nothing of the reference package).
//
// Host-side C++ for the map
// bookkeeping that the reference implements inside KeyFrame/MapPoint
// (reference: KeyFrame::UpdateConnections covisibility counting,
// include/KeyFrame.h:224; MapPoint::ComputeDistinctiveDescriptors,
// include/MapPoint.h:144). The SoA observation table (K, F) int32 makes
// these tight counting loops; numpy pays a full-table pass per query, this
// library keeps them cache-friendly single passes with OpenMP-free plain
// loops (K*F is ~1e6 — memory-bound).
//
// Built by native/__init__.py at first use:
//   g++ -O3 -shared -fPIC covis.cc -o ../_build/libcovis.so
// and loaded via ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Shared-observation weights between keyframe k and every other keyframe.
// obs: (K, F) row-major int32, -1 = no point. valid: (K,) uint8.
// out: (K,) int32.
void covis_weights(const int32_t* obs, const uint8_t* valid, int64_t K,
                   int64_t F, int64_t n_points, int64_t k, int32_t* out) {
  std::vector<uint8_t> seen(n_points, 0);
  const int32_t* row = obs + k * F;
  for (int64_t f = 0; f < F; ++f) {
    int32_t p = row[f];
    if (p >= 0 && p < n_points) seen[p] = 1;
  }
  for (int64_t j = 0; j < K; ++j) {
    int32_t w = 0;
    if (valid[j] && j != k) {
      const int32_t* r = obs + j * F;
      for (int64_t f = 0; f < F; ++f) {
        int32_t p = r[f];
        if (p >= 0 && p < n_points && seen[p]) ++w;
      }
    }
    out[j] = w;
  }
}

// Number of observing keyframes per map point. out: (M,) int32.
void obs_counts(const int32_t* obs, const uint8_t* valid, int64_t K, int64_t F,
                int64_t n_points, int32_t* out) {
  std::memset(out, 0, n_points * sizeof(int32_t));
  for (int64_t j = 0; j < K; ++j) {
    if (!valid[j]) continue;
    const int32_t* r = obs + j * F;
    for (int64_t f = 0; f < F; ++f) {
      int32_t p = r[f];
      if (p >= 0 && p < n_points) ++out[p];
    }
  }
}

// Keyframes observing any of the given points. pts: (n,) int32 indices.
// out: (K,) uint8 bool.
void point_observers(const int32_t* obs, const uint8_t* valid, int64_t K,
                     int64_t F, int64_t n_points, const int32_t* pts,
                     int64_t n_pts, uint8_t* out) {
  std::vector<uint8_t> mark(n_points, 0);
  for (int64_t i = 0; i < n_pts; ++i) {
    int32_t p = pts[i];
    if (p >= 0 && p < n_points) mark[p] = 1;
  }
  for (int64_t j = 0; j < K; ++j) {
    uint8_t hit = 0;
    if (valid[j]) {
      const int32_t* r = obs + j * F;
      for (int64_t f = 0; f < F && !hit; ++f) {
        int32_t p = r[f];
        if (p >= 0 && p < n_points && mark[p]) hit = 1;
      }
    }
    out[j] = hit;
  }
}

// Observer list for one point: fills (ks, slots) up to cap; returns count.
int64_t observers_of_point(const int32_t* obs, const uint8_t* valid, int64_t K,
                           int64_t F, int32_t point, int32_t* ks,
                           int32_t* slots, int64_t cap) {
  int64_t n = 0;
  for (int64_t j = 0; j < K && n < cap; ++j) {
    if (!valid[j]) continue;
    const int32_t* r = obs + j * F;
    for (int64_t f = 0; f < F && n < cap; ++f) {
      if (r[f] == point) {
        ks[n] = (int32_t)j;
        slots[n] = (int32_t)f;
        ++n;
      }
    }
  }
  return n;
}

}  // extern "C"
