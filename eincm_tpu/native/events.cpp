// Native event-stream ingest kernels (no external deps).
//
// The reference rectifies and filters the full event stream with numpy
// (src/dataloaders/dsec_loader.py:145-171): a (N,2) float gather, rounding,
// an in-sensor mask and four masked compactions — several multi-GB
// temporaries at DSEC scale (hundreds of millions of events). These kernels
// do the same work in one streaming multithreaded pass with a single
// prefix-sum compaction.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int n_workers(int64_t n, int64_t grain) {
  unsigned hc = std::thread::hardware_concurrency();
  int maxw = hc ? static_cast<int>(hc) : 4;
  int bywork = static_cast<int>(std::max<int64_t>(1, n / grain));
  return std::max(1, std::min(maxw, bywork));
}

template <typename F>
void parallel_chunks(int64_t n, F&& fn) {
  int w = n_workers(n, 1 << 20);
  if (w == 1) {
    fn(0, int64_t{0}, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (n + w - 1) / w;
  for (int i = 0; i < w; ++i) {
    int64_t lo = i * per, hi = std::min<int64_t>(n, lo + per);
    if (lo >= hi) break;
    ts.emplace_back([&, i, lo, hi] { fn(i, lo, hi); });
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// Rectify raw (x, y) sensor coordinates through a (H, W, 2) float32 map,
// round to integer pixels, drop events that leave the sensor, and compact
// all four channels in order. Returns the kept count.
//
// in:  x_u16/y_u16 (N,), t_i64 (N,), p_u8 (N,), map (H*W*2,) [x, y] pairs
// out: ox/oy int16 (N,), ot int64 (N,), op uint8 (N,)  (first n_kept valid)
int64_t rectify_filter_events(const uint16_t* x, const uint16_t* y,
                              const int64_t* t, const uint8_t* p, int64_t n,
                              const float* map, int64_t height, int64_t width,
                              int16_t* ox, int16_t* oy, int64_t* ot,
                              uint8_t* op) {
  int w = n_workers(n, 1 << 20);
  int64_t per = (n + w - 1) / w;
  std::vector<int64_t> counts(static_cast<size_t>(w) + 1, 0);

  // pass 1: per-worker rectify into a SCRATCH buffer + count. The scratch
  // (not ox/oy) holds the uncompacted coords: compacting ox/oy in place
  // across workers races — worker k's destination slots start at the global
  // prefix counts[k], which lies inside an earlier worker's still-being-read
  // range whenever any events were dropped.
  std::vector<uint8_t> keep(static_cast<size_t>(n));
  std::vector<int16_t> rxs(static_cast<size_t>(n)), rys(static_cast<size_t>(n));
  parallel_chunks(n, [&](int wi, int64_t lo, int64_t hi) {
    int64_t c = 0;
    for (int64_t i = lo; i < hi; ++i) {
      const float* m = map + (static_cast<int64_t>(y[i]) * width + x[i]) * 2;
      // numpy rounds half to even (np.round, dsec_loader.py:153-154);
      // std::rint under the default FE_TONEAREST mode matches exactly —
      // lround (half away from zero) does NOT: real rectify maps do land
      // on exact .5 (caught by the warped-geometry loader parity harness)
      long rx = static_cast<long>(std::rint(m[0]));
      long ry = static_cast<long>(std::rint(m[1]));
      bool ok = rx >= 0 && rx < width && ry >= 0 && ry < height;
      keep[static_cast<size_t>(i)] = ok;
      rxs[static_cast<size_t>(i)] = static_cast<int16_t>(rx);
      rys[static_cast<size_t>(i)] = static_cast<int16_t>(ry);
      c += ok;
    }
    counts[static_cast<size_t>(wi) + 1] = c;
  });
  for (int i = 0; i < w; ++i) counts[i + 1] += counts[i];

  // pass 2: stable compaction into the prefix-summed global slots. Sources
  // (scratch + the t/p inputs) are never written here and destination
  // ranges [counts[wi], counts[wi+1]) are disjoint per worker — race-free.
  parallel_chunks(n, [&](int wi, int64_t lo, int64_t hi) {
    int64_t dst = counts[wi];
    for (int64_t i = lo; i < hi; ++i) {
      if (!keep[static_cast<size_t>(i)]) continue;
      ox[dst] = rxs[static_cast<size_t>(i)];
      oy[dst] = rys[static_cast<size_t>(i)];
      ot[dst] = t[i];
      op[dst] = p[i];
      ++dst;
    }
  });
  return counts[static_cast<size_t>(w)];
}

}  // extern "C"
