// Native numerosity dot-pattern generator.
//
// The only host-bound component of the framework's data pipeline: the
// Python generator (data/numerosity.py) places dots with a per-dot
// rejection loop and per-image convex-hull computation, which dominates
// dataset construction wall-clock at flagship sizes (2048 x 100x100).
// This C++ implementation produces the same stimulus family (binary
// non-overlapping discs + cumArea / convex hull / density features) with
// per-sample splitmix64 RNG streams, so generation is deterministic for a
// fixed seed and embarrassingly parallel over samples (OpenMP when
// available).
//
// Exposed as a plain C ABI consumed via ctypes (data/native/__init__.py);
// the Python generator remains the permanent fallback.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>
#include <cmath>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

struct Rng {
  uint64_t state;
  explicit Rng(uint64_t s) : state(s) {}
  uint64_t next() {
    uint64_t z = (state += 0x9E3779B97F4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }
  // uniform integer in [lo, hi] inclusive
  int randint(int lo, int hi) {
    if (hi <= lo) return lo;
    return lo + static_cast<int>(next() % static_cast<uint64_t>(hi - lo + 1));
  }
};

struct Pt {
  double x, y;
};

double cross(const Pt &o, const Pt &a, const Pt &b) {
  return (a.x - o.x) * (b.y - o.y) - (a.y - o.y) * (b.x - o.x);
}

// Monotone-chain convex hull area (shoelace), matching the Python helper.
double hull_area(std::vector<Pt> pts) {
  std::sort(pts.begin(), pts.end(), [](const Pt &a, const Pt &b) {
    return a.x < b.x || (a.x == b.x && a.y < b.y);
  });
  pts.erase(std::unique(pts.begin(), pts.end(),
                        [](const Pt &a, const Pt &b) {
                          return a.x == b.x && a.y == b.y;
                        }),
            pts.end());
  const size_t n = pts.size();
  if (n < 3) return 0.0;
  std::vector<Pt> hull(2 * n);
  size_t k = 0;
  for (size_t i = 0; i < n; ++i) {
    while (k >= 2 && cross(hull[k - 2], hull[k - 1], pts[i]) <= 0) --k;
    hull[k++] = pts[i];
  }
  const size_t lower = k + 1;
  for (size_t i = n - 1; i-- > 0;) {
    while (k >= lower && cross(hull[k - 2], hull[k - 1], pts[i]) <= 0) --k;
    hull[k++] = pts[i];
  }
  hull.resize(k - 1);
  double area = 0.0;
  for (size_t i = 0; i < hull.size(); ++i) {
    const Pt &p = hull[i];
    const Pt &q = hull[(i + 1) % hull.size()];
    area += p.x * q.y - q.x * p.y;
  }
  return std::fabs(area) * 0.5;
}

void generate_one(Rng &rng, int n_dots, int side, int r_min, int r_max,
                  int max_tries, float *img, float *cum_area, float *ch,
                  float *density, int32_t *n_placed_out) {
  std::memset(img, 0, sizeof(float) * side * side);
  // keep radii placeable (needs r < side - r), same clamp as the Python path
  r_max = std::max(1, std::min(r_max, side / 2 - 2));
  r_min = std::max(1, std::min(r_min, r_max));

  std::vector<int> cxs, cys, rs;
  cxs.reserve(n_dots);
  cys.reserve(n_dots);
  rs.reserve(n_dots);

  auto try_place = [&](int r) -> bool {
    const int cx = rng.randint(r, side - r - 1);
    const int cy = rng.randint(r, side - r - 1);
    for (size_t j = 0; j < cxs.size(); ++j) {
      const long dx = cx - cxs[j];
      const long dy = cy - cys[j];
      const long min_d = r + rs[j] + 1;
      if (dx * dx + dy * dy < min_d * min_d) return false;
    }
    cxs.push_back(cx);
    cys.push_back(cy);
    rs.push_back(r);
    const long r2 = static_cast<long>(r) * r;
    for (int y = cy - r; y <= cy + r; ++y) {
      const long dy = y - cy;
      for (int x = cx - r; x <= cx + r; ++x) {
        const long dx = x - cx;
        if (dx * dx + dy * dy <= r2) img[y * side + x] = 1.0f;
      }
    }
    return true;
  };

  for (int d = 0; d < n_dots; ++d) {
    bool placed = false;
    for (int t = 0; t < max_tries; ++t) {
      if (try_place(rng.randint(r_min, r_max))) {
        placed = true;
        break;
      }
    }
    if (!placed) {
      // fallback at the smallest radius so the labeled numerosity stays
      // truthful at dense configurations
      for (int t = 0; t < max_tries; ++t) {
        if (try_place(r_min)) break;
      }
    }
  }

  double area = 0.0;
  for (int i = 0; i < side * side; ++i) area += img[i];
  *cum_area = static_cast<float>(area);

  double hull = area;  // < 3 dots: fall back to pixel area (Python parity)
  if (cxs.size() >= 3) {
    std::vector<Pt> pts(cxs.size());
    for (size_t i = 0; i < cxs.size(); ++i) {
      pts[i] = {static_cast<double>(cxs[i]), static_cast<double>(cys[i])};
    }
    hull = hull_area(std::move(pts));
  }
  *ch = static_cast<float>(std::max(hull, 1.0));
  *density = static_cast<float>(cxs.size() / std::max(hull, 1.0));
  *n_placed_out = static_cast<int32_t>(cxs.size());
}

}  // namespace

extern "C" {

// Fills images [n_samples, side, side] and per-sample feature arrays.
// numerosities: target dot count per sample. Deterministic per
// (seed, sample index) regardless of thread count.
void generate_dot_dataset(uint64_t seed, int n_samples,
                          const int32_t *numerosities, int side, int r_min,
                          int r_max, int max_tries, float *images,
                          float *cum_area, float *ch, float *density,
                          int32_t *n_placed) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(dynamic)
#endif
  for (int i = 0; i < n_samples; ++i) {
    Rng rng(seed ^ ((static_cast<uint64_t>(i) + 1) *
                    0xD1B54A32D192ED03ULL));
    generate_one(rng, numerosities[i], side, r_min, r_max, max_tries,
                 images + static_cast<size_t>(i) * side * side,
                 cum_area + i, ch + i, density + i, n_placed + i);
  }
}

int dotgen_version() { return 1; }

}  // extern "C"
