// Image-source RIR engine for shoebox rooms.
//
// Native (C++) implementation of the simulator hot path, mirroring the role
// of pyroomacoustics' compiled `libroom` extension in the reference stack
// (SURVEY.md §2.2): the separation math runs on the TPU, but RIR synthesis
// is host-side and dominates sweep setup time. Same math as the NumPy
// fallback in overiva_tpu/sim/room.py: images along axis d at
// (-1)^p s_d + 2 n L_d carrying 2|n| (p=0) or |2n-1| (p=1) reflections,
// amplitude rho^order / (4 pi dist), Hann-windowed-sinc fractional delay.
//
// Exposed via a C ABI for ctypes; no Python headers needed.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

inline double sinc(double x) {
  if (x == 0.0) return 1.0;
  const double px = kPi * x;
  return std::sin(px) / px;
}

}  // namespace

extern "C" {

// Computes the RIR length needed (upper bound) for the given geometry so the
// caller can allocate. Returns <0 on error.
int64_t shoebox_rir_capacity(const double* room, const double* src,
                             const double* mic, double fs, int max_order,
                             double c, int frac_len, int extra) {
  (void)src;
  (void)mic;
  // farthest image is bounded by (max_order + 2) half-room traversals plus
  // the room diagonal
  const double diag =
      std::sqrt(room[0] * room[0] + room[1] * room[1] + room[2] * room[2]);
  const double max_dist = diag * (max_order + 3);
  return static_cast<int64_t>(max_dist / c * fs) + 2 * frac_len + extra + 8;
}

// Fills rir_out (zero-initialised by caller, length rir_capacity).
// Returns the actual used length, or <0 on error:
//   -1 bad geometry, -2 capacity too small.
int64_t shoebox_rir(const double* room, const double* src, const double* mic,
                    double fs, double absorption, int max_order, double c,
                    int frac_len, int extra, double* rir_out,
                    int64_t rir_capacity) {
  for (int d = 0; d < 3; ++d) {
    if (src[d] <= 0.0 || src[d] >= room[d] || mic[d] <= 0.0 ||
        mic[d] >= room[d])
      return -1;
  }
  const double rho = std::sqrt(absorption < 1.0 ? 1.0 - absorption : 0.0);
  const int half = max_order / 2 + 1;
  const int center = frac_len / 2;

  // precompute per-axis image coordinate deltas and reflection counts
  std::vector<double> pos[3];
  std::vector<int> refl[3];
  for (int d = 0; d < 3; ++d) {
    for (int n = -half; n <= half; ++n) {
      pos[d].push_back(src[d] + 2.0 * n * room[d]);   // p = 0
      refl[d].push_back(2 * std::abs(n));
      pos[d].push_back(-src[d] + 2.0 * n * room[d]);  // p = 1
      refl[d].push_back(std::abs(2 * n - 1));
    }
  }

  // rho^order table (pow per image is ~100 cycles; order <= max_order)
  std::vector<double> rho_pow(max_order + 1);
  rho_pow[0] = 1.0;
  for (int o = 1; o <= max_order; ++o) rho_pow[o] = rho_pow[o - 1] * rho;

  // Tap trig hoisting. With integer tap offset k = t - center and
  // fractional delay frac in [0, 1), u = k - frac and
  //   sin(pi*u)          = -(-1)^k * sin(pi*frac)
  //   cos(2*pi*u/L)      = cos(2*pi*k/L)*cos(2*pi*frac/L)
  //                        + sin(2*pi*k/L)*sin(2*pi*frac/L)
  // so the 81-tap inner loop needs NO trig: one sin + one sincos per
  // image against per-k tables (exact identities, not approximations).
  std::vector<double> neg_par(frac_len), kk(frac_len), ca(frac_len),
      sa(frac_len);
  for (int t = 0; t < frac_len; ++t) {
    const int k = t - center;
    neg_par[t] = (k & 1) ? 1.0 : -1.0;  // -(-1)^k
    kk[t] = static_cast<double>(k);
    const double a = 2.0 * kPi * k / frac_len;
    ca[t] = std::cos(a);
    sa[t] = std::sin(a);
  }

  int64_t max_used = 0;
  const size_t nx = pos[0].size(), ny = pos[1].size(), nz = pos[2].size();
  for (size_t i = 0; i < nx; ++i) {
    const int rx = refl[0][i];
    if (rx > max_order) continue;
    const double dx = pos[0][i] - mic[0];
    for (size_t j = 0; j < ny; ++j) {
      const int rxy = rx + refl[1][j];
      if (rxy > max_order) continue;
      const double dy = pos[1][j] - mic[1];
      const double dxy2 = dx * dx + dy * dy;
      for (size_t k = 0; k < nz; ++k) {
        const int order = rxy + refl[2][k];
        if (order > max_order) continue;
        const double dz = pos[2][k] - mic[2];
        double dist = std::sqrt(dxy2 + dz * dz);
        if (dist < 1e-3) dist = 1e-3;
        const double amp = rho_pow[order] / (4.0 * kPi * dist);

        const double delay = dist / c * fs + center;
        const int64_t base = static_cast<int64_t>(std::floor(delay));
        const double frac = delay - static_cast<double>(base);

        const int64_t start = base - center;
        if (start < 0) return -1;
        if (start + frac_len + extra > rir_capacity) return -2;
        // windowed-sinc injection at u = (t - center) - frac, via the
        // hoisted identities above (branchless, auto-vectorizable)
        if (frac == 0.0) {
          // sinc lands exactly on integer taps: only u = 0 contributes
          rir_out[base] += amp;
        } else {
          const double sf = std::sin(kPi * frac);
          const double b = 2.0 * kPi * frac / frac_len;
          const double cb = std::cos(b), sb = std::sin(b);
          const double g = amp * sf / kPi;  // amp * sin(pi*frac)/pi
          double* out = rir_out + start;
          for (int t = 0; t < frac_len; ++t) {
            const double win = 0.5 + 0.5 * (ca[t] * cb + sa[t] * sb);
            out[t] += neg_par[t] * g / (kk[t] - frac) * win;
          }
        }
        const int64_t used = start + frac_len + extra;
        if (used > max_used) max_used = used;
      }
    }
  }
  return max_used;
}

}  // extern "C"
