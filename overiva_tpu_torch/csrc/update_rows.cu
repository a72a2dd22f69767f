// Fused per-bin OverIVA update after the activations, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel overiva_tpu/ops/pallas_epoch.py
// (pallas_update_rows; body _make_kernel, solver _gauss_solve_refs, OC step
// update_J). For each bin f and each source k in order, on complex64 data in
// f32 arithmetic:
//
//   V_k = (1/T) sum_t phi[t,k] x x^H         (all N sources in one pass)
//   A = W V_k;  solve A w = e_k;  w = clamp_pow2(w)
//   s = w^H V_k w;  W[k] = conj(w / sqrt(s)), or W[k] kept where s has no
//                   significant bits (s <= 4 eps sum|terms|)
//   if N < M: tmp[k] = W[k] Cx;  J^H = clamp_pow2(solve(tmp[:, :N], tmp[:, N:]))
//             W[N:, :N] = J
//
// with the production guards of ops/linalg.py that the Pallas kernel lacks:
// dead pivots and determinants (|den| <= sqrt(FLT_MIN) * ref) zero their
// solution, the solve dispatches as gauss_solve does (m = 1 direct, m = 2, 3
// adjugate, m >= 4 Gauss-Jordan pivoting on the first maximum of |.| among
// unused rows), clamp_pow2 rescales huge solutions by exact powers of two,
// and quad_form's keep-previous-row mask replaces rsqrt(max(s, 1e-30)).
// tmp = W1 Cx is kept row by row, as the port's eager epoch keeps it.
//
// What bounds it: at the headline (F=2049, T=128, M=8, N=3) one launch reads
// X once, 2049*128*8*8 B = 16.8 MB (about 5 us at 3.35 TB/s), and does about
// 0.2 G f32 multiply-adds for the covariances plus a few thousand per bin for
// the solves. Neither is near the card's limits: the per-bin work is a chain
// of small dependent steps (covariance, product, 8 elimination steps, norm,
// OC solve, times N sources), so the kernel is bound by latency and block
// synchronisation. The design keeps the whole chain of a bin inside one
// block, in shared memory, so the ~880 launches of the eager epoch become
// one, and many bins run side by side (2049 blocks, ~15 per SM) to hide the
// synchronisation stalls of each.
//
// Design: one block per bin, M*M threads rounded up to whole warps, thread
// (m, n) owning element (m, n) of every M x M matrix. The block stages its
// bin's frames in shared memory a chunk at a time (chunk * M <= 1024 complex
// values, 8 KB), and each thread accumulates its (m, n) element of all N
// covariances in registers (a compile-time bound of accumulators, selected
// by N). The solves run on a shared tableau with one __syncthreads() between
// elimination steps; the pivot search is one warp's shuffle reduction. Shared
// rows are padded to M + 1 complex values so that the rows one warp reads at
// the same column fall in distinct banks.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunkElems = 1024;                      // X values staged per pass
constexpr float kSqrtTiny = 1.0842021724855044e-19f;   // sqrt(FLT_MIN), ops/linalg.py::_dead
constexpr float kFourEps = 4.76837158203125e-07f;      // 4 * FLT_EPSILON, quad_form
constexpr float kPow2Threshold = 20.f;                 // clamp_pow2's threshold_exp
constexpr float kPow2Cap = 120.f;                      // clamp_pow2's exponent cap

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cconj(float2 a) { return make_float2(a.x, -a.y); }
__device__ __forceinline__ float cabsf2(float2 a) { return hypotf(a.x, a.y); }
__device__ __forceinline__ float2 czero() { return make_float2(0.f, 0.f); }

// a / b, scaled so that |b|^2 neither overflows nor underflows for the
// tiny-but-alive pivots the dead-bin threshold lets through.
__device__ __forceinline__ float2 cdiv(float2 a, float2 b) {
  const float s = fabsf(b.x) + fabsf(b.y);
  const float br = b.x / s;
  const float bi = b.y / s;
  const float d = br * br + bi * bi;
  return make_float2((a.x * br + a.y * bi) / d / s, (a.y * br - a.x * bi) / d / s);
}

// Sum (or max) of one value per thread over the block, returned to every
// thread. red: >= 32 floats of shared memory. Every thread must call it.
template <bool kMax>
__device__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    const float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, u) : v + u;
  }
  __syncthreads();  // earlier readers of red are done
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < n_warps; ++w) v = kMax ? fmaxf(v, red[w]) : v + red[w];
  return v;
}

// The power-of-two exponent by which clamp_pow2 divides a bin whose largest
// magnitude is mag (0: the bin is left as it is).
__device__ __forceinline__ float clamp_exponent(float mag) {
  const float e = fminf(ceilf(log2f(fmaxf(mag, 1.f))), kPow2Cap);
  return e > kPow2Threshold ? e : 0.f;
}

struct Scratch {
  float2* piv;   // (width) normalized pivot row
  float2* col;   // (m) elimination factors
  float2* inv;   // (9) adjugate inverse
  float* red;    // (32) reduction slots
  int* ints;     // [0] pivot row, [1] unused-row mask, [2 + i] perm
};

// Block-wide solve of A X = B for the tableau tab = [A | B] (m rows, row
// stride ld, m + nrhs columns), as ops/linalg.py::gauss_solve dispatches.
// The solution goes to sol (m x nrhs, row stride ld). tab must be complete
// before the call (after a __syncthreads()); sol is complete after it.
__device__ void block_solve(float2* tab, int ld, int m, int nrhs, float2* sol,
                            const Scratch& s) {
  const int tid = threadIdx.x;
  const int width = m + nrhs;
  if (m == 1) {
    const float2 den = tab[0];
    const bool ok = cabsf2(den) > kSqrtTiny * cabsf2(den);
    for (int c = tid; c < nrhs; c += blockDim.x) sol[c] = ok ? cdiv(tab[1 + c], den) : czero();
    __syncthreads();
    return;
  }
  if (m <= 3) {
    if (tid == 0) {
      float2* inv = s.inv;
      if (m == 2) {
        const float2 a = tab[0], b = tab[1], c = tab[ld], d = tab[ld + 1];
        const float sc = fmaxf(fmaxf(cabsf2(a), cabsf2(b)), fmaxf(cabsf2(c), cabsf2(d)));
        const float2 det = csub(cmul(a, d), cmul(b, c));
        const bool ok = cabsf2(det) > kSqrtTiny * (sc * sc);
        const float2 adj[4] = {d, make_float2(-b.x, -b.y), make_float2(-c.x, -c.y), a};
        for (int i = 0; i < 4; ++i) inv[i] = ok ? cdiv(adj[i], det) : czero();
      } else {
        const float2 a = tab[0], b = tab[1], c = tab[2];
        const float2 d = tab[ld], e = tab[ld + 1], f = tab[ld + 2];
        const float2 g = tab[2 * ld], h = tab[2 * ld + 1], i = tab[2 * ld + 2];
        const float2 cof[9] = {
            csub(cmul(e, i), cmul(f, h)), csub(cmul(c, h), cmul(b, i)),
            csub(cmul(b, f), cmul(c, e)), csub(cmul(f, g), cmul(d, i)),
            csub(cmul(a, i), cmul(c, g)), csub(cmul(c, d), cmul(a, f)),
            csub(cmul(d, h), cmul(e, g)), csub(cmul(b, g), cmul(a, h)),
            csub(cmul(a, e), cmul(b, d)),
        };
        float max_cof = 0.f;
        for (int j = 0; j < 9; ++j) max_cof = fmaxf(max_cof, cabsf2(cof[j]));
        float max_a = 0.f;
        for (int r = 0; r < 3; ++r)
          for (int q = 0; q < 3; ++q) max_a = fmaxf(max_a, cabsf2(tab[r * ld + q]));
        // ref = max|cofactor| * max|A|: the size of what det divides
        const float2 det = cadd(cadd(cmul(a, cof[0]), cmul(b, cof[3])), cmul(c, cof[6]));
        const bool ok = cabsf2(det) > kSqrtTiny * (max_cof * max_a);
        for (int j = 0; j < 9; ++j) inv[j] = ok ? cdiv(cof[j], det) : czero();
      }
    }
    __syncthreads();
    for (int idx = tid; idx < m * nrhs; idx += blockDim.x) {
      const int r = idx / nrhs;
      const int c = idx % nrhs;
      float2 acc = czero();
      for (int j = 0; j < m; ++j) acc = cadd(acc, cmul(s.inv[r * m + j], tab[j * ld + m + c]));
      sol[r * ld + c] = acc;
    }
    __syncthreads();
    return;
  }

  // Gauss-Jordan with partial pivoting; the dead-pivot reference is max|A|
  float a_mag = 0.f;
  for (int idx = tid; idx < m * m; idx += blockDim.x)
    a_mag = fmaxf(a_mag, cabsf2(tab[(idx / m) * ld + idx % m]));
  const float scale0 = block_reduce<true>(a_mag, s.red);
  if (tid == 0) s.ints[1] = (m == 32) ? -1 : static_cast<int>((1u << m) - 1u);
  __syncthreads();
  for (int i = 0; i < m; ++i) {
    if (tid < 32) {  // warp 0: first maximum of |tab[r][i]| among unused rows
      const unsigned avail = static_cast<unsigned>(s.ints[1]);
      float v = -2.f;
      int r = tid;
      if (tid < m) v = ((avail >> tid) & 1u) ? cabsf2(tab[tid * ld + i]) : -1.f;
      for (int o = 16; o > 0; o >>= 1) {
        const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
        const int r2 = __shfl_xor_sync(0xffffffffu, r, o);
        if (v2 > v || (v2 == v && r2 < r)) {
          v = v2;
          r = r2;
        }
      }
      if (tid == 0) {
        s.ints[0] = r;
        s.ints[1] = static_cast<int>(avail & ~(1u << r));
        s.ints[2 + i] = r;
      }
    }
    __syncthreads();
    const int p = s.ints[0];
    const float2 den = tab[p * ld + i];
    const bool ok = cabsf2(den) > kSqrtTiny * scale0;
    for (int c = tid; c < width; c += blockDim.x)
      s.piv[c] = ok ? cdiv(tab[p * ld + c], den) : czero();
    for (int r = tid; r < m; r += blockDim.x) s.col[r] = (r == p) ? czero() : tab[r * ld + i];
    __syncthreads();
    for (int idx = tid; idx < m * width; idx += blockDim.x) {
      const int r = idx / width;
      const int c = idx % width;
      tab[r * ld + c] = (r == p) ? s.piv[c] : csub(tab[r * ld + c], cmul(s.col[r], s.piv[c]));
    }
    __syncthreads();
  }
  for (int idx = tid; idx < m * nrhs; idx += blockDim.x) {
    const int r = idx / nrhs;
    const int c = idx % nrhs;
    sol[r * ld + c] = tab[s.ints[2 + r] * ld + m + c];
  }
  __syncthreads();
}

// clamp_pow2 of the (rows x cols) block sol (row stride ld), in place.
__device__ void block_clamp_pow2(float2* sol, int ld, int rows, int cols, float* red) {
  float mag = 0.f;
  for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x)
    mag = fmaxf(mag, cabsf2(sol[(idx / cols) * ld + idx % cols]));
  const float e = clamp_exponent(block_reduce<true>(mag, red));
  if (e > 0.f) {
    const float scale = exp2f(e);
    for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
      float2& v = sol[(idx / cols) * ld + idx % cols];
      v = make_float2(v.x / scale, v.y / scale);
    }
  }
  __syncthreads();
}

template <int kMaxN>
__global__ void __launch_bounds__(1024) update_rows_kernel(const float2* __restrict__ X,
                                   const float* __restrict__ phi,
                                   const float2* __restrict__ Cx,
                                   const float2* __restrict__ W_in,
                                   float2* __restrict__ W_out,
                                   int T, int F, int M, int N) {
  extern __shared__ float2 smem[];
  const int ld = M + 1;  // padded row stride of every shared matrix
  const int chunk = kChunkElems / M;
  float2* sW = smem;               // (M, ld) the working demixing matrix
  float2* sC = sW + M * ld;        // (M, ld) Cx
  float2* sV = sC + M * ld;        // (M, ld) V_k of the current source
  float2* sTab = sV + M * ld;      // (M, ld) solve tableau
  float2* sTmp = sTab + M * ld;    // (M, ld) tmp = W1 Cx, rows < N
  float2* sSol = sTmp + M * ld;    // (M, ld) solution
  float2* sX = sSol + M * ld;      // (chunk, M) staged frames
  Scratch s;
  s.piv = sX + kChunkElems;        // (ld)
  s.col = s.piv + ld;              // (M)
  s.inv = s.col + M;               // (9)
  float* sPhi = reinterpret_cast<float*>(s.inv + 9);  // (chunk, N)
  s.red = sPhi + chunk * N;        // (32)
  s.ints = reinterpret_cast<int*>(s.red + 32);  // (2 + M)

  const int f = blockIdx.x;
  const int tid = threadIdx.x;
  const int m = tid / M;
  const int n = tid % M;
  const bool owner = tid < M * M;
  const size_t mat = static_cast<size_t>(f) * M * M;

  for (int idx = tid; idx < M * M; idx += blockDim.x) {
    sW[(idx / M) * ld + idx % M] = W_in[mat + idx];
    sC[(idx / M) * ld + idx % M] = Cx[mat + idx];
  }

  // all N weighted covariances in one pass over the bin's frames
  float2 acc[kMaxN];
#pragma unroll
  for (int k = 0; k < kMaxN; ++k) acc[k] = czero();
  for (int t0 = 0; t0 < T; t0 += chunk) {
    const int tc = min(chunk, T - t0);
    __syncthreads();  // the previous chunk has been consumed
    for (int idx = tid; idx < tc * M; idx += blockDim.x) {
      const int t = idx / M;
      sX[idx] = X[(static_cast<size_t>(t0 + t) * F + f) * M + idx % M];
    }
    for (int idx = tid; idx < tc * N; idx += blockDim.x)
      sPhi[idx] = phi[static_cast<size_t>(t0) * N + idx];
    __syncthreads();
    if (owner) {
      for (int t = 0; t < tc; ++t) {
        const float2 xm = sX[t * M + m];
        const float2 xn = sX[t * M + n];
#pragma unroll
        for (int k = 0; k < kMaxN; ++k) {
          if (k < N) {
            const float p = sPhi[t * N + k];
            const float2 a = make_float2(xm.x * p, xm.y * p);
            // a conj(x_n)
            acc[k].x += a.x * xn.x + a.y * xn.y;
            acc[k].y += a.y * xn.x - a.x * xn.y;
          }
        }
      }
    }
  }

  const bool oc = N < M;
  if (oc) {  // tmp = W1 Cx for the epoch-start W
    for (int idx = tid; idx < N * M; idx += blockDim.x) {
      const int r = idx / M;
      const int c = idx % M;
      float2 v = czero();
      for (int j = 0; j < M; ++j) v = cadd(v, cmul(sW[r * ld + j], sC[j * ld + c]));
      sTmp[r * ld + c] = v;
    }
  }

  const float n_frames = static_cast<float>(T);
  for (int k = 0; k < N; ++k) {  // IP updates are order-dependent
    if (owner) {
      float2 v = czero();
#pragma unroll
      for (int j = 0; j < kMaxN; ++j)
        if (j == k) v = acc[j];
      sV[m * ld + n] = make_float2(v.x / n_frames, v.y / n_frames);
    }
    __syncthreads();

    // tableau [W V_k | e_k]
    for (int idx = tid; idx < M * M; idx += blockDim.x) {
      const int r = idx / M;
      const int c = idx % M;
      float2 v = czero();
      for (int j = 0; j < M; ++j) v = cadd(v, cmul(sW[r * ld + j], sV[j * ld + c]));
      sTab[r * ld + c] = v;
    }
    for (int r = tid; r < M; r += blockDim.x)
      sTab[r * ld + M] = make_float2(r == k ? 1.f : 0.f, 0.f);
    __syncthreads();
    block_solve(sTab, ld, M, 1, sSol, s);
    block_clamp_pow2(sSol, ld, M, 1, s.red);

    // guarded normalization: s = w^H V w and the significance of its bits
    float term = 0.f;
    if (owner) {
      const float2 wm = sSol[m * ld];
      const float2 wn = sSol[n * ld];
      term = cmul(cmul(cconj(wm), sV[m * ld + n]), wn).x;
    }
    const float quad = block_reduce<false>(term, s.red);
    const float ref = block_reduce<false>(fabsf(term), s.red);
    const bool good = quad > kFourEps * ref;
    const float root = sqrtf(good ? quad : 1.f);
    if (tid < M) {
      const float2 w = sSol[tid * ld];
      // W[k] = conj(w / sqrt(s)), or the previous row where s is noise
      if (good) sW[k * ld + tid] = cconj(make_float2(w.x / root, w.y / root));
    }
    __syncthreads();

    if (oc) {
      for (int c = tid; c < M; c += blockDim.x) {
        float2 v = czero();
        for (int j = 0; j < M; ++j) v = cadd(v, cmul(sW[k * ld + j], sC[j * ld + c]));
        sTmp[k * ld + c] = v;
      }
      __syncthreads();
      for (int idx = tid; idx < N * M; idx += blockDim.x)
        sTab[(idx / M) * ld + idx % M] = sTmp[(idx / M) * ld + idx % M];
      __syncthreads();
      // J^H = solve(tmp[:, :N], tmp[:, N:]), then W[N + c][r] = conj(J^H[r][c])
      block_solve(sTab, ld, N, M - N, sSol, s);
      block_clamp_pow2(sSol, ld, N, M - N, s.red);
      for (int idx = tid; idx < N * (M - N); idx += blockDim.x) {
        const int r = idx / (M - N);
        const int c = idx % (M - N);
        sW[(N + c) * ld + r] = cconj(sSol[r * ld + c]);
      }
      __syncthreads();
    }
  }

  for (int idx = tid; idx < M * M; idx += blockDim.x)
    W_out[mat + idx] = sW[(idx / M) * ld + idx % M];
}

size_t shared_bytes(int M, int N) {
  const int ld = M + 1;
  const int chunk = kChunkElems / M;
  return sizeof(float2) * (6 * M * ld + kChunkElems + ld + M + 9) +
         sizeof(float) * (chunk * N + 32) + sizeof(int) * (2 + M);
}

template <int kMaxN>
int launch(const void* X, const void* phi, const void* Cx, const void* W_in,
           void* W_out, int T, int F, int M, int N, cudaStream_t stream) {
  const size_t smem = shared_bytes(M, N);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        update_rows_kernel<kMaxN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = (M * M + 31) / 32 * 32;
  update_rows_kernel<kMaxN><<<F, threads, smem, stream>>>(
      static_cast<const float2*>(X), static_cast<const float*>(phi),
      static_cast<const float2*>(Cx), static_cast<const float2*>(W_in),
      static_cast<float2*>(W_out), T, F, M, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the CUDA error code (0 on success).
// X: (T, F, M) complex64; phi: (T, N) f32; Cx, W_in, W_out: (F, M, M)
// complex64; all contiguous on one device. The caller has checked shapes,
// types and devices, and that 1 <= N <= M <= 32, T >= 1 and F >= 1.
int update_rows_launch(const void* X, const void* phi, const void* Cx,
                       const void* W_in, void* W_out, int T, int F, int M,
                       int N, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 4) return launch<4>(X, phi, Cx, W_in, W_out, T, F, M, N, st);
  if (N <= 8) return launch<8>(X, phi, Cx, W_in, W_out, T, F, M, N, st);
  if (N <= 16) return launch<16>(X, phi, Cx, W_in, W_out, T, F, M, N, st);
  return launch<32>(X, phi, Cx, W_in, W_out, T, F, M, N, st);
}

const char* update_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
