// Fused per-bin OverIVA update after the activations, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel overiva_tpu/ops/pallas_epoch.py
// (pallas_update_rows; body _make_kernel, solver _gauss_solve_refs, OC step
// update_J). For each bin f and each source k in order, on complex64 data in
// f32 arithmetic:
//
//   V_k = (1/T) sum_t phi[t,b,k] x x^H       (all N sources in one pass)
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
// phi is (T, n_mix, N): X may hold n_mix mixtures folded into its bin axis
// (models/overiva.py::fold_mixtures), mixture b owning bins b F/n_mix ..
// (b + 1) F/n_mix - 1, and bin f is weighted by the phi of its own mixture,
// b = f / (F/n_mix). n_mix = 1 is the single-clip layout (T, N).
//
// What bounds it: at the headline (F=2049, T=128, M=8, N=3) one launch reads
// X once (16.8 MB) and Cx, W once and writes W (1.05 MB each): 19.9 MB, about
// 6 us at 3.35 TB/s. It does about 0.40 GFLOP for the three weighted
// covariances and 0.06 GFLOP for the solves: about 7 us at the card's
// 67 TFLOP/s of f32 outside the tensor cores, so the bound is arithmetic.
// The tensor cores are not used, on purpose: this is the f32 tier, and TF32
// (wgmma on f32 data) keeps about 10 mantissa bits, while the tier and its
// 1e-4 gate rest on full f32 products. What keeps the kernel far above the
// bound is the per-bin chain of small dependent steps (covariance, W V,
// M elimination steps, norm, OC solve, times N sources): latency, not
// throughput.
//
// Two kernels, chosen by M at launch:
//
// - 2 <= M <= 8 (update_rows_warp_kernel, M a template parameter): one warp
//   runs one bin's whole chain, kBinsPerBlock adjacent bins per block.
//   Adjacent bins make each frame's slice of X contiguous (8 bins x M=8 x
//   8 B = 512 B), so the block stages frames with coalesced cp.async copies
//   (16 B where M is even), double-buffered over chunks of kFrames frames:
//   the copy of chunk c+1 runs while the warps accumulate chunk c. These
//   staging barriers are the kernel's only block-wide barriers. The
//   covariances are Hermitian: each lane keeps one entry of their upper
//   triangle (or two of their real diagonal) for all N sources in
//   registers, so a frame costs a lane 4 + 2N multiply-adds, and the loop
//   over frames is compiled for each N (a switch per chunk). The
//   solves run on a per-warp shared tableau, the lanes spread over its
//   elements, with __syncwarp() between steps and ping-pong buffers so that
//   one step's reads never race the next step's writes; the pivot search is
//   a shuffle reduction (ties to the lower row), the m <= 3 adjugate solve
//   takes one cofactor per lane. Compile-time M turns every index split into
//   shifts and multiplies and lets the loops over M unroll; the launch
//   bounds are the real block size, so ptxas has no register cap to spill
//   under. Each elimination step updates only the columns that later steps
//   and the solution read. Magnitudes compared with a threshold stay
//   hypotf; the quotients of a step multiply by one reciprocal of the
//   pivot.
// - 9 <= M <= 32 (update_rows_kernel): one block per bin, M*M threads
//   rounded up to whole warps, thread (m, n) owning element (m, n) of every
//   M x M matrix. The block stages its bin's frames in shared memory a chunk
//   at a time, each thread accumulates its (m, n) element of all N
//   covariances in registers, and the solves run on a shared tableau with
//   one __syncthreads() between elimination steps; the pivot search is one
//   warp's shuffle reduction. Shared rows are padded to M + 1 complex values
//   so that the rows one warp reads at the same column fall in distinct banks.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
                                   int T, int F, int M, int N, int n_mix) {
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
  const int mix = f / (F / n_mix);  // the mixture whose phi weights bin f
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
    for (int idx = tid; idx < tc * N; idx += blockDim.x) {
      const int t = idx / N;
      sPhi[idx] = phi[(static_cast<size_t>(t0 + t) * n_mix + mix) * N + idx - t * N];
    }
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
           void* W_out, int T, int F, int M, int N, int n_mix, cudaStream_t stream) {
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
      static_cast<float2*>(W_out), T, F, M, N, n_mix);
  return static_cast<int>(cudaGetLastError());
}


// ------------------------------------------------- warp per bin, 2 <= M <= 8

// 8 bins a block measured faster than 2 or 4 at T=512 on an H100; a
// second warp a bin for the covariance pass measured slower (PERF.md).
constexpr int kMaxWarpM = 8;       // largest M of the warp-per-bin kernel
constexpr int kBinsPerBlock = 8;   // adjacent bins (one warp each) per block
constexpr int kFrames = 32;        // frames per staged chunk
constexpr int kBinThreads = 32 * kBinsPerBlock;
constexpr unsigned kFull = 0xffffffffu;
// below this |re| + |im| a pivot's reciprocal could overflow: divide exactly
constexpr float kRecipFloor = 1e-30f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}
// every lane gets the same bits: each butterfly step adds a pair in both
// orders, and float addition is commutative
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// 1 / b as conj(b) / |b|^2, scaled so that |b|^2 neither overflows nor
// underflows. Valid for |b.x| + |b.y| >= kRecipFloor.
__device__ __forceinline__ float2 crecip(float2 b) {
  const float r = 1.f / (fabsf(b.x) + fabsf(b.y));
  const float br = b.x * r;
  const float bi = b.y * r;
  const float q = r / (br * br + bi * bi);
  return make_float2(br * q, -bi * q);
}

// a / b by the reciprocal inv = crecip(b), or exactly where b is too small
// for one (exact is the same on every lane)
__device__ __forceinline__ float2 cquot(float2 a, float2 b, float2 inv, bool exact) {
  return exact ? cdiv(a, b) : cmul(a, inv);
}

__device__ __forceinline__ bool recip_unsafe(float2 b) {
  return fabsf(b.x) + fabsf(b.y) < kRecipFloor;
}

// The per-warp shared tiles of one bin. Rows are padded to M + 2 complex
// values so that the rows a warp reads at one column fall in distinct banks.
template <int M>
struct BinTiles {
  static constexpr int S = M + 2;  // row stride of every tile
  float2 W[M * S];                  // the working demixing matrix
  float2 C[M * S];                  // Cx
  float2 V[M * S];                  // V_k of the current source
  float2 tmp[M * S];                // tmp = W1 Cx, rows < N
  float2 sol[M * S];                // solution of the last solve
  float2 tab[2][M * S];             // ping-pong solve tableau
  float2 inv[9];                    // adjugate inverse, m <= 3
};

// Solve A X = B on one warp for the tableau [A | B] = tab[0] (m rows, width
// columns, A the first m), as ops/linalg.py::gauss_solve dispatches. The
// solution (m x (width - m)) goes to t.sol. kW is the largest width, so
// that each lane's elements (r, c) = divmod(lane + 32 j, kW) split at
// compile time. tab[0] must be complete (after a __syncwarp()); t.sol is
// complete when it returns. Every lane of the warp calls it.
template <int M, int kW>
__device__ __forceinline__ void warp_solve(BinTiles<M>& t, int m, int width) {
  constexpr int S = BinTiles<M>::S;
  constexpr int kE = (M * kW + 31) / 32;  // tableau elements per lane
  const int lane = threadIdx.x & 31;
  const int nrhs = width - m;
  if (m == 1) {
    const float2 den = t.tab[0][0];
    const bool ok = cabsf2(den) > kSqrtTiny * cabsf2(den);
    const float2 inv = crecip(den);
    const bool exact = recip_unsafe(den);
    if (lane < nrhs) t.sol[lane] = ok ? cquot(t.tab[0][1 + lane], den, inv, exact) : czero();
    __syncwarp();
    return;
  }
  if (m <= 3) {
    // one adjugate entry (r, c) per lane; ref sizes as ops/linalg.py
    const float2* A = t.tab[0];
    float2 adj = czero();
    float a_mag = 0.f;
    float c_mag = 0.f;
    if (lane < m * m) {
      const int r = lane / m;
      const int c = lane - r * m;
      if (m == 2) {
        adj = (r == c) ? A[(1 - r) * S + 1 - r] : make_float2(-A[r * S + c].x, -A[r * S + c].y);
      } else {  // cofactor (c, r): the adjugate is the transposed cofactor matrix
        const int c1 = (c + 1) % 3, c2 = (c + 2) % 3, r1 = (r + 1) % 3, r2 = (r + 2) % 3;
        adj = csub(cmul(A[c1 * S + r1], A[c2 * S + r2]), cmul(A[c1 * S + r2], A[c2 * S + r1]));
      }
      a_mag = cabsf2(A[r * S + c]);
      c_mag = cabsf2(adj);
    }
    const float max_a = warp_max(a_mag);
    float2 det;
    bool ok;
    if (m == 2) {
      det = csub(cmul(A[0], A[S + 1]), cmul(A[1], A[S]));
      ok = cabsf2(det) > kSqrtTiny * (max_a * max_a);
    } else {
      const float max_cof = warp_max(c_mag);
      const float2 cof0 = make_float2(__shfl_sync(kFull, adj.x, 0), __shfl_sync(kFull, adj.y, 0));
      const float2 cof3 = make_float2(__shfl_sync(kFull, adj.x, 3), __shfl_sync(kFull, adj.y, 3));
      const float2 cof6 = make_float2(__shfl_sync(kFull, adj.x, 6), __shfl_sync(kFull, adj.y, 6));
      // ref = max|cofactor| * max|A|: the size of what det divides
      det = cadd(cadd(cmul(A[0], cof0), cmul(A[1], cof3)), cmul(A[2], cof6));
      ok = cabsf2(det) > kSqrtTiny * (max_cof * max_a);
    }
    const float2 dinv = crecip(det);
    const bool exact = recip_unsafe(det);
    if (lane < m * m) t.inv[lane] = ok ? cquot(adj, det, dinv, exact) : czero();
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kE; ++j) {  // X = inv B, element (r, c) of m x nrhs
      const int e = lane + 32 * j;
      const int r = e / kW;
      const int c = e - r * kW;
      if (e < M * kW && r < m && c < nrhs) {
        float2 acc = czero();
        for (int q = 0; q < m; ++q) acc = cadd(acc, cmul(t.inv[r * m + q], A[q * S + m + c]));
        t.sol[r * S + c] = acc;
      }
    }
    __syncwarp();
    return;
  }

  // Gauss-Jordan with partial pivoting; the dead-pivot reference is max|A|
  float a_mag = 0.f;
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    const int e = lane + 32 * j;
    const int r = e / kW;
    const int c = e - r * kW;
    if (e < M * kW && r < m && c < m) a_mag = fmaxf(a_mag, cabsf2(t.tab[0][r * S + c]));
  }
  const float scale0 = warp_max(a_mag);
  // the pivot search runs on groups of kP lanes, lane & (kP - 1) reading
  // row lane & (kP - 1): every group reaches the same pivot
  constexpr int kP = M <= 4 ? 4 : 8;
  const int prow = lane & (kP - 1);
  unsigned avail = (1u << m) - 1u;
  int my_var = 0;  // on lane r < m: the unknown whose row r is the pivot row
  for (int i = 0; i < m; ++i) {
    const float2* cur = t.tab[i & 1];
    float2* nxt = t.tab[(i + 1) & 1];
    // first maximum of |cur[r][i]| among unused rows
    float v = prow < m ? (((avail >> prow) & 1u) ? cabsf2(cur[prow * S + i]) : -1.f) : -2.f;
    int p = prow;
#pragma unroll
    for (int o = kP / 2; o > 0; o >>= 1) {
      const float v2 = __shfl_xor_sync(kFull, v, o);
      const int p2 = __shfl_xor_sync(kFull, p, o);
      if (v2 > v || (v2 == v && p2 < p)) {
        v = v2;
        p = p2;
      }
    }
    avail &= ~(1u << p);
    if (lane == p) my_var = i;
    const float2 den = cur[p * S + i];
    const bool ok = v > kSqrtTiny * scale0;  // v = |den|
    const float2 dinv = crecip(den);
    const bool exact = recip_unsafe(den);
    // only columns c > i are read again (by later steps and the solution),
    // so the step updates those alone: the elements (r, c) = (e % M,
    // i + 1 + e / M) of the m rows
    for (int e = lane; e < M * (width - 1 - i); e += 32) {
      const int r = e % M;
      const int c = i + 1 + e / M;
      if (r < m) {
        const float2 pc = ok ? cquot(cur[p * S + c], den, dinv, exact) : czero();
        nxt[r * S + c] = (r == p) ? pc : csub(cur[r * S + c], cmul(cur[r * S + i], pc));
      }
    }
    __syncwarp();
  }
  // row r of the last tableau holds unknown my_var (of lane r)
  const float2* fin = t.tab[m & 1];
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    const int e = lane + 32 * j;
    const int r = e / kW;
    const int c = e - r * kW;
    const int var = __shfl_sync(kFull, my_var, r & 31);
    if (e < M * kW && r < m && c < nrhs) t.sol[var * S + c] = fin[r * S + m + c];
  }
  __syncwarp();
}

// clamp_pow2 of the (rows x cols) block t.sol, in place, on one warp.
template <int M, int kW>
__device__ __forceinline__ void warp_clamp_pow2(BinTiles<M>& t, int rows, int cols) {
  constexpr int S = BinTiles<M>::S;
  constexpr int kE = (M * kW + 31) / 32;
  const int lane = threadIdx.x & 31;
  float mag = 0.f;
#pragma unroll
  for (int j = 0; j < kE; ++j) {
    const int e = lane + 32 * j;
    const int r = e / kW;
    const int c = e - r * kW;
    if (e < M * kW && r < rows && c < cols) mag = fmaxf(mag, cabsf2(t.sol[r * S + c]));
  }
  const float e2 = clamp_exponent(warp_max(mag));
  if (e2 > 0.f) {
    const int shift = -static_cast<int>(e2);
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const int e = lane + 32 * j;
      const int r = e / kW;
      const int c = e - r * kW;
      if (e < M * kW && r < rows && c < cols) {
        float2& v = t.sol[r * S + c];
        v = make_float2(ldexpf(v.x, shift), ldexpf(v.y, shift));  // exact
      }
    }
  }
  __syncwarp();
}

// One staged chunk of the covariance pass for KN sources, on one warp: for
// frames tt < tc, acc[k] += phi[tt, k] a,
// with a = x_i0 conj(x_i1) on a lane of the upper triangle, and
// a = |x_i0|^2 + i |x_i1|^2 on a lane of two diagonal entries (written so
// that both lanes run the same instructions). KN is a template argument so
// that no multiply-add is issued for an absent source.
template <int M, int KN>
__device__ __forceinline__ void accumulate_chunk(float2 (&acc)[M], const float2* xs,
                                                 const float* ps, int tc, int i0, int i1,
                                                 bool diag) {
  constexpr int kSlab = kBinsPerBlock * M;
#pragma unroll 4
  for (int tt = 0; tt < tc; ++tt) {
    const float2 u = xs[tt * kSlab + i0];
    const float2 w = xs[tt * kSlab + i1];
    const float2 b = diag ? u : w;
    const float2 c = diag ? make_float2(-w.y, w.x) : u;
    const float re = u.x * b.x + u.y * b.y;
    const float im = c.y * w.x - c.x * w.y;
#pragma unroll
    for (int k = 0; k < KN; ++k) {
      const float p = ps[tt * KN + k];
      acc[k].x += p * re;
      acc[k].y += p * im;
    }
  }
}

// accumulate_chunk with the source count N as a template argument
template <int M, int KN = 1>
__device__ __forceinline__ void accumulate_chunk_n(int N, float2 (&acc)[M], const float2* xs,
                                                   const float* ps, int tc, int i0, int i1,
                                                   bool diag) {
  if (N == KN) {
    accumulate_chunk<M, KN>(acc, xs, ps, tc, i0, i1, diag);
  } else if constexpr (KN < M) {
    accumulate_chunk_n<M, KN + 1>(N, acc, xs, ps, tc, i0, i1, diag);
  }
}

// Launch bounds: the real block size, and one block an SM is enough. Without
// the second bound ptxas held the M = 4, 5, 6 instances to 64 registers
// and spilled; with it no instance spills, and M = 8 keeps its 113.
//
// phi_slots: the most mixtures that kBinsPerBlock adjacent bins can
// straddle (1 for one clip, 2 where a mixture holds kBinsPerBlock - 1 bins or
// more); each block stages the phi of each mixture it touches.
template <int M>
__global__ void __launch_bounds__(kBinThreads, 1) update_rows_warp_kernel(
    const float2* __restrict__ X, const float* __restrict__ phi,
    const float2* __restrict__ Cx, const float2* __restrict__ W_in,
    float2* __restrict__ W_out, int T, int F, int N, int n_mix, int phi_slots,
    bool vec16) {
  constexpr int S = BinTiles<M>::S;
  constexpr int kSlab = kBinsPerBlock * M;  // complex values of one staged frame
  constexpr int kE = (M * M + 31) / 32;     // M x M elements per lane
  constexpr int kPhiSlot = kFrames * M;     // floats of one mixture's staged phi
  extern __shared__ float4 smem_raw[];
  float2* sX = reinterpret_cast<float2*>(smem_raw);           // [2][kFrames][kSlab]
  // [2][phi_slots][kFrames * N]
  float* sPhi = reinterpret_cast<float*>(sX + 2 * kFrames * kSlab);
  BinTiles<M>* tiles = reinterpret_cast<BinTiles<M>*>(sPhi + 2 * phi_slots * kPhiSlot);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bin = warp;  // bin of this warp within the block
  const int f0 = blockIdx.x * kBinsPerBlock;
  const int nb = min(kBinsPerBlock, F - f0);
  const bool live = bin < nb;
  BinTiles<M>& t = tiles[bin];
  const size_t mat = static_cast<size_t>(f0 + bin) * M * M;
  // the mixtures of the block's bins are mix0 .. mix0 + n_slots - 1
  const int f_mix = F / n_mix;
  const int mix0 = f0 / f_mix;
  const int n_slots = (f0 + nb - 1) / f_mix - mix0 + 1;
  const int slot = (f0 + min(bin, nb - 1)) / f_mix - mix0;  // this warp's mixture

  // chunk c: frames [c kFrames, ...) of bins f0 .. f0 + nb - 1, and the phi
  // of their mixtures
  auto stage = [&](int c) {
    const int t0 = c * kFrames;
    const int tc = min(kFrames, T - t0);
    float2* dst = sX + (c & 1) * kFrames * kSlab;
    const float2* src = X + (static_cast<size_t>(t0) * F + f0) * M;
    const size_t stride = static_cast<size_t>(F) * M;
    if (vec16) {
      const int units = nb * M / 2;  // 16-byte pieces of one frame
      for (int u = threadIdx.x; u < tc * units; u += kBinThreads) {
        const int tt = u / units;
        const int k = u - tt * units;
        cp_async16(dst + tt * kSlab + 2 * k, src + tt * stride + 2 * k);
      }
    } else {
      const int units = nb * M;
      for (int u = threadIdx.x; u < tc * units; u += kBinThreads) {
        const int tt = u / units;
        const int k = u - tt * units;
        cp_async8(dst + tt * kSlab + k, src + tt * stride + k);
      }
    }
    float* pdst = sPhi + (c & 1) * phi_slots * kPhiSlot;
    const int per_slot = tc * N;
    for (int u = threadIdx.x; u < n_slots * per_slot; u += kBinThreads) {
      const int sl = u / per_slot;
      const int v = u - sl * per_slot;
      const int tt = v / N;
      cp_async4(pdst + sl * kPhiSlot + v,
                phi + (static_cast<size_t>(t0 + tt) * n_mix + mix0 + sl) * N + v - tt * N);
    }
    cp_async_commit();
  };

  const int n_chunks = (T + kFrames - 1) / kFrames;
  stage(0);
  if (live) {
    for (int e = lane; e < M * M; e += 32) {
      t.W[(e / M) * S + e % M] = W_in[mat + e];
      t.C[(e / M) * S + e % M] = Cx[mat + e];
    }
  }

  // all N weighted covariances in one pass over the bin's frames. They are
  // Hermitian: lane l < kPairs owns the upper-triangle entry (i0, i1) of
  // each, and the next ceil(M/2) lanes two diagonal entries (i0, i1) each
  // (real, so one complex accumulator holds both); M <= 8 fits one warp
  constexpr int kPairs = M * (M - 1) / 2;
  constexpr int kSlots = kPairs + (M + 1) / 2;
  static_assert(kSlots <= 32, "the covariance entries of one bin exceed a warp");
  const bool diag = lane >= kPairs;
  int i0 = 0;
  int i1 = 0;
  if (!diag) {
    int rem = lane;
    while (rem >= M - 1 - i0) rem -= M - 1 - i0++;
    i1 = i0 + 1 + rem;
  } else if (lane < kSlots) {
    i0 = 2 * (lane - kPairs);
    i1 = min(i0 + 1, M - 1);
  }
  float2 acc[M];
#pragma unroll
  for (int k = 0; k < M; ++k) acc[k] = czero();
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait_all();
    __syncthreads();  // chunk c is visible; chunk c - 1 is consumed
    if (c + 1 < n_chunks) stage(c + 1);
    if (!live) continue;
    accumulate_chunk_n<M>(N, acc, sX + (c & 1) * kFrames * kSlab + bin * M,
                          sPhi + ((c & 1) * phi_slots + slot) * kPhiSlot,
                          min(kFrames, T - c * kFrames), i0, i1, diag);
  }
  if (!live) return;

  // from here on one warp runs the bin's chain: only __syncwarp()
  const float n_frames = static_cast<float>(T);
  const bool constrained = N < M;
  if (constrained) {  // tmp = W1 Cx for the epoch-start W
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const int e = lane + 32 * j;
      const int r = e / M;
      const int c = e % M;
      if (e < M * M && r < N) {
        float2 v = czero();
#pragma unroll
        for (int q = 0; q < M; ++q) v = cadd(v, cmul(t.W[r * S + q], t.C[q * S + c]));
        t.tmp[r * S + c] = v;
      }
    }
  }
  for (int k = 0; k < N; ++k) {  // IP updates are order-dependent
    {  // V_k, mirrored to the full matrix
      float2 v = czero();
#pragma unroll
      for (int q = 0; q < M; ++q)
        if (q == k) v = acc[q];
      v = make_float2(v.x / n_frames, v.y / n_frames);
      if (!diag) {
        t.V[i0 * S + i1] = v;
        t.V[i1 * S + i0] = cconj(v);
      } else if (lane < kSlots) {
        t.V[i0 * S + i0] = make_float2(v.x, 0.f);
        if (i1 != i0) t.V[i1 * S + i1] = make_float2(v.y, 0.f);
      }
    }
    __syncwarp();

    // tableau [W V_k | e_k]
    constexpr int kEt = (M * (M + 1) + 31) / 32;
#pragma unroll
    for (int j = 0; j < kEt; ++j) {
      const int e = lane + 32 * j;
      const int r = e / (M + 1);
      const int c = e % (M + 1);
      if (e < M * (M + 1)) {
        float2 v = make_float2(r == k ? 1.f : 0.f, 0.f);
        if (c < M) {
          v = czero();
#pragma unroll
          for (int q = 0; q < M; ++q) v = cadd(v, cmul(t.W[r * S + q], t.V[q * S + c]));
        }
        t.tab[0][r * S + c] = v;
      }
    }
    __syncwarp();
    warp_solve<M, M + 1>(t, M, M + 1);
    warp_clamp_pow2<M, M + 1>(t, M, 1);

    // guarded normalization: s = w^H V w and the significance of its bits
    float term = 0.f;
    float mag = 0.f;
#pragma unroll
    for (int j = 0; j < kE; ++j) {
      const int e = lane + 32 * j;
      if (e < M * M) {
        const float2 wm = t.sol[(e / M) * S];
        const float2 wn = t.sol[(e % M) * S];
        const float tr = cmul(cmul(cconj(wm), t.V[(e / M) * S + e % M]), wn).x;
        term += tr;
        mag += fabsf(tr);
      }
    }
    const float quad = warp_sum(term);
    const float ref = warp_sum(mag);
    const bool good = quad > kFourEps * ref;
    const float root = sqrtf(good ? quad : 1.f);
    if (good && lane < M) {  // W[k] = conj(w / sqrt(s)); else the previous row
      const float2 w = t.sol[lane * S];
      t.W[k * S + lane] = cconj(make_float2(w.x / root, w.y / root));
    }
    __syncwarp();

    if (constrained) {
      if (lane < M) {  // tmp[k] = W[k] Cx
        float2 v = czero();
#pragma unroll
        for (int q = 0; q < M; ++q) v = cadd(v, cmul(t.W[k * S + q], t.C[q * S + lane]));
        t.tmp[k * S + lane] = v;
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        const int e = lane + 32 * j;
        const int r = e / M;
        const int c = e % M;
        if (e < M * M && r < N) t.tab[0][r * S + c] = t.tmp[r * S + c];
      }
      __syncwarp();
      // J^H = solve(tmp[:, :N], tmp[:, N:]), then W[N + c][r] = conj(J^H[r][c])
      warp_solve<M, M>(t, N, M);
      warp_clamp_pow2<M, M>(t, N, M - N);
#pragma unroll
      for (int j = 0; j < kE; ++j) {
        const int e = lane + 32 * j;
        const int r = e / M;
        const int c = e % M;
        if (e < M * M && r < N && c < M - N) t.W[(N + c) * S + r] = cconj(t.sol[r * S + c]);
      }
      __syncwarp();
    }
  }

  for (int e = lane; e < M * M; e += 32) W_out[mat + e] = t.W[(e / M) * S + e % M];
}

template <int M>
size_t warp_shared_bytes(int phi_slots) {
  return sizeof(float2) * 2 * kFrames * kBinsPerBlock * M +
         sizeof(float) * 2 * phi_slots * kFrames * M + sizeof(BinTiles<M>) * kBinsPerBlock;
}

template <int M>
int launch_warp(const void* X, const void* phi, const void* Cx, const void* W_in,
                void* W_out, int T, int F, int N, int n_mix, cudaStream_t stream) {
  // kBinsPerBlock adjacent bins straddle at most ceil((kBinsPerBlock - 1) /
  // f_mix) + 1 mixtures of f_mix bins each
  const int f_mix = F / n_mix;
  const int straddled = (kBinsPerBlock - 1 + f_mix - 1) / f_mix + 1;
  const int phi_slots = straddled < n_mix ? straddled : n_mix;
  const size_t smem = warp_shared_bytes<M>(phi_slots);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        update_rows_warp_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // 16-byte copies where a frame's slice of X is whole 16-byte pieces
  const bool vec16 = M % 2 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0;
  const int blocks = (F + kBinsPerBlock - 1) / kBinsPerBlock;
  update_rows_warp_kernel<M><<<blocks, kBinThreads, smem, stream>>>(
      static_cast<const float2*>(X), static_cast<const float*>(phi),
      static_cast<const float2*>(Cx), static_cast<const float2*>(W_in),
      static_cast<float2*>(W_out), T, F, N, n_mix, phi_slots, vec16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the CUDA error code (0 on success).
// X: (T, F, M) complex64; phi: (T, n_mix, N) f32; Cx, W_in, W_out:
// (F, M, M) complex64; all contiguous on one device. The caller has checked
// shapes, types and devices, and that 1 <= N <= M <= 32, T >= 1, F >= 1 and
// that n_mix >= 1 divides F. 2 <= M <= 8 runs the warp-per-bin kernel, the
// other M the block-per-bin kernel.
int update_rows_launch(const void* X, const void* phi, const void* Cx,
                       const void* W_in, void* W_out, int T, int F, int M,
                       int N, int n_mix, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M >= 2 && M <= kMaxWarpM) {
    switch (M) {
      case 2: return launch_warp<2>(X, phi, Cx, W_in, W_out, T, F, N, n_mix, st);
      case 3: return launch_warp<3>(X, phi, Cx, W_in, W_out, T, F, N, n_mix, st);
      case 4: return launch_warp<4>(X, phi, Cx, W_in, W_out, T, F, N, n_mix, st);
      case 5: return launch_warp<5>(X, phi, Cx, W_in, W_out, T, F, N, n_mix, st);
      case 6: return launch_warp<6>(X, phi, Cx, W_in, W_out, T, F, N, n_mix, st);
      case 7: return launch_warp<7>(X, phi, Cx, W_in, W_out, T, F, N, n_mix, st);
      default: return launch_warp<8>(X, phi, Cx, W_in, W_out, T, F, N, n_mix, st);
    }
  }
  if (N <= 4) return launch<4>(X, phi, Cx, W_in, W_out, T, F, M, N, n_mix, st);
  if (N <= 8) return launch<8>(X, phi, Cx, W_in, W_out, T, F, M, N, n_mix, st);
  if (N <= 16) return launch<16>(X, phi, Cx, W_in, W_out, T, F, M, N, n_mix, st);
  return launch<32>(X, phi, Cx, W_in, W_out, T, F, M, N, n_mix, st);
}

const char* update_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
