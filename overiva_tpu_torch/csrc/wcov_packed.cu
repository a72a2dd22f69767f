// All-source weighted covariances from bf16 planes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel overiva_tpu/ops/pallas_wcov.py
// (_wcov_kernel, launched by _wcov_packed_planes). It computes
//
//   V[k,f,m,n] = (1/n_frames) sum_t w[k,f,m,t] * conj(x[f,n,t])
//   w = bf16(x[f,m,t] * bf16(phi[t,k]))
//
// with x given as bf16 real and imaginary planes of shape (F, M, T), f32
// accumulation, and V written as complex64 (K, F, M, M). The weighted
// operand is rounded to bf16 exactly where the Pallas kernel rounds it: the
// product of two bf16 values is exact in f32, so one round-to-nearest-even
// of it equals bf16 x bf16 in JAX and in PyTorch. Only the left operand is
// weighted and rounded, so V is not exactly Hermitian: every (m, n) entry is
// computed, none mirrored.
//
// What bounds it: at the main-path shape (K=3, F=2049, M=8, T=128) one call
// reads F*M*T*4 B = 8.4 MB of planes and writes K*F*M*M*8 B = 3.1 MB, about
// 3.5 us at 3.35 TB/s; its 0.40 GFLOP take 0.4 us at the bf16 tensor-core
// rate, but 6 us at the f32 rate outside them. So the kernel must move each
// byte once, and multiply on the tensor cores.
//
// Two kernels, chosen by M at launch:
//
// - 1 <= M <= 8 (wcov_tc_kernel, tensor cores): one warp per bin,
//   kBinsPerBlock adjacent bins per block, all sources of a group of up to
//   kMaxSources in one pass over the bin's frames. A k-step of 16 frames is
//   two mma.sync.m16n8k16 bf16 -> f32 per source:
//     A = [w_re; w_im] (16 x 16: mics 0-7 weighted real, then imaginary),
//     C1 = A x_re^T, C2 = A x_im^T (each 16 x 8),
//     re = C1[0:8] + C2[8:16], im = C1[8:16] - C2[0:8],
//   which are exactly the four real 8 x 8 x 16 products the function needs.
//   In the m16n8k16 fragments, lane (g, c) = (lane / 4, lane % 4) holds A's
//   rows g and g + 8 and B's column g at the same four k slots {2c, 2c+1,
//   2c+8, 2c+9}: the same (mic g, frame) pairs. So one set of loads is B as
//   it stands, and the same registers times bf16(phi) (__hmul2, round to
//   nearest even) are A. A sum over frames does not care which frame sits in
//   which k slot, as long as A and B agree, and they do, since the map
//   depends on c alone: lane c takes frames [8c, 8c + 8) of every 32-frame
//   chunk, one 16-byte load per plane, frames 8c..8c+3 for the first k-step
//   and 8c+4..8c+7 for the second. A warp's load then reads 64 contiguous
//   bytes of each of its bin's 8 rows. Loads run two chunks ahead of the
//   mma. bf16(phi) is rounded once per block into shared memory, a tile of
//   kPhiTile frames at a time, zero past T. Lanes with g >= M load zeros and
//   store nothing. The C fragments put re and im of (m, n) = (g, 2c) and
//   (g, 2c + 1) in one lane: it divides them by n_frames and stores 16 B,
//   and a warp writes each source's M x M block of the bin contiguously.
//   Where the rows are not 16-byte aligned (T not a multiple of 8, or planes
//   at an odd offset) the loads fall back to 2-byte loads, zero past T.
//   The tensor cores truncate as they accumulate, so one accumulator over
//   all T frames drifts with T (1.7e-5 max|V| at T=4096 on an H100, against
//   an f64 sum of the same operands). Each mma accumulator therefore sums at
//   most kFlushChunks chunks (8 k-steps), and is then added, rounded to
//   nearest, into per-lane (re, im) totals: 4 more registers a source.
//   Options measured on an H100 and not taken: 2 or 4 bins a block, 2 or 4
//   warps a bin (frames split, sums reduced in shared memory), loads 1, 3
//   or 4 chunks ahead (PERF.md).
// - 9 <= M <= 32 (wcov_packed_kernel, CUDA cores): one block per (bin,
//   source), M*M threads, each owning one (m, n) output. The block stages
//   the bin's planes and the weighted planes in shared memory a chunk of
//   frames at a time; rows are padded by one float so that the n-indexed
//   reads of one warp fall in distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------- tensor cores, 1 <= M <= 8

constexpr int kMaxTcM = 8;          // largest M of the tensor-core kernel
constexpr int kMaxSources = 8;      // sources a pass (12 registers each)
constexpr int kBinsPerBlock = 8;    // adjacent bins (one warp each) a block
constexpr int kChunk = 32;          // frames a warp takes per step: 8 a lane
constexpr int kFlushChunks = 4;     // chunks an mma accumulator sums at most
constexpr int kPhiTile = 512;       // frames of bf16(phi) staged at a time
constexpr int kBinThreads = 32 * kBinsPerBlock;

// The 8 frames [t, t + 8) of one bf16 row as four packed pairs; zero past T.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* row, int t, int T, bool vec16) {
  if (vec16 && t < T)  // T % 8 == 0: all 8 are in range
    return __ldg(reinterpret_cast<const uint4*>(row + t));
  uint32_t h[8];
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = t + i < T ? r[t + i] : 0u;
  return make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16,
                    h[6] | h[7] << 16);
}

// Two bf16 products, each the exact product rounded to nearest even.
__device__ __forceinline__ uint32_t bmul2(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                             *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

// d += A B for one m16n8k16 tile: bf16 operands, f32 accumulation.
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One 32-frame chunk of all KB sources: xr, xi hold this lane's frames
// [8c, 8c + 8) of mic g; ph points at bf16(phi) of the same frames of the
// first source, rows kPhiTile apart. c1 / c2 are the A x_re^T / A x_im^T
// accumulators of each source.
template <int KB>
__device__ __forceinline__ void mma_chunk(float (&c1)[KB][4], float (&c2)[KB][4],
                                          const uint4& xr, const uint4& xi,
                                          const __nv_bfloat16* ph) {
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    const uint4 p = *reinterpret_cast<const uint4*>(ph + k * kPhiTile);
    // k-step 0: frames 8c + 0..3. A: (row g, slots 2c, 2c+1) = w_re of
    // frames 0, 1; row g + 8 the same of w_im; slots 2c+8, 2c+9 frames 2, 3
    uint32_t wr0 = bmul2(xr.x, p.x), wi0 = bmul2(xi.x, p.x);
    uint32_t wr1 = bmul2(xr.y, p.y), wi1 = bmul2(xi.y, p.y);
    mma16816(c1[k], wr0, wi0, wr1, wi1, xr.x, xr.y);
    mma16816(c2[k], wr0, wi0, wr1, wi1, xi.x, xi.y);
    // k-step 1: frames 8c + 4..7
    wr0 = bmul2(xr.z, p.z);
    wi0 = bmul2(xi.z, p.z);
    wr1 = bmul2(xr.w, p.w);
    wi1 = bmul2(xi.w, p.w);
    mma16816(c1[k], wr0, wi0, wr1, wi1, xr.z, xr.w);
    mma16816(c2[k], wr0, wi0, wr1, wi1, xi.z, xi.w);
  }
}

// Block (x, y): bins [x kBinsPerBlock, ...), sources [y KB, y KB + KB) of K.
// vec16: the planes start on a 16-byte boundary and T % 8 == 0.
template <int KB>
__global__ void __launch_bounds__(kBinThreads) wcov_tc_kernel(
    const __nv_bfloat16* __restrict__ xr, const __nv_bfloat16* __restrict__ xi,
    const float* __restrict__ phi, float2* __restrict__ V, int F, int M, int T, int K,
    float n_frames, bool vec16) {
  __shared__ __align__(16) __nv_bfloat16 sphi[KB * kPhiTile];  // [KB][kPhiTile]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // mic of this lane's A rows and B column
  const int c = lane & 3;   // this lane's frames: [8c, 8c + 8) of a chunk
  const int f = blockIdx.x * kBinsPerBlock + warp;
  const int k0 = blockIdx.y * KB;
  const bool live = f < F;
  const bool has_row = live && g < M;
  const size_t row = (static_cast<size_t>(live ? f : 0) * M + (has_row ? g : 0)) * T;
  const __nv_bfloat16* pr = xr + row;
  const __nv_bfloat16* pi = xi + row;
  const int T_pad = (T + kChunk - 1) / kChunk * kChunk;
  auto load = [&](const __nv_bfloat16* p, int t0) {
    return has_row ? load8(p, t0 + 8 * c, T, vec16) : make_uint4(0u, 0u, 0u, 0u);
  };

  // c1, c2: the mma accumulators; v: (re, im) of (g, 2c), then of
  // (g, 2c + 1), where c1 and c2 are flushed every kFlushChunks chunks
  float c1[KB][4], c2[KB][4], v[KB][4];
#pragma unroll
  for (int k = 0; k < KB; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j) c1[k][j] = c2[k][j] = v[k][j] = 0.f;
  // lane (g, c) holds C[g][2c], C[g][2c+1] (c1[k][0..1], c2[k][0..1]) and
  // C[g+8][2c], C[g+8][2c+1] (c1[k][2..3], c2[k][2..3])
  auto flush = [&]() {
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      v[k][0] += c1[k][0] + c2[k][2];
      v[k][1] += c1[k][2] - c2[k][0];
      v[k][2] += c1[k][1] + c2[k][3];
      v[k][3] += c1[k][3] - c2[k][1];
#pragma unroll
      for (int j = 0; j < 4; ++j) c1[k][j] = c2[k][j] = 0.f;
    }
  };

  // the planes run two chunks ahead of the mma
  int held = 0;  // chunks in c1, c2 since the last flush
  uint4 r0 = load(pr, 0), i0 = load(pi, 0);
  uint4 r1 = load(pr, kChunk), i1 = load(pi, kChunk);
  for (int t0 = 0; t0 < T_pad; t0 += kChunk) {
    const int tt = t0 % kPhiTile;
    if (tt == 0) {  // stage bf16(phi) of frames [t0, t0 + kPhiTile), zero past T and K
      const int n = min(kPhiTile, T_pad - t0) * KB;
      __syncthreads();  // the previous tile is consumed
      for (int idx = threadIdx.x; idx < n; idx += kBinThreads) {
        const int t = idx / KB;
        const int k = idx - t * KB;
        const float p = (t0 + t < T && k0 + k < K)
                            ? phi[static_cast<size_t>(t0 + t) * K + k0 + k] : 0.f;
        sphi[k * kPhiTile + t] = __float2bfloat16_rn(p);
      }
      __syncthreads();
    }
    const uint4 r2 = load(pr, t0 + 2 * kChunk), i2 = load(pi, t0 + 2 * kChunk);
    if (live) mma_chunk<KB>(c1, c2, r0, i0, sphi + tt + 8 * c);
    if (++held == kFlushChunks) {
      flush();
      held = 0;
    }
    r0 = r1;
    i0 = i1;
    r1 = r2;
    i1 = i2;
  }
  flush();
  const int n = 2 * c;
  if (!has_row || n >= M) return;
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    if (k0 + k >= K) break;
    const float re0 = __fdiv_rn(v[k][0], n_frames);
    const float im0 = __fdiv_rn(v[k][1], n_frames);
    const float re1 = __fdiv_rn(v[k][2], n_frames);
    const float im1 = __fdiv_rn(v[k][3], n_frames);
    float2* out = V + ((static_cast<size_t>(k0 + k) * F + f) * M + g) * M + n;
    if (M % 2 == 0) {  // (m, n) and (m, n + 1): one 16-byte store
      *reinterpret_cast<float4*>(out) = make_float4(re0, im0, re1, im1);
    } else {
      out[0] = make_float2(re0, im0);
      if (n + 1 < M) out[1] = make_float2(re1, im1);
    }
  }
}

template <int KB>
int launch_tc(const void* xr, const void* xi, const void* phi, void* V, int F, int M, int T,
              int K, int n_frames, cudaStream_t stream) {
  const bool vec16 = T % 8 == 0 && reinterpret_cast<uintptr_t>(xr) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(xi) % 16 == 0;
  const dim3 grid((F + kBinsPerBlock - 1) / kBinsPerBlock, (K + KB - 1) / KB);
  wcov_tc_kernel<KB><<<grid, kBinThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(xr), static_cast<const __nv_bfloat16*>(xi),
      static_cast<const float*>(phi), static_cast<float2*>(V), F, M, T, K,
      static_cast<float>(n_frames), vec16);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------- CUDA cores, 9 <= M <= 32

constexpr int kStage = 64;            // frames staged per pass
constexpr int kRow = kStage + 1;      // padded row stride in shared memory

__global__ void wcov_packed_kernel(const __nv_bfloat16* __restrict__ xr,
                                   const __nv_bfloat16* __restrict__ xi,
                                   const float* __restrict__ phi,
                                   float2* __restrict__ V,
                                   int F, int M, int T, int K, float n_frames) {
  extern __shared__ float smem[];
  float* sxr = smem;              // (M, kRow) x real
  float* sxi = sxr + M * kRow;    // (M, kRow) x imag
  float* swr = sxi + M * kRow;    // (M, kRow) weighted real
  float* swi = swr + M * kRow;    // (M, kRow) weighted imag

  const int f = blockIdx.x;
  const int k = blockIdx.y;
  const int tid = threadIdx.x;
  const int m = tid / M;
  const int n = tid % M;
  const size_t base = static_cast<size_t>(f) * M * T;

  float acc_re = 0.f;
  float acc_im = 0.f;
  for (int t0 = 0; t0 < T; t0 += kStage) {
    const int tc = min(kStage, T - t0);
    __syncthreads();  // the previous chunk has been consumed
    for (int idx = tid; idx < M * tc; idx += blockDim.x) {
      const int r = idx / tc;
      const int t = idx % tc;
      const float a = __bfloat162float(xr[base + static_cast<size_t>(r) * T + t0 + t]);
      const float b = __bfloat162float(xi[base + static_cast<size_t>(r) * T + t0 + t]);
      const float p = __bfloat162float(
          __float2bfloat16_rn(phi[static_cast<size_t>(t0 + t) * K + k]));
      sxr[r * kRow + t] = a;
      sxi[r * kRow + t] = b;
      swr[r * kRow + t] = __bfloat162float(__float2bfloat16_rn(a * p));
      swi[r * kRow + t] = __bfloat162float(__float2bfloat16_rn(b * p));
    }
    __syncthreads();
    const float* wr_m = swr + m * kRow;
    const float* wi_m = swi + m * kRow;
    const float* xr_n = sxr + n * kRow;
    const float* xi_n = sxi + n * kRow;
    for (int t = 0; t < tc; ++t) {
      // (wr + i wi)(xr - i xi), products of bf16 values are exact in f32
      acc_re = fmaf(wr_m[t], xr_n[t], acc_re);
      acc_re = fmaf(wi_m[t], xi_n[t], acc_re);
      acc_im = fmaf(wi_m[t], xr_n[t], acc_im);
      acc_im = fmaf(-wr_m[t], xi_n[t], acc_im);
    }
  }
  V[((static_cast<size_t>(k) * F + f) * M + m) * M + n] =
      make_float2(__fdiv_rn(acc_re, n_frames), __fdiv_rn(acc_im, n_frames));
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// xr, xi: (F, M, T) bf16; phi: (T, K) f32, contiguous; V: (K, F, M, M)
// complex64, written as V / n_frames. The caller has checked shapes, types,
// devices and contiguity, and that 1 <= M <= 32, F >= 1, 1 <= K <= 65535,
// T >= 1 and n_frames >= 1. 1 <= M <= 8 runs the tensor-core kernel, the
// other M the block-per-(bin, source) kernel.
int wcov_packed_launch(const void* xr, const void* xi, const void* phi, void* V, int F,
                       int M, int T, int K, int n_frames, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= kMaxTcM) {
    switch (K < kMaxSources ? K : kMaxSources) {
      case 1: return launch_tc<1>(xr, xi, phi, V, F, M, T, K, n_frames, st);
      case 2: return launch_tc<2>(xr, xi, phi, V, F, M, T, K, n_frames, st);
      case 3: return launch_tc<3>(xr, xi, phi, V, F, M, T, K, n_frames, st);
      case 4: return launch_tc<4>(xr, xi, phi, V, F, M, T, K, n_frames, st);
      case 5: return launch_tc<5>(xr, xi, phi, V, F, M, T, K, n_frames, st);
      case 6: return launch_tc<6>(xr, xi, phi, V, F, M, T, K, n_frames, st);
      case 7: return launch_tc<7>(xr, xi, phi, V, F, M, T, K, n_frames, st);
      default: return launch_tc<8>(xr, xi, phi, V, F, M, T, K, n_frames, st);
    }
  }
  const dim3 grid(F, K);
  const size_t smem = 4 * static_cast<size_t>(M) * kRow * sizeof(float);
  wcov_packed_kernel<<<grid, M * M, smem, st>>>(
      static_cast<const __nv_bfloat16*>(xr), static_cast<const __nv_bfloat16*>(xi),
      static_cast<const float*>(phi), static_cast<float2*>(V), F, M, T, K,
      static_cast<float>(n_frames));
  return static_cast<int>(cudaGetLastError());
}

const char* wcov_packed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
