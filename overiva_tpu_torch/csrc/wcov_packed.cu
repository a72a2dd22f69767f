// All-source weighted covariances from bf16 planes, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel overiva_tpu/ops/pallas_wcov.py
// (_wcov_kernel, launched by _wcov_packed_planes). It computes, in f32,
//
//   vr[k,f,m,n] + i vi[k,f,m,n] = sum_t w[k,f,m,t] * conj(x[f,n,t])
//   w = bf16(x[f,m,t] * bf16(phi[t,k]))
//
// with x given as bf16 real and imaginary planes of shape (F, M, T). The
// weighted operand is rounded to bf16 exactly where the Pallas kernel
// rounds it: the f32 product of two bf16 values is exact, so one
// round-to-nearest-even of that product equals bf16 x bf16 in JAX and in
// PyTorch. The caller divides by T.
//
// What bounds it: at the main-path shape (K=3, F=2049, M=8, T=128) one pass
// reads F*M*T*4 B = 8.4 MB of planes and does about 0.2 G real multiply-adds.
// That is microseconds of bandwidth and far less of the card's f32 rate, so
// the kernel is bound by latency and occupancy, not by bytes. The TPU packed
// 16 bins into one 128-row MXU tile and threw away the off-diagonal blocks;
// here each output is an M x M block small enough for one thread per
// element, so no packing and no F padding are needed.
//
// Design: one block per (bin, source). The block stages the bin's planes
// and the source's bf16-weighted planes into shared memory, a chunk of
// frames at a time, and each of its M*M threads owns one (m, n) output and
// accumulates over the chunk in f32. Rows of the staged planes are padded
// by one float so the n-indexed reads of one warp fall in distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;            // frames staged per pass
constexpr int kRow = kChunk + 1;      // padded row stride in shared memory

__global__ void wcov_packed_kernel(const __nv_bfloat16* __restrict__ xr,
                                   const __nv_bfloat16* __restrict__ xi,
                                   const float* __restrict__ phi,
                                   float* __restrict__ vr,
                                   float* __restrict__ vi,
                                   int F, int M, int T, int K) {
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
  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int tc = min(kChunk, T - t0);
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
  const size_t out = ((static_cast<size_t>(k) * F + f) * M + m) * M + n;
  vr[out] = acc_re;
  vi[out] = acc_im;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// The caller has checked shapes, types, devices and contiguity, and that
// 1 <= M*M <= 1024, F >= 1, 1 <= K <= 65535 and T >= 1.
int wcov_packed_launch(const void* xr, const void* xi, const void* phi,
                       void* vr, void* vi, int F, int M, int T, int K,
                       void* stream) {
  const dim3 grid(F, K);
  const int threads = M * M;
  const size_t smem = 4 * static_cast<size_t>(M) * kRow * sizeof(float);
  wcov_packed_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(xr), static_cast<const __nv_bfloat16*>(xi),
      static_cast<const float*>(phi), static_cast<float*>(vr),
      static_cast<float*>(vi), F, M, T, K);
  return static_cast<int>(cudaGetLastError());
}

const char* wcov_packed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
