// The M source-steering steps of one ISS or T-ISS epoch, one launch, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs ISS and T-ISS as XLA
// operations, with no Pallas. This kernel was added because the port's
// eager steps (ops/iss_steps.py::iss_steps_reference: per step two cuBLAS
// batched matrix-vector products for the frame sums and about eighteen
// element-wise passes over Y and W) ran at under 1 % of their byte floor on
// an H100.
//
// What it computes, for every bin f of mixture b = f / (BF / n_mix), on
// complex64 data in f32 arithmetic, given the outputs Y (T, BF, M), the
// weights phi (T, n_mix, M) and the demixing rows W (BF, M, J) of any row
// width J (T-ISS steers its augmented rows):
//
//   for n = 0 .. M - 1, in order:
//     num_m = sum_t phi[t,b,m] Y[t,m] conj(Y[t,n])
//     den_m = sum_t phi[t,b,m] |Y[t,n]|^2
//     v_m   = num_m / max(den_m, 1e-15)                 (m != n)
//     v_n   = 1 - rsqrt(max(den_n / T, 1e-15))
//     Y[:, m] -= v_m Y[:, n];   W[m, :] -= v_m W[n, :]
//
// T is the tensor's frame count, padded frames included, as in the plain
// steps.
//
// What bounds it: bytes. One launch must read and write Y once, read and
// write W once and read phi: at the tiss_batch cell (T=192, BF=8 x 513,
// M=8, J=48) 126.0 MB, 37.6 us at 3.35 TB/s
// (benchmark/roofline_sources.py). The f32 work, 22 flops per (t, f, m,
// step) (phi y_n, the two sums, the update), is 1.1 GFLOP there: 17 us at
// the card's 67 TFLOP/s outside the tensor cores. Every sum is an f32 multiply-add; no tensor cores (TF32
// would keep ~10 mantissa bits).
//
// What the design does about it:
//
// - A warp per bin, kWarps adjacent bins a block. A bin's steps are
//   bin-local and run in order inside its warp (the loop replaces the
//   Python loop over n).
// - Y stays on chip: lane (g, m) = (lane / kMP, lane % kMP), kMP = M
//   rounded up to a power of two, owns output m at frames t = g + G i,
//   G = 32 / kMP, i < kFPL, in registers for all M steps. Y is read once and
//   written once. The budget is T <= 256 frames (kFPL = 48 at the cell).
//   Frames past T are zeros and add exact zeros.
// - Step n needs y_n at every lane's frames. The lanes of output n write
//   their column into the warp's shared memory (kTPad complex, 1.5 KB at the
//   cell) and every lane reads it back: one 8-byte load a frame, where
//   shuffles from lane (g, n) would take two, and the G distinct addresses
//   of a load are broadcasts without bank conflicts.
// - Each step: every lane sums its frames (two partial sums each, for
//   instruction-level parallelism), then a butterfly over the G lanes of its
//   output (log2 G shuffle steps of 3 floats) gives all of them the same
//   num, den and so the same bits of v.
// - W is not touched step by step. The lanes keep the M x M transform
//   A = (I - v^(M-1) e_(M-1)^T) ... (I - v^(0) e_0^T), which steps the same
//   way: lane (g, m) holds A[m][k] for k = g + G j, and at step n takes
//   A[n][k] by one shuffle from lane (g, n), which holds the same k. At the
//   end A goes to shared memory and W_out = A W is written in one coalesced
//   pass, a column of W a lane: W is read once and written once, and J
//   takes no shared memory or registers beyond that column.
// - phi: the block stages the T x M weights of the (at most phi_slots)
//   mixtures its bins belong to, once, zero-padded; the 513 bins of a
//   mixture share them through L2. The block's only barrier follows that
//   copy.
// - The inputs are only read: the caller's W and Y are never modified.
//
// Shared memory a block: phi_slots x kTPad x kMP floats, then for each warp
// y_n's column (kTPad complex) and A (kMP x kMP complex). At the cell:
// 12,288 + 4 x 2,048 = 20,480 bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;       // bins (one warp each) a block
constexpr float kEps = 1e-15f;  // the clamp of the denominators (models/auxiva_iss.py)
constexpr unsigned kFull = 0xffffffffu;

template <int kMP, int kFPL>
__global__ void __launch_bounds__(32 * kWarps) iss_steps_kernel(
    const float2* __restrict__ W_in, float2* __restrict__ W_out,
    const float2* __restrict__ Y_in, float2* __restrict__ Y_out,
    const float* __restrict__ phi, int T, int BF, int M, int J, int n_mix, int phi_slots) {
  constexpr int G = 32 / kMP;            // lanes an output: the frame groups
  constexpr int kTPad = G * kFPL;        // frames held; zeros from T on
  constexpr int kA = (kMP + G - 1) / G;  // entries of A's row a lane holds
  extern __shared__ float4 smem_raw[];
  float* phis = reinterpret_cast<float*>(smem_raw);
  float2* warps = reinterpret_cast<float2*>(phis + phi_slots * kTPad * kMP);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f_mix = BF / n_mix;
  const int f0 = blockIdx.x * kWarps;
  const int b0 = f0 / f_mix;

  // phi (kTPad x kMP, zero-padded) of each mixture the block's bins are in
  for (int k = threadIdx.x; k < phi_slots * kTPad * kMP; k += blockDim.x) {
    const int s = k / (kTPad * kMP);
    const int t = (k / kMP) % kTPad;
    const int m = k % kMP;
    const int b = b0 + s;
    phis[k] = (b < n_mix && t < T && m < M)
                  ? phi[(static_cast<long long>(t) * n_mix + b) * M + m]
                  : 0.f;
  }
  __syncthreads();
  const int f = f0 + warp;
  if (f >= BF) return;

  float2* col = warps + warp * (kTPad + kMP * kMP);
  float2* abuf = col + kTPad;
  const float* ph = phis + (f / f_mix - b0) * kTPad * kMP;
  const int m = lane % kMP;
  const int g = lane / kMP;
  float2 y[kFPL];
#pragma unroll
  for (int i = 0; i < kFPL; ++i) {
    const int t = g + G * i;
    y[i] = (t < T && m < M) ? Y_in[(static_cast<long long>(t) * BF + f) * M + m]
                            : make_float2(0.f, 0.f);
  }
  float2 a[kA];  // A[m][g + G j], the identity at the start
#pragma unroll
  for (int j = 0; j < kA; ++j) a[j] = make_float2(g + G * j == m ? 1.f : 0.f, 0.f);

  for (int n = 0; n < M; ++n) {
    if (m == n) {
#pragma unroll
      for (int i = 0; i < kFPL; ++i) col[g + G * i] = y[i];
    }
    __syncwarp();  // y_n's column is in place
    float ar[2] = {0.f, 0.f}, ai[2] = {0.f, 0.f}, den[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kFPL; ++i) {
      const int t = g + G * i;
      const float2 yn = col[t];
      const float p = ph[t * kMP + m];
      const float qx = p * yn.x;  // q = phi y_n: num += y conj(q), den += y_n conj(q)
      const float qy = p * yn.y;
      ar[i & 1] = fmaf(y[i].x, qx, fmaf(y[i].y, qy, ar[i & 1]));
      ai[i & 1] = fmaf(y[i].y, qx, fmaf(-y[i].x, qy, ai[i & 1]));
      den[i & 1] = fmaf(yn.x, qx, fmaf(yn.y, qy, den[i & 1]));
    }
    float sr = ar[0] + ar[1];
    float si = ai[0] + ai[1];
    float sd = den[0] + den[1];
    // every lane of output m gets the same bits: each butterfly step adds a
    // pair in both orders, and float addition is commutative
#pragma unroll
    for (int o = kMP; o < 32; o <<= 1) {
      sr += __shfl_xor_sync(kFull, sr, o);
      si += __shfl_xor_sync(kFull, si, o);
      sd += __shfl_xor_sync(kFull, sd, o);
    }
    float vr, vi;
    if (m == n) {
      vr = 1.f - rsqrtf(fmaxf(sd / static_cast<float>(T), kEps));
      vi = 0.f;
    } else {  // outputs past M have phi = 0: v = 0, nothing moves
      const float d = fmaxf(sd, kEps);
      vr = sr / d;
      vi = si / d;
    }
#pragma unroll
    for (int i = 0; i < kFPL; ++i) {  // y -= v y_n
      const float2 yn = col[g + G * i];
      y[i].x = fmaf(-vr, yn.x, fmaf(vi, yn.y, y[i].x));
      y[i].y = fmaf(-vr, yn.y, fmaf(-vi, yn.x, y[i].y));
    }
#pragma unroll
    for (int j = 0; j < kA; ++j) {  // A[m] -= v A[n]: lane (g, n) holds A[n][g + G j]
      const float anx = __shfl_sync(kFull, a[j].x, g * kMP + n);
      const float any = __shfl_sync(kFull, a[j].y, g * kMP + n);
      a[j].x = fmaf(-vr, anx, fmaf(vi, any, a[j].x));
      a[j].y = fmaf(-vr, any, fmaf(-vi, anx, a[j].y));
    }
    __syncwarp();  // every lane is done with the column before the next step writes it
  }

#pragma unroll
  for (int i = 0; i < kFPL; ++i) {
    const int t = g + G * i;
    if (t < T && m < M) Y_out[(static_cast<long long>(t) * BF + f) * M + m] = y[i];
  }
#pragma unroll
  for (int j = 0; j < kA; ++j) {
    const int k = g + G * j;
    if (k < kMP) abuf[m * kMP + k] = a[j];
  }
  __syncwarp();  // A is in place
  const long long row0 = static_cast<long long>(f) * M * J;
  for (int c = lane; c < J; c += 32) {  // W_out[:, c] = A W[:, c]
    float2 w[kMP];
#pragma unroll
    for (int k = 0; k < kMP; ++k)
      w[k] = k < M ? W_in[row0 + static_cast<long long>(k) * J + c] : make_float2(0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kMP; ++r) {
      if (r >= M) break;
      float ox = 0.f, oy = 0.f;
#pragma unroll
      for (int k = 0; k < kMP; ++k) {
        const float2 ak = abuf[r * kMP + k];
        ox = fmaf(ak.x, w[k].x, fmaf(-ak.y, w[k].y, ox));
        oy = fmaf(ak.x, w[k].y, fmaf(ak.y, w[k].x, oy));
      }
      W_out[row0 + static_cast<long long>(r) * J + c] = make_float2(ox, oy);
    }
  }
}

template <int kMP, int kFPL>
int launch(const void* W_in, void* W_out, const void* Y_in, void* Y_out, const void* phi,
           int T, int BF, int M, int J, int n_mix, cudaStream_t stream) {
  constexpr int kTPad = (32 / kMP) * kFPL;
  // kWarps adjacent bins straddle at most ceil((kWarps - 1) / f_mix) + 1
  // mixtures of f_mix bins each
  const int f_mix = BF / n_mix;
  const int straddled = (kWarps - 1 + f_mix - 1) / f_mix + 1;
  const int phi_slots = straddled < n_mix ? straddled : n_mix;
  const size_t smem = sizeof(float) * phi_slots * kTPad * kMP +
                      sizeof(float2) * kWarps * (kTPad + kMP * kMP);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        iss_steps_kernel<kMP, kFPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (BF + kWarps - 1) / kWarps;
  iss_steps_kernel<kMP, kFPL><<<blocks, 32 * kWarps, smem, stream>>>(
      static_cast<const float2*>(W_in), static_cast<float2*>(W_out),
      static_cast<const float2*>(Y_in), static_cast<float2*>(Y_out),
      static_cast<const float*>(phi), T, BF, M, J, n_mix, phi_slots);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the CUDA error code (0 on success).
// W_in, W_out: (BF, M, J) complex64; Y_in, Y_out: (T, BF, M) complex64;
// phi: (T, n_mix, M) float32; all contiguous, on one device. The caller has
// checked shapes, types and devices, and that 1 <= M <= 8, M <= J,
// 1 <= T <= 256, BF >= 1 and that n_mix >= 1 divides BF. The frames a lane
// holds (kFPL) are the fewest of the compiled counts that cover T.
int iss_steps_launch(const void* W_in, void* W_out, const void* Y_in, void* Y_out,
                     const void* phi, int T, int BF, int M, int J, int n_mix, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ISS_ARGS W_in, W_out, Y_in, Y_out, phi, T, BF, M, J, n_mix, st
  if (M <= 1) return launch<1, 8>(ISS_ARGS);
  if (M <= 2) return launch<2, 16>(ISS_ARGS);
  if (M <= 4) return T <= 8 * 16 ? launch<4, 16>(ISS_ARGS) : launch<4, 32>(ISS_ARGS);
  if (T <= 4 * 16) return launch<8, 16>(ISS_ARGS);
  if (T <= 4 * 32) return launch<8, 32>(ISS_ARGS);
  if (T <= 4 * 48) return launch<8, 48>(ISS_ARGS);
  return launch<8, 64>(ISS_ARGS);
#undef ISS_ARGS
}

const char* iss_steps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
