// The tap-steering steps of one T-ISS epoch, one launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package runs T-ISS as a lax.scan of XLA
// operations, with no Pallas. This kernel was added because the port's
// eager steps (ops/tap_steps.py::tap_steps_reference: per step a cuBLAS
// batched matrix-vector product for the frame sums and about five
// element-wise passes over Y) ran at 0.4 % of their byte floor on an H100.
//
// What it computes, for every bin f of mixture b = f / (BF / n_mix), on
// complex64 data in f32 arithmetic, given the delayed observations Z
// (T, BF, MK), the outputs Y (T, BF, M), the weights phi (T, n_mix, M) and
// the augmented demixing rows P (BF, M, M + MK):
//
//   for j = 0 .. MK - 1, in order:
//     den_m = sum_t phi[t,b,m] |z_j[t]|^2
//     num_m = sum_t phi[t,b,m] Y[t,m] conj(z_j[t])
//     v_jm  = num_m / max(den_m, 1e-15)
//     Y[:, m] -= v_jm z_j
//   P_out[f, m, :M] = P[f, m, :M],  P_out[f, m, M + j] = P[f, m, M + j] - v_jm
//
// What bounds it: bytes. One launch must read Z once, read and write Y
// once, read phi and write P's tap block: at the tiss_batch cell (T=192,
// BF=8 x 513, M=8, MK=40) 363.6 MB, 108.5 us at 3.35 TB/s
// (benchmark/roofline_taps.py). The f32 work, 22 flops per (t, f, m, step)
// (phi z, the two sums, the update), is 5.5 GFLOP there: 83 us at the card's
// 67 TFLOP/s outside the tensor cores, close behind the bytes. Every sum is
// an f32 multiply-add; no tensor cores (TF32 would keep ~10 mantissa bits).
//
// What the design does about it:
//
// - A warp per bin, kWarps adjacent bins a block. A bin's steps are bin-local
//   and run in order inside its warp (the loop replaces the Python loop over
//   j); the grid covers the BF bins (1,026 blocks at the cell, three resident
//   on each of the 132 SMs: 12 warps an SM).
// - Y stays on chip: lane (g, m) = (lane / kMP, lane % kMP), kMP = M rounded
//   up to a power of two, owns output m at frames t = g + G i, G = 32 / kMP,
//   i < kFPL, in registers for all MK steps. Y is read once and written once.
//   The budget is T <= 256 frames: 2 kFPL <= 128 floats of Y a lane at M = 8
//   (kFPL = 48 at the cell). Frames past T are zeros and add exact zeros.
// - Z is read in place through its strides (the view Xt[:, :, M:]; no copy).
//   Each warp stages its bin's Z kSteps steps at a time (T rows of 32
//   contiguous bytes, whole 32-byte sectors) into shared memory with
//   cp.async, double-buffered: chunk c + 1 is in flight while chunk c's steps
//   run. 16-byte copies where Z's base and strides allow, else 8-byte. Each
//   element of Z leaves device memory once an epoch.
// - The denominators come from the same staged column (no separate pass over
//   Z). Each step: every lane sums its frames (two partial sums each, for
//   instruction-level parallelism), then a butterfly over the G lanes of its
//   output (log2 G shuffle steps of 3 floats) gives all of them the same
//   num, den and so the same bits of v.
// - phi: the block stages the T x M weights of the (at most phi_slots)
//   mixtures its bins belong to, once; the 513 bins of a mixture share them
//   through L2. The block's only barrier follows that copy.
// - P: each v is kept in shared memory (M x MK, MK <= 128: 8 KB a warp at
//   M = 8) and the bin's rows of P_out are written once at the end,
//   coalesced. P_in is only read: the caller's P is never modified.
//
// Shared memory a block: phi_slots x kTPad x kMP floats, then for each warp
// two Z chunks (2 x kTPad x kSteps complex) and v (M x MK, rounded up to an
// even count so that every warp's chunks stay 16-byte aligned). At the cell:
// 12,288 + 4 x 14,848 = 71,680 bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;       // bins (one warp each) a block
constexpr int kSteps = 4;       // steps a staged chunk of Z (even): 32 bytes a frame
constexpr float kEps = 1e-15f;  // the clamp of the denominators (models/tiss.py)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most kPending of this thread's committed groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Copies Z[t, f, j0 .. j0 + w - 1] of one bin (zbin = &Z[0, f, 0]) for
// t < T into rows of kSteps values of dst, as one commit group of this lane.
__device__ __forceinline__ void stage_chunk(const float2* __restrict__ zbin, long long zt,
                                            int T, int j0, int w, float2* dst, int lane,
                                            bool vec16) {
  const float2* src = zbin + j0;
  if (vec16 && w == kSteps) {
    constexpr int kPieces = kSteps / 2;  // 16-byte pieces a frame row
    for (int k = lane; k < kPieces * T; k += 32) {
      const int t = k / kPieces;
      const int h = (k % kPieces) * 2;
      cp_async16(dst + t * kSteps + h, src + t * zt + h);
    }
  } else {
    for (int k = lane; k < w * T; k += 32) {
      const int t = k / w;
      const int jj = k - t * w;
      cp_async8(dst + t * kSteps + jj, src + t * zt + jj);
    }
  }
  cp_async_commit();
}

template <int kMP, int kFPL>
__global__ void __launch_bounds__(32 * kWarps) tap_steps_kernel(
    const float2* __restrict__ P_in, float2* __restrict__ P_out,
    const float2* __restrict__ Y_in, float2* __restrict__ Y_out,
    const float2* __restrict__ Z, long long zt, long long zf,
    const float* __restrict__ phi, int T, int BF, int M, int MK, int n_mix,
    int phi_slots, bool vec16) {
  constexpr int G = 32 / kMP;        // lanes an output: the frame groups
  constexpr int kTPad = G * kFPL;    // frames held; zeros from T on
  constexpr int kChunk = kTPad * kSteps;
  extern __shared__ float4 smem_raw[];
  float* phis = reinterpret_cast<float*>(smem_raw);
  float2* warps = reinterpret_cast<float2*>(phis + phi_slots * kTPad * kMP);
  const int v_len = (M * MK + 1) & ~1;
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

  float2* zbuf = warps + warp * (2 * kChunk + v_len);
  float2* vbuf = zbuf + 2 * kChunk;
  const float* ph = phis + (f / f_mix - b0) * kTPad * kMP;
  const float2* zbin = Z + f * zf;
  const int n_chunks = (MK + kSteps - 1) / kSteps;
  stage_chunk(zbin, zt, T, 0, MK < kSteps ? MK : kSteps, zbuf, lane, vec16);
  // the padded frames of both buffers read as zeros; no copy writes them
  const int pad = (kTPad - T) * kSteps;
  for (int k = lane; k < 2 * pad; k += 32) {
    const int buf = k / pad;
    zbuf[buf * kChunk + T * kSteps + (k - buf * pad)] = make_float2(0.f, 0.f);
  }

  const int m = lane % kMP;
  const int g = lane / kMP;
  float2 y[kFPL];
#pragma unroll
  for (int i = 0; i < kFPL; ++i) {
    const int t = g + G * i;
    y[i] = (t < T && m < M) ? Y_in[(static_cast<long long>(t) * BF + f) * M + m]
                            : make_float2(0.f, 0.f);
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int j0 = c * kSteps;
    const float2* zc = zbuf + (c & 1) * kChunk;
    if (c + 1 < n_chunks) {
      const int rest = MK - j0 - kSteps;
      stage_chunk(zbin, zt, T, j0 + kSteps, rest < kSteps ? rest : kSteps,
                  zbuf + ((c + 1) & 1) * kChunk, lane, vec16);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();  // every lane's copies of chunk c have landed
    const int w = MK - j0 < kSteps ? MK - j0 : kSteps;
    for (int jj = 0; jj < w; ++jj) {
      float ar[2] = {0.f, 0.f}, ai[2] = {0.f, 0.f}, den[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kFPL; ++i) {
        const int t = g + G * i;
        const float2 z = zc[t * kSteps + jj];
        const float p = ph[t * kMP + m];
        const float qx = p * z.x;  // q = phi z: num += y conj(q), den += z conj(q)
        const float qy = p * z.y;
        ar[i & 1] = fmaf(y[i].x, qx, fmaf(y[i].y, qy, ar[i & 1]));
        ai[i & 1] = fmaf(y[i].y, qx, fmaf(-y[i].x, qy, ai[i & 1]));
        den[i & 1] = fmaf(z.x, qx, fmaf(z.y, qy, den[i & 1]));
      }
      float sr = ar[0] + ar[1];
      float si = ai[0] + ai[1];
      float sd = den[0] + den[1];
      // every lane of output m gets the same bits: each butterfly step adds
      // a pair in both orders, and float addition is commutative
#pragma unroll
      for (int o = kMP; o < 32; o <<= 1) {
        sr += __shfl_xor_sync(kFull, sr, o);
        si += __shfl_xor_sync(kFull, si, o);
        sd += __shfl_xor_sync(kFull, sd, o);
      }
      const float d = fmaxf(sd, kEps);
      const float vr = sr / d;
      const float vi = si / d;
      if (g == 0 && m < M) vbuf[m * MK + j0 + jj] = make_float2(vr, vi);
#pragma unroll
      for (int i = 0; i < kFPL; ++i) {  // y -= v z
        const float2 z = zc[(g + G * i) * kSteps + jj];
        y[i].x = fmaf(-vr, z.x, fmaf(vi, z.y, y[i].x));
        y[i].y = fmaf(-vr, z.y, fmaf(-vi, z.x, y[i].y));
      }
    }
    __syncwarp();  // every lane is done with this buffer (and v is visible)
  }

  const int MJ = M + MK;
  const long long row0 = static_cast<long long>(f) * M * MJ;
  for (int k = lane; k < M * MJ; k += 32) {
    const int r = k / MJ;
    const int col = k - r * MJ;
    float2 p = P_in[row0 + k];
    if (col >= M) {
      const float2 v = vbuf[r * MK + col - M];
      p.x -= v.x;
      p.y -= v.y;
    }
    P_out[row0 + k] = p;
  }
#pragma unroll
  for (int i = 0; i < kFPL; ++i) {
    const int t = g + G * i;
    if (t < T && m < M) Y_out[(static_cast<long long>(t) * BF + f) * M + m] = y[i];
  }
}

template <int kMP, int kFPL>
int launch(const void* P_in, void* P_out, const void* Y_in, void* Y_out, const void* Z,
           long long zt, long long zf, const void* phi, int T, int BF, int M, int MK,
           int n_mix, cudaStream_t stream) {
  constexpr int kTPad = (32 / kMP) * kFPL;
  // kWarps adjacent bins straddle at most ceil((kWarps - 1) / f_mix) + 1
  // mixtures of f_mix bins each
  const int f_mix = BF / n_mix;
  const int straddled = (kWarps - 1 + f_mix - 1) / f_mix + 1;
  const int phi_slots = straddled < n_mix ? straddled : n_mix;
  const size_t v_len = static_cast<size_t>((M * MK + 1) & ~1);
  const size_t smem = sizeof(float) * phi_slots * kTPad * kMP +
                      sizeof(float2) * kWarps * (2 * kTPad * kSteps + v_len);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tap_steps_kernel<kMP, kFPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // 16-byte copies where every staged row starts on a 16-byte boundary
  const bool vec16 = reinterpret_cast<uintptr_t>(Z) % 16 == 0 && zt % 2 == 0 && zf % 2 == 0;
  const int blocks = (BF + kWarps - 1) / kWarps;
  tap_steps_kernel<kMP, kFPL><<<blocks, 32 * kWarps, smem, stream>>>(
      static_cast<const float2*>(P_in), static_cast<float2*>(P_out),
      static_cast<const float2*>(Y_in), static_cast<float2*>(Y_out),
      static_cast<const float2*>(Z), zt, zf, static_cast<const float*>(phi), T, BF, M, MK,
      n_mix, phi_slots, vec16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the CUDA error code (0 on success).
// P_in, P_out: (BF, M, M + MK) complex64; Y_in, Y_out: (T, BF, M) complex64;
// phi: (T, n_mix, M) float32; all contiguous. Z: (T, BF, MK) complex64 at
// element strides (zt, zf, 1). All on one device. The caller has checked
// shapes, types and devices, and that 1 <= M <= 8, 1 <= MK <= 128,
// 1 <= T <= 256, BF >= 1 and that n_mix >= 1 divides BF. The frames a lane
// holds (kFPL) are the fewest of the compiled counts that cover T.
int tap_steps_launch(const void* P_in, void* P_out, const void* Y_in, void* Y_out,
                     const void* Z, long long zt, long long zf, const void* phi, int T,
                     int BF, int M, int MK, int n_mix, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TAP_ARGS P_in, P_out, Y_in, Y_out, Z, zt, zf, phi, T, BF, M, MK, n_mix, st
  if (M <= 1) return launch<1, 8>(TAP_ARGS);
  if (M <= 2) return launch<2, 16>(TAP_ARGS);
  if (M <= 4) return T <= 8 * 16 ? launch<4, 16>(TAP_ARGS) : launch<4, 32>(TAP_ARGS);
  if (T <= 4 * 16) return launch<8, 16>(TAP_ARGS);
  if (T <= 4 * 32) return launch<8, 32>(TAP_ARGS);
  if (T <= 4 * 48) return launch<8, 48>(TAP_ARGS);
  return launch<8, 64>(TAP_ARGS);
#undef TAP_ARGS
}

const char* tap_steps_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
