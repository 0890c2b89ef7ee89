// Fused SwiGLU MLP for Hopper (sm_90a): out = (silu(x Wg) * (x Wu)) Wd.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_mlp.py:fused_mlp
// (_fused_mlp_kernel).  It keeps that kernel's defining property, the
// PipeOrgan producer->consumer hand-off: a block computes its (BT x kBF)
// tile h of the intermediate from the two producer products, keeps it in
// shared memory, and feeds it straight into the down-projection consumer.
// The (T, F) intermediate never reaches device memory.
//
// Numerics follow the TPU kernel: products accumulate in fp32, h is
// rounded to x's dtype before the down product (fused_mlp.py:40), and
// the fp32 output is cast to x's dtype by the caller (fused_mlp.py:72).
//
// Design.  The Pallas grid swept F in order and revisited one fp32
// output block; Hopper runs blocks in no order, so here each block owns
// one (T tile, F chunk) pair and the down-projection partials of all F
// chunks are reduced with fp32 atomicAdd into a zeroed (T, D) buffer.
// The reduction order therefore changes from run to run (fp32 sums over
// F / kBF partials; the caller's tolerance allows for it).  Ragged T, D
// and F are masked, so qwen2.5-3b's F = 11008 and any slot count work.
//
//   phase 1: K loop over D in kDK chunks; the x chunk is staged in shared
//            memory as fp32; thread (column c, D-slice s) accumulates
//            g, u for its column over rows s, s + kDS, ... (a warp reads
//            32 consecutive columns of one row: coalesced); the kDS
//            partial sums meet in shared memory.
//   phase 2: h (BT x kBF, fp32 after rounding) times rows f0..f0+kBF of
//            Wd, one output column per thread (coalesced rows of Wd),
//            atomically added into out.
//
// What bounds it.  At decode (T = the slot count, 4 on the main path)
// the three weight matrices are read once per call: 3 * D * F * 2 bytes
// = 135.3 MB at qwen2.5-3b width in bf16, about 40 us at the H100 SXM's
// 3.35 TB/s.  The arithmetic (6 T D F flops) is far below the card's
// rate, so the kernel is bound by device-memory bytes.  This design reads
// each weight once per T tile; decode has one T tile, so it can approach
// that bound once the loads keep enough bytes in flight.  Prefill-sized T
// re-reads the weights once per BT rows and runs on CUDA cores, not the
// tensor cores; wgmma, TMA and a persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBF = 32;                  // F columns per block
constexpr int kDS = kThreads / kBF;      // D slices in phase 1 (8)
constexpr int kDK = 128;                 // D rows of x staged per chunk

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round an fp32 value to the storage type T and back (h.astype(x.dtype)).
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T, int BT>
__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                 const T* __restrict__ wu, const T* __restrict__ wd,
                 float* __restrict__ out, int n_t, int d, int f) {
  __shared__ float x_s[BT][kDK];
  __shared__ float red_g[kDS][BT][kBF];
  __shared__ float red_u[kDS][BT][kBF];
  __shared__ float h_s[BT][kBF];

  const int tid = threadIdx.x;
  const int col = tid % kBF;
  const int slice = tid / kBF;           // one warp per D slice
  const int f0 = blockIdx.x * kBF;
  const int t0 = blockIdx.y * BT;
  const int fc = f0 + col;

  // ---- phase 1: g, u = x Wg, x Wu for this block's (BT x kBF) tile ----
  float acc_g[BT];
  float acc_u[BT];
#pragma unroll
  for (int t = 0; t < BT; ++t) {
    acc_g[t] = 0.f;
    acc_u[t] = 0.f;
  }
  for (int d0 = 0; d0 < d; d0 += kDK) {
    const int dk = min(kDK, d - d0);
    __syncthreads();                     // the previous chunk is consumed
    for (int i = tid; i < BT * kDK; i += kThreads) {
      const int t = i / kDK;
      const int k = i % kDK;
      float v = 0.f;
      if (t0 + t < n_t && k < dk) {
        v = to_f32(x[static_cast<size_t>(t0 + t) * d + d0 + k]);
      }
      x_s[t][k] = v;
    }
    __syncthreads();
    if (fc < f) {
      const T* pg = wg + static_cast<size_t>(d0) * f + fc;
      const T* pu = wu + static_cast<size_t>(d0) * f + fc;
#pragma unroll 4
      for (int k = slice; k < dk; k += kDS) {
        const float g = to_f32(pg[static_cast<size_t>(k) * f]);
        const float u = to_f32(pu[static_cast<size_t>(k) * f]);
#pragma unroll
        for (int t = 0; t < BT; ++t) {
          acc_g[t] = fmaf(x_s[t][k], g, acc_g[t]);
          acc_u[t] = fmaf(x_s[t][k], u, acc_u[t]);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < BT; ++t) {
    red_g[slice][t][col] = acc_g[t];
    red_u[slice][t][col] = acc_u[t];
  }
  __syncthreads();

  // ---- the on-chip hand-off: h = silu(g) * u, rounded to T ----
  for (int i = tid; i < BT * kBF; i += kThreads) {
    const int t = i / kBF;
    const int c = i % kBF;
    float g = 0.f;
    float u = 0.f;
#pragma unroll
    for (int s = 0; s < kDS; ++s) {
      g += red_g[s][t][c];
      u += red_u[s][t][c];
    }
    const float h = g / (1.f + expf(-g)) * u;
    h_s[t][c] = (f0 + c < f) ? round_as(h, x) : 0.f;
  }
  __syncthreads();

  // ---- phase 2: out[t0:t0+BT, :] += h Wd[f0:f0+kBF, :] ----
  const int f_len = min(kBF, f - f0);
  const T* pd = wd + static_cast<size_t>(f0) * d;
  for (int n = tid; n < d; n += kThreads) {
    float acc[BT];
#pragma unroll
    for (int t = 0; t < BT; ++t) acc[t] = 0.f;
#pragma unroll 8
    for (int k = 0; k < f_len; ++k) {
      const float w = to_f32(pd[static_cast<size_t>(k) * d + n]);
#pragma unroll
      for (int t = 0; t < BT; ++t) acc[t] = fmaf(h_s[t][k], w, acc[t]);
    }
#pragma unroll
    for (int t = 0; t < BT; ++t) {
      if (t0 + t < n_t) {
        atomicAdd(out + static_cast<size_t>(t0 + t) * d + n, acc[t]);
      }
    }
  }
}

template <typename T, int BT>
cudaError_t launch(const void* x, const void* wg, const void* wu,
                   const void* wd, float* out, int n_t, int d, int f,
                   cudaStream_t stream) {
  const dim3 grid((f + kBF - 1) / kBF, (n_t + BT - 1) / BT);
  fused_mlp_kernel<T, BT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<const T*>(wd), out, n_t, d, f);
  return cudaGetLastError();
}

// The T tile follows T so that decode (a few slots) wastes no rows.
template <typename T>
cudaError_t launch_for_t(const void* x, const void* wg, const void* wu,
                         const void* wd, float* out, int n_t, int d, int f,
                         cudaStream_t stream) {
  if (n_t <= 4) return launch<T, 4>(x, wg, wu, wd, out, n_t, d, f, stream);
  if (n_t <= 8) return launch<T, 8>(x, wg, wu, wd, out, n_t, d, f, stream);
  return launch<T, 16>(x, wg, wu, wd, out, n_t, d, f, stream);
}

}  // namespace

extern "C" {

// Largest T one launch takes (gridDim.y <= 65535 tiles of 16 rows).
int fused_mlp_max_t() { return 65535 * 16; }

// x: (T, D); wg, wu: (D, F); wd: (F, D), all row-major of one dtype
// (0 = float32, 1 = bfloat16).  out: (T, D) float32, zeroed by the
// caller.  Launches on `stream` and returns cudaGetLastError().
int fused_mlp_launch(const void* x, const void* wg, const void* wu,
                     const void* wd, void* out, int n_t, int d, int f,
                     int dtype, void* stream) {
  if (n_t <= 0 || d <= 0 || f <= 0 || n_t > fused_mlp_max_t()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    return static_cast<int>(
        launch_for_t<float>(x, wg, wu, wd, o, n_t, d, f, s));
  }
  if (dtype == 1) {
    return static_cast<int>(
        launch_for_t<__nv_bfloat16>(x, wg, wu, wd, o, n_t, d, f, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fused_mlp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
