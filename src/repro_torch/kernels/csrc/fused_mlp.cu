// Fused SwiGLU MLP for Hopper (sm_90a): out = (silu(x Wg) * (x Wu)) Wd.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_mlp.py:fused_mlp
// (_fused_mlp_kernel).  It keeps that kernel's defining property, the
// PipeOrgan producer->consumer hand-off: the tile h of the intermediate
// that the two producer products make is fed on chip into the
// down-projection consumer.  The (T, F) intermediate never reaches device
// memory.  Numerics follow the TPU kernel: products accumulate in fp32,
// h = silu(g) * u is formed in fp32 and rounded to x's dtype before the
// down product (fused_mlp.py:40), and the fp32 output is cast to x's
// dtype on the way out (fused_mlp.py:72).
//
// The TPU kernel keeps a (bt, D) fp32 output block in VMEM across an
// in-order F sweep.  On this card a tile with enough rows for the tensor
// cores does not fit one SM (64 x 5120 x 4 bytes = 1.3 MB), blocks run in
// no order, and nothing carries over between them.  Three regimes, chosen
// by the wrapper (kernels/fused_mlp.py:choose_regime) from T, D and dtype;
// both cluster regimes split a 64-row tile over D across a cluster of
// kC = 8 CTAs (16 in regime 1 at D > 5120) on neighbouring SMs and pass
// partials and h through the
// cluster's distributed shared memory, the on-chip network between the
// producer and consumer SMs (partials and h never leave the cluster):
//
// 1. bf16 prefill past one row tile, or at D > 2560,
//    fused_mlp_kernel_wgmma<C>: warpgroup MMA fed by TMA.  CTA c of a
//    cluster of C owns the DC columns [c DC, (c + 1) DC) of x and of out,
//    DC = D / C rounded up to a multiple of 64, up to kMaxDC = 640: C = 8
//    for D <= 5120, else C = 16 (a cluster size Hopper allows as
//    non-portable, D <= 10240), where each CTA reduces 4 columns of g and
//    u a chunk instead of 8 and pushes h in 8-byte pieces.  Its x slice is
//    loaded once by TMA and stays in shared memory; its out slice is an
//    fp32 accumulator in the registers of two consumer warpgroups (64 x
//    320 each at DC = 640, in 232 registers a thread by setmaxnreg; the
//    producer warpgroup keeps 40).  For each kBF = 64 chunk of F: (i)
//    consumer 0 forms the partial g and consumer 1 the partial u over the
//    CTA's D-slice, wgmma m64n64k16 from shared memory (x K-major, the
//    weight tiles MN-major, both in the 128-byte swizzled layout that TMA
//    writes); (ii) each 64 / C-column group of the partials goes to the
//    owning CTA's shared memory (st.async); the owner sums the C partials
//    in rank order, forms h in fp32, rounds it to bf16 and pushes its
//    columns of h into every CTA; (iii) each CTA adds h Wd[chunk, slice c] to its out
//    slice, the 64-column blocks of the slice taken by the consumers in
//    turn.  Each consumer has its own ring of kRing = 6 stages of 64 x 64
//    weight tiles (8 KB; the layout is sized for the widest slice); a
//    producer warp per ring issues the TMA loads in the order the
//    consumer reads them, and every consumer warp frees a stage when the
//    products that read it are done, one wgmma group after.  Data crosses
//    the cluster only by st.async, counted on the receiver's mbarrier; a
//    buffer is written again only after every reader has said, by a remote
//    mbarrier arrive, that it is done with it.  The down product of chunk
//    j - 1 runs while chunk j's partials are in flight.  The clusters in
//    launch order walk the row tiles first, so the clusters that run
//    together read the same weight tiles from L2.
//    Bound: at large T the operations (6 T D F at 989 TFLOP/s).  What
//    holds it back (PERF.md): the m64n64 products, one dependent chain a
//    consumer, take most of the time even with every load removed; the
//    loads and the exchange once per chunk add the rest.  A wider N or a
//    second chain needs registers that the out slice holds at DC = 640.  Fewer than 132 / 8 clusters run at once
//    (cudaOccupancyMaxActiveClusters; the wrapper sizes its F splits by
//    it).  TMA needs 16-byte row pitches: the wrapper pads D and F to
//    multiples of 8.
// 2. bf16 decode (one tile of 4 rows: the serve path's 4 slots) and
//    float32 (every T), fused_mlp_kernel_rows: bound by reading the
//    weights once (3 D F x 2 bytes at 3.35 TB/s: 40 us at qwen2.5-3b
//    width, 251 us at qwen1.5-32b's).  F is split into even column
//    ranges, one block each, a whole wave of blocks (two per SM); x is
//    staged once in shared memory as fp32 (whole up to kRowsXBytes: D =
//    5120 at 4 bf16 rows), by 16-byte loads; each thread keeps 2
//    kRowsInFlight 16-byte loads of Wg and Wu in flight, then twice as
//    many rows of Wd; h stays in shared memory between the gate/up and
//    the down product.  float32 runs on the CUDA cores with fp32 products
//    (no TF32), the weights re-read once per kRowsBtF32 = 8 rows.
// 3. bf16 prefill of one row tile (5 <= T <= 64) at D <= 2560,
//    fused_mlp_kernel_cluster: the same hand-off on mma.sync m16n8k16 fed
//    by ldmatrix, 8 warps a CTA, weight stripes by cp.async, x slice and
//    out slice as in regime 1 (D-slice tiles 64, 128, 256, 320 columns),
//    one relaxed cluster barrier a chunk.  Such a call streams every
//    weight once from HBM, and this kernel does that faster than regime 1
//    (PERF.md), which takes every longer call.
// With F split over clusters (short T), each split of a cluster regime
// writes an fp32 partial that fused_mlp_kernel_reduce sums.
//
// Determinism.  No atomics: every sum has a fixed order (the tensor cores'
// own, the cluster's rank-order sums, each block's chunks in order, and
// the reduction of per-split partials in a fixed order), so two calls on
// the same inputs give the same bits.  Ragged T, D and F are masked (zero-
// filled by TMA or in shared memory, stores masked).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;            // 8 warps, every kernel
constexpr int kWarps = kThreads / 32;
constexpr int kBF = 64;                  // F columns per chunk
constexpr int kC = 8;                    // CTAs per cluster (portable max)
constexpr int kBT = 64;                  // rows per cluster tile
constexpr int kRowsInFlight = 4;         // rows kernel: Wg/Wu rows a thread
                                         // loads at once (Wd: twice as many);
                                         // two blocks fit an SM

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

// 16 bytes at p: VECOK, one aligned 16-byte load, every element valid
// (the widths are multiples of the vector); else the first `valid`
// elements one by one, the rest 0.
template <typename T, bool VECOK>
__device__ __forceinline__ uint4 load_raw(const T* p, int valid) {
  if (VECOK) return __ldg(reinterpret_cast<const uint4*>(p));
  constexpr int VEC = 16 / sizeof(T);
  uint4 raw = make_uint4(0, 0, 0, 0);
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if (i < valid) e[i] = p[i];
  }
  return raw;
}

// The VEC elements of a 16-byte vector as fp32.
template <typename T, int VEC>
__device__ __forceinline__ void widen(const uint4& raw, float (&v)[VEC]) {
  static_assert(VEC * sizeof(T) == 16, "one 16-byte vector");
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = to_f32(e[i]);
}

// ---------------------------------------------------------------------------
// Regime 2: one block per (BT-row tile, range of F columns); the ranges
// split F evenly in 16-byte groups, so that the blocks of a decode call
// read the same bytes.  The block walks its range in kBF-wide chunks.
// Grid: (row tiles, splits).  x is staged in shared memory as fp32, whole
// if its BT x D fits `x_cols` columns (once per block), else in pieces.
//   phase 1: g, u (BT x kBF) = x Wg, x Wu.  Thread (column vector v, D row
//            group dg) reads 16-byte vectors of Wg and Wu rows dg, dg + DG,
//            ...; the DG partial sums meet by warp shuffles, then in shared
//            memory, in a fixed order.
//   phase 2: h (rounded to T) times rows of Wd, one 16-byte column vector
//            of out per thread, added to the block's workspace slice.
// ---------------------------------------------------------------------------
template <typename T, int BT, bool VECOK>
__global__ void __launch_bounds__(kThreads, 2)
fused_mlp_kernel_rows(const T* __restrict__ x, const T* __restrict__ wg,
                      const T* __restrict__ wu, const T* __restrict__ wd,
                      float* __restrict__ ws, int n_t, int d, int f,
                      int x_cols) {
  constexpr int VEC = 16 / sizeof(T);    // elements per 16-byte load
  constexpr int CG = kBF / VEC;          // column vectors per chunk
  constexpr int DGW = 32 / CG;           // D rows per warp and step
  constexpr int DG = kWarps * DGW;       // D rows per block and step
  extern __shared__ __align__(16) float x_s[];   // [BT][x_cols]
  __shared__ float red_g[kWarps][BT][kBF];
  __shared__ float red_u[kWarps][BT][kBF];
  __shared__ float h_s[BT][kBF];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int v = lane % CG;
  const int dg = warp * DGW + lane / CG;
  const int t0 = blockIdx.x * BT;
  const int split = blockIdx.y;
  const int n_split = gridDim.y;
  const int groups = (f + VEC - 1) / VEC;
  const int f_begin = static_cast<int>(
      static_cast<long long>(split) * groups / n_split) * VEC;
  const int f_end = min(f, static_cast<int>(static_cast<long long>(split + 1)
                                            * groups / n_split) * VEC);
  const int n_vec = (d + VEC - 1) / VEC;
  const bool x_resident = d <= x_cols;
  float* ws_s = ws + static_cast<size_t>(split) * n_t * d;

  // x[t0.., d0 .. d0 + dk) as fp32; vec: 16-byte loads (VECOK: x_cols
  // and dk are then multiples of VEC)
  auto stage_x = [&](int d0, int dk, bool vec) {
    if (vec) {
      const int per_row = x_cols / VEC;
      for (int i = tid; i < BT * per_row; i += kThreads) {
        const int t = i / per_row;
        const int k = (i % per_row) * VEC;
        float e[VEC];
        if (t0 + t < n_t && k < dk) {
          widen<T, VEC>(load_raw<T, true>(
                            x + static_cast<size_t>(t0 + t) * d + d0 + k, VEC),
                        e);
        } else {
#pragma unroll
          for (int q = 0; q < VEC; ++q) e[q] = 0.f;
        }
#pragma unroll
        for (int q = 0; q < VEC; q += 4) {
          *reinterpret_cast<float4*>(x_s + t * x_cols + k + q) =
              make_float4(e[q], e[q + 1], e[q + 2], e[q + 3]);
        }
      }
    } else {
      for (int i = tid; i < BT * x_cols; i += kThreads) {
        const int t = i / x_cols;
        const int k = i % x_cols;
        x_s[i] = (t0 + t < n_t && k < dk)
                     ? to_f32(x[static_cast<size_t>(t0 + t) * d + d0 + k])
                     : 0.f;
      }
    }
  };
  if (x_resident) stage_x(0, d, VECOK);

  for (int f0 = f_begin; f0 < f_end; f0 += kBF) {
    const int fc = f0 + v * VEC;         // this thread's first column
    const int f_valid = min(VEC, f_end - fc);

    // ---- phase 1 ----
    float acc_g[BT][VEC];
    float acc_u[BT][VEC];
#pragma unroll
    for (int t = 0; t < BT; ++t) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        acc_g[t][e] = 0.f;
        acc_u[t][e] = 0.f;
      }
    }
    for (int d0 = 0; d0 < d; d0 += x_cols) {
      const int dk = min(x_cols, d - d0);
      if (!x_resident) {
        __syncthreads();                 // the previous piece is consumed
        stage_x(d0, dk, false);
      }
      __syncthreads();
      if (f_valid > 0) {
        // kRowsInFlight rows of Wg and Wu per thread are loaded together,
        // then consumed: 2 kRowsInFlight 16-byte loads in flight
        for (int k0 = dg; k0 < dk; k0 += kRowsInFlight * DG) {
          uint4 rg[kRowsInFlight], ru[kRowsInFlight];
#pragma unroll
          for (int i = 0; i < kRowsInFlight; ++i) {
            const int k = k0 + i * DG;
            rg[i] = ru[i] = make_uint4(0, 0, 0, 0);
            if (k < dk) {
              const size_t off = static_cast<size_t>(d0 + k) * f + fc;
              rg[i] = load_raw<T, VECOK>(wg + off, f_valid);
              ru[i] = load_raw<T, VECOK>(wu + off, f_valid);
            }
          }
#pragma unroll
          for (int i = 0; i < kRowsInFlight; ++i) {
            const int k = k0 + i * DG;
            if (k >= dk) break;
            float g[VEC], u[VEC];
            widen<T, VEC>(rg[i], g);
            widen<T, VEC>(ru[i], u);
#pragma unroll
            for (int t = 0; t < BT; ++t) {
              const float xv = x_s[t * x_cols + k];
#pragma unroll
              for (int e = 0; e < VEC; ++e) {
                acc_g[t][e] = fmaf(xv, g[e], acc_g[t][e]);
                acc_u[t][e] = fmaf(xv, u[e], acc_u[t][e]);
              }
            }
          }
        }
      }
    }
    // the DGW row groups of a warp: butterfly sums, the same order in
    // every lane; then the warps' sums in warp order
#pragma unroll
    for (int off = CG; off < 32; off *= 2) {
#pragma unroll
      for (int t = 0; t < BT; ++t) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          acc_g[t][e] += __shfl_xor_sync(0xffffffffu, acc_g[t][e], off);
          acc_u[t][e] += __shfl_xor_sync(0xffffffffu, acc_u[t][e], off);
        }
      }
    }
    if (lane < CG) {
#pragma unroll
      for (int t = 0; t < BT; ++t) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          red_g[warp][t][v * VEC + e] = acc_g[t][e];
          red_u[warp][t][v * VEC + e] = acc_u[t][e];
        }
      }
    }
    __syncthreads();

    // ---- the on-chip hand-off: h = silu(g) * u, rounded to T ----
    for (int i = tid; i < BT * kBF; i += kThreads) {
      const int t = i / kBF;
      const int c = i % kBF;
      float g = 0.f;
      float u = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        g += red_g[w][t][c];
        u += red_u[w][t][c];
      }
      h_s[t][c] =
          (f0 + c < f_end) ? to_f32(from_f32<T>(silu_mul(g, u))) : 0.f;
    }
    __syncthreads();

    // ---- phase 2: ws[t0:t0+BT, :] (+)= h Wd[f0:f0+kBF, :] ----
    const int f_len = min(kBF, f_end - f0);
    for (int n = tid; n < n_vec; n += kThreads) {
      const int col = n * VEC;
      const int d_valid = min(VEC, d - col);
      float acc[BT][VEC];
#pragma unroll
      for (int t = 0; t < BT; ++t) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[t][e] = 0.f;
      }
      for (int k0 = 0; k0 < f_len; k0 += 2 * kRowsInFlight) {
        uint4 rw[2 * kRowsInFlight];
#pragma unroll
        for (int i = 0; i < 2 * kRowsInFlight; ++i) {
          rw[i] = make_uint4(0, 0, 0, 0);
          if (k0 + i < f_len) {
            rw[i] = load_raw<T, VECOK>(
                wd + static_cast<size_t>(f0 + k0 + i) * d + col, d_valid);
          }
        }
#pragma unroll
        for (int i = 0; i < 2 * kRowsInFlight; ++i) {
          if (k0 + i >= f_len) break;
          float w[VEC];
          widen<T, VEC>(rw[i], w);
#pragma unroll
          for (int t = 0; t < BT; ++t) {
            const float hv = h_s[t][k0 + i];
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              acc[t][e] = fmaf(hv, w[e], acc[t][e]);
            }
          }
        }
      }
#pragma unroll
      for (int t = 0; t < BT; ++t) {
        if (t0 + t >= n_t) continue;
        float* p = ws_s + static_cast<size_t>(t0 + t) * d + col;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          if (e < d_valid) p[e] = (f0 == f_begin ? 0.f : p[e]) + acc[t][e];
        }
      }
    }
    // red_* and h_s are rewritten only after the next chunk's barriers
  }
}

// out[i] = the sum over splits s of ws[s][i], cast to T, in a fixed
// order: `groups` threads per element each sum the splits s = g, g +
// groups, ... in order, then the group sums meet in group order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel_reduce(const float* __restrict__ ws, T* __restrict__ out,
                        size_t n, int n_split, int groups) {
  __shared__ float red[kThreads];
  const int per = kThreads / groups;     // elements per block and pass
  const int e = threadIdx.x % per;
  const int g = threadIdx.x / per;
  for (size_t base = blockIdx.x * static_cast<size_t>(per); base < n;
       base += static_cast<size_t>(gridDim.x) * per) {
    const size_t i = base + e;
    float s = 0.f;
    if (i < n) {
#pragma unroll 8
      for (int k = g; k < n_split; k += groups) s += ws[k * n + i];
    }
    red[threadIdx.x] = s;
    __syncthreads();
    if (g == 0 && i < n) {
      float t = red[e];
      for (int q = 1; q < groups; ++q) t += red[q * per + e];
      out[i] = from_f32<T>(t);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// What both cluster regimes share: distributed shared memory, mbarriers.
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kTileBytes = 64 * 64 * 2;  // one 64 x 64 bf16 tile (a TMA box)
constexpr int kMaxDC = 640;              // widest D-slice a CTA owns
constexpr int kMaxNK = kMaxDC / 64;      // its 64-column blocks
constexpr int kMaxNBW = (kMaxNK + 1) / 2;  // down blocks of a warpgroup
constexpr int kWgThreads = 384;          // a producer and two consumer
                                         // warpgroups
constexpr int kSmemLimit = 232448;       // one CTA's shared memory

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Cluster barrier, every thread of every CTA: release, then acquire.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// mbarriers in shared memory (32-bit shared addresses): init (one thread,
// before a cluster_sync), arm a phase with the bytes it awaits, arrive
// (here or, by a cluster address, in a peer), wait for a phase by its
// parity.  A wait still spinning after 20 s traps: a fault in the
// hand-off then ends the launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t cluster_bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          cluster_bar)
      : "memory");
}
// CLUSTER: acquire at cluster scope, for a phase that peers complete
template <bool CLUSTER>
__device__ __forceinline__ bool mbar_try(uint32_t bar, uint32_t parity) {
  uint32_t done;
  if (CLUSTER) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } else {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
  return done != 0;
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
template <bool CLUSTER = false>
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t start = 0;
  for (uint32_t tries = 1; !mbar_try<CLUSTER>(bar, parity); ++tries) {
    if (tries % 1024 == 0) {
      const uint64_t now = global_ns();
      if (start == 0) start = now;
      if (now - start > 20000000000ull) asm volatile("trap;");
    }
  }
}
// The address of shared-memory location `addr` of this CTA in CTA `rank`.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
// 16 bytes into a peer's shared memory; the peer's mbarrier `bar` counts
// them when they have landed.
__device__ __forceinline__ void st_async16(uint32_t addr, uint4 v,
                                           uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(addr), "r"(v.x), "r"(v.y),
      "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}
// 8 bytes into a peer's shared memory, counted like st_async16.
__device__ __forceinline__ void st_async8(uint32_t addr, uint32_t a,
                                          uint32_t b, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 "
      "[%0], {%1, %2}, [%3];\n" ::"r"(addr), "r"(a), "r"(b), "r"(bar)
      : "memory");
}
// ---------------------------------------------------------------------------
// Regime 3: bf16 prefill of one row tile (T <= 64) at D <= 2560, mma.sync
// across a cluster of kC CTAs.
// ---------------------------------------------------------------------------
// 16-byte async copy; src_bytes = 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// four 8x8 b16 matrices; lane l addresses row l % 8 of matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy a ROWS x COLS tile (COLS a multiple of 8) from src (row stride ld)
// into dst (row pitch `pitch`); element (r, c) is valid if r < rv and
// c < cv, else 0.  VECOK: cv is a multiple of 8 and the copies are
// 16-byte cp.async (commit by the caller); else element loads.
template <int ROWS, int COLS, bool VECOK>
__device__ __forceinline__ void load_tile(bf16* dst, int pitch,
                                          const bf16* src, size_t ld, int rv,
                                          int cv, const bf16* safe) {
  constexpr int VPR = COLS / 8;
#pragma unroll 4
  for (int i = threadIdx.x; i < ROWS * VPR; i += kThreads) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    bf16* dp = dst + r * pitch + c;
    const bf16* sp = src + r * ld + c;
    if (VECOK) {
      const bool in = r < rv && c < cv;
      cp_async16(dp, in ? sp : safe, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        dp[e] = (r < rv && c + e < cv) ? sp[e] : __float2bfloat16(0.f);
      }
    }
  }
}

// Split-phase cluster barrier; arrive and wait alternate in every thread
// and the work between them hides the wait.  The relaxed arrive orders no
// memory: the kernel uses it only to say "this CTA is done with a buffer"
// (its reads of the buffer were consumed before it arrives); data crosses
// the cluster by st.async and is awaited on mbarriers.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Shared-memory layout of one CTA for a D-slice tile of DC columns (byte
// offsets).  Rows are padded by 8 elements so that the 8 rows an ldmatrix
// reads fall in distinct banks.  h has two buffers: peers write chunk j's
// while this CTA still reads chunk j - 1's.  recv holds the fp32 partial g
// and u of this CTA's kBF / kC columns from each of the kC CTAs.
template <int DC>
struct ClusterSmem {
  static constexpr int XP = DC + 8;      // pitch of the x and Wd tiles
  static constexpr int WP = kBF + 8;     // pitch of the Wg, Wu and h tiles
  static constexpr int kOwn = kBF / kC;  // columns of g, u a CTA reduces
  static constexpr int kX = 0;                            // x  [kBT][XP]
  static constexpr int kWg = kX + kBT * XP * 2;           // Wg [DC][WP]
  static constexpr int kWu = kWg + DC * WP * 2;           // Wu [DC][WP]
  static constexpr int kWd = kWu + DC * WP * 2;           // Wd [kBF][XP]
  static constexpr int kH = kWd + kBF * XP * 2;           // h  [2][kBT][WP]
  // recv [2 (g, u)][kC (source rank)][kBT][kOwn] fp32
  static constexpr int kRecv = kH + 2 * kBT * WP * 2;
  static constexpr int kRecvBytes = 2 * kC * kBT * kOwn * 4;
  // mbarriers: recv full, h buffer 0 full, h buffer 1 full
  static constexpr int kBar = kRecv + kRecvBytes;
  static constexpr int kHBytes = kC * kBT * kOwn * 2;    // h arriving a chunk
  static constexpr int kBytes = kBar + 3 * 8;
  static_assert(kBytes <= 232448, "one CTA's shared memory");
};

// Warp tiling of both products: warp (wm, wn) = (warp % 2, warp / 2) owns
// rows 32 wm.. (two 16-row mma tiles) and a quarter of the columns: 16 of
// g and of u, DC / 4 of the out slice.  Each ldmatrix of an operand then
// feeds two mma.
// out[:, slice] += h Wd[chunk rows, slice] for one chunk's h and Wd tiles.
template <int DC>
__device__ __forceinline__ void down_product(float (&acc)[2][DC / 32][4],
                                             const bf16* hs, const bf16* wds,
                                             int lane, int wm, int wn) {
  using L = ClusterSmem<DC>;
#pragma unroll
  for (int k = 0; k < kBF; k += 16) {
    uint32_t a[2][4], b[4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      ldsm_x4(a[m], hs + (wm * 32 + m * 16 + lane % 16) * L::WP + k +
                        (lane / 16) * 8);
    }
#pragma unroll
    for (int j = 0; j < DC / 64; ++j) {
      ldsm_x4_t(b, wds + (k + lane % 16) * L::XP + wn * (DC / 4) + j * 16 +
                       (lane / 16) * 8);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        mma16816(acc[m][2 * j], a[m], b[0], b[1]);
        mma16816(acc[m][2 * j + 1], a[m], b[2], b[3]);
      }
    }
  }
}

// Grid: (kC * splits, row tiles), clusters of kC along x.  CTA `rank` of a
// cluster owns D columns [rank * dc, rank * dc + dc); DC >= dc is the
// tile width.
//
// Chunk j runs, in every CTA: the partial products (i) of j; wait X(j-1);
// each 8-column group of the partials pushed into its owner's recv
// (st.async); the down product (iii) of j - 1 once h(j - 1) has arrived;
// the exchange (ii) of j once recv is full: the owned columns summed in
// rank order, h pushed to every CTA; arrive X(j).  X(j-1) says every CTA
// has consumed its recv of j - 1 and its h buffer of j - 2, so both may be
// written again.  Only stores cross the cluster, and no step waits on a
// memory fence.
template <int DC, bool VECOK>
__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_kernel_cluster(const bf16* __restrict__ x,
                         const bf16* __restrict__ wg,
                         const bf16* __restrict__ wu,
                         const bf16* __restrict__ wd,
                         float* __restrict__ ws, bf16* __restrict__ out,
                         int n_t, int d, int f, int dc,
                         int chunks_per_split) {
  using L = ClusterSmem<DC>;
  constexpr int NT = DC / 32;            // 8-column tiles of out per warp
  static_assert(DC % 64 == 0, "pairs of 8-column tiles per warp");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem + L::kX);
  bf16* wgs = reinterpret_cast<bf16*>(smem + L::kWg);
  bf16* wus = reinterpret_cast<bf16*>(smem + L::kWu);
  bf16* wds = reinterpret_cast<bf16*>(smem + L::kWd);
  bf16* hs = reinterpret_cast<bf16*>(smem + L::kH);
  float* recv = reinterpret_cast<float*>(smem + L::kRecv);
  const uint32_t bar_recv = smem_u32(smem + L::kBar);
  const uint32_t bar_h = bar_recv + 8;   // [2], one per h buffer

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wm = (tid / 32) % 2;
  const int wn = (tid / 32) / 2;
  const int split = blockIdx.x / kC;
  const int t0 = blockIdx.y * kBT;
  const int d0 = rank * dc;
  const int dv = max(0, min(dc, d - d0));  // valid columns of the slice
  const int rv = min(kBT, n_t - t0);       // valid rows of the tile
  const int n_chunks = (f + kBF - 1) / kBF;
  const int c_begin = split * chunks_per_split;
  const int c_end = min(n_chunks, c_begin + chunks_per_split);

  auto load_gu = [&](int chunk) {
    const size_t off = static_cast<size_t>(d0) * f + chunk * kBF;
    const int fv = min(kBF, f - chunk * kBF);
    load_tile<DC, kBF, VECOK>(wgs, L::WP, wg + off, f, dv, fv, wg);
    load_tile<DC, kBF, VECOK>(wus, L::WP, wu + off, f, dv, fv, wu);
  };

  float acc[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
    }
  }

  // the x slice (kept for the whole sweep) and the first gate/up stripes;
  // then an empty group in place of "Wd of chunk c_begin - 1"
  load_tile<kBT, DC, VECOK>(xs, L::XP, x + static_cast<size_t>(t0) * d + d0,
                            d, rv, dv, x);
  if (c_begin < c_end) load_gu(c_begin);
  cp_async_commit();
  cp_async_commit();
  if (tid == 0) {
    mbar_init(bar_recv, 1);
    mbar_init(bar_h, 1);
    mbar_init(bar_h + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();                        // every CTA's mbarriers are ready
  cluster_arrive_relaxed();              // X(-1): nothing in use yet

  for (int chunk = c_begin; chunk < c_end; ++chunk) {
    const int j = chunk - c_begin;
    const int f0 = chunk * kBF;
    cp_async_wait<1>();                  // x and this chunk's Wg, Wu
    __syncthreads();

    // (i) partial g, u (kBT x kBF) over this CTA's D-slice
    float pg[2][2][4], pu[2][2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pg[m][q][e] = 0.f;
          pu[m][q][e] = 0.f;
        }
      }
    }
#pragma unroll 4
    for (int k = 0; k < DC; k += 16) {
      uint32_t a[2][4], b[4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        ldsm_x4(a[m], xs + (wm * 32 + m * 16 + lane % 16) * L::XP + k +
                          (lane / 16) * 8);
      }
      const int c = wn * 16 + (lane / 16) * 8;
      ldsm_x4_t(b, wgs + (k + lane % 16) * L::WP + c);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        mma16816(pg[m][0], a[m], b[0], b[1]);
        mma16816(pg[m][1], a[m], b[2], b[3]);
      }
      ldsm_x4_t(b, wus + (k + lane % 16) * L::WP + c);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        mma16816(pu[m][0], a[m], b[0], b[1]);
        mma16816(pu[m][1], a[m], b[2], b[3]);
      }
    }
    __syncthreads();                     // Wg, Wu consumed
    if (chunk + 1 < c_end) load_gu(chunk + 1);   // lands meanwhile
    cp_async_commit();                   // possibly empty: keeps the count

    cluster_wait();                      // X(j-1)
    {
      // lanes l and l ^ 1 hold columns c, c + 1 and c + 2, c + 3 of rows r
      // and r + 8; one shuffle gives the even lane 4 columns of row r and
      // the odd lane 4 of row r + 8, pushed as one 16-byte vector each
      const bool odd = lane & 1;
      const int c4 = ((lane % 4) / 2) * 4;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int row = wm * 32 + m * 16 + lane / 4 + (odd ? 8 : 0);
        const float* g = recv + (rank * kBT + row) * L::kOwn + c4;
        const float* u = g + kC * kBT * L::kOwn;
#pragma unroll
        for (int q = 0; q < 2; ++q) {    // columns 8 (2 wn + q).. -> owner
          const float* pgq = pg[m][q];
          const float* puq = pu[m][q];
          const float sg0 = __shfl_xor_sync(0xffffffffu, odd ? pgq[0] : pgq[2], 1);
          const float sg1 = __shfl_xor_sync(0xffffffffu, odd ? pgq[1] : pgq[3], 1);
          const float su0 = __shfl_xor_sync(0xffffffffu, odd ? puq[0] : puq[2], 1);
          const float su1 = __shfl_xor_sync(0xffffffffu, odd ? puq[1] : puq[3], 1);
          const uint4 vg =
              odd ? make_uint4(__float_as_uint(sg0), __float_as_uint(sg1),
                               __float_as_uint(pgq[2]), __float_as_uint(pgq[3]))
                  : make_uint4(__float_as_uint(pgq[0]), __float_as_uint(pgq[1]),
                               __float_as_uint(sg0), __float_as_uint(sg1));
          const uint4 vu =
              odd ? make_uint4(__float_as_uint(su0), __float_as_uint(su1),
                               __float_as_uint(puq[2]), __float_as_uint(puq[3]))
                  : make_uint4(__float_as_uint(puq[0]), __float_as_uint(puq[1]),
                               __float_as_uint(su0), __float_as_uint(su1));
          const int owner = wn * 2 + q;
          const uint32_t bar = mapa(bar_recv, owner);
          st_async16(mapa(smem_u32(g), owner), vg, bar);
          st_async16(mapa(smem_u32(u), owner), vu, bar);
        }
      }
    }

    // (iii) of the previous chunk, while the peers catch up
    if (j > 0) {
      if (tid == 0) mbar_expect_tx(bar_h + (j - 1) % 2 * 8, L::kHBytes);
      mbar_wait(bar_h + (j - 1) % 2 * 8, ((j - 1) / 2) & 1);   // h(j - 1)
      cp_async_wait<1>();                // Wd of chunk - 1
      __syncthreads();
      down_product<DC>(acc, hs + ((j - 1) % 2) * kBT * L::WP, wds, lane, wm,
                       wn);
    }
    __syncthreads();                     // Wd consumed
    load_tile<kBF, DC, VECOK>(wds, L::XP,
                              wd + static_cast<size_t>(f0) * d + d0, d,
                              min(kBF, f - f0), dv, wd);
    cp_async_commit();

    // (ii) exchange: this CTA's kOwn columns of g and u summed over the
    // kC partials in rank order, h formed in fp32, rounded to bf16 and
    // pushed into every CTA's h buffer of this chunk
    if (tid == 0) mbar_expect_tx(bar_recv, L::kRecvBytes);
    mbar_wait(bar_recv, j & 1);          // every partial of chunk j
    {
      const int row = tid / 4;
      const int c2 = (tid % 4) * 2;
      float g0 = 0.f, g1 = 0.f, u0 = 0.f, u1 = 0.f;
#pragma unroll
      for (int r = 0; r < kC; ++r) {
        const float* p = recv + (r * kBT + row) * L::kOwn + c2;
        const float2 g = *reinterpret_cast<const float2*>(p);
        const float2 u =
            *reinterpret_cast<const float2*>(p + kC * kBT * L::kOwn);
        g0 += g.x;
        g1 += g.y;
        u0 += u.x;
        u1 += u.y;
      }
      const __nv_bfloat162 h2 =
          __floats2bfloat162_rn(silu_mul(g0, u0), silu_mul(g1, u1));
      // the 4 lanes of a row gather its kOwn = 8 columns (16 bytes); lane
      // i of the 4 pushes them into CTAs 2 i and 2 i + 1
      uint32_t h4[4];
      const uint32_t mine = *reinterpret_cast<const uint32_t*>(&h2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        h4[i] = __shfl_sync(0xffffffffu, mine, (lane & ~3) + i);
      }
      const uint4 hv = make_uint4(h4[0], h4[1], h4[2], h4[3]);
      const bf16* hj =
          hs + (j % 2) * kBT * L::WP + row * L::WP + rank * L::kOwn;
#pragma unroll
      for (int r = 2 * (tid % 4); r < 2 * (tid % 4) + 2; ++r) {
        st_async16(mapa(smem_u32(hj), r), hv, mapa(bar_h + j % 2 * 8, r));
      }
    }
    cluster_arrive_relaxed();            // X(j)
  }
  // X(last): every CTA is past its last exchange; h of the last chunk
  // lands here before the last product, and nothing else will
  cluster_wait();
  if (c_end > c_begin) {
    const int j = c_end - c_begin - 1;
    if (tid == 0) mbar_expect_tx(bar_h + j % 2 * 8, L::kHBytes);
    mbar_wait(bar_h + j % 2 * 8, (j / 2) & 1);
    cp_async_wait<0>();
    __syncthreads();
    down_product<DC>(acc, hs + (j % 2) * kBT * L::WP, wds, lane, wm, wn);
  }

  // one split: the result in bf16; else this split's fp32 partial
  float* part = ws + static_cast<size_t>(split) * n_t * d;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = wn * (DC / 4) + j * 8 + (lane % 4) * 2;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = t0 + wm * 32 + m * 16 + lane / 4 + half * 8;
        if (row >= n_t) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (col + e < dv) {
            const size_t i = static_cast<size_t>(row) * d + d0 + col + e;
            if (out != nullptr) {
              out[i] = __float2bfloat16(acc[m][j][half * 2 + e]);
            } else {
              part[i] = acc[m][j][half * 2 + e];
            }
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Regime 1: bf16 prefill, wgmma fed by TMA across a cluster of kC CTAs.
// ---------------------------------------------------------------------------
// One 64 x 64 tile of a 2-D tensor map at (column c0, row c1) into shared
// memory, counted on `bar`; parts outside the tensor arrive as zeros.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* tm,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Shared-memory matrix descriptor of a wgmma operand in the 128-byte
// swizzled layout: K-major (x, h: rows of 64 K values) with lbo 16,
// MN-major (the weight tiles: rows of 64 N values, one row a K index)
// with lbo the distance to the next 64 N columns; sbo 1024 = 8 rows.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// keep the compiler from moving accumulator reads or writes across wgmma
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// d (64x64 fp32 over the warpgroup, 32 a thread) = (accumulate ? d : 0)
// + a (64x16, K-major, shared) b (16x64, MN-major, shared)
__device__ __forceinline__ void wgmma_kn(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (+)= a (64 x 64 K-major tile at a_addr) b (64 x 64 MN-major tile at
// b_addr): four k16 steps, issued as one wgmma group and not waited for
__device__ __forceinline__ void tile_issue(float (&d)[32], uint32_t a_addr,
                                           uint32_t b_addr, bool accumulate) {
  fence_regs(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_kn(d, wgmma_desc(a_addr + kk * 32, 16, 1024),
             wgmma_desc(b_addr + kk * 16 * 128, 64 * 128, 1024),
             accumulate || kk > 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  fence_regs(d);
}
// wait until at most N of this warpgroup's wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory layout of one CTA of a C-CTA cluster (byte offsets from a
// 1024-byte aligned base; the swizzled tiles need that alignment).  x:
// kMaxNK 64-column blocks of the slice; h: two 64 x 64 buffers (peers
// write chunk j's while this CTA still reads chunk j - 1's); two rings of
// kRing weight tiles, one per warpgroup; recv: the fp32 partial g and u of
// this CTA's kOwn columns from each CTA; then the mbarriers.  recv and h
// take the same bytes at C = 8 and 16 (C kOwn = kBF), so the ring depth
// is the same.
template <int C>
struct WgSmem {
  static constexpr int kOwn = kBF / C;   // columns of g, u a CTA reduces
  static constexpr int kX = 0;
  static constexpr int kH = kX + kMaxNK * kTileBytes;
  static constexpr int kRingBase = kH + 2 * kTileBytes;
  static constexpr int kRecvBytes = 2 * C * kBT * kOwn * 4;
  static constexpr int kHBytes = C * kBT * kOwn * 2;     // h arriving a chunk
  static constexpr int kBarSlots = 64;
  static constexpr int kRing =
      (kSmemLimit - 1024 - kRingBase - kRecvBytes - kBarSlots * 8) /
      (2 * kTileBytes);
  static constexpr int kRecv = kRingBase + 2 * kRing * kTileBytes;
  // mbarriers: full[2][kRing], empty[2][kRing], x, recv, h[2], recv_ok,
  // h_ok[2]
  static constexpr int kBar = kRecv + kRecvBytes;
  static constexpr int kFull = kBar;
  static constexpr int kEmpty = kFull + 2 * kRing * 8;
  static constexpr int kXFull = kEmpty + 2 * kRing * 8;
  static constexpr int kRecvFull = kXFull + 8;
  static constexpr int kHFull = kRecvFull + 8;
  static constexpr int kRecvOk = kHFull + 16;
  static constexpr int kHOk = kRecvOk + 8;
  static constexpr int kEnd = kHOk + 16;
  static constexpr int kBytes = kEnd + 1024;             // + the alignment
  static_assert(kRing >= 2 && 4 * kRing + 7 <= kBarSlots, "barriers");
  static_assert(kBytes <= kSmemLimit, "one CTA's shared memory");
};

// Grid: C * splits * row tiles CTAs along x, in clusters of C (8, or 16
// where 8 slices of kMaxDC do not cover D), the row tiles fastest.  CTA `rank` of a cluster owns D columns [rank * dc,
// rank * dc + dc), dc = 64 nk.  Three warpgroups: warpgroup 0 produces
// (its warp w < 2 issues the TMA loads of ring w; it keeps 40 registers a
// thread), warpgroups 1 and 2 consume rings 0 (gate) and 1 (up) and hold
// the out slice (232 registers a thread).
//
// Step s = 0 .. nch of a split's nch chunks, in every CTA: U(s), the
// partial products of chunk s, and their push to the owners once every
// owner has read its recv of chunk s - 1 (recv_ok); D(s - 1), the down
// product, once h(s - 1) has arrived; X(s), the exchange: the owned
// columns summed in rank order once recv is full, recv_ok signalled to
// every CTA, h_ok(s - 1) too (D(s - 1) is done), and h(s) pushed to every
// CTA once every CTA has done D(s - 2).  Only stores and mbarrier arrives
// cross the cluster.
template <int C>
__global__ void __launch_bounds__(kWgThreads, 1)
fused_mlp_kernel_wgmma(const __grid_constant__ CUtensorMap tm_x,
                       const __grid_constant__ CUtensorMap tm_g,
                       const __grid_constant__ CUtensorMap tm_u,
                       const __grid_constant__ CUtensorMap tm_d,
                       float* __restrict__ ws, bf16* __restrict__ out,
                       int n_t, int d, int f, int nk, int chunks_per_split) {
  using L = WgSmem<C>;
  constexpr int R = L::kRing;
  constexpr int kOwn = L::kOwn;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  float* recv = reinterpret_cast<float*>(
      smem_raw + (base - smem_u32(smem_raw)) + L::kRecv);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wg = tid / 128 - 1;          // consumer: 0 gate, 1 up; -1 producer
  const int wtid = tid % 128;
  const int wwarp = wtid / 32;           // warp within the warpgroup
  // clusters in launch order walk the row tiles first, so that the
  // clusters that run together read the same weight tiles (from L2)
  const int n_tiles = (n_t + kBT - 1) / kBT;
  const int cl = static_cast<int>(blockIdx.x) / C;
  const int split = cl / n_tiles;
  const int t0 = (cl % n_tiles) * kBT;
  const int d0 = rank * nk * 64;
  const int n_chunks = (f + kBF - 1) / kBF;
  const int c_begin = split * chunks_per_split;
  const int nch = min(n_chunks, c_begin + chunks_per_split) - c_begin;

  const uint32_t x_full = base + L::kXFull;
  const uint32_t recv_full = base + L::kRecvFull;
  const uint32_t h_full = base + L::kHFull;       // [2]
  const uint32_t recv_ok = base + L::kRecvOk;
  const uint32_t h_ok = base + L::kHOk;           // [2]

  if (tid == 0) {
    for (int s = 0; s < 2 * R; ++s) {
      mbar_init(base + L::kFull + s * 8, 1);
      mbar_init(base + L::kEmpty + s * 8, 4);   // one arrive a warp
    }
    mbar_init(x_full, 1);
    mbar_init(recv_full, 1);
    mbar_init(h_full, 1);
    mbar_init(h_full + 8, 1);
    mbar_init(recv_ok, C);
    mbar_init(h_ok, C);
    mbar_init(h_ok + 8, C);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();                        // every CTA's mbarriers are ready

  if (wg < 0) {
    // ---- producer: warp w < 2 streams ring w; its tiles in the order
    // its consumer reads them, each once the consumer freed its stage ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (wwarp < 2 && lane == 0) {
      const int w = wwarp;
      const int nbw = (nk + 1 - w) / 2;
      const uint32_t ring = base + L::kRingBase + w * R * kTileBytes;
      const uint32_t full = base + L::kFull + w * R * 8;
      const uint32_t empty = base + L::kEmpty + w * R * 8;
      if (w == 0) {
        mbar_expect_tx(x_full, nk * kTileBytes);
        for (int k = 0; k < nk; ++k) {
          tma_load(base + L::kX + k * kTileBytes, &tm_x, d0 + k * 64, t0,
                   x_full);
        }
      }
      // the tiles in the order the consumer reads them, step by step:
      // U(s), the nk 64-row stripes of the gate (w 0) or up (w 1)
      // weights over the slice for chunk s, then D(s - 1), the nbw
      // 64-column blocks 2 i + w of Wd[chunk s - 1 rows, slice]
      const CUtensorMap* up = w ? &tm_u : &tm_g;
      int slot = 0, n = 0;
      uint32_t phase = 0;                // parity of the stage's use
      auto put = [&](const CUtensorMap* map, int col, int row) {
        if (n++ >= R) mbar_wait(empty + slot * 8, phase ^ 1);
        mbar_expect_tx(full + slot * 8, kTileBytes);
        tma_load(ring + slot * kTileBytes, map, col, row, full + slot * 8);
        if (++slot == R) {
          slot = 0;
          phase ^= 1;
        }
      };
      for (int s = 0; s <= nch; ++s) {
        if (s < nch) {
          for (int k = 0; k < nk; ++k) {
            put(up, (c_begin + s) * kBF, d0 + k * 64);
          }
        }
        if (s > 0) {
          for (int i = 0; i < nbw; ++i) {
            put(&tm_d, d0 + (2 * i + w) * 64, (c_begin + s - 1) * kBF);
          }
        }
      }
    }
    __syncwarp();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int ctid = tid - 128;          // 0 .. 255 over both consumers
    const int nbw = (nk + 1 - wg) / 2;   // down blocks of this warpgroup
    const uint32_t ring = base + L::kRingBase + wg * R * kTileBytes;
    const uint32_t full = base + L::kFull + wg * R * 8;
    const uint32_t empty = base + L::kEmpty + wg * R * 8;
    // this warp is done with item n: free its stage
    auto release = [&](int n) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + (n % R) * 8);
    };

    float acc[kMaxNBW][32];              // out[:, blocks 2 i + wg]
#pragma unroll
    for (int i = 0; i < kMaxNBW; ++i) {
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[i][e] = 0.f;
    }
    float part[32];                      // partial g (wg 0) or u (wg 1)

    int n = 0;                           // this warpgroup's next item
    for (int s = 0; s <= nch; ++s) {
      if (s < nch) {
        // ---- U(s): part = x[:, slice] W[slice, chunk s]; each tile's
        // products issued once it has landed, the previous tile's stage
        // freed once its products are done ----
        if (s == 0) mbar_wait(x_full, 0);
        for (int k = 0; k < nk; ++k, ++n) {
          mbar_wait(full + (n % R) * 8, (n / R) & 1);
          tile_issue(part, base + L::kX + k * kTileBytes,
                     ring + (n % R) * kTileBytes, k > 0);
          if (k > 0) {
            wgmma_wait<1>();
            release(n - 1);
          }
        }
        wgmma_wait<0>();
        fence_regs(part);
        release(n - 1);
        // ---- push each 4-column group of part to its owner ----
        // lanes l and l ^ 1 hold columns c, c + 1 and c + 2, c + 3 of
        // rows r and r + 8; one shuffle gives the even lane 4 columns of
        // row r and the odd lane 4 of row r + 8, pushed as one 16-byte
        // vector each: C = 8, to CTA q at column c4 of its recv; C = 16,
        // to CTA 2 q + c4 / 4 at column 0
        constexpr bool kWhole = kOwn == 8;   // a CTA owns a whole group
        if (s > 0) mbar_wait<true>(recv_ok, (s - 1) & 1);
        const bool odd = lane & 1;
        const int c4 = ((lane % 4) / 2) * 4;
        const int row = wwarp * 16 + lane / 4 + (odd ? 8 : 0);
        const uint32_t dst =
            smem_u32(recv + ((wg * C + rank) * kBT + row) * kOwn +
                     (kWhole ? c4 : 0));
#pragma unroll
        for (int q = 0; q < 8; ++q) {    // columns 8 q .. 8 q + 7
          const int owner = kWhole ? q : 2 * q + c4 / 4;
          const float* p = part + 4 * q;
          const float s0 = __shfl_xor_sync(0xffffffffu, odd ? p[0] : p[2], 1);
          const float s1 = __shfl_xor_sync(0xffffffffu, odd ? p[1] : p[3], 1);
          const uint4 v =
              odd ? make_uint4(__float_as_uint(s0), __float_as_uint(s1),
                               __float_as_uint(p[2]), __float_as_uint(p[3]))
                  : make_uint4(__float_as_uint(p[0]), __float_as_uint(p[1]),
                               __float_as_uint(s0), __float_as_uint(s1));
          st_async16(mapa(dst, owner), v, mapa(recv_full, owner));
        }
      }
      if (s > 0) {
        // ---- D(s - 1): out[:, own blocks] += h(s - 1) Wd[chunk, block] ----
        const int j = s - 1;
        if (ctid == 0) mbar_expect_tx(h_full + (j % 2) * 8, L::kHBytes);
        mbar_wait<true>(h_full + (j % 2) * 8, (j / 2) & 1);
        // h arrived by st.async; wgmma reads it through the async proxy
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const uint32_t h_tile = base + L::kH + (j % 2) * kTileBytes;
#pragma unroll
        for (int i = 0; i < kMaxNBW; ++i) {
          if (i < nbw) {
            mbar_wait(full + (n % R) * 8, (n / R) & 1);
            tile_issue(acc[i], h_tile, ring + (n % R) * kTileBytes, true);
            if (i > 0) {
              wgmma_wait<1>();
              release(n - 1);
            }
            ++n;
          }
        }
        if (nbw > 0) {
          wgmma_wait<0>();
          release(n - 1);
        }
#pragma unroll
        for (int i = 0; i < kMaxNBW; ++i) fence_regs(acc[i]);
      }
      if (s < nch) {
        // ---- X(s): this CTA's kOwn columns of g and u summed over the
        // C partials in rank order, h formed in fp32, rounded to bf16 and
        // pushed into every CTA's h buffer of chunk s; a thread takes
        // kOwn / 4 columns of a row ----
        if (ctid == 0) mbar_expect_tx(recv_full, L::kRecvBytes);
        mbar_wait<true>(recv_full, s & 1);
        constexpr int kCols = kOwn / 4;
        const int row = ctid / 4;
        const int cc = (ctid % 4) * kCols;
        float g[kCols], u[kCols];
#pragma unroll
        for (int e = 0; e < kCols; ++e) g[e] = u[e] = 0.f;
#pragma unroll
        for (int r = 0; r < C; ++r) {
          const float* p = recv + (r * kBT + row) * kOwn + cc;
          if constexpr (kCols == 2) {      // 8-byte loads
            const float2 gv = *reinterpret_cast<const float2*>(p);
            const float2 uv =
                *reinterpret_cast<const float2*>(p + C * kBT * kOwn);
            g[0] += gv.x;
            g[1] += gv.y;
            u[0] += uv.x;
            u[1] += uv.y;
          } else {
            g[0] += p[0];
            u[0] += p[C * kBT * kOwn];
          }
        }
        // both consumers: recv read, D(s - 1) done
        asm volatile("bar.sync 1, 256;\n" ::: "memory");
        if (ctid < C) mbar_arrive_cluster(mapa(recv_ok, ctid));
        if (s > 0 && ctid >= C && ctid < 2 * C) {
          mbar_arrive_cluster(mapa(h_ok + ((s - 1) % 2) * 8, ctid - C));
        }
        // the 4 lanes of a row gather its kOwn columns (2 kOwn bytes),
        // which sit at byte 2 rank kOwn of the row: 16-byte chunk byte / 16
        // (swizzled with the row) and byte % 16 in it; lane i of the 4
        // pushes them into CTAs i C / 4 .. (i + 1) C / 4 - 1
        const int byte = rank * kOwn * 2;
        const uint32_t hj = base + L::kH + (s % 2) * kTileBytes + row * 128 +
                            ((((byte >> 4) ^ (row & 7))) << 4) + (byte & 15);
        const uint32_t hbar = h_full + (s % 2) * 8;
        if constexpr (kCols == 2) {
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(
              silu_mul(g[0], u[0]), silu_mul(g[1], u[1]));
          uint32_t h4[4];
          const uint32_t mine = *reinterpret_cast<const uint32_t*>(&h2);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            h4[i] = __shfl_sync(0xffffffffu, mine, (lane & ~3) + i);
          }
          const uint4 hv = make_uint4(h4[0], h4[1], h4[2], h4[3]);
          if (s >= 2) mbar_wait<true>(h_ok + (s % 2) * 8, ((s - 2) / 2) & 1);
#pragma unroll
          for (int r = (C / 4) * (ctid % 4); r < (C / 4) * (ctid % 4 + 1);
               ++r) {
            st_async16(mapa(hj, r), hv, mapa(hbar, r));
          }
        } else {
          static_assert(kCols == 1, "a thread forms 1 or 2 columns of h");
          const bf16 h1 = __float2bfloat16_rn(silu_mul(g[0], u[0]));
          const uint32_t mine = static_cast<uint32_t>(
              *reinterpret_cast<const uint16_t*>(&h1));
          // lanes 4 j .. 4 j + 3 hold a row's 4 columns: pair them
          const uint32_t lo = __shfl_sync(0xffffffffu, mine, lane & ~3);
          const uint32_t m1 = __shfl_sync(0xffffffffu, mine, (lane & ~3) + 1);
          const uint32_t m2 = __shfl_sync(0xffffffffu, mine, (lane & ~3) + 2);
          const uint32_t m3 = __shfl_sync(0xffffffffu, mine, (lane & ~3) + 3);
          const uint32_t w0 = lo | (m1 << 16), w1 = m2 | (m3 << 16);
          if (s >= 2) mbar_wait<true>(h_ok + (s % 2) * 8, ((s - 2) / 2) & 1);
#pragma unroll
          for (int r = (C / 4) * (ctid % 4); r < (C / 4) * (ctid % 4 + 1);
               ++r) {
            st_async8(mapa(hj, r), w0, w1, mapa(hbar, r));
          }
        }
      }
    }

    // one split: the result in bf16; else this split's fp32 partial (the
    // stores need no peer, so they go before the last cluster barrier)
    float* ws_s = ws + static_cast<size_t>(split) * n_t * d;
#pragma unroll
    for (int i = 0; i < kMaxNBW; ++i) {
      if (i >= nbw) continue;
      const int col0 = d0 + (2 * i + wg) * 64 + (lane % 4) * 2;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int col = col0 + q * 8;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = t0 + wwarp * 16 + lane / 4 + half * 8;
          if (row >= n_t || col >= d) continue;
          const size_t o = static_cast<size_t>(row) * d + col;
          const float a = acc[i][4 * q + 2 * half];
          const float b = acc[i][4 * q + 2 * half + 1];
          if (out != nullptr) {
            *reinterpret_cast<__nv_bfloat162*>(out + o) =
                __floats2bfloat162_rn(a, b);
          } else {
            *reinterpret_cast<float2*>(ws_s + o) = make_float2(a, b);
          }
        }
      }
    }
  }
  // no CTA leaves while a peer may still write its shared memory
  cluster_sync();
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 64-column blocks of D each CTA of a C-CTA cluster owns: D / C rounded up
// to a multiple of 64, so that slices never overlap and every TMA box of x
// and Wg, Wu rows lies in one slice (or past D, where TMA reads zeros).
int wgmma_nk(int d, int c) { return ((d + c - 1) / c + 63) / 64; }

template <typename T>
cudaError_t launch_reduce(const float* ws, T* out, size_t n, int n_split,
                          cudaStream_t stream) {
  const int groups = n_split >= 8 ? 8 : n_split >= 4 ? 4 : n_split >= 2 ? 2 : 1;
  const size_t per = kThreads / groups;
  const size_t blocks = std::min<size_t>((n + per - 1) / per, 132 * 16);
  fused_mlp_kernel_reduce<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                               stream>>>(ws, out, n, n_split, groups);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, looked up with cudaGetDriverEntryPoint (no
// link against libcuda).
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// A (rows, cols) row-major bf16 tensor in 64 x 64 boxes, 128-byte swizzle,
// zeros outside (cols a multiple of 8, base 16-byte aligned).
bool tensor_map(CUtensorMap* m, const void* ptr, int rows, int cols) {
  const PFN_cuTensorMapEncodeTiled_v12000 fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, 64};
  const cuuint32_t elem[2] = {1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int C>
cudaLaunchConfig_t wgmma_config(int n_split, int n_tiles, cudaStream_t stream,
                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * n_split * n_tiles, 1, 1);
  cfg.blockDim = dim3(kWgThreads, 1, 1);
  cfg.dynamicSmemBytes = WgSmem<C>::kBytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Dynamic shared memory above 48 KB must be allowed once per kernel, and
// a cluster of more than 8 CTAs (not portable: Hopper runs up to 16).
template <int C>
cudaError_t wgmma_set_attributes() {
  static const cudaError_t err = [] {
    cudaError_t e = cudaFuncSetAttribute(
        fused_mlp_kernel_wgmma<C>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, WgSmem<C>::kBytes);
    if (e == cudaSuccess && C > 8) {
      e = cudaFuncSetAttribute(fused_mlp_kernel_wgmma<C>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    }
    return e;
  }();
  return err;
}

// With one split the kernel writes the bf16 result itself; else each
// split writes its fp32 partial to ws and fused_mlp_kernel_reduce sums.
template <int C>
cudaError_t launch_wgmma(const bf16* x, const bf16* wg, const bf16* wu,
                         const bf16* wd, float* ws, bf16* out, int n_t,
                         int d, int f, int n_split, int cps,
                         cudaStream_t stream) {
  cudaError_t err = wgmma_set_attributes<C>();
  if (err != cudaSuccess) return err;
  CUtensorMap tx, tg, tu, td;
  if (!tensor_map(&tx, x, n_t, d) || !tensor_map(&tg, wg, d, f) ||
      !tensor_map(&tu, wu, d, f) || !tensor_map(&td, wd, f, d)) {
    return cudaErrorInvalidValue;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      wgmma_config<C>(n_split, (n_t + kBT - 1) / kBT, stream, attr);
  err = cudaLaunchKernelEx(&cfg, fused_mlp_kernel_wgmma<C>, tx, tg, tu, td,
                           ws, n_split == 1 ? out : nullptr, n_t, d, f,
                           wgmma_nk(d, C), cps);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess && n_split > 1) {
    err = launch_reduce(ws, out, static_cast<size_t>(n_t) * d, n_split,
                        stream);
  }
  return err;
}

// Columns of D each CTA of an mma.sync cluster owns: D / kC rounded up to
// 8 elements (16 bytes), so that every slice starts on a 16-byte boundary.
int cluster_dc(int d) { return ((d + kC - 1) / kC + 7) / 8 * 8; }

template <int DC>
cudaLaunchConfig_t cluster_config(int n_split, int n_tiles,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kC * n_split, n_tiles, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = ClusterSmem<DC>::kBytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kC;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Dynamic shared memory above 48 KB must be allowed once per kernel.
template <int DC, bool VECOK>
cudaError_t cluster_set_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel_cluster<DC, VECOK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, ClusterSmem<DC>::kBytes);
  return err;
}

template <int DC, bool VECOK>
cudaError_t launch_cluster(const bf16* x, const bf16* wg, const bf16* wu,
                           const bf16* wd, float* ws, bf16* out, int n_t,
                           int d, int f, int n_split, int cps,
                           cudaStream_t stream) {
  cudaError_t err = cluster_set_smem<DC, VECOK>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config<DC>(n_split, (n_t + kBT - 1) / kBT, stream, attr);
  err = cudaLaunchKernelEx(&cfg, fused_mlp_kernel_cluster<DC, VECOK>, x, wg,
                           wu, wd, ws, out, n_t, d, f, cluster_dc(d), cps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// With one split the kernel writes the bf16 result itself; else each
// split writes its fp32 partial to ws and fused_mlp_kernel_reduce sums.
template <int DC>
cudaError_t launch_cluster(const bf16* x, const bf16* wg, const bf16* wu,
                           const bf16* wd, float* ws, bf16* out, int n_t,
                           int d, int f, int n_split, int cps, bool vec,
                           cudaStream_t stream) {
  bf16* direct = n_split == 1 ? out : nullptr;
  cudaError_t err =
      vec ? launch_cluster<DC, true>(x, wg, wu, wd, ws, direct, n_t, d, f,
                                     n_split, cps, stream)
          : launch_cluster<DC, false>(x, wg, wu, wd, ws, direct, n_t, d, f,
                                      n_split, cps, stream);
  if (err == cudaSuccess && n_split > 1) {
    err = launch_reduce(ws, out, static_cast<size_t>(n_t) * d, n_split,
                        stream);
  }
  return err;
}

template <int DC>
int max_clusters() {
  if (cluster_set_smem<DC, true>() != cudaSuccess) return -1;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config<DC>(1, 1, nullptr, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(
          &n, fused_mlp_kernel_cluster<DC, true>, &cfg) != cudaSuccess) {
    return -1;
  }
  return n;
}

template <int C>
int wgmma_max_clusters() {
  if (wgmma_set_attributes<C>() != cudaSuccess) return -1;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = wgmma_config<C>(1, 1, nullptr, attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, fused_mlp_kernel_wgmma<C>, &cfg) !=
      cudaSuccess) {
    return -1;
  }
  return n;
}

// Rows a block of the rows regime takes (kernels/fused_mlp.py:ROWS_BT).
constexpr int kRowsBtF32 = 8;
constexpr int kRowsBtBf16 = 4;

// Shared memory the rows kernel stages x in: the whole (BT x D) block of
// x where it fits, else pieces of as many columns as fit; with the static
// buffers (17 KB in bf16, 34 KB in float32) two blocks still fit an SM.
// bf16 at 4 rows holds D <= 5120 whole, float32 at 8 rows D <= 2048.
template <typename T>
constexpr int kRowsXBytes = sizeof(T) == 2 ? 80 * 1024 : 64 * 1024;

template <typename T, int BT>
int rows_x_cols(int d) {
  return std::min(d, kRowsXBytes<T> / (BT * 4));
}

template <typename T, int BT, bool VECOK>
cudaError_t rows_set_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel_rows<T, BT, VECOK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kRowsXBytes<T>);
  return err;
}

template <typename T, int BT, bool VECOK>
cudaError_t launch_rows(const T* x, const T* wg, const T* wu, const T* wd,
                        float* ws, int n_t, int d, int f, int n_split,
                        cudaStream_t stream) {
  cudaError_t err = rows_set_smem<T, BT, VECOK>();
  if (err != cudaSuccess) return err;
  const int x_cols = rows_x_cols<T, BT>(d);
  const dim3 grid((n_t + BT - 1) / BT, n_split);
  fused_mlp_kernel_rows<T, BT, VECOK>
      <<<grid, kThreads, BT * x_cols * 4, stream>>>(x, wg, wu, wd, ws, n_t,
                                                    d, f, x_cols);
  return cudaGetLastError();
}

template <typename T, int BT>
cudaError_t launch_rows(const void* x, const void* wg, const void* wu,
                        const void* wd, float* ws, int n_t, int d, int f,
                        int n_split, bool vec, cudaStream_t stream) {
  const T *tx = static_cast<const T*>(x), *tg = static_cast<const T*>(wg),
          *tu = static_cast<const T*>(wu), *td = static_cast<const T*>(wd);
  return vec ? launch_rows<T, BT, true>(tx, tg, tu, td, ws, n_t, d, f,
                                        n_split, stream)
             : launch_rows<T, BT, false>(tx, tg, tu, td, ws, n_t, d, f,
                                         n_split, stream);
}

template <typename T, int BT>
int rows_blocks_per_sm(int d) {
  if (rows_set_smem<T, BT, true>() != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, fused_mlp_kernel_rows<T, BT, true>, kThreads,
          BT * rows_x_cols<T, BT>(d) * 4) != cudaSuccess) {
    return -1;
  }
  return n;
}

}  // namespace

extern "C" {

// Largest T one launch takes (gridDim.y <= 65535 cluster tiles of kBT).
int fused_mlp_max_t() { return 65535 * kBT; }

// Blocks of the rows regime that fit one SM at once for a width D and a
// dtype (0 = float32, 1 = bfloat16); negative on an error.
int fused_mlp_rows_blocks_per_sm(int dtype, int d) {
  if (d <= 0) return -1;
  if (dtype == 0) return rows_blocks_per_sm<float, kRowsBtF32>(d);
  if (dtype == 1) return rows_blocks_per_sm<bf16, kRowsBtBf16>(d);
  return -1;
}

// Clusters that fit the card at once (cudaOccupancyMaxActiveClusters) of
// the wgmma regime (regime 1, tile = its cluster's CTAs, 8 or 16) or of
// the mma.sync regime (regime 2, tile = its D-slice tile); 0 if none fits,
// negative on an error or an unknown tile.
int fused_mlp_max_active_clusters(int regime, int tile) {
  if (regime == 1 && tile == 8) return wgmma_max_clusters<8>();
  if (regime == 1 && tile == 16) return wgmma_max_clusters<16>();
  if (regime != 2) return -1;
  switch (tile) {
    case 64: return max_clusters<64>();
    case 128: return max_clusters<128>();
    case 256: return max_clusters<256>();
    case 320: return max_clusters<320>();
    default: return -1;
  }
}

// x: (T, D); wg, wu: (D, F); wd: (F, D), row-major, one dtype (0 =
// float32, 1 = bfloat16).  ws: n_split * T * D float32 scratch; out:
// (T, D) in the inputs' dtype.  regime 0 = rows (any dtype), 1 = wgmma
// (bf16, clusters of dc_tile = 8 or 16 CTAs, D <= dc_tile kMaxDC, D and F
// multiples of 8, 16-byte aligned pointers), 2 = mma.sync cluster (bf16,
// D-slice tile dc_tile).  A
// cluster regime's split s takes the kBF-wide F chunks [s * cps, (s + 1)
// * cps); rows split s an even share of F's 16-byte column groups, at
// least one (cps unused).  Launches the regime's kernel and the reduce on
// `stream`; returns the first cudaError_t that is not cudaSuccess.
int fused_mlp_launch(const void* x, const void* wg, const void* wu,
                     const void* wd, void* ws, void* out, int n_t, int d,
                     int f, int dtype, int regime, int dc_tile, int n_split,
                     int cps, void* stream) {
  const int n_chunks = (f + kBF - 1) / kBF;
  const bool ptrs = aligned16(x) && aligned16(wg) && aligned16(wu) &&
                    aligned16(wd);
  if (n_t <= 0 || d <= 0 || f <= 0 || n_t > fused_mlp_max_t() ||
      n_split <= 0 || n_split > 65535 ||
      ((regime == 1 || regime == 2) &&
       (dtype != 1 || cps <= 0 ||
        static_cast<long long>(n_split) * cps < n_chunks ||
        static_cast<long long>(n_split - 1) * cps >= n_chunks)) ||
      (regime == 1 && ((dc_tile != 8 && dc_tile != 16) ||
                       d > dc_tile * kMaxDC || d % 8 != 0 || f % 8 != 0 ||
                       !ptrs || !aligned16(out))) ||
      (regime == 2 && cluster_dc(d) > dc_tile) ||
      (regime == 0 && n_split > (dtype == 0 ? (f + 3) / 4 : (f + 7) / 8))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  const size_t n = static_cast<size_t>(n_t) * d;
  cudaError_t err = cudaErrorInvalidValue;
  if (regime == 1) {
    const bf16 *bx = static_cast<const bf16*>(x),
               *bg = static_cast<const bf16*>(wg),
               *bu = static_cast<const bf16*>(wu),
               *bd = static_cast<const bf16*>(wd);
    bf16* o = static_cast<bf16*>(out);
    err = dc_tile == 8
              ? launch_wgmma<8>(bx, bg, bu, bd, w, o, n_t, d, f, n_split,
                                cps, s)
              : launch_wgmma<16>(bx, bg, bu, bd, w, o, n_t, d, f, n_split,
                                 cps, s);
  } else if (regime == 2) {
    const bf16 *bx = static_cast<const bf16*>(x),
               *bg = static_cast<const bf16*>(wg),
               *bu = static_cast<const bf16*>(wu),
               *bd = static_cast<const bf16*>(wd);
    const bool vec = ptrs && d % 8 == 0 && f % 8 == 0;
    bf16* o = static_cast<bf16*>(out);
    switch (dc_tile) {
      case 64: err = launch_cluster<64>(bx, bg, bu, bd, w, o, n_t, d, f, n_split, cps, vec, s); break;
      case 128: err = launch_cluster<128>(bx, bg, bu, bd, w, o, n_t, d, f, n_split, cps, vec, s); break;
      case 256: err = launch_cluster<256>(bx, bg, bu, bd, w, o, n_t, d, f, n_split, cps, vec, s); break;
      case 320: err = launch_cluster<320>(bx, bg, bu, bd, w, o, n_t, d, f, n_split, cps, vec, s); break;
      default: break;
    }
  } else if (regime == 0 && dtype == 0) {
    const bool vec = ptrs && d % 4 == 0 && f % 4 == 0;
    err = launch_rows<float, kRowsBtF32>(x, wg, wu, wd, w, n_t, d, f,
                                         n_split, vec, s);
    if (err == cudaSuccess) {
      err = launch_reduce(w, static_cast<float*>(out), n, n_split, s);
    }
  } else if (regime == 0 && dtype == 1) {
    const bool vec = ptrs && d % 8 == 0 && f % 8 == 0;
    err = launch_rows<bf16, kRowsBtBf16>(x, wg, wu, wd, w, n_t, d, f,
                                         n_split, vec, s);
    if (err == cudaSuccess) {
      err = launch_reduce(w, static_cast<bf16*>(out), n, n_split, s);
    }
  }
  return static_cast<int>(err);
}

const char* fused_mlp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
