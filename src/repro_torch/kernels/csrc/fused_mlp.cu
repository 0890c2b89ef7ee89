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
// cores does not fit one SM (64 x 2560 x 4 bytes = 655 KB), blocks run in
// no order, and nothing carries over between them.  Three regimes, chosen
// by the wrapper (kernels/fused_mlp.py:choose_regime) from T, D and dtype:
//
// 1. bf16 prefill, fused_mlp_kernel_cluster: tensor cores across a thread-
//    block cluster.  A cluster of kC = 8 CTAs on neighbouring SMs takes one
//    kBT = 64-row tile, split over D: CTA c owns columns [c dc, (c+1) dc)
//    of x and of out.  Its x slice stays in shared memory for the whole F
//    sweep and its out slice is an fp32 accumulator in registers.  For each
//    kBF = 64 chunk of F: (i) each CTA forms partial g and u over its
//    D-slice with mma.sync m16n8k16 (bf16 in, fp32 out), fed by ldmatrix,
//    the next chunk's weight stripes arriving by cp.async meanwhile; (ii)
//    it pushes each 8-column group of its partials into the owning CTA's
//    shared memory (st.async); the owner sums the 8 partials in rank
//    order, forms h in fp32, rounds it to bf16 and pushes its 8 columns of
//    h into every CTA; (iii) each CTA adds h Wd[chunk, slice c] to its out
//    slice.  The cluster's distributed shared memory is the on-chip
//    network between the producer and consumer SMs: partials and h never
//    leave the cluster.  Data crosses it only by st.async, counted on the
//    receiver's mbarrier, so no step waits on a memory fence; a relaxed
//    cluster barrier per chunk says when a buffer may be written again,
//    and the down product of chunk j - 1 runs while chunk j's partials are
//    in flight.  Each weight element is read once per 64 rows, from L2.
//    At large T the kernel is bound by the operations (6 T D F at 989
//    TFLOP/s); what holds it back on this card is the L2 traffic (3 D F x 2
//    bytes per 64 rows), mma.sync fed from shared memory, and the exchange
//    once per chunk.  A cluster's 8 CTAs must share a GPC, so fewer than
//    132 / 8 clusters run at once (cudaOccupancyMaxActiveClusters; the
//    wrapper sizes its splits by it).  With F split over clusters (short
//    T), each split writes an fp32 partial that fused_mlp_kernel_reduce
//    sums.
// 2. bf16 decode (one tile of 4 rows: the serve path's 4 slots),
//    fused_mlp_kernel_rows: bound by reading the weights once (3 D F x 2
//    bytes at 3.35 TB/s: 40 us at qwen2.5-3b width).  F is split into even column ranges, one block each, a whole
//    wave of blocks (two per SM); each thread keeps 2 kRowsInFlight 16-byte
//    loads of Wg and Wu in flight, then twice as many rows of Wd; h stays
//    in shared memory between the gate/up and the down product.
// 3. float32, every T: the same rows kernel on the CUDA cores with fp32
//    products (no TF32), the weights re-read once per kRowsBtF32 = 8 rows.
//
// Determinism.  No atomics: every sum has a fixed order (the cluster's
// rank-order sums, each block's chunks in order, and the reduction of
// per-split partials in a fixed order), so two calls on the same inputs
// give the same bits.  Ragged T, D and F are masked (zero-filled in
// shared memory, stores masked); 16-byte copies are used where the widths
// and pointers allow, element loads elsewhere.

#include <cooperative_groups.h>
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
// Regimes 2 and 3: one block per (BT-row tile, range of F columns); the
// ranges split F evenly in 16-byte groups, so that the blocks of a decode
// call read the same bytes.  The block walks its range in kBF-wide chunks.
// Grid: (row tiles, splits).  x is staged in shared memory as fp32, whole
// if its BT x D fits `x_cols` columns (once per call), else in pieces.
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

  auto stage_x = [&](int d0, int dk) {
    for (int i = tid; i < BT * x_cols; i += kThreads) {
      const int t = i / x_cols;
      const int k = i % x_cols;
      x_s[i] = (t0 + t < n_t && k < dk)
                   ? to_f32(x[static_cast<size_t>(t0 + t) * d + d0 + k])
                   : 0.f;
    }
  };
  if (x_resident) stage_x(0, d);

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
        stage_x(d0, dk);
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
// Regime 1: bf16 prefill on the tensor cores across a cluster of kC CTAs.
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
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
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// mbarriers in shared memory: init (one thread, before a cluster_sync),
// arm a phase with the bytes it awaits, wait for a phase by its parity.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)), "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n .reg .pred p;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)), "r"(parity)
      : "memory");
}
// The address of this CTA's shared-memory location p in CTA `rank`.
__device__ __forceinline__ uint32_t mapa(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
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
  uint64_t* bar_recv = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* bar_h = bar_recv + 1;        // [2], one per h buffer

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
    mbar_init(bar_h + 1, 1);
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
          st_async16(mapa(g, owner), vg, bar);
          st_async16(mapa(u, owner), vu, bar);
        }
      }
    }

    // (iii) of the previous chunk, while the peers catch up
    if (j > 0) {
      if (tid == 0) mbar_expect_tx(bar_h + (j - 1) % 2, L::kHBytes);
      mbar_wait(bar_h + (j - 1) % 2, ((j - 1) / 2) & 1);   // h(j - 1)
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
        st_async16(mapa(hj, r), hv, mapa(bar_h + j % 2, r));
      }
    }
    cluster_arrive_relaxed();            // X(j)
  }
  // X(last): every CTA is past its last exchange; h of the last chunk
  // lands here before the last product, and nothing else will
  cluster_wait();
  if (c_end > c_begin) {
    const int j = c_end - c_begin - 1;
    if (tid == 0) mbar_expect_tx(bar_h + j % 2, L::kHBytes);
    mbar_wait(bar_h + j % 2, (j / 2) & 1);
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
// Host side
// ---------------------------------------------------------------------------
bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Columns of D each CTA of a cluster owns: D / kC rounded up to 8 elements
// (16 bytes), so that every slice starts on a 16-byte boundary.
int cluster_dc(int d) { return ((d + kC - 1) / kC + 7) / 8 * 8; }

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

// Rows a block of the rows regime takes (kernels/fused_mlp.py:ROWS_BT).
constexpr int kRowsBtF32 = 8;
constexpr int kRowsBtBf16 = 4;

// Shared memory the rows kernel stages x in: the whole (BT x D) block of
// x where it fits, else pieces of as many columns as fit.
constexpr int kRowsXBytes = 64 * 1024;

template <int BT>
int rows_x_cols(int d) {
  return std::min(d, kRowsXBytes / (BT * 4));
}

template <typename T, int BT, bool VECOK>
cudaError_t rows_set_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel_rows<T, BT, VECOK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kRowsXBytes);
  return err;
}

template <typename T, int BT, bool VECOK>
cudaError_t launch_rows(const T* x, const T* wg, const T* wu, const T* wd,
                        float* ws, int n_t, int d, int f, int n_split,
                        cudaStream_t stream) {
  cudaError_t err = rows_set_smem<T, BT, VECOK>();
  if (err != cudaSuccess) return err;
  const int x_cols = rows_x_cols<BT>(d);
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
          BT * rows_x_cols<BT>(d) * 4) != cudaSuccess) {
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

// Clusters of the prefill regime that fit the card at once for a D-slice
// tile of dc_tile columns (cudaOccupancyMaxActiveClusters); 0 if none
// fits, negative on an error or an unknown tile.
int fused_mlp_max_active_clusters(int dc_tile) {
  switch (dc_tile) {
    case 64: return max_clusters<64>();
    case 128: return max_clusters<128>();
    case 256: return max_clusters<256>();
    case 320: return max_clusters<320>();
    default: return -1;
  }
}

// x: (T, D); wg, wu: (D, F); wd: (F, D), row-major, one dtype (0 =
// float32, 1 = bfloat16).  ws: n_split * T * D float32 scratch; out:
// (T, D) in the inputs' dtype.  regime 0 = rows (any dtype), 1 = cluster
// (bf16, D-slice tile dc_tile).  Cluster split s takes the kBF-wide F
// chunks [s * cps, (s + 1) * cps); rows split s an even share of F's
// 16-byte column groups, at least one (cps unused).  Launches the regime's kernel and
// the reduce on `stream`; returns the first cudaError_t that is not
// cudaSuccess.
int fused_mlp_launch(const void* x, const void* wg, const void* wu,
                     const void* wd, void* ws, void* out, int n_t, int d,
                     int f, int dtype, int regime, int dc_tile, int n_split,
                     int cps, void* stream) {
  const int n_chunks = (f + kBF - 1) / kBF;
  if (n_t <= 0 || d <= 0 || f <= 0 || n_t > fused_mlp_max_t() ||
      n_split <= 0 || n_split > 65535 ||
      (regime == 1 && (cps <= 0 ||
                       static_cast<long long>(n_split) * cps < n_chunks ||
                       static_cast<long long>(n_split - 1) * cps >= n_chunks)) ||
      (regime == 0 && n_split > (dtype == 0 ? (f + 3) / 4 : (f + 7) / 8))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  const bool ptrs = aligned16(x) && aligned16(wg) && aligned16(wu) &&
                    aligned16(wd);
  const size_t n = static_cast<size_t>(n_t) * d;
  cudaError_t err = cudaErrorInvalidValue;
  if (regime == 1 && dtype == 1 && cluster_dc(d) <= dc_tile) {
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
