// Flash attention for Hopper (sm_90a): online-softmax attention with
// causal and sliding-window masks, GQA by head-group indexing.
//
//   o[b, i, h] = sum_j softmax_j(scale q[b, i, h] . k[b, j, h / G])
//                      v[b, j, h / G]
//
// over the keys j that the masks admit: j <= i if causal, i - j < window if
// window > 0.  scale = hd^-1/2, G = H / Hkv.  Inputs are float32 or
// bfloat16; scores, the running max and sum and the output accumulator are
// fp32, and the output is written in the inputs' type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (_flash_kernel).  Its semantics are kept: masked scores
// are the finite -1e30 (flash_attention.py:23), p = exp(s - m_new),
// alpha = exp(m_prev - m_new), and the output is acc / max(l, 1e-30).
//
// Both regimes keep the Pallas kernel's state on chip.  Its grid
// (BH, S / bq, T / bk) swept the kv axis in order with acc, m and l in
// VMEM scratch.  Hopper runs blocks in no order, so one block owns one
// (query tile, head, batch) and the kv sweep is a loop inside the block.
// The loop visits only the kv tiles that the causal or window mask can
// admit for the tile's rows, so a local layer (window 1024) at S = 8192
// reads about window + one tile of keys a row, not S.  Every row keeps at
// least one admitted key in that range, so the result is the reference's,
// whose fully masked tiles wash out through alpha = exp(-1e30 - m) = 0.
// Only when some row has no admitted key at all (window > 0 and
// S - T >= window) does the block sweep every tile, as the reference
// does, so such a row gets the reference's mean of v.  Unlike the
// reference the kernel takes any S and T: rows past S are not stored and
// keys past T get p = 0.  No atomics: two calls give the same bits.
//
// Layout.  q, o: element (b, i, h, d) at b q_sb + i q_ss + h q_sh + d;
// k, v: (b, j, kh, d) at b k_sb + j k_ss + kh k_sh + d.  The model's
// (B, S, H, hd) tensors and the reference's (BH, S, hd) ones are both such
// strided views, so GQA never repeats k or v in memory.
//
// Three regimes (flash_attention.py: choose_regime); every CUDA function is
// named flash_attention_kernel_*.
//
// bfloat16: the tensor cores, bf16 products with fp32 accumulation; both
// kernels share one body (attention_tc).  A block of 8 warps owns 128
// query rows and sweeps kv tiles of 64 keys.  The q tile and a double
// buffer of K/V tiles live in shared memory (hd = 256: 64 + 128 KB) in
// wgmma's canonical swizzled layout (column blocks of 128-byte rows, the
// 16-byte chunks XORed with the row), which also keeps ldmatrix free of
// bank conflicts; the next K/V tile is issued with cp.async right after
// the barrier that frees its buffer, so it lands while the current
// tile's products run.  The score accumulator's register layout is the
// A-fragment layout of the PV product, so P is rounded to bf16 in
// registers and never touches shared memory.  The row max is reduced over
// the 4 lanes that share a row by shuffles; the row sum is kept per lane
// and reduced once at the end.  Softmax runs in base 2 (scale
// pre-multiplied by log2 e), and only tiles that a mask can cut (the
// diagonal tile, the window's edge, the ragged last tile) evaluate the
// mask; a unit that issues products skips a tile its rows cannot see.
// The grid is one-dimensional with the query tiles in reverse, so the
// heaviest causal tiles start first.
//   hd >= 64, flash_attention_kernel_wgmma: a warpgroup owns 64 rows.  QK^T
// runs as wgmma m64n64k16 with both operands read from shared memory
// through descriptors (128-byte swizzle mode); PV as wgmma with P from
// registers and V read transposed (MN-major) from the same layout.
//   hd 16, 32 (rows shorter than a 128-byte swizzle atom),
// flash_attention_kernel_mma: a warp owns 16 rows; QK^T and PV run as
// mma.sync.m16n8k16 fed by ldmatrix (ldmatrix.trans for V).
//   The O accumulator is 16 x hd fp32 a warp (hd / 2 registers a thread).
//
// float32: flash_attention_kernel_fp32, the CUDA cores.  Tensor cores would
// take float32 only as TF32 (about 1e-3 relative), outside the reference
// suite's 3e-4, so float32 (a test instrument, not the served path) keeps
// the first kernel: 64 query rows and 32-key tiles a block of 256 threads,
// products as fp32 fmaf loops over tiles staged synchronously in shared
// memory (rows padded by 4 elements), p through shared memory to PV.
//
// What bounds it.  The function's work is 4 hd H sum_rows(admitted keys)
// operations and one read of q, k, v and one write of o.  At gemma3-4b's
// width (H = 8, Hkv = 4, hd = 256) and S = 8192 that is 6.4e10 operations
// (local, window 1024) or 2.7e11 (global) against 100 MB: on the H100 the
// bf16 tensor cores need 0.065 ms and 0.28 ms, the bytes 0.030 ms, so the
// bound is operations.  Both bf16 regimes do a tile's two products and its
// softmax one after the other, so the tensor cores idle while the softmax
// runs; overlapping them (a producer warp feeding TMA loads, warpgroups
// taking turns) needs registers that the hd = 256 accumulator already
// holds (251 a thread at one block an SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;        // the reference's masked score

// kv tile range [t_begin, t_end) of tiles of `bk` keys that the masks can
// admit for rows q0 .. q_last; every tile when some row has no admitted key
__device__ __forceinline__ void kv_range(int q0, int q_last, int n_q,
                                         int n_k, int causal, int window,
                                         int bk, int* t_begin, int* t_end) {
  int lo = 0;
  int hi = n_k;
  if (!(window > 0 && n_q - n_k >= window)) {
    if (causal) hi = min(n_k, q_last + 1);
    if (window > 0) lo = max(0, q0 - window + 1);
  }
  *t_begin = lo / bk;
  *t_end = (hi + bk - 1) / bk;
}

// ---------------------------------------------------------------------------
// float32: the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;                  // query rows per block
constexpr int kBK = 32;                  // keys per kv tile
constexpr int kPad = 4;                  // elements of padding per row
constexpr int kPLd = kBQ + kPad;         // row length of the p tile

// Stage rows row0 .. row0 + n_rows - 1 of a strided (row, hd) view into
// shared memory (row length HD + kPad); rows at or past `limit` are zero.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int row0,
                                          int n_rows, int limit) {
  constexpr int kQuads = HD / 4;
  for (int i = threadIdx.x; i < n_rows * kQuads; i += kThreads) {
    const int r = i / kQuads;
    const int c = (i % kQuads) * 4;
    const int row = row0 + r;
    const float4 val = row < limit
        ? *reinterpret_cast<const float4*>(src + row * row_stride + c)
        : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * (HD + kPad) + c) = val;
  }
}

// Thread (ty, tx) owns rows 4 ty .. 4 ty + 3 of the tile, scores for keys
// tx and tx + 16, and output columns 64 g + 4 tx .. + 3 (hd >= 64) or
// tx + 16 i (hd < 64).  Row maxima and sums are reduced over the 16 lanes
// of a row group with shuffles; p goes through shared memory (transposed).
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel_fp32(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            float* __restrict__ o, int n_q, int n_k,
                            int group, long long q_sb, long long q_sh,
                            long long q_ss, long long k_sb, long long k_sh,
                            long long k_ss, int causal, int window,
                            float scale) {
  constexpr int kLd = HD + kPad;
  constexpr bool kVecCols = HD % 64 == 0;
  constexpr int kCols = HD / 16;         // output columns per thread

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* k_s = q_s + kBQ * kLd;
  float* v_s = k_s + kBK * kLd;
  float* p_s = v_s + kBK * kLd;          // (kBK, kPLd)

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long q_off = b * q_sb + h * q_sh;
  const long long k_off = b * k_sb + (h / group) * k_sh;

  load_tile<HD>(q_s, q + q_off, q_ss, q0, kBQ, n_q);

  int t_begin, t_end;
  kv_range(q0, min(q0 + kBQ, n_q) - 1, n_q, n_k, causal, window, kBK,
           &t_begin, &t_end);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                     // the previous tile is consumed
    load_tile<HD>(k_s, k + k_off, k_ss, k0, kBK, n_k);
    load_tile<HD>(v_s, v + k_off, k_ss, k0, kBK, n_k);
    __syncthreads();

    // scores of rows 4 ty + r against keys tx and tx + 16
    float s[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 k_a = *reinterpret_cast<const float4*>(k_s + tx * kLd + d);
      const float4 k_b =
          *reinterpret_cast<const float4*>(k_s + (tx + 16) * kLd + d);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(q_s + (4 * ty + r) * kLd + d);
        s[r][0] = fmaf(qv.x, k_a.x, s[r][0]);
        s[r][0] = fmaf(qv.y, k_a.y, s[r][0]);
        s[r][0] = fmaf(qv.z, k_a.z, s[r][0]);
        s[r][0] = fmaf(qv.w, k_a.w, s[r][0]);
        s[r][1] = fmaf(qv.x, k_b.x, s[r][1]);
        s[r][1] = fmaf(qv.y, k_b.y, s[r][1]);
        s[r][1] = fmaf(qv.z, k_b.z, s[r][1]);
        s[r][1] = fmaf(qv.w, k_b.w, s[r][1]);
      }
    }

    // mask, then the online softmax update of each row
    float alpha[4];
    float p[2][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + 4 * ty + r;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kj = k0 + tx + 16 * c;
        float x = s[r][c] * scale;
        if (kj >= n_k) {
          x = -INFINITY;                 // past T: no key at all
        } else if ((causal && kj > qi) || (window > 0 && qi - kj >= window)) {
          x = kNegInf;
        }
        s[r][c] = x;
      }
      float mt = fmaxf(s[r][0], s[r][1]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off, 16));
      }
      const float m_new = fmaxf(m[r], mt);
      p[0][r] = expf(s[r][0] - m_new);
      p[1][r] = expf(s[r][1] - m_new);
      float sum = p[0][r] + p[1][r];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, off, 16);
      }
      alpha[r] = expf(m[r] - m_new);
      l[r] = l[r] * alpha[r] + sum;
      m[r] = m_new;
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      *reinterpret_cast<float4*>(p_s + (tx + 16 * c) * kPLd + 4 * ty) =
          make_float4(p[c][0], p[c][1], p[c][2], p[c][3]);
    }
    __syncthreads();

    // acc = acc * alpha + p v
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha[r];
    }
#pragma unroll 2
    for (int j = 0; j < kBK; ++j) {
      const float4 pj = *reinterpret_cast<const float4*>(p_s + j * kPLd +
                                                          4 * ty);
      const float pr[4] = {pj.x, pj.y, pj.z, pj.w};
      if constexpr (kVecCols) {
#pragma unroll
        for (int g = 0; g < HD / 64; ++g) {
          const float4 vv = *reinterpret_cast<const float4*>(
              v_s + j * kLd + 64 * g + 4 * tx);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[r][4 * g + 0] = fmaf(pr[r], vv.x, acc[r][4 * g + 0]);
            acc[r][4 * g + 1] = fmaf(pr[r], vv.y, acc[r][4 * g + 1]);
            acc[r][4 * g + 2] = fmaf(pr[r], vv.z, acc[r][4 * g + 2]);
            acc[r][4 * g + 3] = fmaf(pr[r], vv.w, acc[r][4 * g + 3]);
          }
        }
      } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float vv = v_s[j * kLd + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(pr[r], vv, acc[r][c]);
        }
      }
    }
  }

  // o = acc / max(l, 1e-30), rows past S not stored
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + 4 * ty + r;
    if (qi >= n_q) continue;
    const float den = fmaxf(l[r], 1e-30f);
    float* row = o + q_off + qi * q_ss;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = kVecCols ? 64 * (c / 4) + 4 * tx + (c % 4) : tx + 16 * c;
      row[col] = acc[r][c] / den;
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores: mma.sync (every hd) and wgmma (hd >= 64)
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;

constexpr int kWarps = kThreads / 32;
constexpr int kTcBQ = 16 * kWarps;       // query rows per block, 16 a warp
constexpr int kTcBK = 64;                // keys per kv tile
constexpr int kNT = kTcBK / 8;           // n8 tiles of a tile's scores
constexpr float kLog2e = 1.4426950408889634f;

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
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
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
// shared-memory matrix descriptor of a 128-byte swizzled wgmma operand
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across wgmma
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// d (64x64 fp32 over the warpgroup, 32 a thread) = (accumulate ? d : 0)
// + a (64x16, K-major, shared) b (16x64, K-major, shared)
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64x64 fp32) += a (64x16 bf16 in registers, each warp's 16 rows in
// the mma A-fragment layout) b (16x64, MN-major, shared)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// two floats as bf16x2, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// The tiles' layout in shared memory: HD / 64 column blocks (one when
// HD < 64) of kW = min(HD, 64) elements a row, one after another; within
// a row, 16-byte chunk c sits at chunk_pos(r, c), the chunk index XORed
// with the row's index among 128-byte lines.  The 8 rows of one ldmatrix
// matrix then fall in 8 distinct bank groups, and at HD >= 64 this is the
// layout that wgmma's 128-byte swizzle mode reads.
template <int HD>
constexpr int kRowElems = HD < 64 ? HD : 64;

template <int HD>
__device__ __forceinline__ int chunk_pos(int r, int c) {
  constexpr int kCh = kRowElems<HD> / 8;
  return (c % kCh) ^ ((r / (8 / kCh)) % kCh);
}

// Element offset of chunk c of row r in a (ROWS, HD) tile.
template <int HD, int ROWS>
__device__ __forceinline__ int tile_offset(int r, int c) {
  constexpr int kW = kRowElems<HD>;
  return (c / (kW / 8)) * ROWS * kW + r * kW + (chunk_pos<HD>(r, c) << 3);
}

// Issue cp.async copies of rows row0 .. row0 + ROWS - 1 of a strided
// (row, HD) view into a tile; rows at or past `limit` are zero.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                long long row_stride,
                                                int row0, int limit) {
  constexpr int kChunks = HD / 8;
  constexpr int kTotal = ROWS * kChunks;
#pragma unroll
  for (int it = 0; it < (kTotal + kThreads - 1) / kThreads; ++it) {
    const int i = it * kThreads + threadIdx.x;
    if (kTotal % kThreads == 0 || i < kTotal) {
      const int r = i / kChunks;
      const int c = i % kChunks;
      const int row = row0 + r;
      const bool in = row < limit;
      cp_async16(dst + tile_offset<HD, ROWS>(r, c),
                 in ? src + row * row_stride + c * 8 : src, in ? 16 : 0);
    }
  }
}

// Byte offsets, within a row, of the chunks 2 s + hi (s = 0 .. 3) that a
// lane reads with ldmatrix from row `row`.  Rows 16 apart share the XOR
// pattern, and chunk 2 s + hi lies in column block s / 4 at the position
// of chunk 2 (s % 4) + hi, so the address of step s is the row's address
// + off[s % 4] + (s / 4) column blocks: one of four registers plus an
// immediate.
template <int HD>
__device__ __forceinline__ void ldsm_offsets(uint32_t (&off)[4], int row,
                                             int hi) {
#pragma unroll
  for (int j = 0; j < 4; ++j) off[j] = chunk_pos<HD>(row, 2 * j + hi) * 16;
}

// S = Q K^T, the warp's 16 rows x 64 keys, by mma.sync: q_addr and k_addr
// are the lane's ldmatrix rows, q_sw and k_sw their chunk offsets.
template <int HD>
__device__ __forceinline__ void qk_mma(float (&s)[kNT][4], uint32_t q_addr,
                                       const uint32_t (&q_sw)[4],
                                       uint32_t k_addr,
                                       const uint32_t (&k_sw)[4]) {
  constexpr int kW = kRowElems<HD>;
#pragma unroll
  for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, q_addr + q_sw[kk & 3] + (kk >> 2) * kTcBQ * kW * 2);
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      uint32_t bb[4];
      ldsm_x4(bb, k_addr + k_sw[kk & 3] + (kk >> 2) * kTcBK * kW * 2 +
                      np * 16 * kW * 2);
      mma16816(s[2 * np], a, bb[0], bb[1]);
      mma16816(s[2 * np + 1], a, bb[2], bb[3]);
    }
  }
}

// O += P V by mma.sync: the S fragments of keys 16 kk .. + 15 are P's A
// fragment; v_addr is the lane's ldmatrix row of V, v_sw its offsets.
template <int HD>
__device__ __forceinline__ void pv_mma(float (&acc)[HD / 8][4],
                                       const uint32_t (&p)[kNT][2],
                                       uint32_t v_addr,
                                       const uint32_t (&v_sw)[4]) {
  constexpr int kW = kRowElems<HD>;
#pragma unroll
  for (int kk = 0; kk < kNT / 2; ++kk) {
    const uint32_t a[4] = {p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0],
                           p[2 * kk + 1][1]};
#pragma unroll
    for (int dn = 0; dn < HD / 16; ++dn) {
      uint32_t bb[4];
      ldsm_x4_t(bb, v_addr + v_sw[dn & 3] + (dn >> 2) * kTcBK * kW * 2 +
                        kk * 16 * kW * 2);
      mma16816(acc[2 * dn], a, bb[0], bb[1]);
      mma16816(acc[2 * dn + 1], a, bb[2], bb[3]);
    }
  }
}

// S = Q K^T, the warpgroup's 64 rows x 64 keys, by wgmma from shared
// memory: q_addr is the warpgroup's first q row, k_addr the K tile.  The
// accumulator's layout is the mma one, so s serves both regimes.
template <int HD>
__device__ __forceinline__ void qk_wgmma(float (&s)[kNT][4], uint32_t q_addr,
                                         uint32_t k_addr) {
  float(&d)[32] = reinterpret_cast<float(&)[32]>(s);
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kb = 0; kb < HD / 64; ++kb) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_ss(d, wgmma_desc(q_addr + kb * kTcBQ * 128 + j * 32, 16, 1024),
               wgmma_desc(k_addr + kb * kTcBK * 128 + j * 32, 16, 1024),
               kb | j);
    }
  }
  wgmma_commit_wait();
  fence_regs(d);
}

// O += P V by wgmma, P from registers, V read MN-major (transposed) from
// the tile at v_addr, one 64-column block of O at a time.
template <int HD>
__device__ __forceinline__ void pv_wgmma(float (&acc)[HD / 8][4],
                                         const uint32_t (&p)[kNT][2],
                                         uint32_t v_addr) {
#pragma unroll
  for (int d = 0; d < HD / 64; ++d) {
    fence_regs(reinterpret_cast<float(&)[32]>(acc[8 * d]));
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kNT / 2; ++kk) {
    const uint32_t a[4] = {p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0],
                           p[2 * kk + 1][1]};
#pragma unroll
    for (int d = 0; d < HD / 64; ++d) {
      wgmma_rs(reinterpret_cast<float(&)[32]>(acc[8 * d]), a,
               wgmma_desc(v_addr + d * kTcBK * 128 + kk * 16 * 128,
                          kTcBK * 128, 1024));
    }
  }
  wgmma_commit_wait();
#pragma unroll
  for (int d = 0; d < HD / 64; ++d) {
    fence_regs(reinterpret_cast<float(&)[32]>(acc[8 * d]));
  }
}

// One kv tile's softmax for this lane's rows r0 + g and r0 + g + 8 of the
// warp's rows r0 .. r1: scale the scores to base 2, mask them only where
// a mask or T can cut the tile, update the running max m and this lane's
// part of the row sums l, rescale acc, and round P to bf16 as the PV
// product's A fragments.
template <int kDT>
__device__ __forceinline__ void softmax_tile(float (&s)[kNT][4],
                                             float (&acc)[kDT][4],
                                             uint32_t (&p)[kNT][2],
                                             float (&m)[2], float (&l)[2],
                                             int r0, int r1, int k0, int n_k,
                                             int causal, int window,
                                             float scale_log2) {
  const int g = (threadIdx.x & 31) >> 2;
  const int tq = threadIdx.x & 3;
  const int k_last = k0 + kTcBK - 1;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
  }
  if ((causal && k_last > r0) || (window > 0 && r1 - k0 >= window) ||
      k_last >= n_k) {
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + 8 * (e >> 1);
        const int key = k0 + 8 * j + 2 * tq + (e & 1);
        if (key >= n_k) {
          s[j][e] = -INFINITY;           // past T: no key at all
        } else if ((causal && key > row) ||
                   (window > 0 && row - key >= window)) {
          s[j][e] = kNegInf;
        }
      }
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mt = m[r];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      mt = fmaxf(mt, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    alpha[r] = exp2f(m[r] - mt);
    m[r] = mt;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const float p0 = exp2f(s[j][0] - m[0]);
    const float p1 = exp2f(s[j][1] - m[0]);
    const float p2 = exp2f(s[j][2] - m[1]);
    const float p3 = exp2f(s[j][3] - m[1]);
    sum[0] += p0 + p1;
    sum[1] += p2 + p3;
    p[j][0] = pack_bf16(p0, p1);
    p[j][1] = pack_bf16(p2, p3);
  }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
#pragma unroll
  for (int d = 0; d < kDT; ++d) {
    acc[d][0] *= alpha[0];
    acc[d][1] *= alpha[0];
    acc[d][2] *= alpha[1];
    acc[d][3] *= alpha[1];
  }
}

// Both regimes' kernel body.  Block: (query tile, batch x head), the
// query tiles in reverse so the tiles with the most kv tiles start
// first.  A warp (mma) or warpgroup (wgmma) issues the products for its
// 16 or 64 rows; every warp runs the softmax for its own 16.
template <int HD, bool kWgmma>
__device__ __forceinline__ void attention_tc(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, int n_q, int n_k,
    int heads, int group, long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, int causal, int window,
    float scale_log2) {
  constexpr int kDT = HD / 8;            // n8 tiles of O (columns)
  constexpr int kW = kRowElems<HD>;
  constexpr int kTile = kTcBK * HD;      // elements of one K or V tile

  extern __shared__ __align__(1024) unsigned char smem_tc[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_tc);  // (kTcBQ, HD)
  bf16* kv_s = q_s + kTcBQ * HD;                 // [2][K, V](kTcBK, HD)

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_qt = (n_q + kTcBQ - 1) / kTcBQ;
  const int hb_count = static_cast<int>(gridDim.x) / n_qt;   // B H
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / hb_count;
  const int hb = static_cast<int>(blockIdx.x) % hb_count;
  const int h = hb % heads;
  const long long b = hb / heads;
  const int q0 = qt * kTcBQ;
  const long long k_off = b * k_sb + (h / group) * k_sh;
  const bf16* k_g = k + k_off;
  const bf16* v_g = v + k_off;
  bf16* o_g = o + b * q_sb + h * q_sh;

  int t_begin, t_end;
  kv_range(q0, min(q0 + kTcBQ, n_q) - 1, n_q, n_k, causal, window, kTcBK,
           &t_begin, &t_end);
  const bool full_sweep = window > 0 && n_q - n_k >= window;

  load_tile_async<HD, kTcBQ>(q_s, q + (b * q_sb + h * q_sh), q_ss, q0, n_q);
  load_tile_async<HD, kTcBK>(kv_s, k_g, k_ss, t_begin * kTcBK, n_k);
  load_tile_async<HD, kTcBK>(kv_s + kTile, v_g, k_ss, t_begin * kTcBK, n_k);
  cp_async_commit();

  // this warp's rows r0 .. r1, and those of the unit that issues the
  // products, u0 .. u1 (r1 < r0, u1 < u0: none lie before S)
  const int r0 = q0 + 16 * warp;
  const int r1 = min(r0 + 15, n_q - 1);
  const int u0 = kWgmma ? q0 + 64 * (warp >> 2) : r0;
  const int u1 = min(u0 + (kWgmma ? 63 : 15), n_q - 1);

  // mma: the lane's ldmatrix rows of Q (A fragments), K (B fragments, two
  // n8 tiles of keys) and V (B fragments, a k16 step of keys); Q's and
  // V's rows agree modulo 8 and read the same chunks, so V takes Q's
  // offsets
  const int q_row = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int k_row = (lane & 7) + 8 * (lane >> 4);
  const int v_row = (lane & 7) + 8 * ((lane >> 3) & 1);
  uint32_t q_sw[4], k_sw[4];
  ldsm_offsets<HD>(q_sw, q_row, lane >> 4);
  ldsm_offsets<HD>(k_sw, k_row, (lane >> 3) & 1);
  const uint32_t q_addr = smem_u32(q_s);
  const uint32_t kv_addr = smem_u32(kv_s);

  float acc[kDT][4];
#pragma unroll
  for (int d = 0; d < kDT; ++d) {
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};       // rows g and g + 8
  float l[2] = {0.f, 0.f};               // this lane's part of the row sums

  for (int t = t_begin; t < t_end; ++t) {
    cp_async_wait<0>();                  // tile t (and q) landed
    if constexpr (kWgmma) {              // wgmma reads by the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();                     // ... for every thread; tile t - 1
                                         // is consumed, its buffer free
    if (t + 1 < t_end) {
      bf16* nxt = kv_s + ((t + 1 - t_begin) & 1) * 2 * kTile;
      load_tile_async<HD, kTcBK>(nxt, k_g, k_ss, (t + 1) * kTcBK, n_k);
      load_tile_async<HD, kTcBK>(nxt + kTile, v_g, k_ss, (t + 1) * kTcBK,
                                 n_k);
    }
    cp_async_commit();

    const int k0 = t * kTcBK;
    const uint32_t k_addr = kv_addr + ((t - t_begin) & 1) * 4 * kTile;
    const uint32_t v_addr = k_addr + 2 * kTile;
    if (u1 < u0) continue;
    // a tile that no row of the unit can see adds nothing (every row
    // meets an admitted key elsewhere in the range)
    if (!full_sweep && ((causal && k0 > u1) ||
                        (window > 0 && u0 - (k0 + kTcBK - 1) >= window))) {
      continue;
    }
    float s[kNT][4];
    uint32_t p[kNT][2];
    if constexpr (kWgmma) {
      qk_wgmma<HD>(s, q_addr + (u0 - q0) * kW * 2, k_addr);
    } else {
      qk_mma<HD>(s, q_addr + q_row * kW * 2, q_sw, k_addr + k_row * kW * 2,
                 k_sw);
    }
    softmax_tile(s, acc, p, m, l, r0, r1, k0, n_k, causal, window,
                 scale_log2);
    if constexpr (kWgmma) {
      pv_wgmma<HD>(acc, p, v_addr);
    } else {
      pv_mma<HD>(acc, p, v_addr + v_row * kW * 2, q_sw);
    }
  }
  cp_async_wait<0>();                    // leave no copy in flight
  if (r1 < r0) return;

  // o = acc / max(l, 1e-30), rows past S not stored
  const int g = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float inv = 1.f / fmaxf(sum, 1e-30f);
    const int row = r0 + g + 8 * r;
    if (row > r1) continue;
    bf16* dst = o_g + row * q_ss + 2 * tq;
#pragma unroll
    for (int d = 0; d < kDT; ++d) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * d) =
          __floats2bfloat162_rn(acc[d][2 * r] * inv, acc[d][2 * r + 1] * inv);
    }
  }
}

#define FLASH_TC_ARGS                                                      \
  const bf16 *__restrict__ q, const bf16 *__restrict__ k,                  \
      const bf16 *__restrict__ v, bf16 *__restrict__ o, int n_q, int n_k,  \
      int heads, int group, long long q_sb, long long q_sh, long long q_ss, \
      long long k_sb, long long k_sh, long long k_ss, int causal,          \
      int window, float scale_log2
#define FLASH_TC_PASS                                                     \
  q, k, v, o, n_q, n_k, heads, group, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, \
      causal, window, scale_log2

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel_mma(FLASH_TC_ARGS) {
  attention_tc<HD, false>(FLASH_TC_PASS);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel_wgmma(FLASH_TC_ARGS) {
  attention_tc<HD, true>(FLASH_TC_PASS);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int batch, heads, group, n_q, n_k;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss;
  int causal, window;
  float scale;
};

template <int HD>
cudaError_t launch_fp32(const Args& a, cudaStream_t stream) {
  constexpr size_t kSmem =
      ((kBQ + 2 * kBK) * (HD + kPad) + kBK * kPLd) * sizeof(float);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel_fp32<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (attr != cudaSuccess) return attr;
  if (a.batch > 65535 || a.heads > 65535) return cudaErrorInvalidValue;
  const dim3 grid((a.n_q + kBQ - 1) / kBQ, a.heads, a.batch);
  flash_attention_kernel_fp32<HD><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.n_q, a.n_k,
      a.group, a.q_sb, a.q_sh, a.q_ss, a.k_sb, a.k_sh, a.k_ss, a.causal,
      a.window, a.scale);
  return cudaGetLastError();
}

// the tensor-core kernel of a regime: wgmma or mma.sync
template <int HD, bool kWgmma>
auto tc_kernel() {
  if constexpr (kWgmma) {
    return &flash_attention_kernel_wgmma<HD>;
  } else {
    return &flash_attention_kernel_mma<HD>;
  }
}

template <int HD, bool kWgmma>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  constexpr size_t kSmem = (kTcBQ + 4 * kTcBK) * HD * sizeof(bf16);
  const auto kernel = tc_kernel<HD, kWgmma>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmem));
  if (attr != cudaSuccess) return attr;
  const long long blocks = static_cast<long long>(
      (a.n_q + kTcBQ - 1) / kTcBQ) * a.heads * a.batch;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.n_q, a.n_k,
      a.heads, a.group, a.q_sb, a.q_sh, a.q_ss, a.k_sb, a.k_sh, a.k_ss,
      a.causal, a.window, a.scale * kLog2e);
  return cudaGetLastError();
}

// regime 0: float32 on the CUDA cores; 1: bf16 by mma.sync (hd < 64); 2:
// bf16 by wgmma (hd >= 64)
template <int HD>
cudaError_t launch_regime(int regime, const Args& a, cudaStream_t stream) {
  if (regime == 0) return launch_fp32<HD>(a, stream);
  if constexpr (HD >= 64) {
    if (regime == 2) return launch_tc<HD, true>(a, stream);
  } else {
    if (regime == 1) return launch_tc<HD, false>(a, stream);
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_for_hd(int regime, int hd, const Args& a,
                          cudaStream_t stream) {
  switch (hd) {
    case 16: return launch_regime<16>(regime, a, stream);
    case 32: return launch_regime<32>(regime, a, stream);
    case 64: return launch_regime<64>(regime, a, stream);
    case 128: return launch_regime<128>(regime, a, stream);
    case 256: return launch_regime<256>(regime, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o: (batch, n_q, heads, hd) and k, v: (batch, n_k, heads / group, hd)
// as strided views (strides in elements, see the header).  regime 0: the
// CUDA cores, float32 inputs; 1: mma.sync (hd 16, 32), 2: wgmma (hd >= 64),
// bfloat16 inputs.  hd is one of 16, 32, 64, 128, 256; window <= 0 means
// unbounded.  Launches on `stream` and returns cudaGetLastError() (or the
// error of a refused argument or attribute).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int regime, int batch, int heads,
                           int group, int n_q, int n_k, int hd,
                           long long q_sb, long long q_sh, long long q_ss,
                           long long k_sb, long long k_sh, long long k_ss,
                           int causal, int window, float scale,
                           void* stream) {
  if (batch <= 0 || heads <= 0 || group <= 0 || heads % group != 0 ||
      n_q <= 0 || n_k <= 0 || regime < 0 || regime > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q,    k,    v,    o,    batch, heads, group,  n_q,   n_k,
               q_sb, q_sh, q_ss, k_sb, k_sh,  k_ss,  causal, window, scale};
  return static_cast<int>(
      launch_for_hd(regime, hd, a, static_cast<cudaStream_t>(stream)));
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
