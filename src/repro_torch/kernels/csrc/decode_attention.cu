// Decode attention for Hopper (sm_90a): one query a (slot, head) against
// that slot's KV cache, read in place and split over the cache's length
// ("flash-decoding").
//
//   o[b, h] = sum_j softmax_j(scale q[b, h] . k[b, j, h / G]) v[b, j, h / G]
//
// over the cache slots j that slot b's position pos admits.  The cache is
// a ring of T slots: slot j holds position p_j = pos - (((pos mod T) - j)
// mod T), admitted when 0 <= p_j <= pos and pos - p_j < window.  So the
// admitted slots are pos mod T and the n - 1 before it, cyclically, with
// n = min(pos + 1, window, T): the linear cache before it wraps, a local
// layer's window, and a ring buffer after it wraps are one case.
// scale = hd^-1/2, G = H / Hkv.  A query that admits no key (pos < 0)
// gets the mean of v over all T slots, as the masked softmax gives it.
//
// Replaces no TPU kernel.  The JAX package decodes with its plain einsum
// attention (src/repro/models/layers.py: _sdpa), which XLA fuses on the
// TPU; in PyTorch that einsum copies the whole (B, T, Hkv, hd) cache into
// a batched-matrix layout every layer and tick, and the softmax runs over
// all T slots.  The flash kernel (flash_attention.cu) counts query rows
// from 0 and takes one fill for the whole batch, so it cannot take a
// query at a per-slot position against a per-slot fill inside a captured
// CUDA graph.
//
// What bounds it: the bytes of the admitted K and V, 2 n hd Hkv elements
// a slot, read once.  The work is 4 G hd n operations a (slot, kv head):
// at most 16 / (element bytes) operations a byte, far below the 295 at
// which the H100's tensor cores, not its memory, would bound it.  At
// qwen2.5-3b's serving shape (64 slots, 2 kv heads x 128, 340 admitted
// positions a slot) one layer reads 22 MB: 6.6 us at 3.35 TB/s.
//
// Design.  The grid is (ceil(T / chunk), Hkv, B) and depends on static
// shapes only: each CTA reads its slot's pos from device memory and
// returns at once if its chunk of slots holds no admitted key, so the
// kernel runs unchanged inside a captured graph, with no host sync.  A
// CTA loads its chunk's admitted K and V rows once for the whole GQA
// group with cp.async (rows it does not admit are zero-filled, not read):
// K as one group, V as a second, so V lands while QK^T and the softmax
// run.  Its four warps each own a quarter of the chunk's keys.
//
// bfloat16: the G query heads of the group are the rows of QK^T and PV,
// padded to 16, on the tensor cores (mma.sync m16n8k16 fed by ldmatrix,
// fp32 accumulation); tiles in shared memory in the flash kernel's
// swizzled layout, so ldmatrix has no bank conflicts.  The softmax runs in
// fp32 in base 2; P is rounded to bf16 for the PV product in registers, as
// in the flash kernel.  float32 (a test instrument, not the served path):
// the CUDA cores, scores a warp a key, P through shared memory, fp32 FMAs.
//
// Each warp's (max, sum, output) are merged through shared memory in warp
// order.  A (slot, kv head) whose admitted keys lie in one chunk writes
// its output there; otherwise each live chunk writes (m, l, acc) in fp32
// to scratch, and decode_attention_kernel_combine merges the live chunks
// of each (slot, head) in chunk order.  No atomics: two calls give the
// same bits.  The masked score is the reference's finite -1e30; keys past
// T (the ragged last chunk) get p = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                // query rows of a CTA: G <= 16
constexpr float kNegInf = -1e30f;        // the reference's masked score
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxChunks = 12288;        // the combine's weights: 48 KB

// ---------------------------------------------------------------------------
// which slots a query admits
// ---------------------------------------------------------------------------

// The admitted slots of one query: r, r - 1, ..., r - n + 1 (mod T), r =
// pos mod T; n <= 0 admits none, and then every slot is read, masked.
struct Ring {
  int r;
  int n;
  int T;

  __device__ __forceinline__ bool admits(int j) const {   // 0 <= j < T
    int d = r - j;
    if (d < 0) d += T;
    return d < n;
  }
  // whether slots lo .. hi (hi < T) hold a slot the query reads
  __device__ __forceinline__ bool meets(int lo, int hi) const {
    if (n <= 0 || n >= T) return true;
    const int s = r - n + 1;
    if (s >= 0) return lo <= r && hi >= s;
    return lo <= r || hi >= s + T;
  }
  // chunks of `chunk` slots that hold a slot the query reads
  __device__ __forceinline__ int live_chunks(int chunk, int n_chunks) const {
    if (n <= 0 || n >= T) return n_chunks;
    const int s = r - n + 1;
    if (s >= 0) return r / chunk - s / chunk + 1;
    const int first_hi = (s + T) / chunk;  // the wrapped part's first chunk
    return r / chunk + 1 + n_chunks - first_hi - (first_hi == r / chunk);
  }
};

__device__ __forceinline__ Ring ring_of(const long long* __restrict__ pos,
                                        int b, int T, int window) {
  const long long p = pos[b];
  Ring g;
  g.T = T;
  if (p < 0) {
    g.r = 0;
    g.n = 0;
    return g;
  }
  g.r = static_cast<int>(p % T);
  g.n = static_cast<int>(min(p + 1, static_cast<long long>(min(window, T))));
  return g;
}

// ---------------------------------------------------------------------------
// tensor-core building blocks (as in flash_attention.cu)
// ---------------------------------------------------------------------------

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
// two floats as bf16x2, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Tiles in shared memory: HD / 64 column blocks (one when HD < 64) of
// kW = min(HD, 64) elements a row; within a row, 16-byte chunk c sits at
// chunk_pos(r, c), the chunk index XORed with the row's index among
// 128-byte lines, so the 8 rows of one ldmatrix matrix fall in 8 distinct
// bank groups.
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

// Issue cp.async copies of rows 0 .. ROWS - 1 of a strided (row, HD) view
// into a tile; a row for which `take(row)` is false is zero-filled and
// not read.
template <int HD, int ROWS, typename Take>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                long long row_stride,
                                                Take take) {
  constexpr int kChunks = HD / 8;
  constexpr int kTotal = ROWS * kChunks;
#pragma unroll 4
  for (int i = threadIdx.x; i < kTotal; i += kThreads) {
    const int r = i / kChunks;
    const int c = i % kChunks;
    const bool in = take(r);
    cp_async16(dst + tile_offset<HD, ROWS>(r, c),
               in ? src + r * row_stride + c * 8 : src, in ? 16 : 0);
  }
}

// Byte offsets, within a row, of the chunks 2 s + hi (s = 0 .. 3) that a
// lane reads with ldmatrix from row `row` (rows 16 apart share them).
template <int HD>
__device__ __forceinline__ void ldsm_offsets(uint32_t (&off)[4], int row,
                                             int hi) {
#pragma unroll
  for (int j = 0; j < 4; ++j) off[j] = chunk_pos<HD>(row, 2 * j + hi) * 16;
}

// ---------------------------------------------------------------------------
// the split pass
// ---------------------------------------------------------------------------

// Where a (slot, kv head)'s result goes: its output rows when one chunk
// holds all it reads, else this chunk's (m, l) pairs and fp32 acc rows.
template <typename OutT>
__device__ __forceinline__ void store_out(OutT* dst, float x);
template <>
__device__ __forceinline__ void store_out<float>(float* dst, float x) {
  *dst = x;
}
template <>
__device__ __forceinline__ void store_out<bf16>(bf16* dst, float x) {
  *dst = __float2bfloat16_rn(x);
}

// Merge row `row`'s per-warp (m, l) and the warps' rescaled sums red
// (kWarps, kRows, HD) in warp order, and write column `col`.
template <typename OutT>
__device__ __forceinline__ void finish(const float (&m_s)[kWarps][kRows],
                                       const float (&l_s)[kWarps][kRows],
                                       const float* red, int HD, int row,
                                       int col, bool single, OutT* o_row,
                                       float* acc_row, float* ml_row) {
  float M = m_s[0][row];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) M = fmaxf(M, m_s[w][row]);
  float L = 0.f;
  float a = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    L += l_s[w][row] * exp2f(m_s[w][row] - M);
    a += red[(w * kRows + row) * HD + col];
  }
  if (single) {
    store_out(o_row + col, a / L);
  } else {
    acc_row[col] = a;
    if (col == 0) {
      ml_row[0] = M;
      ml_row[1] = L;
    }
  }
}

// bfloat16: grid (chunks, Hkv, B), 4 warps, each KEYS = CHUNK / 4 keys.
// Shared memory: q (16, HD), K and V (CHUNK, HD), then, once the products
// are done, the warps' rescaled outputs (4, 16, HD) fp32 over K and V.
template <int HD, int CHUNK>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel_split_bf16(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const long long* __restrict__ pos,
    bf16* __restrict__ o, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int heads, int kv_heads, int T, int window,
    float scale_log2) {
  constexpr int kW = kRowElems<HD>;
  constexpr int kKeys = CHUNK / kWarps;  // keys of a warp
  constexpr int kNT = kKeys / 8;         // n8 tiles of its scores
  constexpr int kDT = HD / 8;            // n8 tiles of its output
  static_assert(kRows * HD * 4 * kWarps <= 2 * CHUNK * HD * 2,
                "the warps' outputs must fit over K and V");

  const int chunk = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int group = heads / kv_heads;
  const Ring ring = ring_of(pos, b, T, window);
  const int c0 = chunk * CHUNK;
  if (!ring.meets(c0, min(c0 + CHUNK, T) - 1)) return;
  const bool single = ring.live_chunks(CHUNK, n_chunks) == 1;

  extern __shared__ __align__(128) unsigned char smem_bf[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_bf);   // (kRows, HD)
  bf16* k_s = q_s + kRows * HD;                    // (CHUNK, HD)
  bf16* v_s = k_s + CHUNK * HD;                    // (CHUNK, HD)
  __shared__ float m_s[kWarps][kRows];
  __shared__ float l_s[kWarps][kRows];

  const long long head0 = static_cast<long long>(b) * heads + kvh * group;
  const long long row_stride = static_cast<long long>(kv_heads) * HD;
  const long long kv_off =
      (static_cast<long long>(b) * T + c0) * row_stride +
      static_cast<long long>(kvh) * HD;
  auto take_q = [&](int r) { return r < group; };
  auto take_kv = [&](int r) {
    const int j = c0 + r;
    return j < T && (ring.n <= 0 || ring.admits(j));
  };
  load_tile_async<HD, kRows>(q_s, q + head0 * HD, HD, take_q);
  load_tile_async<HD, CHUNK>(k_s, k + kv_off, row_stride, take_kv);
  cp_async_commit();
  load_tile_async<HD, CHUNK>(v_s, v + kv_off, row_stride, take_kv);
  cp_async_commit();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gq = lane >> 2;              // the lane's rows gq, gq + 8
  const int tq = lane & 3;
  // the lane's ldmatrix rows of Q (A fragments), K (B fragments, two n8
  // tiles of keys) and V (B fragments, a k16 step of keys); V's rows agree
  // with Q's modulo 16 and read the same chunks, so V takes Q's offsets
  const int q_row = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int k_row = warp * kKeys + (lane & 7) + 8 * (lane >> 4);
  const int v_row = warp * kKeys + q_row;
  uint32_t q_sw[4], k_sw[4];
  ldsm_offsets<HD>(q_sw, q_row, lane >> 4);
  ldsm_offsets<HD>(k_sw, k_row, (lane >> 3) & 1);
  const uint32_t q_addr = smem_u32(q_s) + q_row * kW * 2;
  const uint32_t k_addr = smem_u32(k_s) + k_row * kW * 2;
  const uint32_t v_addr = smem_u32(v_s) + v_row * kW * 2;

  cp_async_wait<1>();                    // q and K landed
  __syncthreads();

  // S = Q K^T over the warp's keys
  float s[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, q_addr + q_sw[kk & 3] + (kk >> 2) * kRows * kW * 2);
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      uint32_t bb[4];
      ldsm_x4(bb, k_addr + k_sw[kk & 3] + (kk >> 2) * CHUNK * kW * 2 +
                      np * 16 * kW * 2);
      mma16816(s[2 * np], a, bb[0], bb[1]);
      mma16816(s[2 * np + 1], a, bb[2], bb[3]);
    }
  }

  // softmax over the warp's keys, base 2: masked keys -1e30, keys past T
  // -inf; a warp whose keys all lie past T keeps m = -inf and p = 0
  const int key0 = c0 + warp * kKeys;
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + 8 * j + 2 * tq + (e & 1);
      float x = s[j][e] * scale_log2;
      if (key >= T) {
        x = -INFINITY;
      } else if (!ring.admits(key)) {
        x = kNegInf;
      }
      s[j][e] = x;
      m[e >> 1] = fmaxf(m[e >> 1], x);
    }
  }
  float l[2] = {0.f, 0.f};
  float mu[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    mu[r] = m[r] == -INFINITY ? 0.f : m[r];
  }
  uint32_t p[kNT][2];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const float p0 = exp2f(s[j][0] - mu[0]);
    const float p1 = exp2f(s[j][1] - mu[0]);
    const float p2 = exp2f(s[j][2] - mu[1]);
    const float p3 = exp2f(s[j][3] - mu[1]);
    l[0] += p0 + p1;
    l[1] += p2 + p3;
    p[j][0] = pack_bf16(p0, p1);
    p[j][1] = pack_bf16(p2, p3);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  cp_async_wait<0>();                    // V landed
  __syncthreads();

  // O = P V over the warp's keys
  float acc[kDT][4];
#pragma unroll
  for (int d = 0; d < kDT; ++d) {
    acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < kNT / 2; ++kk) {
    const uint32_t a[4] = {p[2 * kk][0], p[2 * kk][1], p[2 * kk + 1][0],
                           p[2 * kk + 1][1]};
#pragma unroll
    for (int dn = 0; dn < HD / 16; ++dn) {
      uint32_t bb[4];
      ldsm_x4_t(bb, v_addr + q_sw[dn & 3] + (dn >> 2) * CHUNK * kW * 2 +
                        kk * 16 * kW * 2);
      mma16816(acc[2 * dn], a, bb[0], bb[1]);
      mma16816(acc[2 * dn + 1], a, bb[2], bb[3]);
    }
  }

  // merge the warps: each rescales its rows to the CTA's max and writes
  // them over K and V (every warp is done reading them)
  if (tq == 0) {
    m_s[warp][gq] = m[0];
    m_s[warp][gq + 8] = m[1];
    l_s[warp][gq] = l[0];
    l_s[warp][gq + 8] = l[1];
  }
  __syncthreads();
  float* red = reinterpret_cast<float*>(k_s);     // (kWarps, kRows, HD)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = gq + 8 * r;
    float M = m_s[0][row];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) M = fmaxf(M, m_s[w][row]);
    const float wt = exp2f(m[r] - M);
    float* dst = red + (warp * kRows + row) * HD + 2 * tq;
#pragma unroll
    for (int d = 0; d < kDT; ++d) {
      *reinterpret_cast<float2*>(dst + 8 * d) =
          make_float2(acc[d][2 * r] * wt, acc[d][2 * r + 1] * wt);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < group * HD; i += kThreads) {
    const int row = i / HD;
    const int col = i % HD;
    const long long h = head0 + row;
    finish(m_s, l_s, red, HD, row, col, single, o + h * HD,
           part_acc + (h * n_chunks + chunk) * HD,
           part_ml + (h * n_chunks + chunk) * 2);
  }
}

// float32 on the CUDA cores: grid (chunks, Hkv, B), 4 warps.  Shared
// memory: q (G, HD) and the scores, then weights, (G, chunk).  A warp
// takes a key at a time (lanes along hd, reading the K row coalesced);
// then a warp a row runs the softmax; then a thread a (row, column)
// sums P V over the chunk, reading V rows coalesced.
template <int HD>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel_split_fp32(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const long long* __restrict__ pos,
    float* __restrict__ o, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int heads, int kv_heads, int T, int window,
    int chunk_len, float scale_log2) {
  constexpr int kPer = (HD + 31) / 32;   // columns of a lane
  const int chunk = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int group = heads / kv_heads;
  const Ring ring = ring_of(pos, b, T, window);
  const int c0 = chunk * chunk_len;
  if (!ring.meets(c0, min(c0 + chunk_len, T) - 1)) return;
  const bool single = ring.live_chunks(chunk_len, n_chunks) == 1;

  extern __shared__ __align__(16) float smem_f[];
  float* q_s = smem_f;                   // (group, HD)
  float* s_s = q_s + kRows * HD;         // (group, chunk_len)
  __shared__ float m_s[kRows];           // each row's max and sum
  __shared__ float l_s[kRows];

  const long long head0 = static_cast<long long>(b) * heads + kvh * group;
  const long long row_stride = static_cast<long long>(kv_heads) * HD;
  const long long kv_off = static_cast<long long>(b) * T * row_stride +
                           static_cast<long long>(kvh) * HD;
  for (int i = threadIdx.x; i < group * HD; i += kThreads) {
    q_s[i] = q[head0 * HD + i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_keys = min(chunk_len, T - c0);
  for (int i = warp; i < chunk_len; i += kWarps) {
    const int key = c0 + i;
    if (i >= n_keys || !ring.admits(key)) {
      if (lane < group) {
        s_s[lane * chunk_len + i] = i >= n_keys ? -INFINITY : kNegInf;
      }
      continue;
    }
    const float* kr = k + kv_off + key * row_stride;
    float kv[kPer];
#pragma unroll
    for (int t = 0; t < kPer; ++t) {
      const int c = lane + 32 * t;
      kv[t] = (HD % 32 == 0 || c < HD) ? kr[c] : 0.f;
    }
    for (int r = 0; r < group; ++r) {
      float d = 0.f;
#pragma unroll
      for (int t = 0; t < kPer; ++t) {
        const int c = lane + 32 * t;
        if (HD % 32 == 0 || c < HD) d = fmaf(q_s[r * HD + c], kv[t], d);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        d += __shfl_xor_sync(0xffffffffu, d, off);
      }
      if (lane == 0) s_s[r * chunk_len + i] = d * scale_log2;
    }
  }
  __syncthreads();

  for (int r = warp; r < group; r += kWarps) {
    float* row = s_s + r * chunk_len;
    float mx = -INFINITY;
    for (int i = lane; i < chunk_len; i += 32) mx = fmaxf(mx, row[i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    float sum = 0.f;
    for (int i = lane; i < chunk_len; i += 32) {
      const float pi = exp2f(row[i] - mx);    // the chunk's first key is
      row[i] = pi;                            // < T, so mx is finite
      sum += pi;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    if (lane == 0) {
      m_s[r] = mx;
      l_s[r] = sum;
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < group * HD; i += kThreads) {
    const int r = i / HD;
    const int col = i % HD;
    const float* w = s_s + r * chunk_len;
    const float* vc = v + kv_off + static_cast<long long>(c0) * row_stride +
                      col;
    float a = 0.f;
    for (int j = 0; j < n_keys; ++j) {
      if (w[j] != 0.f) a = fmaf(w[j], vc[j * row_stride], a);
    }
    const long long h = head0 + r;
    if (single) {
      o[h * HD + col] = a / l_s[r];
    } else {
      part_acc[(h * n_chunks + chunk) * HD + col] = a;
      if (col == 0) {
        part_ml[(h * n_chunks + chunk) * 2] = m_s[r];
        part_ml[(h * n_chunks + chunk) * 2 + 1] = l_s[r];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the combine pass
// ---------------------------------------------------------------------------

// grid (H, B): one (slot, head) a CTA, when its reads span two chunks or
// more.  The first warp weighs each live chunk by exp2(m_c - M), M the
// largest m (0 for a chunk it does not read), into shared memory and sums
// the weighted l; then a thread a column sums the weighted acc rows in
// chunk order, each row read once.
template <typename OutT>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel_combine(const long long* __restrict__ pos,
                                const float* __restrict__ part_acc,
                                const float* __restrict__ part_ml,
                                OutT* __restrict__ o, int heads, int T,
                                int window, int chunk_len, int n_chunks,
                                int hd) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const Ring ring = ring_of(pos, b, T, window);
  if (ring.live_chunks(chunk_len, n_chunks) <= 1) return;
  extern __shared__ float w_s[];         // (n_chunks)
  __shared__ float L_s;
  const long long bh = static_cast<long long>(b) * heads + h;
  const float* ml = part_ml + bh * n_chunks * 2;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float M = -INFINITY;
    for (int c = lane; c < n_chunks; c += 32) {
      const int lo = c * chunk_len;
      const float m = ring.meets(lo, min(lo + chunk_len, T) - 1)
                          ? ml[2 * c]
                          : -INFINITY;
      w_s[c] = m;
      M = fmaxf(M, m);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    }
    float L = 0.f;
    for (int c = lane; c < n_chunks; c += 32) {
      const float w = exp2f(w_s[c] - M);
      w_s[c] = w;
      if (w != 0.f) L += ml[2 * c + 1] * w;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      L += __shfl_xor_sync(0xffffffffu, L, off);
    }
    if (lane == 0) L_s = L;
  }
  __syncthreads();
  const float* acc = part_acc + bh * n_chunks * hd;
  for (int col = threadIdx.x; col < hd; col += kThreads) {
    float a = 0.f;
#pragma unroll 4
    for (int c = 0; c < n_chunks; ++c) {
      const float w = w_s[c];
      if (w != 0.f) a += acc[static_cast<long long>(c) * hd + col] * w;
    }
    store_out(o + bh * hd + col, a / L_s);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const long long* pos;
  void* o;
  float* part_acc;
  float* part_ml;
  int batch, heads, kv_heads, T, window, chunk;
  float scale_log2;
};

template <int HD, int CHUNK>
cudaError_t launch_bf16(const Args& a, dim3 grid, cudaStream_t stream) {
  constexpr size_t kSmem = (kRows + 2 * CHUNK) * HD * sizeof(bf16);
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_attention_kernel_split_bf16<HD, CHUNK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (attr != cudaSuccess) return attr;
  decode_attention_kernel_split_bf16<HD, CHUNK>
      <<<grid, kThreads, kSmem, stream>>>(
          static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
          static_cast<const bf16*>(a.v), a.pos, static_cast<bf16*>(a.o),
          a.part_acc, a.part_ml, a.heads, a.kv_heads, a.T, a.window,
          a.scale_log2);
  return cudaGetLastError();
}

// the chunk lengths of one head size: CHUNK x HD <= 16384 (K and V 32 KB
// each in bf16)
template <int HD>
cudaError_t launch_bf16_chunk(const Args& a, dim3 grid,
                              cudaStream_t stream) {
  switch (a.chunk) {
    case 64: return launch_bf16<HD, 64>(a, grid, stream);
    case 128:
      if constexpr (128 * HD <= 16384) {
        return launch_bf16<HD, 128>(a, grid, stream);
      }
      break;
    case 256:
      if constexpr (256 * HD <= 16384) {
        return launch_bf16<HD, 256>(a, grid, stream);
      }
      break;
    default: break;
  }
  return cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch_fp32(const Args& a, dim3 grid, cudaStream_t stream) {
  const size_t smem = (kRows * HD + kRows * a.chunk) * sizeof(float);
  decode_attention_kernel_split_fp32<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.pos, static_cast<float*>(a.o),
      a.part_acc, a.part_ml, a.heads, a.kv_heads, a.T, a.window, a.chunk,
      a.scale_log2);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_split(int bf16_in, const Args& a, dim3 grid,
                         cudaStream_t stream) {
  return bf16_in ? launch_bf16_chunk<HD>(a, grid, stream)
                 : launch_fp32<HD>(a, grid, stream);
}

}  // namespace

extern "C" {

// q, o: (batch, heads, hd); k, v: (batch, T, kv_heads, hd), contiguous;
// pos: (batch,) int64.  dtype 0: float32, 1: bfloat16.  hd is one of 16,
// 32, 64, 128, 256; heads / kv_heads <= 16; 1 <= window; chunk one of 64,
// 128, 256 (bf16: chunk x hd <= 16384).  part_acc (batch, heads,
// ceil(T / chunk), hd) and part_ml (batch, heads, ceil(T / chunk), 2)
// fp32 scratch, unused when T <= chunk; ceil(T / chunk) <= 12288.  Launches the split pass and,
// when T > chunk, the combine pass on `stream`; returns
// cudaGetLastError() (or the error of a refused argument or attribute).
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* pos, void* o, void* part_acc,
                            void* part_ml, int dtype, int batch, int heads,
                            int kv_heads, int T, int hd, int window,
                            int chunk, float scale, void* stream) {
  if (batch <= 0 || batch > 65535 || kv_heads <= 0 || kv_heads > 65535 ||
      heads % kv_heads != 0 || heads / kv_heads > kRows || T <= 0 ||
      window <= 0 || (chunk != 64 && chunk != 128 && chunk != 256) ||
      dtype < 0 || dtype > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{q,
               k,
               v,
               static_cast<const long long*>(pos),
               o,
               static_cast<float*>(part_acc),
               static_cast<float*>(part_ml),
               batch,
               heads,
               kv_heads,
               T,
               window,
               chunk,
               scale * kLog2e};
  const int n_chunks = (T + chunk - 1) / chunk;
  if (n_chunks > kMaxChunks) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_chunks, kv_heads, batch);
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (hd) {
    case 16: err = launch_split<16>(dtype, a, grid, s); break;
    case 32: err = launch_split<32>(dtype, a, grid, s); break;
    case 64: err = launch_split<64>(dtype, a, grid, s); break;
    case 128: err = launch_split<128>(dtype, a, grid, s); break;
    case 256: err = launch_split<256>(dtype, a, grid, s); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || n_chunks == 1) return static_cast<int>(err);
  const dim3 cgrid(heads, batch);
  const size_t csmem = n_chunks * sizeof(float);
  if (dtype) {
    decode_attention_kernel_combine<bf16><<<cgrid, kThreads, csmem, s>>>(
        a.pos, a.part_acc, a.part_ml, static_cast<bf16*>(o), heads, T,
        window, chunk, n_chunks, hd);
  } else {
    decode_attention_kernel_combine<float><<<cgrid, kThreads, csmem, s>>>(
        a.pos, a.part_acc, a.part_ml, static_cast<float*>(o), heads, T,
        window, chunk, n_chunks, hd);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
