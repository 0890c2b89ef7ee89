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
// Design.  The Pallas grid (BH, S / bq, T / bk) swept the kv axis in order
// with acc, m and l in VMEM scratch.  Hopper runs blocks in no order, so
// one block owns one (64-row query tile, head, batch) and the kv sweep is
// a loop inside the block: the q tile (shared memory), the running max
// and sum and the fp32 accumulator (registers, hd / 4 values a thread)
// stay on chip for the whole sweep.  The loop visits only the kv tiles of
// 32 keys that the causal or window mask can admit for the tile's rows, so
// a local layer (window 1024) at S = 8192 reads about window + 64 keys a
// row, not S.  Every row keeps at least one admitted key in that range,
// so the result is the reference's, whose fully masked tiles wash out
// through alpha = exp(-1e30 - m) = 0.  Only when some row has no admitted
// key at all (window > 0 and S - T >= window) does the block sweep every
// tile, as the reference does, so such a row gets the reference's mean of
// v.  Unlike the reference the kernel takes any S and T: rows past S are
// not stored and keys past T get p = 0.
//
// Layout.  q, o: element (b, i, h, d) at b q_sb + i q_ss + h q_sh + d;
// k, v: (b, j, kh, d) at b k_sb + j k_ss + kh k_sh + d.  The model's
// (B, S, H, hd) tensors and the reference's (BH, S, hd) ones are both such
// strided views, so GQA never repeats k or v in memory.  Tiles are staged
// in shared memory in the inputs' type, rows padded by 4 elements so that
// the 4-element loads of 16 (bf16) or 8 (float32) lanes fall in distinct
// banks.  256 threads: thread (ty, tx) owns rows 4 ty .. 4 ty + 3 of the
// tile, scores for keys tx and tx + 16, and output columns
// 64 g + 4 tx .. + 3 (hd >= 64) or tx + 16 i (hd < 64).  Row maxima and
// sums are reduced over the 16 lanes of a row group with shuffles; p goes
// through shared memory (transposed) to the PV product.
//
// What bounds it.  The function's work is 4 hd H sum_rows(admitted keys)
// operations and one read of q, k, v and one write of o.  At gemma3-4b's
// width (H = 8, Hkv = 4, hd = 256) and S = 8192 that is 6.4e10 operations
// (local, window 1024) or 2.7e11 (global) against 100 MB: on the H100 the
// bf16 tensor cores would need 0.065 ms and 0.28 ms, the bytes 0.030 ms,
// so the bound is operations.  This first kernel runs its products on the
// CUDA cores in fp32 (67 TFLOP/s peak, and the shared-memory reads of the
// tiles limit it further), so it stays far above the bf16 bound; mma/wgmma
// tiles fed by TMA are the lever for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;                  // query rows per block
constexpr int kBK = 32;                  // keys per kv tile
constexpr int kPad = 4;                  // elements of padding per row
constexpr int kPLd = kBQ + kPad;         // row length of the p tile
constexpr float kNegInf = -1e30f;        // the reference's masked score

// Four consecutive elements: 16 bytes of float32, 8 bytes of bfloat16.
template <typename T> struct Quad;
template <> struct Quad<float> { using type = float4; };
template <> struct Quad<__nv_bfloat16> { using type = uint2; };

__device__ __forceinline__ float4 to_float4(float4 v) { return v; }
__device__ __forceinline__ float4 to_float4(uint2 v) {
  // a bfloat16 is the high half of a float32
  return make_float4(__uint_as_float(v.x << 16),
                     __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16),
                     __uint_as_float(v.y & 0xffff0000u));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ typename Quad<T>::type zero_quad();
template <>
__device__ __forceinline__ float4 zero_quad<float>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
template <>
__device__ __forceinline__ uint2 zero_quad<__nv_bfloat16>() {
  return make_uint2(0u, 0u);
}

// Stage rows row0 .. row0 + n_rows - 1 of a strided (row, hd) view into
// shared memory (row length HD + kPad); rows at or past `limit` are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          long long row_stride, int row0,
                                          int n_rows, int limit) {
  using Q = typename Quad<T>::type;
  constexpr int kQuads = HD / 4;
  for (int i = threadIdx.x; i < n_rows * kQuads; i += kThreads) {
    const int r = i / kQuads;
    const int c = (i % kQuads) * 4;
    const int row = row0 + r;
    const Q val = row < limit
        ? *reinterpret_cast<const Q*>(src + row * row_stride + c)
        : zero_quad<T>();
    *reinterpret_cast<Q*>(dst + r * (HD + kPad) + c) = val;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_tile_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o,
                            int n_q, int n_k, int group, long long q_sb,
                            long long q_sh, long long q_ss, long long k_sb,
                            long long k_sh, long long k_ss, int causal,
                            int window, float scale) {
  using Q = typename Quad<T>::type;
  constexpr int kLd = HD + kPad;
  constexpr bool kVecCols = HD % 64 == 0;
  constexpr int kCols = HD / 16;         // output columns per thread

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* k_s = q_s + kBQ * kLd;
  T* v_s = k_s + kBK * kLd;
  float* p_s = reinterpret_cast<float*>(v_s + kBK * kLd);   // (kBK, kPLd)

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const long long q_off = b * q_sb + h * q_sh;
  const long long k_off = b * k_sb + (h / group) * k_sh;

  load_tile<T, HD>(q_s, q + q_off, q_ss, q0, kBQ, n_q);

  // the kv tiles the masks can admit for rows q0 .. q_last
  const int q_last = min(q0 + kBQ, n_q) - 1;
  int lo = 0;
  int hi = n_k;
  if (!(window > 0 && n_q - n_k >= window)) {
    if (causal) hi = min(n_k, q_last + 1);
    if (window > 0) lo = max(0, q0 - window + 1);
  }
  const int t_begin = lo / kBK;
  const int t_end = (hi + kBK - 1) / kBK;

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
    load_tile<T, HD>(k_s, k + k_off, k_ss, k0, kBK, n_k);
    load_tile<T, HD>(v_s, v + k_off, k_ss, k0, kBK, n_k);
    __syncthreads();

    // scores of rows 4 ty + r against keys tx and tx + 16
    float s[4][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 k_a = to_float4(
          *reinterpret_cast<const Q*>(k_s + tx * kLd + d));
      const float4 k_b = to_float4(
          *reinterpret_cast<const Q*>(k_s + (tx + 16) * kLd + d));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 qv = to_float4(
            *reinterpret_cast<const Q*>(q_s + (4 * ty + r) * kLd + d));
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
          const float4 vv = to_float4(*reinterpret_cast<const Q*>(
              v_s + j * kLd + 64 * g + 4 * tx));
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
          const float vv = to_float(v_s[j * kLd + tx + 16 * c]);
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
    T* row = o + q_off + qi * q_ss;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = kVecCols ? 64 * (c / 4) + 4 * tx + (c % 4) : tx + 16 * c;
      store(row + col, acc[r][c] / den);
    }
  }
}

constexpr size_t smem_bytes(int hd, size_t elem) {
  return (kBQ + 2 * kBK) * (hd + kPad) * elem + kBK * kPLd * sizeof(float);
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int heads, int group, int n_q, int n_k,
                   long long q_sb, long long q_sh, long long q_ss,
                   long long k_sb, long long k_sh, long long k_ss,
                   int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t kSmem = smem_bytes(HD, sizeof(T));
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_tile_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kSmem));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((n_q + kBQ - 1) / kBQ, heads, batch);
  flash_attention_tile_kernel<T, HD><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n_q, n_k, group, q_sb,
      q_sh, q_ss, k_sb, k_sh, k_ss, causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_for_hd(int hd, const void* q, const void* k,
                          const void* v, void* o, int batch, int heads,
                          int group, int n_q, int n_k, long long q_sb,
                          long long q_sh, long long q_ss, long long k_sb,
                          long long k_sh, long long k_ss, int causal,
                          int window, float scale, cudaStream_t stream) {
#define FLASH_HD(N)                                                       \
  case N:                                                                 \
    return launch<T, N>(q, k, v, o, batch, heads, group, n_q, n_k, q_sb,  \
                        q_sh, q_ss, k_sb, k_sh, k_ss, causal, window,     \
                        scale, stream);
  switch (hd) {
    FLASH_HD(16)
    FLASH_HD(32)
    FLASH_HD(64)
    FLASH_HD(128)
    FLASH_HD(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_HD
}

}  // namespace

extern "C" {

// 1 if one launch takes head size `hd`.
int flash_attention_supports_hd(int hd) {
  return hd == 16 || hd == 32 || hd == 64 || hd == 128 || hd == 256;
}

// q, o: (batch, n_q, heads, hd) and k, v: (batch, n_k, heads / group, hd)
// as strided views (strides in elements, see the header), one dtype
// (0 = float32, 1 = bfloat16).  window <= 0 means unbounded.  Launches on
// `stream` and returns cudaGetLastError() (or the error of a refused
// argument or attribute).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int batch, int heads,
                           int group, int n_q, int n_k, int hd,
                           long long q_sb, long long q_sh, long long q_ss,
                           long long k_sb, long long k_sh, long long k_ss,
                           int causal, int window, float scale,
                           void* stream) {
  if (batch <= 0 || batch > 65535 || heads <= 0 || heads > 65535 ||
      group <= 0 || heads % group != 0 || n_q <= 0 || n_k <= 0 ||
      !flash_attention_supports_hd(hd)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return static_cast<int>(launch_for_hd<float>(
        hd, q, k, v, o, batch, heads, group, n_q, n_k, q_sb, q_sh, q_ss,
        k_sb, k_sh, k_ss, causal, window, scale, s));
  }
  if (dtype == 1) {
    return static_cast<int>(launch_for_hd<__nv_bfloat16>(
        hd, q, k, v, o, batch, heads, group, n_q, n_k, q_sb, q_sh, q_ss,
        k_sb, k_sh, k_ss, causal, window, scale, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
