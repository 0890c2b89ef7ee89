// WKV6 recurrence for Hopper (sm_90a), per (batch x head) row bh:
//
//   y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
//   S_t = diag(w_t) S_{t-1} + k_t^T v_t,        S_{-1} = s0 (or 0)
//
// r, k, v, w, y: (BH, T, N) float32; u: (BH, N); S: (BH, N, N) float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py: wkv6
// (_wkv6_kernel), the RWKV-6 time mix's recurrence.
//
// Two regimes (rwkv6_scan.py: choose_regime); every CUDA function is named
// wkv6_kernel_*.
//
// step, T < 16 (every decode call), wkv6_kernel_step: the recurrence one
// step at a time.  One block of N threads owns one row bh; thread j keeps
// column j of the state, S[0..N-1][j], in registers.  Per step the block
// stages r_t, k_t, w_t in shared memory (double-buffered, so one barrier
// a step), and each thread computes
//
//   y_t[j]  = sum_i r_t[i] (S[i][j] + u[i] (k_t[i] v_t[j]))
//   S[i][j] = w_t[i] S[i][j] + k_t[i] v_t[j]
//
// with the next step's inputs in flight in registers.  No exp or log.
// Each step is a dependent chain of N multiply-adds and a barrier, and
// 64 blocks of two warps leave most of the card idle: at T = 512 this
// kernel is 28x its bound (0.363 ms of device time at (BH 64, T 512,
// N 64) on an NVIDIA H100 80GB HBM3 at 700 W), so it serves decode only.
//
// chunked, T >= 16, wkv6_kernel_chunked: the Pallas kernel's chunked
// form, with the decays as products instead of exponentials of
// cumulative logs.  Within a chunk of 16 steps, with P_t = prod_{s<t} w_s
// and D(tau, t) = prod_{tau<s<t} w_s (a product of decays in [0, 1], so
// it never exceeds 1, as every exponent of the log form was <= 0; w = 0
// gives 0 with no log and no clamp):
//
//   y_t   = (r_t P_t) S_in
//         + sum_{tau<t} A[t][tau] v_tau + (sum_i r_t[i] u[i] k_t[i]) v_t,
//   A[t][tau] = sum_i r_t[i] k_tau[i] D(tau, t)[i],
//   S_out = diag(P_16) S_in + sum_tau diag(D(tau, 16)) k_tau^T v_tau.
//
// Column j of S only ever meets column j of v, so a block of 512 threads
// (256 where N NV < 512) owns one (row bh, slice of NV value columns);
// NV (8, 16 or 32, rwkv6_scan.py: value_split) is the smallest that keeps
// the grid in one wave of the card's SMs (132 on the H100), since every
// block of a row repeats the row's decays and A.  The chunks run in order
// inside the block; cp.async brings chunk c + 2's r, k, w (16 x N each) and v
// (16 x NV) into the third of three shared buffers while chunk c is
// computed.  Per chunk, with three block barriers:
//   1. lane (column i, kTPT steps): the 16 decays of column i, multiplied
//      in order by every thread of the column into the prefix products
//      P_t, the suffix products D(t, 16) and the sub-chunk factors below;
//      then r_t P_t, k_t D(t, 16), P_16 and the factors times r and k.
//   2. A's 120 pairs: inside a sub-chunk of 4 steps (24 pairs, 4 lanes
//      each) with their at most two decays; across sub-chunks (96 pairs,
//      one lane each) as the dot product of r_t prod_{4a<=s<t} w_s and
//      k_tau prod_{tau<s<4a} w_s (a = t / 4), so no pair costs N
//      products of decays.  Beside them 8 warps own the state, 8 rows of
//      one column a thread in registers for the whole sweep: they sum
//      (r_t P_t) S_in over their rows for every t into shared memory, then
//      update S <- P_16 S + sum_tau k_tau D(tau, 16) v_tau, one fused
//      multiply-add a step; two more warps (or, where none is idle, the
//      first two) sum the bonus terms sum_i r_t[i] u[i] k_t[i].
//   3. y_t[j]: the state parts summed over the row groups, the strictly
//      past A v and the bonus, in double, rounded to float32 once.
// A, the bonus and y are summed in double: on rwkv6-1.6b's (2, 512)
// forward this keeps the logits within 1e-3 of the float64 recurrence's,
// where float32 sums there (and the plain float32 path) land 0.13 away,
// see PERF.md.  A last chunk shorter than 16 reads nothing past T (its
// rows are zero-filled) and its masked steps decay by 1.  No fast math,
// no TF32, no atomics: two calls give the same bits.
//
// What bounds it.  Per step and row the function needs 5 N^2 + 5 N
// float32 operations (2 N^2 for r_t S, 3 N^2 for the state update; the
// bonus term factorises, v_t[j] sum_i r_t[i] u[i] k_t[i], so it costs
// O(N)) against 5 N inputs and outputs: at the prefill shape (BH = 64,
// T = 512, N = 64) that is 0.68 GFLOP (10.2 us at 67 TFLOP/s on the CUDA
// cores) against 43 MB (12.8 us at 3.35 TB/s), so bytes set the bound.
// The chunked kernel is held back by shared-memory traffic and issue, not
// bytes: every phase moves its operands through shared memory, and the
// N / NV blocks of a row repeat the decays and A.  Its measured times
// are in PERF.md.

#include <cuda_runtime.h>

namespace {

constexpr int kSplit = 4;                 // partial sums per y element

template <int N>
__global__ void __launch_bounds__(N)
wkv6_kernel_step(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 float* __restrict__ y, float* __restrict__ s_out, int n_t) {
  __shared__ float sh_r[2][N];
  __shared__ float sh_k[2][N];
  __shared__ float sh_w[2][N];
  __shared__ float sh_u[N];
  const int j = threadIdx.x;
  const size_t row = blockIdx.x;
  const size_t base = row * static_cast<size_t>(n_t) * N;

  float s[N];
  if (s0 != nullptr) {
    const float* sr = s0 + row * N * N;
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] = sr[i * N + j];
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) s[i] = 0.0f;
  }
  sh_u[j] = u[row * N + j];

  float rr = r[base + j];
  float kk = k[base + j];
  float ww = w[base + j];
  float vv = v[base + j];
  for (int t = 0; t < n_t; ++t) {
    const int buf = t & 1;
    sh_r[buf][j] = rr;
    sh_k[buf][j] = kk;
    sh_w[buf][j] = ww;
    const float vj = vv;
    __syncthreads();
    if (t + 1 < n_t) {                    // next step's inputs, in flight
      const size_t o = base + static_cast<size_t>(t + 1) * N + j;
      rr = r[o];
      kk = k[o];
      ww = w[o];
      vv = v[o];
    }
    float acc[kSplit];
#pragma unroll
    for (int q = 0; q < kSplit; ++q) acc[q] = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float kv = sh_k[buf][i] * vj;
      acc[i % kSplit] += sh_r[buf][i] * (s[i] + sh_u[i] * kv);
      s[i] = sh_w[buf][i] * s[i] + kv;
    }
    y[base + static_cast<size_t>(t) * N + j] =
        (acc[0] + acc[1]) + (acc[2] + acc[3]);
  }

  float* so = s_out + row * N * N;
#pragma unroll
  for (int i = 0; i < N; ++i) so[i * N + j] = s[i];
}

// ---------------------------------------------------------------------------
// chunked regime
// ---------------------------------------------------------------------------

constexpr int kL = 16;                    // steps a chunk
constexpr int kPairs = kL * (kL - 1) / 2; // strictly-past (t, tau) pairs
constexpr int kStages = 3;                // raw chunk buffers

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
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
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
// Shared-memory layout of a chunked block, in floats.  Rows read by many
// lanes at once are padded by 4 floats, so the lanes of a quarter warp
// that read one 16-byte piece of different rows hit different banks.  Raw
// inputs have three stages (chunk c in use, c + 1 and c + 2 in flight).
template <int N, int NV>
struct ChunkSmem {
  // threads a block: 512 where N NV >= 512, else 256.  In step 2 the
  // first 96 sum A's pairs across sub-chunks (one each), the next 96 its
  // pairs inside one (kIL = 4 lanes each), and kSO of the rest own the
  // state, kRO rows of one column a thread
  static constexpr int kThreads = N * NV >= 512 ? 512 : 256;
  static constexpr int kIL = 4;
  static constexpr int kXT = 96;                    // cross-pair threads
  static constexpr int kOwn = kXT + 24 * kIL;       // first state owner
  static constexpr int kRO = 8;                     // state rows an owner
  static constexpr int kSO = N * NV / kRO;          // state owners
  static constexpr int kG = N / kRO;                // their row groups
  // the bonus sums' 64 threads: the last two warps where they are idle
  // in step 2, else the first two
  static constexpr int kB0 =
      kThreads - kOwn - kSO >= 64 ? kThreads - 64 : 0;
  static constexpr int kNP = N + 4;                 // padded row
  static constexpr int kRaw = kL * kNP;             // one r, k or w tile
  static constexpr int kR = 0;                      // [3][kL][kNP]
  static constexpr int kK = kR + kStages * kRaw;
  static constexpr int kW = kK + kStages * kRaw;
  static constexpr int kV = kW + kStages * kRaw;    // [3][kL][NV]
  // the decays, a column's 16 in a row padded to 20 floats (16-byte
  // reads of 8 neighbouring columns fall in distinct banks)
  static constexpr int kWsP = kL + 4;
  static constexpr int kWs = kV + kStages * kL * NV;    // [N][kWsP]
  static constexpr int kRd = kWs + N * kWsP;        // [kL][kNP] r P
  static constexpr int kKd = kRd + kRaw;            // [kL][kNP] k Q
  static constexpr int kDl = kKd + kRaw;            // [N] the chunk's decay
  // the sub-chunk factors of A: r_t prod_{4a <= s < t} w_s for t >= 4
  // (a = t / 4), and k_tau prod_{tau < s < 4a} w_s for a = 1..3, tau < 4a
  static constexpr int kRf = kDl + N;               // [kL][kNP]
  static constexpr int kKf = kRf + kRaw;            // [3][12][kNP]
  static constexpr int kA = kKf + 36 * kNP;         // [kL][kL] doubles
  static constexpr int kU = kA + 2 * kL * kL;       // [N]
  static constexpr int kB = kU + N;                 // [kL] doubles
  static constexpr int kP = kB + 2 * kL;            // [kG][kL][NV] r S
  static constexpr int kFloats = kP + kG * kL * NV;
  static constexpr size_t kBytes = kFloats * sizeof(float);
  static_assert(kK % 4 == 0 && kV % 4 == 0 && kWs % 4 == 0 &&
                    kRd % 4 == 0 && kKd % 4 == 0 && kDl % 4 == 0 &&
                    kRf % 4 == 0 && kKf % 4 == 0 && kA % 4 == 0 &&
                    kU % 4 == 0 && kB % 4 == 0 && kP % 4 == 0,
                "every tile starts on 16 bytes");
  static_assert(kOwn % 32 == 0 && kSO <= kThreads - kOwn,
                "the block splits step 2 by warps");
};

// Issue the cp.async copies of chunk `c` (steps c kL ..) of row_base into
// stage `stage`: r, k, w rows whole, v only this block's NV columns from
// j0.  Steps at or past n_t are zero-filled.
template <int N, int NV>
__device__ __forceinline__ void load_chunk(
    float* sm, int stage, const float* r, const float* k, const float* w,
    const float* v, size_t row_base, int n_t, int c, int j0) {
  using Sm = ChunkSmem<N, NV>;
  constexpr int kPieces = N / 4;                    // 16-byte pieces a row
  constexpr int kPA = kL * kPieces;                 // of an r, k or w tile
  constexpr int kVA = kL * NV / 4;                  // of the v tile
  static_assert(kPA <= Sm::kThreads && kVA <= Sm::kThreads,
                "one piece of each tile a thread");
  const int tid = threadIdx.x;
  const int t0 = c * kL;
  if (tid < kPA) {
    const int t = tid / kPieces;
    const int p = tid % kPieces;
    const bool in = t0 + t < n_t;
    const size_t off =
        row_base + static_cast<size_t>(in ? t0 + t : 0) * N + 4 * p;
    const int so = stage * Sm::kRaw + t * Sm::kNP + 4 * p;
    cp_async16(sm + Sm::kR + so, r + off, in ? 16 : 0);
    cp_async16(sm + Sm::kK + so, k + off, in ? 16 : 0);
    cp_async16(sm + Sm::kW + so, w + off, in ? 16 : 0);
  }
  const int e = tid - (Sm::kThreads - kVA);      // the last kVA threads
  if (e >= 0) {
    const int t = e / (NV / 4);
    const int p = e % (NV / 4);
    const bool in = t0 + t < n_t;
    cp_async16(sm + Sm::kV + stage * kL * NV + t * NV + 4 * p,
               v + row_base + static_cast<size_t>(in ? t0 + t : 0) * N + j0 +
                   4 * p,
               in ? 16 : 0);
  }
}

// n consecutive floats from shared memory (n = 1, 2 or a multiple of 4;
// aligned to 4 n bytes up to 16)
template <int n>
__device__ __forceinline__ void load_run(float (&out)[n], const float* p) {
  if constexpr (n == 1) {
    out[0] = *p;
  } else if constexpr (n == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    out[0] = a.x;
    out[1] = a.y;
  } else {
#pragma unroll
    for (int q = 0; q < n; q += 4) {
      const float4 a = *reinterpret_cast<const float4*>(p + q);
      out[q] = a.x;
      out[q + 1] = a.y;
      out[q + 2] = a.z;
      out[q + 3] = a.w;
    }
  }
}

template <int N, int NV>
__global__ void __launch_bounds__(ChunkSmem<N, NV>::kThreads,
                                  512 / ChunkSmem<N, NV>::kThreads)
wkv6_kernel_chunked(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u,
                    const float* __restrict__ s0, float* __restrict__ y,
                    float* __restrict__ s_out, int n_t) {
  using Sm = ChunkSmem<N, NV>;
  constexpr int kThreads = Sm::kThreads;
  constexpr int kNP = Sm::kNP;
  constexpr int kS = N / NV;              // blocks a row
  constexpr int kIL = Sm::kIL;
  constexpr int kTPT = kL * N / kThreads; // steps a thread in step 1
  constexpr int kYO = (kL * NV + kThreads - 1) / kThreads;   // y a thread
  static_assert(kTPT >= 1 && kTPT * kThreads == kL * N &&
                    N % (4 * kIL) == 0,
                "N divides the block");
  extern __shared__ float4 smem_f4[];
  float* sm = reinterpret_cast<float*>(smem_f4);

  const int tid = threadIdx.x;
  const int row = blockIdx.x / kS;
  const int j0 = (blockIdx.x % kS) * NV;
  const size_t row_base = static_cast<size_t>(row) * n_t * N;
  const int n_chunks = (n_t + kL - 1) / kL;

  load_chunk<N, NV>(sm, 0, r, k, w, v, row_base, n_t, 0, j0);
  cp_async_commit();
  if (n_chunks > 1) {
    load_chunk<N, NV>(sm, 1, r, k, w, v, row_base, n_t, 1, j0);
  }
  cp_async_commit();

  // step 1: column li, steps lt0 .. lt0 + kTPT - 1 (one value a warp)
  const int li = tid % N;
  const int lt0 = tid / N * kTPT;
  if (tid < N) sm[Sm::kU + tid] = u[static_cast<size_t>(row) * N + tid];
  // step 2: pair (pt, ptau) of A, ptau < pt, and part of i (16-byte
  // pieces part, part + width, ..); or the state, column j and rows
  // kRO g .. kRO g + kRO - 1
  const int kind = tid < Sm::kXT ? 0 : (tid < Sm::kOwn ? 1 : 2);
  const int width = kind == 0 ? 1 : kIL;
  const int task = (tid - (kind == 0 ? 0 : Sm::kXT)) / width;
  const int part = tid % width;
  int pt = 0, ptau = 0;
  if (kind == 0) {                        // t in sub-chunk a, tau < 4a
    const int a = task < 16 ? 1 : (task < 48 ? 2 : 3);
    const int x = task - (a == 1 ? 0 : (a == 2 ? 16 : 48));
    pt = 4 * a + x / (4 * a);
    ptau = x % (4 * a);
  } else if (kind == 1) {                 // both in sub-chunk task / 6
    const int m = task % 6;
    const int tt = m < 1 ? 1 : (m < 3 ? 2 : 3);
    pt = 4 * (task / 6) + tt;
    ptau = 4 * (task / 6) + m - (tt * (tt - 1)) / 2;
  }
  const int so = tid - Sm::kOwn;
  const bool owner = so >= 0 && so < Sm::kSO;
  const int j = (owner ? so : 0) % NV;
  const int g = (owner ? so : 0) / NV;
  constexpr int kRO = Sm::kRO;
  float s[kRO];
#pragma unroll
  for (int m = 0; m < kRO; ++m) {
    s[m] = owner && s0 != nullptr
               ? s0[static_cast<size_t>(row) * N * N +
                    static_cast<size_t>(kRO * g + m) * N + j0 + j]
               : 0.0f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int stage = c % kStages;
    const int valid = min(kL, n_t - c * kL);
    const float* rr = sm + Sm::kR + stage * Sm::kRaw;
    const float* kk = sm + Sm::kK + stage * Sm::kRaw;
    const float* ww = sm + Sm::kW + stage * Sm::kRaw;
    const float* vv = sm + Sm::kV + stage * kL * NV;
    cp_async_wait<1>();
    __syncthreads();                      // chunk c landed
    if (c + 2 < n_chunks) {
      load_chunk<N, NV>(sm, (c + 2) % kStages, r, k, w, v, row_base, n_t,
                        c + 2, j0);
    }
    cp_async_commit();

    // 1. per column li and this thread's kTPT steps from lt0: the decays
    //    of the column's 16 steps (1 for masked steps, which then decay
    //    nothing), multiplied in order by every thread of the column: the
    //    prefix products P_t = prod_{s<t} w_s, the suffix products
    //    Q_t = prod_{t<s<16} w_s, and the sub-chunk factors; then
    //    r_t P_t, k_t Q_t, P_16 (the chunk's decay) and r_t, k_t times
    //    their sub-chunk factors
    {
      float rv[kTPT], kv[kTPT];
#pragma unroll
      for (int q = 0; q < kTPT; ++q) {
        const int t = lt0 + q;
        rv[q] = rr[t * kNP + li];
        kv[q] = kk[t * kNP + li];
        sm[Sm::kWs + li * Sm::kWsP + t] = t < valid ? ww[t * kNP + li] : 1.0f;
      }
      __syncthreads();
      float wv[kL];
      load_run<kL>(wv, sm + Sm::kWs + li * Sm::kWsP);
      float pre[kL + 1], suf[kL], loc[kL], sub[3][12];
      pre[0] = 1.0f;
#pragma unroll
      for (int t = 0; t < kL; ++t) pre[t + 1] = pre[t] * wv[t];
      suf[kL - 1] = 1.0f;
#pragma unroll
      for (int t = kL - 2; t >= 0; --t) suf[t] = suf[t + 1] * wv[t + 1];
#pragma unroll
      for (int t = 0; t < kL; ++t) {      // prod_{4a <= s < t} w_s
        loc[t] = t % 4 == 0 ? 1.0f : loc[t - 1] * wv[t - 1];
      }
#pragma unroll
      for (int a = 1; a < 4; ++a) {       // prod_{tau < s < 4a} w_s
        sub[a - 1][4 * a - 1] = 1.0f;
#pragma unroll
        for (int tau = 4 * a - 2; tau >= 0; --tau) {
          sub[a - 1][tau] = sub[a - 1][tau + 1] * wv[tau + 1];
        }
      }
#pragma unroll
      for (int b = 0; b < kL; b += kTPT) {
        if (b != lt0) continue;           // one value of lt0 a warp
#pragma unroll
        for (int q = 0; q < kTPT; ++q) {
          const int t = b + q;
          sm[Sm::kRd + t * kNP + li] = rv[q] * pre[t];
          sm[Sm::kKd + t * kNP + li] = kv[q] * suf[t];
          if (t >= 4) sm[Sm::kRf + t * kNP + li] = rv[q] * loc[t];
#pragma unroll
          for (int a = 1; a < 4; ++a) {
            if (t < 4 * a) {
              sm[Sm::kKf + ((a - 1) * 12 + t) * kNP + li] =
                  kv[q] * sub[a - 1][t];
            }
          }
        }
      }
      if (lt0 + kTPT == kL) sm[Sm::kDl + li] = pre[kL];
    }
    __syncthreads();

    // 2. A[pt][ptau] = sum_i r[pt][i] k[ptau][i] prod_{ptau<s<pt} w[s][i]:
    //    across sub-chunks the dot product of the two factors, inside one
    //    with its at most two decays, each in double over `width` lanes;
    //    the bonus sums (threads kB0 ..); and, by the state's owners,
    //    (r_t P_t) S_in over their kRO rows for every step (summed over
    //    the row groups in 3.) and the state update,
    //    S <- P_16 S + sum_tau k_tau prod_{s>tau} w_s v_tau
    if (kind < 2) {
      double acc[2] = {0.0, 0.0};
      if (kind == 0) {
        const float* rf = sm + Sm::kRf + pt * kNP;
        const float* kf = sm + Sm::kKf + ((pt / 4 - 1) * 12 + ptau) * kNP;
#pragma unroll
        for (int m = 0; m < N / 4; ++m) {
          const int i = 4 * m;
          float a[4], b[4];
          load_run<4>(a, rf + i);
          load_run<4>(b, kf + i);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[q & 1] = __fma_rn(static_cast<double>(a[q]),
                                  static_cast<double>(b[q]), acc[q & 1]);
          }
        }
      } else {
        const float* rt = rr + pt * kNP;
        const float* kt = kk + ptau * kNP;
        const float* w1 = ww + (ptau + 1) * kNP;            // w between
        const float* w2 = ww + (ptau + 2) * kNP;
        const int gap = pt - ptau;                          // 1, 2 or 3
#pragma unroll
        for (int m = 0; m < N / (4 * kIL); ++m) {
          const int i = 4 * (part + kIL * m);
          float a[4], b[4], x[4] = {1.0f, 1.0f, 1.0f, 1.0f}, z[4];
          load_run<4>(a, rt + i);
          load_run<4>(b, kt + i);
          if (gap > 1) load_run<4>(x, w1 + i);
          if (gap > 2) {
            load_run<4>(z, w2 + i);
#pragma unroll
            for (int q = 0; q < 4; ++q) x[q] *= z[q];
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[q & 1] = __fma_rn(
                static_cast<double>(a[q]) * static_cast<double>(b[q]),
                static_cast<double>(x[q]), acc[q & 1]);
          }
        }
      }
      double sum = acc[0] + acc[1];
#pragma unroll
      for (int o = 1; o < kIL; o *= 2) {  // groups of `width` lanes
        const double other = __shfl_xor_sync(0xffffffffu, sum, o);
        if (o < width) sum += other;
      }
      if (part == 0) {
        reinterpret_cast<double*>(sm + Sm::kA)[pt * kL + ptau] = sum;
      }
    } else if (owner) {
      float prt[kL];
#pragma unroll
      for (int t = 0; t < kL; ++t) {
        float rd[kRO];
        load_run<kRO>(rd, sm + Sm::kRd + t * kNP + kRO * g);
        float acc[2] = {0.0f, 0.0f};
#pragma unroll
        for (int m = 0; m < kRO; ++m) {
          acc[m & 1] = fmaf(rd[m], s[m], acc[m & 1]);
        }
        prt[t] = acc[0] + acc[1];
      }
#pragma unroll
      for (int t = 0; t < kL; ++t) sm[Sm::kP + (g * kL + t) * NV + j] = prt[t];
      float dl[kRO];
      load_run<kRO>(dl, sm + Sm::kDl + kRO * g);
#pragma unroll
      for (int m = 0; m < kRO; ++m) s[m] *= dl[m];
#pragma unroll
      for (int tau = 0; tau < kL; ++tau) {
        float kd[kRO];
        load_run<kRO>(kd, sm + Sm::kKd + tau * kNP + kRO * g);
        const float vj = vv[tau * NV + j];
#pragma unroll
        for (int m = 0; m < kRO; ++m) s[m] = fmaf(kd[m], vj, s[m]);
      }
    }
    const int bi = tid - Sm::kB0;         // the bonus of step bi / 4
    if (bi >= 0 && bi < 4 * kL) {         // over 4 lanes (two warps)
      double bs[2] = {0.0, 0.0};
#pragma unroll
      for (int m = 0; m < N / 16; ++m) {
        const int i = 4 * (bi % 4 + 4 * m);
        float a[4], b[4], uu[4];
        load_run<4>(a, rr + bi / 4 * kNP + i);
        load_run<4>(b, kk + bi / 4 * kNP + i);
        load_run<4>(uu, sm + Sm::kU + i);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          bs[q & 1] = __fma_rn(
              static_cast<double>(a[q]) * static_cast<double>(uu[q]),
              static_cast<double>(b[q]), bs[q & 1]);
        }
      }
      double bonus = bs[0] + bs[1];
      bonus += __shfl_xor_sync(0xffffffffu, bonus, 1);
      bonus += __shfl_xor_sync(0xffffffffu, bonus, 2);
      if (bi % 4 == 0) reinterpret_cast<double*>(sm + Sm::kB)[bi / 4] = bonus;
    }
    __syncthreads();                      // A, the bonus, the r S parts

    // 3. y at step t of column jj: the r S parts, the strictly past A v
    //    and the bonus
#pragma unroll
    for (int q = 0; q < kYO; ++q) {
      const int o = tid + kThreads * q;
      const int t = o / NV;
      const int jj = o % NV;
      if (t < valid) {
        double acc[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
        for (int gg = 0; gg < Sm::kG; ++gg) {
          acc[gg % 2] += sm[Sm::kP + (gg * kL + t) * NV + jj];
        }
        const double* arow =
            reinterpret_cast<const double*>(sm + Sm::kA) + t * kL;
#pragma unroll
        for (int tau = 0; tau < kL - 1; ++tau) {
          if (tau < t) {
            acc[2 + tau % 2] = __fma_rn(
                arow[tau], static_cast<double>(vv[tau * NV + jj]),
                acc[2 + tau % 2]);
          }
        }
        const double out = __fma_rn(
            reinterpret_cast<const double*>(sm + Sm::kB)[t],
            static_cast<double>(vv[t * NV + jj]),
            (acc[0] + acc[1]) + (acc[2] + acc[3]));
        y[row_base + static_cast<size_t>(c * kL + t) * N + j0 + jj] =
            static_cast<float>(out);
      }
    }
  }

  if (owner) {
#pragma unroll
    for (int m = 0; m < kRO; ++m) {
      s_out[static_cast<size_t>(row) * N * N +
            static_cast<size_t>(kRO * g + m) * N + j0 + j] = s[m];
    }
  }
}

template <int N, int NV>
cudaError_t launch_chunked(const float* r, const float* k, const float* v,
                           const float* w, const float* u, const float* s0,
                           float* y, float* s_out, int bh, int n_t,
                           cudaStream_t st) {
  using Sm = ChunkSmem<N, NV>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      wkv6_kernel_chunked<N, NV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Sm::kBytes));
  if (attr != cudaSuccess) return attr;
  wkv6_kernel_chunked<N, NV><<<bh * (N / NV), Sm::kThreads, Sm::kBytes, st>>>(
      r, k, v, w, u, s0, y, s_out, n_t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, v, w, y: (bh, n_t, n) row-major float32; u: (bh, n); s0 (may be
// null for a zero state) and s_out: (bh, n, n).  n is 32 or 64.  regime
// 0 runs wkv6_kernel_step; 1 wkv6_kernel_chunked with nv value columns a
// block (8, 16 or 32, at most n), which takes r, k, v, w aligned to 16
// bytes.  Launches on `stream` and returns cudaGetLastError().
int wkv6_launch(const void* r, const void* k, const void* v, const void* w,
                const void* u, const void* s0, void* y, void* s_out, int bh,
                int n_t, int n, int regime, int nv, void* stream) {
  if (bh <= 0 || n_t <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* rf = static_cast<const float*>(r);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* wf = static_cast<const float*>(w);
  const auto* uf = static_cast<const float*>(u);
  const auto* sf = static_cast<const float*>(s0);
  auto* yf = static_cast<float*>(y);
  auto* of = static_cast<float*>(s_out);
  if (regime == 0) {
    if (n == 64) {
      wkv6_kernel_step<64><<<bh, 64, 0, st>>>(rf, kf, vf, wf, uf, sf, yf, of,
                                             n_t);
    } else if (n == 32) {
      wkv6_kernel_step<32><<<bh, 32, 0, st>>>(rf, kf, vf, wf, uf, sf, yf, of,
                                             n_t);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (regime != 1) return static_cast<int>(cudaErrorInvalidValue);
#define WKV6_CHUNKED(NN, NVV)                                            \
  if (n == NN && nv == NVV) {                                            \
    return static_cast<int>(launch_chunked<NN, NVV>(rf, kf, vf, wf, uf,  \
                                                    sf, yf, of, bh, n_t, \
                                                    st));                \
  }
  WKV6_CHUNKED(64, 8)
  WKV6_CHUNKED(64, 16)
  WKV6_CHUNKED(64, 32)
  WKV6_CHUNKED(32, 8)
  WKV6_CHUNKED(32, 16)
  WKV6_CHUNKED(32, 32)
#undef WKV6_CHUNKED
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
