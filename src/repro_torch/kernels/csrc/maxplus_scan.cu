// Max-plus scan for Hopper (sm_90a): y_t = max(y_{t-1} + s_t, u_t),
// y_{-1} = h0, over each row of (B, T) float64.
//
// Replaces the Pallas TPU kernel src/repro/kernels/maxplus_scan.py:
// maxplus_chunked (_maxplus_kernel), which the simulator runs for its
// three per-burst recurrences (emission chain, GB port server, drain).
//
// Design.  The Pallas grid swept T in chunks of 256 in order, with the
// (1, 1) carry in VMEM scratch.  Hopper runs blocks in no order, so here
// one block of 128 threads owns one row and walks T in tiles of 128 K
// steps, K <= 8 consecutive steps a thread (K is the smallest of 1, 2, 4,
// 8 that covers T in one tile; the simulator's T <= 512 takes K <= 4).
// Every load of a tile is issued before any arithmetic, as double2 where
// the row is 16-byte aligned, and the next tile's loads go out before
// this tile's scan.  A tile's scan, over the semiring pairs
// (s, u) . (s', u') = (s + s', max(u + s', u')) of _maxplus_xla:
//   1. each thread folds its K pairs in order;
//   2. an inclusive warp scan of the 32 thread aggregates (five
//      __shfl_up_sync rounds); each warp's aggregate goes to shared
//      memory, then the tile's one __syncthreads;
//   3. each thread runs the carry through the aggregates of the warps
//      before its own and its lane's exclusive prefix, then steps through
//      its K elements in order and stores y.
// The tile's last y is the next tile's carry (through shared memory,
// double-buffered with the warp aggregates, so one barrier a tile does).
// Slots past T hold the identity (0, -inf), so ragged T needs no padding.
//
// Precision.  Everything is float64: cycle counts pass 2^24, where float32
// drops whole cycles.  The scan adds in tree order, not left to right, so
// for fractional inputs a result may differ from the scalar loop in the
// last bits; integer-valued (and dyadic) inputs below 2^53 add exactly, so
// there it is bit-equal to maxplus_scan_reference.  There is no multiply,
// so no fused multiply-add can change a rounding.  -inf in u or h0 stays
// -inf; with finite s no NaN arises, so fmax agrees with numpy's maximum.
//
// What bounds it.  The simulator scans one row of T <= 512 bursts at a
// time: 3 * 512 * 8 bytes in and out, 12 KB, a few ns at 3.35 TB/s.  What
// is left is one round trip of loads, the dependent chain of one tile
// (K folds, five shuffle rounds, one barrier, K steps) and the launch
// itself: the kernel is bound by launch latency, not by bytes or
// operations.  The caller's host path (copies, the wrapper's checks) costs
// more than the kernel; batching independent scans into rows of one
// launch is the lever left, and it is the caller's.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;             // one row a block
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// K steps from t on: u (identity -inf) and s (identity 0) past n_t
template <int K>
__device__ __forceinline__ void load_steps(const double* __restrict__ ur,
                                           const double* __restrict__ sr,
                                           int t, int n_t, bool vec,
                                           double (&uv)[K], double (&sv)[K]) {
  if constexpr (K % 2 == 0) {
    if (vec && t + K <= n_t) {
#pragma unroll
      for (int k = 0; k < K; k += 2) {
        const double2 a = *reinterpret_cast<const double2*>(ur + t + k);
        const double2 b = *reinterpret_cast<const double2*>(sr + t + k);
        uv[k] = a.x;
        uv[k + 1] = a.y;
        sv[k] = b.x;
        sv[k + 1] = b.y;
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool in = t + k < n_t;
    uv[k] = in ? ur[t + k] : -CUDART_INF;
    sv[k] = in ? sr[t + k] : 0.0;
  }
}

template <int K>
__device__ __forceinline__ void store_steps(double* __restrict__ yr, int t,
                                            int n_t, bool vec,
                                            const double (&yv)[K]) {
  if constexpr (K % 2 == 0) {
    if (vec && t + K <= n_t) {
#pragma unroll
      for (int k = 0; k < K; k += 2) {
        *reinterpret_cast<double2*>(yr + t + k) = make_double2(yv[k],
                                                               yv[k + 1]);
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (t + k < n_t) yr[t + k] = yv[k];
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
maxplus_kernel(const double* __restrict__ u, const double* __restrict__ s,
               const double* __restrict__ h0, double* __restrict__ y,
               int n_t) {
  constexpr int kTile = kThreads * K;
  // [tile parity]: warp aggregates, and the carry into the tile
  __shared__ double agg_s[2][kWarps];
  __shared__ double agg_u[2][kWarps];
  __shared__ double carry_in[2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t row = blockIdx.x;
  const double* ur = u + row * n_t;
  const double* sr = s + row * n_t;
  double* yr = y + row * n_t;
  // t = tile start + tid K is a multiple of K, so an aligned row keeps
  // every thread's double2 aligned when K is even
  const bool vec = ((reinterpret_cast<uintptr_t>(ur)
                     | reinterpret_cast<uintptr_t>(sr)
                     | reinterpret_cast<uintptr_t>(yr)) & 15) == 0;
  const double h_start = h0[row];
  double uv[K], sv[K];
  load_steps<K>(ur, sr, tid * K, n_t, vec, uv, sv);
  int parity = 0;
  for (int t0 = 0; t0 < n_t; t0 += kTile, parity ^= 1) {
    const int t = t0 + tid * K;
    const bool more = t0 + kTile < n_t;
    double un[K], sn[K];
    if (more) load_steps<K>(ur, sr, t + kTile, n_t, vec, un, sn);
    // 1. this thread's K pairs, folded in order
    double ps = 0.0;
    double pu = -CUDART_INF;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      pu = fmax(pu + sv[k], uv[k]);
      ps = ps + sv[k];
    }
    // 2. inclusive warp scan: (ps, pu) <- (prefix from lane - off) . (ps, pu)
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double sp = __shfl_up_sync(kFull, ps, off);
      const double up = __shfl_up_sync(kFull, pu, off);
      if (lane >= off) {
        pu = fmax(up + ps, pu);
        ps = sp + ps;
      }
    }
    double es = __shfl_up_sync(kFull, ps, 1);
    double eu = __shfl_up_sync(kFull, pu, 1);
    if (lane == 0) {
      es = 0.0;
      eu = -CUDART_INF;
    }
    if (lane == 31) {
      agg_s[parity][warp] = ps;
      agg_u[parity][warp] = pu;
    }
    __syncthreads();
    // 3. the carry through the warps before this one and the lanes before
    // this one, then this thread's K steps in order
    double x = (t0 == 0) ? h_start : carry_in[parity];
    for (int w = 0; w < warp; ++w) {
      x = fmax(x + agg_s[parity][w], agg_u[parity][w]);
    }
    x = fmax(x + es, eu);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      x = fmax(x + sv[k], uv[k]);
      uv[k] = x;                          // y, in the slot u no longer needs
    }
    store_steps<K>(yr, t, n_t, vec, uv);
    if (more) {
      // a tile with a successor is full: the last thread holds its last y
      if (tid == kThreads - 1) carry_in[parity ^ 1] = x;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        uv[k] = un[k];
        sv[k] = sn[k];
      }
    }
  }
}

template <int K>
cudaError_t launch(const void* u, const void* s, const void* h0, void* y,
                   int n_rows, int n_t, cudaStream_t stream) {
  maxplus_kernel<K><<<n_rows, kThreads, 0, stream>>>(
      static_cast<const double*>(u), static_cast<const double*>(s),
      static_cast<const double*>(h0), static_cast<double*>(y), n_t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// u, s, y: (n_rows, n_t) row-major float64; h0: (n_rows,) float64.
// Launches on `stream` and returns cudaGetLastError().
int maxplus_launch(const void* u, const void* s, const void* h0, void* y,
                   int n_rows, int n_t, void* stream) {
  if (n_rows <= 0 || n_t <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_thread = (n_t + kThreads - 1) / kThreads;
  cudaError_t err;
  if (per_thread <= 1) {
    err = launch<1>(u, s, h0, y, n_rows, n_t, st);
  } else if (per_thread <= 2) {
    err = launch<2>(u, s, h0, y, n_rows, n_t, st);
  } else if (per_thread <= 4) {
    err = launch<4>(u, s, h0, y, n_rows, n_t, st);
  } else {
    err = launch<8>(u, s, h0, y, n_rows, n_t, st);
  }
  return static_cast<int>(err);
}

const char* maxplus_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
