// Max-plus scan for Hopper (sm_90a): y_t = max(y_{t-1} + s_t, u_t),
// y_{-1} = h0, over each row of (B, T) float64.
//
// Replaces the Pallas TPU kernel src/repro/kernels/maxplus_scan.py:
// maxplus_chunked (_maxplus_kernel), which the simulator runs for its
// three per-burst recurrences (emission chain, GB port server, drain).
//
// Design.  The Pallas grid swept T in chunks of 256 in order, with the
// (1, 1) carry in VMEM scratch.  Hopper runs blocks in no order, so here
// one warp owns one row and loops over T in chunks of 32, one element per
// lane, with the carry in a register.  Inside a chunk the lanes run an
// inclusive warp scan (__shfl_up_sync) over the semiring pairs
// (s, u) . (s', u') = (s + s', max(u + s', u')) of _maxplus_xla; lane t
// then holds (S_t, U_t) and y_t = max(carry + S_t, U_t).  The last lane's
// y is the next chunk's carry.  Lanes past T hold the identity (0, -inf),
// so ragged T needs no padding.
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
// time: 3 * 512 * 8 bytes in and out, 12 KB, a few ns at 3.35 TB/s.  The
// warp's 16 chunks of 5 dependent shuffle steps take a few microseconds,
// and the launch itself costs about as much: the kernel is bound by launch
// latency and the scan's dependent chain, not by bytes or operations.
// Batching many rows per launch (B rows -> B / 4 blocks) is the lever, and
// it is the caller's: the simulator's scans depend on each other.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 4;                 // rows per block
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
maxplus_kernel(const double* __restrict__ u, const double* __restrict__ s,
               const double* __restrict__ h0, double* __restrict__ y,
               int n_rows, int n_t) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;              // the whole warp leaves together
  const double* ur = u + static_cast<size_t>(row) * n_t;
  const double* sr = s + static_cast<size_t>(row) * n_t;
  double* yr = y + static_cast<size_t>(row) * n_t;
  double carry = h0[row];
  for (int t0 = 0; t0 < n_t; t0 += 32) {
    const int t = t0 + lane;
    double ss = 0.0;
    double uu = -CUDART_INF;
    if (t < n_t) {
      ss = sr[t];
      uu = ur[t];
    }
    // inclusive scan: (ss, uu) <- (prefix from lane - off) . (ss, uu)
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double sp = __shfl_up_sync(kFull, ss, off);
      const double up = __shfl_up_sync(kFull, uu, off);
      if (lane >= off) {
        uu = fmax(up + ss, uu);
        ss = sp + ss;
      }
    }
    const double x = fmax(carry + ss, uu);
    if (t < n_t) yr[t] = x;
    carry = __shfl_sync(kFull, x, 31);
  }
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
  const dim3 grid((n_rows + kWarps - 1) / kWarps);
  maxplus_kernel<<<grid, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(u), static_cast<const double*>(s),
      static_cast<const double*>(h0), static_cast<double*>(y), n_rows, n_t);
  return static_cast<int>(cudaGetLastError());
}

const char* maxplus_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
