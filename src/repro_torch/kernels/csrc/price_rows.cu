// Batched Fig. 3 interval recurrence for Hopper (sm_90a): prices every
// DP candidate of one edge bucket in one launch.
//
// Replaces the planner's device function of the JAX package,
// src/repro/core/pipeline_model_jax.py:_make_price_fn (the jit + vmap of
// `one`, called by price_rows): XLA code, not Pallas, but the planner's
// only device code on the pricing path.  The recurrence per candidate b,
// over its edges k in slot-DAG order (incoming edges of k's producer slot
// come before k), is `one`'s loop body line by line:
//
//   prod_side = max(0, max_{d in inc[k]} delta_d * (n_d / n_k))
//   ci        = max(t_prod_k, max(t_cons_k, prod_side))
//   over      = sp_k and load_k > ci
//   comm      = over ? min(load_k * max(1, ci),
//                          max(2 load_k, load_k + hops_k + ci)) : ci
//   delta_k   = max(ci, comm) + mem_stall / n_k
//   pfill_k   = max(0, max_{d in inc[k]} pfill_d) + delta_k * fill_k
//   latency   = max_{k final} (pfill_k + n_k delta_k) + max_{k sp} hops_k
//
// plus the congestion flag (any `over`) and the hop energy
// (sum_{k sp} hop_unit_k * n_k).
//
// Numerics.  The DP compares these latencies exactly (a one-ulp change
// can flip a tie and change the selected plan), so every float64
// operation must round as the host's segment_cost does.  This source is
// built with -fmad=false (kernels/build.py EXTRA_FLAGS; the flag is part
// of the library's digest): nvcc would otherwise contract
// `upstream + delta * fill` and `pfill + n * delta` into fused
// multiply-adds.  `n_d / n_k` and `mem_stall / n_k` are IEEE divisions
// (double division is always correctly rounded in CUDA).  The operations
// run in the host's order, so the results are bit-equal to the host's.
//
// Design.  One thread per candidate, 64 candidates per block.  A
// candidate's deltas are written straight into its row of the output,
// and its pipeline-fill values into a scratch row the wrapper allocates;
// both rows stay in L1 while the thread walks its E edges, and there is
// no limit on E (the XR-bench plans produce up to 32 edges per candidate
// once padded).  The reference padded E and B to powers of two to bound
// its jit shapes; here E and B are run-time arguments, and the caller
// pads E only to keep the reference's edge buckets (padded edges are
// inert: t = 0, n = 1, masks off).
//
// What bounds it.  A batch reads 7 float64 (B, E) rows, 2 bool (B, E)
// masks, the (B, E, E) incidence and mem_stall, and writes 2 + E float64
// and one byte per candidate: 229 candidates at E = 8 move under 50 KB, a
// few hundred nanoseconds of the card's 3.35 TB/s, and do O(B E^2)
// float64 operations, far below its float64 rate.  Each thread's walk is
// a dependent chain of E^2 steps, and the launch costs microseconds, so
// the kernel is bound by launch latency.  The lever is fewer, larger
// launches: pricing more of the DP frontier per call.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;

__global__ void __launch_bounds__(kThreads)
price_rows_kernel(const double* __restrict__ t_prod,
                  const double* __restrict__ t_cons,
                  const double* __restrict__ n,
                  const double* __restrict__ fill,
                  const double* __restrict__ load,
                  const double* __restrict__ hops,
                  const double* __restrict__ hop_unit,
                  const uint8_t* __restrict__ sp,
                  const uint8_t* __restrict__ fin,
                  const uint8_t* __restrict__ inc,
                  const double* __restrict__ mem_stall,
                  double* __restrict__ latency,
                  uint8_t* __restrict__ congested,
                  double* __restrict__ hop_energy,
                  double* __restrict__ deltas,
                  double* __restrict__ pfill,
                  int n_rows, int n_edges) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= n_rows) return;
  const size_t row = static_cast<size_t>(b) * n_edges;
  const double* nb = n + row;
  double* dl = deltas + row;
  double* pf = pfill + row;
  for (int k = 0; k < n_edges; ++k) {     // `one` starts from zeros
    dl[k] = 0.0;
    pf[k] = 0.0;
  }
  const double stall = mem_stall[b];
  bool any_over = false;
  double max_hops = 0.0;
  double hop_e = 0.0;
  for (int k = 0; k < n_edges; ++k) {
    const double nk = nb[k];
    const uint8_t* inck = inc + (row + k) * n_edges;
    double prod_side = 0.0;
    double upstream = 0.0;
    for (int d = 0; d < n_edges; ++d) {
      if (inck[d]) {
        prod_side = fmax(prod_side, dl[d] * (nb[d] / nk));
        upstream = fmax(upstream, pf[d]);
      }
    }
    const double ci = fmax(t_prod[row + k], fmax(t_cons[row + k], prod_side));
    const double ld = load[row + k];
    const double hp = hops[row + k];
    const bool spk = sp[row + k] != 0;
    const bool over = spk && (ld > ci);
    const double capped = fmin(ld * fmax(1.0, ci),
                               fmax(ld * 2.0, ld + hp + ci));
    const double comm = over ? capped : ci;
    any_over = any_over || over;
    max_hops = fmax(max_hops, spk ? hp : 0.0);
    hop_e = hop_e + (spk ? hop_unit[row + k] * nk : 0.0);
    const double delta = fmax(ci, comm) + stall / nk;
    dl[k] = delta;
    pf[k] = upstream + delta * fill[row + k];
  }
  double lat = -CUDART_INF;
  for (int k = 0; k < n_edges; ++k) {
    if (fin[row + k]) lat = fmax(lat, pf[k] + nb[k] * dl[k]);
  }
  latency[b] = lat + max_hops;
  congested[b] = any_over ? 1 : 0;
  hop_energy[b] = hop_e;
}

}  // namespace

extern "C" {

// Inputs: t_prod, t_cons, n, fill, load, hops, hop_unit (B, E) float64;
// sp, fin (B, E) and inc (B, E, E) bytes of 0/1; mem_stall (B,) float64.
// Outputs: latency, hop_energy (B,) float64; congested (B,) bytes;
// deltas (B, E) float64.  pfill: (B, E) float64 scratch.  All row-major.
// Launches on `stream` and returns cudaGetLastError().
int price_rows_launch(const void* t_prod, const void* t_cons, const void* n,
                      const void* fill, const void* load, const void* hops,
                      const void* hop_unit, const void* sp, const void* fin,
                      const void* inc, const void* mem_stall, void* latency,
                      void* congested, void* hop_energy, void* deltas,
                      void* pfill, int n_rows, int n_edges, void* stream) {
  if (n_rows <= 0 || n_edges <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n_rows + kThreads - 1) / kThreads);
  price_rows_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(t_prod), static_cast<const double*>(t_cons),
      static_cast<const double*>(n), static_cast<const double*>(fill),
      static_cast<const double*>(load), static_cast<const double*>(hops),
      static_cast<const double*>(hop_unit),
      static_cast<const uint8_t*>(sp), static_cast<const uint8_t*>(fin),
      static_cast<const uint8_t*>(inc),
      static_cast<const double*>(mem_stall), static_cast<double*>(latency),
      static_cast<uint8_t*>(congested), static_cast<double*>(hop_energy),
      static_cast<double*>(deltas), static_cast<double*>(pfill), n_rows,
      n_edges);
  return static_cast<int>(cudaGetLastError());
}

const char* price_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
