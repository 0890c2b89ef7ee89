// Fig. 3 interval recurrence for Hopper (sm_90a): prices every DP
// candidate of one planner call in one launch, whatever its edge counts.
//
// Replaces the planner's device function of the JAX package,
// src/repro/core/pipeline_model_jax.py:_make_price_fn (the jit + vmap of
// `one`, called by price_rows once per power-of-two edge bucket): XLA
// code, not Pallas, but the planner's only device code on the pricing
// path.  The recurrence per candidate, over its edges k in slot-DAG order
// (the incoming edges of k's producer slot come before k), is the host's
// pipeline_model._dag_segment_cost:
//
//   prod_side = max(0, max_{d in in(k)} delta_d * (n_d / n_k))
//   ci        = max(t_prod_k, t_cons_k, prod_side)
//   over      = sp_k and load_k > ci
//   comm      = over ? min(load_k * max(1, ci),
//                          max(load_k * 2, (load_k + hops_k) + ci)) : ci
//   delta_k   = max(ci, comm) + mem_stall / n_k
//   pfill_k   = max(0, max_{d in in(k)} pfill_d) + delta_k * fill_k
//   latency   = max_{k final} (pfill_k + n_k delta_k) + max_{k sp} hops_k
//
// plus the congestion flag (any `over`) and the hop energy, the sum in
// edge order of hop_unit_k * n_k over the edges with NoC stats.
//
// Ragged input.  Row b's edges are [row_ptr[b], row_ptr[b + 1]) of a flat
// edge axis; in(k) is the list in_idx[in_ptr[k] .. in_ptr[k + 1]) of edge
// indices within k's row.  The reference padded E to a power of two to
// bound its jit shapes; here nothing is padded (a padded edge never fed a
// real edge and was sliced away, so dropping it changes no result).
//
// Numerics.  The DP compares these latencies exactly (a one-ulp change can
// flip a tie and change the selected plan), so every float64 operation
// rounds as the host's does.  This source is built with -fmad=false
// (kernels/build.py EXTRA_FLAGS; the flag is part of the library's
// digest): nvcc would otherwise contract `upstream + delta * fill` and
// `pfill + n * delta` into fused multiply-adds.  `n_d / n_k` and
// `mem_stall / n_k` are IEEE divisions (double division is always
// correctly rounded in CUDA).  Sums and products run in the host's order;
// `load + hops` is formed first, as the host's left-to-right sum does.
// Maxima are exact and every value is finite and >= +0, so the order in
// which they are taken (an incoming list's order, t_prod before t_cons)
// changes no bit, and a compare and a select (dmax) give fmax's bits.
//
// Design.  The recurrence is a dependent chain along each row's edges, so
// one thread walks one row; the parallelism is across rows.  A block
// takes up to 4 consecutive rows, walked by lanes of one warp: lanes
// whose rows take different paths hold each other up, so fewer rows a
// block walk faster, down to one, where a call of many rows pays for its
// many blocks.  All 128 threads first stage the block's rows: one pass
// copies its inputs into shared memory, every load of a step issued
// before its stores, and a second computes in place every quantity that
// does not wait on the chain (max(t_prod, t_cons, 0), mem_stall / n_k,
// load + hops, the hop-energy terms, and n_d / n_k for every incoming
// entry, the divisions among them).  An edge's inputs sit together
// (Edge, four 16-byte loads), as do an entry's ratio and index and an
// edge's delta and pfill.  The walk then reads only shared memory: per edge its
// incoming list and, per entry, d's delta and pfill -- O(E + entries)
// steps, not the O(E^2) scan of an E x E incidence row.  The next edge's
// list end and first entry are loaded a step ahead; an edge that does
// not congest skips the capped branch (its delta is ci + stall, which
// max(ci, ci) + stall equals); a second warp sums the rows' hop energies
// meanwhile; the deltas leave the block at the end, coalesced.  The
// host's block plan (price_rows_plan) halves the rows a block takes until
// every block's staged bytes fit 48 KB; a block whose rows cannot fit
// even one at a time (a row of hundreds of edges) stages into global
// scratch with the same code: a regime chosen by size.
//
// What bounds it.  A call of B rows, N edges and M entries reads 56 N +
// 8 B bytes of float64 inputs, 4 (B + N + M) of indices and N flag bytes,
// and writes 8 (3 B + N): the 1539 rows of an 8-task plan run (N = 6210)
// move about 0.5 MB, 0.15 us of the card's 3.35 TB/s, and need ~20
// float64 operations per edge.  The kernel is bound by the latency of
// its longest row's chain instead: each link is a dependent
// shared-memory load, a multiply, compare-selects and a branch in one
// instruction stream, after two staging steps and the block's first two
// dependent global loads (row_ptr, then in_ptr).  On an H100 a call
// whose longest row has 31 edges takes ~6 us of device time whatever
// its other rows, and each edge of a longer row ~0.2 us more
// (chip_smoke.py).  Splitting a row over lanes would need a barrier per
// edge.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;           // a block stages with all of them
constexpr int kMaxRows = 4;             // rows a block walks (one warp's lanes)
constexpr int kSmemLimit = 48 * 1024;   // dynamic shared memory, no opt-in

// What the walk reads of an edge, computed before it (step 2 of
// price_block): four 16-byte loads.
struct __align__(16) Edge {
  double base;    // max(t_prod, t_cons, 0)
  double stall;   // mem_stall / n
  double load;
  double lh;      // load + hops
  double fill;
  double n;
  double hops;    // hops if the edge has NoC stats, else 0
  double hun;     // hop_unit * n if the edge has NoC stats, else 0
};

// An incoming entry of edge k: d's burst ratio n_d / n_k, d's index in
// the block, and k's (used only while the ratios are computed).
struct __align__(16) Entry {
  double ratio;
  int d;
  int pad;
};

// Bytes a block of nr rows, ne edges and nj incoming entries stages: an
// Edge, its (delta, pfill) and (end of its incoming list, flags) per
// edge, an Entry per entry, mem_stall and row_ptr (nr + 1) per row.
__host__ __device__ inline long long block_bytes(long long ne, long long nj,
                                                 long long nr) {
  return 88 * ne + 16 * nj + 12 * nr + 4;
}

struct Inputs {
  const double* f;          // (7, N): t_prod t_cons n fill load hops hop_unit
  const double* mem_stall;  // (B,)
  const int* row_ptr;       // (B + 1,)
  const uint8_t* flags;     // (N,): bit 0 sp, bit 1 final
  const int* in_ptr;        // (N + 1,)
  const int* in_idx;        // (M,): edge indices within the row
  int B, N, M;
};

// One block's staged arrays, indexed within the block (edges from the
// block's first edge, entries from its first entry, rows from its first
// row), in shared memory or in global scratch.
struct Work {
  Edge* edge;
  double2* dp;       // (delta, pfill)
  Entry* entry;
  int2* meta;        // (end of the incoming list, flags)
  double* row_stall;
  int* rp;           // row_ptr, nr + 1
};

__device__ __forceinline__ Work carve_shared(char* p, int ne, int nj,
                                             int nr) {
  Work w;
  w.edge = reinterpret_cast<Edge*>(p);
  w.dp = reinterpret_cast<double2*>(w.edge + ne);
  w.entry = reinterpret_cast<Entry*>(w.dp + ne);
  w.meta = reinterpret_cast<int2*>(w.entry + nj);
  w.row_stall = reinterpret_cast<double*>(w.meta + ne);
  w.rp = reinterpret_cast<int*>(w.row_stall + nr);
  return w;
}

// The same arrays over the whole call in global scratch (sized by
// scratch_bytes, 16-byte aligned), offset to block b's
// slices; row_ptr takes one more slot per block.
__device__ __forceinline__ Work carve_global(char* p, const Inputs& in,
                                             int b, int e0, int j0, int r0) {
  Work w;
  Edge* edge = reinterpret_cast<Edge*>(p);
  double2* dp = reinterpret_cast<double2*>(edge + in.N);
  Entry* entry = reinterpret_cast<Entry*>(dp + in.N);
  int2* meta = reinterpret_cast<int2*>(entry + in.M);
  double* row_stall = reinterpret_cast<double*>(meta + in.N);
  int* rp = reinterpret_cast<int*>(row_stall + in.B);
  w.edge = edge + e0;
  w.dp = dp + e0;
  w.entry = entry + j0;
  w.meta = meta + e0;
  w.row_stall = row_stall + r0;
  w.rp = rp + r0 + b;
  return w;
}

// Maxima and minima as one compare and a select: every value here is
// finite and none is -0, so these give the bits fmax and fmin give.
__device__ __forceinline__ double dmax(double a, double b) {
  return a > b ? a : b;
}
__device__ __forceinline__ double dmin(double a, double b) {
  return a < b ? a : b;
}

__device__ __forceinline__ void price_block(const Inputs& in, const Work& w,
                                            int r0, int nr, int e0, int ne,
                                            int j0, int nj,
                                            double* __restrict__ out) {
  const int tid = threadIdx.x;
  const size_t N = in.N;

  // 1. copy the block's inputs in, every load of a step issued before its
  //    stores; raw t_prod, t_cons and hop_unit land in base, stall and
  //    hun, and the raw in_idx in Entry::d, which step 2 rewrites
  const int steps = max(max(ne, nj), nr + 1);
  for (int i = tid; i < steps; i += kThreads) {
    const size_t g = e0 + i;
    double f[7];
    int fl = 0, end = 0, ix = 0, rp = 0;
    double rs = 0.0;
    if (i < ne) {
#pragma unroll
      for (int a = 0; a < 7; ++a) f[a] = in.f[a * N + g];
      fl = in.flags[g];
      end = in.in_ptr[g + 1];
    }
    if (i < nj) ix = in.in_idx[j0 + i];
    if (i <= nr) rp = in.row_ptr[r0 + i];
    if (i < nr) rs = in.mem_stall[r0 + i];
    if (i < ne) {
      w.edge[i] = Edge{f[0], f[1], f[4], f[5], f[3], f[2], f[5], f[6]};
      w.meta[i] = make_int2(end - j0, fl);
    }
    if (i < nj) w.entry[i].d = ix;
    if (i <= nr) w.rp[i] = rp - e0;
    if (i < nr) w.row_stall[i] = rs;
  }
  __syncthreads();

  // 2. everything of an edge that does not wait on its incoming edges: a
  //    thread rewrites only its own edges, then only its own entries
  //    (n is only read), so that the divisions spread over the block
  for (int e = tid; e < ne; e += kThreads) {
    int t = 0;                         // e's row: the last rp[t] <= e
    for (int half = kMaxRows / 2; half > 0; half /= 2) {
      if (t + half < nr && w.rp[t + half] <= e) t += half;
    }
    Edge& c = w.edge[e];
    const double nk = c.n;
    const bool sp = (w.meta[e].y & 1) != 0;
    const double hp = c.hops;
    // max(t_prod, t_cons, 0): the walk folds the incoming terms into it
    c.base = dmax(dmax(c.base, c.stall), 0.0);
    c.stall = w.row_stall[t] / nk;
    c.lh = c.load + hp;
    c.hops = sp ? hp : 0.0;
    c.hun = sp ? c.hun * nk : 0.0;
    const int first = w.rp[t];
    for (int j = e == 0 ? 0 : w.meta[e - 1].x; j < w.meta[e].x; ++j) {
      w.entry[j].d += first;
      w.entry[j].pad = e;              // the entry's own edge, for 2b
    }
  }
  __syncthreads();
  for (int j = tid; j < nj; j += kThreads) {
    const Entry en = w.entry[j];
    w.entry[j].ratio = w.edge[en.d].n / w.edge[en.pad].n;
  }
  __syncthreads();

  // 3. the recurrence, one thread a row of the first warp, in edge order.
  //    The next edge's list end and first entry are loaded a step ahead,
  //    and an edge's own inputs before its incoming entries, so that
  //    their loads overlap the chain.  The second warp sums the rows' hop
  //    energies (in edge order) and takes their largest hop counts.
  bool any_over = false;
  double lat = -CUDART_INF;
  if (tid < nr) {
    const int k0 = w.rp[tid];
    const int k1 = w.rp[tid + 1];
    int j = k0 == 0 ? 0 : w.meta[k0 - 1].x;
    int2 m = k0 < k1 ? w.meta[k0] : make_int2(j, 0);
    Entry en = j < m.x ? w.entry[j] : Entry{};
    for (int k = k0; k < k1; ++k) {
      const Edge c = w.edge[k];
      const int2 next = w.meta[min(k + 1, k1 - 1)];
      double ci = c.base;
      double upstream = 0.0;
#pragma unroll 1
      for (; j < m.x; ++j) {
        const double2 v = w.dp[en.d];
        const double ratio = en.ratio;
        if (j + 1 < m.x) en = w.entry[j + 1];
        ci = dmax(ci, v.x * ratio);
        upstream = dmax(upstream, v.y);
      }
      if (j < next.x) en = w.entry[j];   // the next edge's first entry
      // comm = over ? capped : ci, delta = max(ci, comm) + stall
      double delta;
      if ((m.y & 1) && c.load > ci) {
        any_over = true;
        const double capped =
            dmin(c.load * dmax(1.0, ci), dmax(c.load * 2.0, c.lh + ci));
        delta = dmax(ci, capped) + c.stall;
      } else {
        delta = ci + c.stall;
      }
      const double pf = upstream + delta * c.fill;
      w.dp[k] = make_double2(delta, pf);
      if (m.y & 2) lat = dmax(lat, pf + c.n * delta);
      m = next;
    }
  } else if (tid >= 32 && tid < 32 + nr) {
    double max_hops = 0.0;
    double hop_e = 0.0;
    for (int k = w.rp[tid - 32]; k < w.rp[tid - 31]; ++k) {
      max_hops = dmax(max_hops, w.edge[k].hops);
      hop_e = hop_e + w.edge[k].hun;
    }
    w.row_stall[tid - 32] = max_hops;
    out[in.B + r0 + tid - 32] = hop_e;
  }
  __syncthreads();

  // 4. the rows' latencies and flags, and the deltas out, coalesced
  if (tid < nr) {
    out[r0 + tid] = lat + w.row_stall[tid];
    out[2 * in.B + r0 + tid] = any_over ? 1.0 : 0.0;
  }
  double* deltas = out + 3 * static_cast<size_t>(in.B) + e0;
  for (int e = tid; e < ne; e += kThreads) deltas[e] = w.dp[e].x;
}

__global__ void __launch_bounds__(kThreads)
price_rows_kernel(Inputs in, int rows_per_block, int smem_bytes,
                  char* scratch, double* __restrict__ out) {
  extern __shared__ __align__(16) char smem[];
  const int r0 = blockIdx.x * rows_per_block;
  const int nr = min(rows_per_block, in.B - r0);
  const int e0 = in.row_ptr[r0];
  const int e1 = in.row_ptr[r0 + nr];
  const int j0 = in.in_ptr[e0];
  const int nj = in.in_ptr[e1] - j0;
  // the block plan's rule: the block's own bytes decide, so a block
  // stages in shared memory exactly when the plan counted it as fitting
  if (block_bytes(e1 - e0, nj, nr) <= smem_bytes) {
    price_block(in, carve_shared(smem, e1 - e0, nj, nr), r0, nr, e0,
                e1 - e0, j0, nj, out);
  } else {
    price_block(in, carve_global(scratch, in, blockIdx.x, e0, j0, r0), r0,
                nr, e0, e1 - e0, j0, nj, out);
  }
}

// Bytes of the global scratch carve_global lays out, rounded up to 16;
// the scratch must start 16-byte aligned.
long long scratch_bytes(int n_rows, int n_edges, int n_entries,
                        int blocks) {
  const long long b = block_bytes(n_edges, n_entries, n_rows) + 4LL * blocks;
  return (b + 15) / 16 * 16;
}

// Inputs as in Inputs above (device pointers); out: (3 B + N,) float64,
// latency (B), hop energy (B), congested (B; 1.0 or 0.0), deltas (N).
// rows_per_block and smem_bytes from price_rows_plan; scratch (device,
// scratch_bytes, 16-byte aligned) may be null when the plan has no
// global block.
// Launches on `stream` and returns cudaGetLastError().
int launch(const void* f, const void* mem_stall, const void* row_ptr,
           const void* flags, const void* in_ptr, const void* in_idx,
           int n_rows, int n_edges, int n_entries, int rows_per_block,
           int smem_bytes, void* scratch, void* out, void* stream) {
  if (n_rows <= 0 || n_edges <= 0 || n_entries < 0 || rows_per_block < 1 ||
      rows_per_block > kMaxRows || smem_bytes < 0 ||
      smem_bytes > kSmemLimit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Inputs in{static_cast<const double*>(f),
                  static_cast<const double*>(mem_stall),
                  static_cast<const int*>(row_ptr),
                  static_cast<const uint8_t*>(flags),
                  static_cast<const int*>(in_ptr),
                  static_cast<const int*>(in_idx), n_rows, n_edges,
                  n_entries};
  const int blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  price_rows_kernel<<<blocks, kThreads, smem_bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      in, rows_per_block, smem_bytes, static_cast<char*>(scratch),
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The block plan of a call from its host-side row_ptr (B + 1) and in_ptr
// (N + 1): plan[0] rows a block (4, halved until every block's staged
// bytes fit kSmemLimit, at least 1), plan[1] the dynamic shared memory a
// block gets (the largest fitting block's bytes), plan[2] the blocks, and
// plan[3] the blocks that stage in global scratch (rows that do not fit
// even alone).
int price_rows_plan(const int* row_ptr, const int* in_ptr, int n_rows,
                    int* plan) {
  if (n_rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int rows = kMaxRows;; rows /= 2) {
    long long most = 0;
    int over = 0;
    for (int r0 = 0; r0 < n_rows; r0 += rows) {
      const int nr = rows < n_rows - r0 ? rows : n_rows - r0;
      const int e0 = row_ptr[r0], e1 = row_ptr[r0 + nr];
      const long long need = block_bytes(e1 - e0, in_ptr[e1] - in_ptr[e0],
                                         nr);
      if (need > kSmemLimit) {
        ++over;
      } else if (need > most) {
        most = need;
      }
    }
    if (over == 0 || rows == 1) {
      plan[0] = rows;
      plan[1] = static_cast<int>(most);
      plan[2] = (n_rows + rows - 1) / rows;
      plan[3] = over;
      return 0;
    }
  }
}

// The planner's round trip for one call, all of it on `stream`:
// `stage` is the host copy (pinned) of the ragged inputs, the six parts at
// byte offsets `at[0..5]` (floats, mem_stall, row_ptr, flags, in_ptr,
// in_idx) of its first `stage_bytes` bytes.  The block plan comes from the
// host copy; then one copy of those bytes to `dev`, one launch on
// addresses inside it, one copy of the (3 B + N) float64 output from
// dev + out_at (16-byte aligned) to `host_out`, and one wait for the
// stream.  The scratch of global blocks, if any, follows the output,
// 16-byte aligned.  Where `dev_bytes` is too small for that, *need is set
// to the bytes needed and nothing runs (cudaErrorMemoryAllocation).
// plan: price_rows_plan's four numbers.
int price_rows_round_trip(const void* stage, long long stage_bytes,
                          const long long* at, int n_rows, int n_edges,
                          int n_entries, void* dev, long long dev_bytes,
                          long long out_at, void* host_out, void* stream,
                          int* plan, long long* need) {
  const char* h = static_cast<const char*>(stage);
  int err = price_rows_plan(reinterpret_cast<const int*>(h + at[2]),
                            reinterpret_cast<const int*>(h + at[4]), n_rows,
                            plan);
  if (err != 0) return err;
  const long long out_bytes = 8LL * (3LL * n_rows + n_edges);
  const long long scratch_at = (out_at + out_bytes + 15) / 16 * 16;
  *need = plan[3] ? scratch_at + scratch_bytes(n_rows, n_edges, n_entries,
                                             plan[2])
                  : out_at + out_bytes;
  if (dev_bytes < *need) return static_cast<int>(cudaErrorMemoryAllocation);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* d = static_cast<char*>(dev);
  err = cudaMemcpyAsync(d, stage, stage_bytes, cudaMemcpyHostToDevice, s);
  if (err != 0) return err;
  err = launch(d + at[0], d + at[1], d + at[2], d + at[3], d + at[4],
               d + at[5], n_rows, n_edges, n_entries, plan[0], plan[1],
               plan[3] ? d + scratch_at : nullptr, d + out_at, stream);
  if (err != 0) return err;
  err = cudaMemcpyAsync(host_out, d + out_at, out_bytes,
                        cudaMemcpyDeviceToHost, s);
  if (err != 0) return err;
  return static_cast<int>(cudaStreamSynchronize(s));
}

const char* price_rows_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
