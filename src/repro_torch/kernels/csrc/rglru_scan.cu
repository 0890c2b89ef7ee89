// RG-LRU diagonal recurrence for Hopper (sm_90a), per batch row and
// channel:
//
//   h_t = a_t h_{t-1} + b_t,        h_{-1} = h0 (or 0)
//
// a, b, h: (B, T, W) float32; h0, h_last: (B, W) float32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rglru_scan.py:
// rglru_chunked (_rglru_kernel), the Griffin block's recurrence.
//
// The Pallas kernel swept T in chunks of L = 64 in order with the (1, W)
// carry in VMEM scratch, and inside a chunk built an (L, L, W) decay
// tensor for a cumulative-log-decay closed form.  The recurrence is
// diagonal, so here no (L, L, W) tensor, no exp and no log: two regimes,
// which the wrapper picks by T (kernels/rglru_scan.py: choose_regime).
//
// step (T < SPLIT_MIN, every decode call): rglru_kernel_step.  One thread
// owns one (row, channel) and walks T with h in a register; neighbouring
// threads own neighbouring channels, so every load and store is
// coalesced.  Each thread issues kUnroll steps of loads before it runs
// their arithmetic.  At T = 1 the body is a load, a multiply-add and a
// store: the launch is the whole cost.
//
// split (T >= SPLIT_MIN): rglru_kernel_split<CG>.  A block owns one row
// and CG channels; its threads are CG lanes along channels by n_seg
// segments of L = 16 steps along T, a tile of n_seg * 16 steps (256 at
// most).  CG is 32 (a warp's 128-byte line a step) where the grid of
// 32-channel blocks fills a wave of the card, else 16 (half-lines, twice
// the blocks; kernels/rglru_scan.py: split_plan).  Per tile:
//   1. each thread loads its segment's 16 values of a and of b into
//      registers, every load before any arithmetic, and folds them into
//      the segment's pair: A = prod a, B = the segment's end state from
//      a zero start;
//   2. the pairs go to shared memory; the CG threads of segment 0 carry
//      them across the segments in order, c_{k+1} = A_k c_k + B_k from the
//      tile's carry (h0 or 0 on the first tile), writing each segment's
//      carry-in;
//   3. each thread reruns h = a h + b from its carry-in over the values it
//      holds and stores every h.
// A longer T loops over tiles, the carry (the tile's last h) kept in
// shared memory; steps past T are the identity (a = 1, b = 0), never
// stored, so h_last is the last segment's h.  Each element is read once
// and written once; two block barriers a tile.
//
// Rounding.  Each step rounds the product and then the sum (__fmul_rn,
// __fadd_rn: no fused multiply-add), as the plain versions' two
// elementwise operations do.  The step regime is therefore bit-equal to
// rglru_ref.  In the split regime h inside a segment is exactly the
// sequential recurrence from its carry-in, but a carry-in comes from the
// pairs (A, B), which round differently: it is bit-equal to
// rglru_split_ref, the same arithmetic in PyTorch, and within the
// reference suite's 1e-4 of rglru_ref.
//
// What bounds it.  Bytes: a and b read once, h written once (12 B per
// element; 31.5 MB at B = 2, T = 512, W = 2560: 9.4 us at 3.35 TB/s).  The
// step regime holds only B W (5120) threads' kUnroll loads in flight and
// is bound by memory latency along T.  The split regime has a whole tile
// in flight (B W T / 16 threads, 32 KB of loads a block of 256), and every
// block of the forward's (2, 512) grid (320 of 16 channels, 4 an SM) is
// resident at once, so it runs near the bytes bound.  What remains above
// it is a tile's latency chain (a load round trip, 2 x 16 dependent steps,
// the carry across n_seg segments, two barriers), once per 256 steps: a
// long T (4096 steps, 16 tiles a block in order) is bound by that chain,
// which loading the next tile during this one's arithmetic would hide.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;              // step: channels per block
constexpr int kUnroll = 16;               // step: steps whose loads fly together
constexpr int kSegLen = 16;               // split: steps a segment
constexpr int kMaxSegs = 16;              // split: segments a tile

__global__ void __launch_bounds__(kThreads)
rglru_kernel_step(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  float* __restrict__ h_last, int n_t, int width) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= width) return;
  const size_t row = blockIdx.y;
  const size_t w = static_cast<size_t>(width);
  const size_t base = row * static_cast<size_t>(n_t) * w + c;
  float x = (h0 != nullptr) ? h0[row * w + c] : 0.0f;
  int t = 0;
  for (; t + kUnroll <= n_t; t += kUnroll) {
    float av[kUnroll];
    float bv[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const size_t o = base + static_cast<size_t>(t + q) * w;
      av[q] = a[o];
      bv[q] = b[o];
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      x = __fadd_rn(__fmul_rn(av[q], x), bv[q]);
      h[base + static_cast<size_t>(t + q) * w] = x;
    }
  }
  for (; t < n_t; ++t) {
    const size_t o = base + static_cast<size_t>(t) * w;
    x = __fadd_rn(__fmul_rn(a[o], x), b[o]);
    h[o] = x;
  }
  h_last[row * w + c] = x;
}

// CG channels by up to kMaxSegs segments of kSegLen steps.  An SM holds
// 1024 threads' worth of blocks (2 of 32 channels, 4 of 16): 64 registers
// a thread, of which the segment's a and b take 2 kSegLen
template <int CG>
__global__ void __launch_bounds__(CG * kMaxSegs, 1024 / (CG * kMaxSegs))
rglru_kernel_split(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ h0, float* __restrict__ h,
                   float* __restrict__ h_last, int n_t, int width,
                   int n_seg) {
  // [segment * CG + lane]: the pairs, the carry-ins; [lane]: the carry
  // into the next tile
  __shared__ float s_a[kMaxSegs * CG];
  __shared__ float s_b[kMaxSegs * CG];
  __shared__ float s_in[kMaxSegs * CG];
  __shared__ float s_carry[CG];
  const int lane = threadIdx.x % CG;
  const int seg = threadIdx.x / CG;
  const int c = blockIdx.x * CG + lane;
  const bool live = c < width;
  const size_t row = blockIdx.y;
  const size_t w = static_cast<size_t>(width);
  const float* ar = a + row * static_cast<size_t>(n_t) * w + c;
  const float* br = b + row * static_cast<size_t>(n_t) * w + c;
  float* hr = h + row * static_cast<size_t>(n_t) * w + c;
  const int tile = n_seg * kSegLen;
  const float start = (seg == 0 && live && h0 != nullptr)
                          ? h0[row * w + c] : 0.0f;
  for (int t0 = 0; t0 < n_t; t0 += tile) {
    const int ts = t0 + seg * kSegLen;
    float av[kSegLen];
    float bv[kSegLen];
#pragma unroll
    for (int q = 0; q < kSegLen; ++q) {
      const bool in = live && ts + q < n_t;
      const size_t o = static_cast<size_t>(ts + q) * w;
      av[q] = in ? ar[o] : 1.0f;
      bv[q] = in ? br[o] : 0.0f;
    }
    // 1. the segment's pair (A, B)
    float pa = 1.0f;
    float pb = 0.0f;
#pragma unroll
    for (int q = 0; q < kSegLen; ++q) {
      pa = __fmul_rn(pa, av[q]);
      pb = __fadd_rn(__fmul_rn(av[q], pb), bv[q]);
    }
    s_a[threadIdx.x] = pa;
    s_b[threadIdx.x] = pb;
    __syncthreads();
    // 2. the carry across the tile's segments, in order
    if (seg == 0) {
      float x = (t0 == 0) ? start : s_carry[lane];
      for (int k = 0; k < n_seg; ++k) {
        s_in[k * CG + lane] = x;
        x = __fadd_rn(__fmul_rn(s_a[k * CG + lane], x), s_b[k * CG + lane]);
      }
    }
    __syncthreads();
    // 3. the segment again from its carry-in, every h stored
    float x = s_in[threadIdx.x];
#pragma unroll
    for (int q = 0; q < kSegLen; ++q) {
      x = __fadd_rn(__fmul_rn(av[q], x), bv[q]);
      if (live && ts + q < n_t) hr[static_cast<size_t>(ts + q) * w] = x;
    }
    // a tile with a successor is full: its last segment ends on its last h
    if (seg == n_seg - 1 && t0 + tile < n_t) s_carry[lane] = x;
    if (live && ts < n_t && n_t <= ts + kSegLen) h_last[row * w + c] = x;
  }
}

}  // namespace

extern "C" {

// a, b, h: (n_rows, n_t, width) row-major float32; h0 (may be null for a
// zero start) and h_last: (n_rows, width).  regime 0 is step, 1 split
// with channel_group (16 or 32) channels and n_seg (1..16) segments a
// block.  Launches on `stream` and returns cudaGetLastError().
int rglru_launch(const void* a, const void* b, const void* h0, void* h,
                 void* h_last, int n_rows, int n_t, int width, int regime,
                 int channel_group, int n_seg, void* stream) {
  if (n_rows <= 0 || n_t <= 0 || width <= 0 || n_rows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pa = static_cast<const float*>(a);
  const float* pb = static_cast<const float*>(b);
  const float* ph0 = static_cast<const float*>(h0);
  float* ph = static_cast<float*>(h);
  float* pl = static_cast<float*>(h_last);
  if (regime == 0) {
    const dim3 grid((width + kThreads - 1) / kThreads, n_rows);
    rglru_kernel_step<<<grid, kThreads, 0, st>>>(pa, pb, ph0, ph, pl, n_t,
                                                 width);
  } else if (regime == 1 && n_seg >= 1 && n_seg <= kMaxSegs
             && (channel_group == 16 || channel_group == 32)) {
    const dim3 grid((width + channel_group - 1) / channel_group, n_rows);
    const int threads = channel_group * n_seg;
    if (channel_group == 32) {
      rglru_kernel_split<32><<<grid, threads, 0, st>>>(pa, pb, ph0, ph, pl,
                                                       n_t, width, n_seg);
    } else {
      rglru_kernel_split<16><<<grid, threads, 0, st>>>(pa, pb, ph0, ph, pl,
                                                       n_t, width, n_seg);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* rglru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
