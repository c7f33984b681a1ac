// K1: exact complete-match rank interval by windowed rank count.
//
// Replaces the Pallas TPU kernel vstree_tpu/native/rankcount.py::
// bucket_rank_lookup (kernel body _kernel).  For query i the caller has
// gathered its bucket bracket [left, left + width) and packed low/high
// two-word keys (q1l, q2l) / (q1h, q2h); t1/t2 hold the two packed key
// words of every suffix rank (row-major (ROWS, 128) tables, read here as
// flat arrays).  The kernel counts the ranks of the window whose key is
// below the low key (-> lo) and at or below the high key (-> hi):
// [lo, hi) is the whole-pattern rank interval.
//
// What bounds it on this card: memory.  Each query reads 24 bytes of
// bracket and keys and about 8 * width bytes of t1/t2 (width is a few
// dozen ranks for a genome-sized index at bucket depth 10), at random
// places of tables far larger than L2, and does two compares per rank.
// Design: one warp per query.  Its lanes stride over the window, so the
// loads of a warp are consecutive addresses (one or two 128-byte
// segments per table and step); the two counts come from
// __popc(__ballot_sync(...)), with no shared memory and no atomics.  The
// TPU kernel's TILE/UNROLL query loop, its VMEM-resident tables and the
// 16-bit packing of both counts into one sum do not carry over.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
rankcount_kernel(const int* __restrict__ left,
                 const int* __restrict__ width,
                 const int* __restrict__ q1l, const int* __restrict__ q2l,
                 const int* __restrict__ q1h, const int* __restrict__ q2h,
                 const int* __restrict__ t1, const int* __restrict__ t2,
                 int* __restrict__ lo, int* __restrict__ hi, int nqueries) {
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= nqueries) return;  // uniform over the warp
  const int l = __ldg(left + q);
  const int w = __ldg(width + q);
  const int a1 = __ldg(q1l + q), a2 = __ldg(q2l + q);
  const int b1 = __ldg(q1h + q), b2 = __ldg(q2h + q);
  int nless = 0, nleq = 0;
  for (int base = 0; base < w; base += 32) {  // w is uniform: no divergence
    const int j = base + lane;
    bool less = false, leq = false;
    if (j < w) {
      const int w1 = __ldg(t1 + l + j);
      const int w2 = __ldg(t2 + l + j);
      less = (w1 < a1) | ((w1 == a1) & (w2 < a2));
      leq = (w1 < b1) | ((w1 == b1) & (w2 <= b2));
    }
    nless += __popc(__ballot_sync(0xffffffffu, less));
    nleq += __popc(__ballot_sync(0xffffffffu, leq));
  }
  if (lane == 0) {
    lo[q] = l + nless;
    hi[q] = l + nleq;
  }
}

}  // namespace

// Launches on ``stream``; returns the cudaError_t of the launch (0 when
// it was accepted).  The caller has checked shapes and bounds.
extern "C" int vstree_rankcount(const int* left, const int* width,
                                const int* q1l, const int* q2l,
                                const int* q1h, const int* q2h,
                                const int* t1, const int* t2, int* lo,
                                int* hi, int nqueries, void* stream) {
  if (nqueries <= 0) return 0;
  const int blocks = (nqueries + kWarpsPerBlock - 1) / kWarpsPerBlock;
  rankcount_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      left, width, q1l, q2l, q1h, q2h, t1, t2, lo, hi, nqueries);
  return static_cast<int>(cudaGetLastError());
}
