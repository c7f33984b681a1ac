// K2: Myers bit-vector edit-distance verification, patterns of <= 32 chars.
//
// Replaces the Pallas TPU kernel vstree_tpu/native/myers.py::
// myers_verify32 (kernel body _kern) together with the gather its
// wrapper verify_edit_pallas runs in front of it.  For candidate i,
// pattern q = qidx[i] (plens[q] chars, Eq masks eqs0[q*256 + c]) is
// matched against the text columns cand[i], cand[i]+1, ... for at most L
// columns with the single-word Myers (1999) update; a column past the
// text end reads as SEPARATOR.  Outputs, over the columns before the
// first SEPARATOR: minsc, the least score of any window length (the
// esaapm existence test); bestlen/bestsc, the longest length whose score
// is <= the best stored so far (the longest-match rule of
// longestmatch.c:6-11).  With no column before a SEPARATOR they are
// (plen, 0, plen).
//
// The checks that depend on the values are the kernel's: a candidate
// below 0, a query number outside [0, nqueries) or a pattern length
// outside 1..32 sets a bit of the error word out[3 * ncand], and the
// thread then reads nothing and writes zeros.  The wrapper reads the one
// word instead of reducing three arrays in front of the launch.
//
// What bounds it on this card: integer operations.  A column costs about
// 25 32-bit integer instructions in a chain that depends on the column
// before, against one text byte and one 4-byte Eq word, and a candidate
// moves 8 bytes in and 12 out.  The Eq rows of a query (1 KB) and the
// text bytes of neighbouring candidates (the caller sorts candidates by
// query and position) are served by L1/L2.
// Design: one thread per candidate, the whole state (Pv, Mv, score and
// the three outputs) in registers, unsigned 32-bit arithmetic (the add
// wraps, >> is logical).  The thread gathers its own text bytes and Eq
// words, so the TPU wrapper's pre-gathered [L, P] Eq and separator
// matrices, its padding of P to a multiple of 1024 and its transposes do
// not carry over.  No output can change after the first SEPARATOR, so
// the loop ends there.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr unsigned kSeparator = 255;
constexpr int kErrCandidate = 1;  // a candidate position below 0
constexpr int kErrQuery = 2;      // a query number outside [0, nqueries)
constexpr int kErrLength = 4;     // a pattern length outside 1..32

__global__ void __launch_bounds__(kThreads)
myers_kernel(const uint8_t* __restrict__ text, const int* __restrict__ cand,
             const int* __restrict__ qidx, const uint32_t* __restrict__ eqs0,
             const int* __restrict__ plens, int* __restrict__ out,
             long long ncand, int nqueries, int ncols, long long n) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= ncand) return;
  int* __restrict__ minsc_out = out;
  int* __restrict__ bestlen_out = out + ncand;
  int* __restrict__ bestsc_out = out + 2 * ncand;
  const int q = __ldg(qidx + i);
  const long long start = __ldg(cand + i);
  int err = start < 0 ? kErrCandidate : 0;
  int plen = 0;
  if (q < 0 || q >= nqueries) {
    err |= kErrQuery;
  } else {
    plen = __ldg(plens + q);
    if (plen < 1 || plen > 32) err |= kErrLength;
  }
  if (err) {
    atomicOr(out + 3 * ncand, err);
    minsc_out[i] = bestlen_out[i] = bestsc_out[i] = 0;
    return;
  }
  const uint32_t* __restrict__ eq = eqs0 + static_cast<size_t>(q) * 256;
  const unsigned top = static_cast<unsigned>(plen - 1);
  uint32_t Pv = 0xffffffffu, Mv = 0u;
  int score = plen, minsc = plen, bestlen = 0, bestsc = plen;
  for (int l = 0; l < ncols; ++l) {
    const long long p = start + l;
    const unsigned ch = p < n ? __ldg(text + p) : kSeparator;
    if (ch == kSeparator) break;
    const uint32_t Eq = __ldg(eq + ch);
    const uint32_t Xh = (((Eq & Pv) + Pv) ^ Pv) | Eq;
    const uint32_t Xv = Eq | Mv;
    const uint32_t Ph = Mv | ~(Xh | Pv);
    const uint32_t Mh = Pv & Xh;
    score += static_cast<int>((Ph >> top) & 1u);
    score -= static_cast<int>((Mh >> top) & 1u);
    const uint32_t Phs = (Ph << 1) | 1u;
    const uint32_t Mhs = Mh << 1;
    Pv = Mhs | ~(Xv | Phs);
    Mv = Phs & Xv;
    minsc = min(minsc, score);
    if (bestsc >= score) {
      bestlen = l + 1;
      bestsc = score;
    }
  }
  minsc_out[i] = minsc;
  bestlen_out[i] = bestlen;
  bestsc_out[i] = bestsc;
}

}  // namespace

// Clears the error word and launches on ``stream`` into ``out``, int32
// [3 * ncand + 1]: minsc, bestlen, bestsc, the error word.  Returns the
// cudaError_t of the launch (0 when it was accepted).  The caller has
// checked shapes and types.
extern "C" int vstree_myers(const uint8_t* text, const int* cand,
                            const int* qidx, const uint32_t* eqs0,
                            const int* plens, int* out, long long ncand,
                            int nqueries, int ncols, long long n,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(out + 3 * ncand, 0, sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (ncand <= 0) return 0;
  const long long blocks = (ncand + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  myers_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      text, cand, qidx, eqs0, plens, out, ncand, nqueries, ncols, n);
  return static_cast<int>(cudaGetLastError());
}
