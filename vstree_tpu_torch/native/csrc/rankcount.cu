// K1: exact complete-match rank interval of a packed query batch.
//
// Replaces the Pallas TPU kernel vstree_tpu/native/rankcount.py::
// bucket_rank_lookup (kernel body _kernel) together with the XLA code in
// front of it (vstree_tpu/engine/complete.py::_device_rank_lookup).  The
// TPU cannot gather inside a kernel, so there every suffix rank gets two
// pre-packed base-(sigma+1) key words on the host, XLA gathers each
// query's bucket bracket and packs its keys, and the kernel counts the
// keys of an aligned window.  A Hopper thread gathers for itself, so this
// kernel takes what the index already holds and no per-rank table exists:
//
//   flat8  int8 [(ppl + 2*cpw + 1) * B], char-major: row j holds char j of
//          every query (-1 padding, >= sigma a wildcard), the last row the
//          query lengths
//   bck    int2 [sigma^ppl + 1], the bracket (left, width) of every
//          bucket code of the first ppl chars, plus a zero-width entry
//          at code sigma^ppl
//   suf    int32 [n+1], text uint8 [n]
//   out    int32 [2*B + 1]: lo [B], hi [B], one error word
//
// One thread per query.  It forms its bucket code and validity flag,
// reads its bracket with one aligned 8-byte load, packs its low/high
// two-word keys in registers (inactive digits 0 in the low key, sigma in
// the high key), and finds
//   lo = first rank of the bracket whose key is >= the low key,
//   hi = first rank from lo on whose key is >  the high key
// by binary search (hi after two single steps from lo, which settle a
// query that occurs at most once): keys are monotone over the ranks of a
// bucket.  The
// key of a probed rank r is made on the spot from text[suf[r] + ppl + j],
// j < 2*cpw: a regular char c as digit c, and from the first special char
// or the text end onwards every digit sigma, packed by the same Horner
// rule; the second word is read only when the first one ties.
//
// What bounds it on this card: memory latency.  A probe is two
// dependent loads, a 32-byte sector of suf at a random place of a table
// larger than L2, then one or two sectors of the text, which at genome
// scale (tens of MB) stays in the 50 MB L2 between launches.  A bracket
// of w ranks costs about log2(w) + 2 probes; their bytes (~100 of
// sectors a probe) and integer work (13 or 26 multiply-adds) would take
// the card a few microseconds, the chain of dependent loads takes
// longer.  The brackets are as wide as the index makes them: a genome's
// poly(dA:dT) tracts give the all-a bucket of depth 10 some 13,000
// ranks, whose queries take ~14 probes for ~5 of a typical bracket, and
// a warp waits for its widest bracket.  Design: the char-major layout
// makes every read of flat8 coalesced over a warp; 10^5 queries are one
// wave of 132 SMs x 2048 threads, so the dependent chains of all
// queries overlap; the text
// bytes of one key word come as 4 aligned 32-bit loads started side by
// side (kCpw is a template constant for the two stock alphabets), not as
// 13 byte loads one behind the other: the lanes of a warp probe 32
// different cache lines, so every load instruction costs 32 line
// lookups, and fewer instructions is what counts.  TMA and wgmma have
// no use here: there are no tiles to copy and no matrix product, only
// dependent gathers of a few bytes.  The TPU kernel's windows (rowspan), its
// VMEM-resident tables and its 16-bit pair sums do not carry over, nor
// its 31-bit packing of a bracket into one int32: both bounded the
// widest bucket the TPU plan takes, and this kernel reads (left, width)
// unpacked, so any index whose queries fit the coverage is taken.
//
// The checks that depend on the data are made here: a bracket that
// lies outside the ranks [0, n+1] or a query longer than the coverage
// sets a bit of the error word, and the thread then probes nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kErrBracket = 1;
constexpr int kErrLength = 2;

struct Params {
  int nqueries, n, ppl, cpw, sigma, numcodes;
};

// One key word of the suffix at text position p, byte by byte: cpw
// digits from p on.  ``sat`` carries the saturation from the first word
// into the second.  The path of alphabets without a template constant
// and of the probes that touch the last bytes of the text.
__device__ __forceinline__ int key_word_bytes(
    const uint8_t* __restrict__ text, int p, int n, int cpw, int sigma,
    bool& sat) {
  const int base = sigma + 1;
  int key = 0;
  for (int j = 0; j < cpw; ++j) {
    const int c = (p + j < n) ? static_cast<int>(__ldg(text + p + j)) : 255;
    sat |= c >= sigma;
    key = key * base + (sat ? sigma : c);
  }
  return key;
}

// The key word of stream bytes [kFirst, kFirst + kCpw) out of aligned
// 32-bit words w[] that hold the stream from byte sh/8 of w[0] on.
template <int kCpw, int kFirst, int kWords>
__device__ __forceinline__ int key_word_packed(const uint32_t (&w)[kWords],
                                               int sh, int sigma,
                                               bool& sat) {
  const int base = sigma + 1;
  int key = 0;
#pragma unroll
  for (int j = kFirst; j < kFirst + kCpw; ++j) {
    const uint32_t r = __funnelshift_r(w[j >> 2], w[(j >> 2) + 1], sh);
    const int c = static_cast<int>((r >> (8 * (j & 3))) & 0xffu);
    sat |= c >= sigma;
    key = key * base + (sat ? sigma : c);
  }
  return key;
}

// Sign of (key of rank r) - (q1, q2).  The text is 4-byte aligned (the
// wrapper checks), so with a template constant the 2*kCpw bytes behind
// p come as aligned 32-bit words, realigned by a funnel shift: 4 loads
// for the first word of a DNA key and 4 more on a tie, instead of 13
// and 13 byte loads that each cost a warp 32 cache-line lookups.
template <int kCpw>
__device__ __forceinline__ int compare_rank(const int* __restrict__ suf,
                                            const uint8_t* __restrict__ text,
                                            int r, const Params& a, int q1,
                                            int q2) {
  const int p = __ldg(suf + r) + a.ppl;  // n < 2^30: no overflow
  bool sat = false;
  if constexpr (kCpw > 0) {
    constexpr int kW1 = (kCpw + 6) / 4;      // words under key word 1
    constexpr int kWT = (2 * kCpw + 6) / 4;  // ... under both
    const int p4 = p & ~3;
    if (p4 + 4 * kWT <= a.n) {  // every word read lies inside the text
      const uint32_t* wp = reinterpret_cast<const uint32_t*>(text + p4);
      const int sh = 8 * (p & 3);
      uint32_t w[kWT + 1];
#pragma unroll
      for (int i = 0; i < kW1; ++i) w[i] = __ldg(wp + i);
#pragma unroll
      for (int i = kW1; i <= kWT; ++i) w[i] = 0;
      const int w1 = key_word_packed<kCpw, 0>(w, sh, a.sigma, sat);
      if (w1 != q1) return w1 < q1 ? -1 : 1;
#pragma unroll
      for (int i = kW1; i < kWT; ++i) w[i] = __ldg(wp + i);
      const int w2 = key_word_packed<kCpw, kCpw>(w, sh, a.sigma, sat);
      return w2 < q2 ? -1 : (w2 > q2 ? 1 : 0);
    }
  }
  const int cw = kCpw ? kCpw : a.cpw;
  const int w1 = key_word_bytes(text, p, a.n, cw, a.sigma, sat);
  if (w1 != q1) return w1 < q1 ? -1 : 1;
  const int w2 = key_word_bytes(text, p + cw, a.n, cw, a.sigma, sat);
  return w2 < q2 ? -1 : (w2 > q2 ? 1 : 0);
}

template <int kCpw>
__global__ void __launch_bounds__(kThreads)
rankcount_kernel(const int8_t* __restrict__ flat8,
                 const int2* __restrict__ bck, const int* __restrict__ suf,
                 const uint8_t* __restrict__ text, int* __restrict__ out,
                 const Params a) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= a.nqueries) return;
  const int B = a.nqueries;
  const int cw = kCpw ? kCpw : a.cpw;
  const int cov = a.ppl + 2 * cw;
  const int8_t* col = flat8 + q;  // row j of this query: col[j * B]
  const int plen = __ldg(col + static_cast<size_t>(cov) * B);
  int err = plen > cov ? kErrLength : 0;

  // bucket code of the first ppl chars; int8 widens with its sign
  int code = 0;
  bool valid = true;
  for (int j = 0; j < a.ppl; ++j) {
    const int c = __ldg(col + static_cast<size_t>(j) * B);
    valid &= (c >= 0) & (c < a.sigma);
    code = code * a.sigma + min(max(c, 0), a.sigma - 1);
  }
  // low/high keys of the chars behind them
  const int base = a.sigma + 1;
  int q1l = 0, q2l = 0, q1h = 0, q2h = 0;
  for (int j = 0; j < 2 * cw; ++j) {
    const int c = __ldg(col + static_cast<size_t>(a.ppl + j) * B);
    const bool act = a.ppl + j < plen;
    valid &= !(act & ((c < 0) | (c >= a.sigma)));
    const int cc = min(max(c, 0), a.sigma - 1);
    const int dl = act ? cc : 0;
    const int dh = act ? cc : a.sigma;
    if (j < cw) {
      q1l = q1l * base + dl;
      q1h = q1h * base + dh;
    } else {
      q2l = q2l * base + dl;
      q2h = q2h * base + dh;
    }
  }
  // invalid queries (wildcards, padding) take the zero-width sentinel
  const int2 br = __ldg(bck + (valid ? code : a.numcodes));
  const int left = br.x, width = br.y;
  int lo = left, hi = left;
  if (left < 0 || width < 0
      || static_cast<long long>(left) + width > a.n + 1LL) {
    err |= kErrBracket;
  } else if (err == 0) {
    const int end = left + width;
    int top = end, end_hi = end;
    while (lo < top) {  // first rank with key >= low key
      const int mid = (lo + top) >> 1;
      if (compare_rank<kCpw>(suf, text, mid, a, q1l, q2l) < 0)
        lo = mid + 1;
      else
        top = mid;
    }
    // Ranks below lo are below the low key, so not above the high one:
    // hi lies in [lo, end].  Most queries occur once or not at all, so
    // two single steps settle them; a search takes the rest.
    hi = lo;
    for (int k = 0; k < 2 && hi < end; ++k) {
      if (compare_rank<kCpw>(suf, text, hi, a, q1h, q2h) > 0) {
        end_hi = hi;
        break;
      }
      ++hi;
    }
    top = end_hi;
    while (hi < top) {  // first rank with key > high key
      const int mid = (hi + top) >> 1;
      if (compare_rank<kCpw>(suf, text, mid, a, q1h, q2h) <= 0)
        hi = mid + 1;
      else
        top = mid;
    }
  }
  out[q] = lo;
  out[B + q] = hi;
  if (err) atomicOr(out + 2 * static_cast<size_t>(B), err);
}

}  // namespace

// Clears the error word and launches on ``stream``; returns the
// cudaError_t of the launch (0 when it was accepted).  The caller has
// checked types, shapes, scalars and the 8-byte alignment of ``bck``
// (int32 pairs).
extern "C" int vstree_rankcount(const int8_t* flat8, const int* bck,
                                const int* suf, const uint8_t* text,
                                int* out, int nqueries, int n, int ppl,
                                int cpw, int sigma, int numcodes,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(out + 2 * static_cast<size_t>(nqueries), 0,
                                  sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (nqueries <= 0) return 0;
  const Params a{nqueries, n, ppl, cpw, sigma, numcodes};
  const int2* br = reinterpret_cast<const int2*>(bck);
  const int blocks = (nqueries + kThreads - 1) / kThreads;
  if (cpw == 13)  // DNA: sigma 4
    rankcount_kernel<13><<<blocks, kThreads, 0, s>>>(flat8, br, suf, text,
                                                     out, a);
  else if (cpw == 7)  // protein: sigma 20
    rankcount_kernel<7><<<blocks, kThreads, 0, s>>>(flat8, br, suf, text,
                                                    out, a);
  else
    rankcount_kernel<0><<<blocks, kThreads, 0, s>>>(flat8, br, suf, text,
                                                    out, a);
  return static_cast<int>(cudaGetLastError());
}
