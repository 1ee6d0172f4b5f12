// The sha256d kernels for Hopper (sm_90a), hand-written CUDA C++: the
// nonce search (B1) and share validation (B2), one library.
//
// search_kernel replaces the Pallas TPU kernel
// otedama_tpu/kernels/sha256_pallas.py `_search_kernel` (reached through
// `sha256d_pallas_search`): for every nonce of a launch window it hashes
// header(midstate, tail, nonce) twice, decides winners EXACTLY against the
// 256-bit target, and returns one fixed uint32[2k+3] buffer:
//   [win_nonce[k] | win_limb[k] | n_winners, 0, min_top_limb]
// with winners in ascending launch-offset order (when n <= k), the true
// in-range winner count (n > k is the caller's overflow signal), and the
// min top compare limb over in-range lanes. Unused slots hold 0 in the
// nonce half and 0xFFFFFFFF in the limb half.
//
// What bounds the search: integer operations, and on this card the ALU
// pipe among them. Per nonce it runs ~120 SHA-256 rounds on 32-bit words
// and moves no memory (the job in as kernel parameters, 2k+3 words out
// per launch). A round's logic — Sigma0, Sigma1 (three funnel-shift
// rotates and a LOP3 each), ch and maj (a LOP3 each) — can only issue on
// the SM's 64-lane ALU pipe; its adds can go to the 64-lane FMA pipe as
// IMAD. Left to ptxas, ~88% of the loop sits on the ALU pipe and the FMA
// pipe idles. The design:
//   - the job's own work is hoisted by hand: sha256_cuda.search_params
//     computes, once a launch on the host, rounds 0..2 of the first
//     compression, round 3 but for its two adds of the nonce, K + W of
//     the constant words W4..W17 and the job-only terms of W18..W33; they
//     ride in the constant bank with the 22 job words as a by-value
//     parameter (no host-to-device copy), so the loop starts at the first
//     operation that depends on the nonce;
//   - every add of the loop is written a * one + b, with one = 1 a launch
//     parameter (ptxas folds a literal 1), and the schedule's right shifts
//     as __umulhi by 2^29 and 2^22: IMAD and IMAD.HI on the FMA pipe, so
//     the ALU pipe keeps only the logic (~63% of the loop); rounds 0..3
//     of the second compression keep plain adds, so the IV's literal
//     words fold;
//   - the second compression stops at digest word 7 (rounds 61..63 and
//     the dead a-chain of rounds 57..60 vanish), which is all the filter
//     `bswap(d7) <= T0` needs — no false negatives, since a lexicographic
//     H <= T forces H0 <= T0;
//   - a filter hit (rare at real difficulty) escalates to a non-inlined
//     full-digest 256-bit compare, kept out of the hot loop's registers;
//   - the min top limb is a per-thread running min, reduced per warp with
//     __reduce_min_sync and per block in shared memory, then one atomicMin
//     per block;
//   - winners take slots with atomicAdd on the count (arbitrary order);
//     a one-thread finalize launch sorts the <= k slots by offset.
// Grid: one wave of persistent blocks (occupancy-sized), each thread
// walking nonces a grid's width apart with a 32-bit counter — a window
// holds up to 2^32 nonces, so only each thread's count is computed in 64
// bits, once. Each step of the loop ends with __syncwarp(): without it a
// warp whose lane escalated stayed split for the rest of the launch, and
// a launch with a winner ran up to twice as long.
//
// verify_kernel replaces `_verify_kernel` (reached through
// `sha256d_verify_pallas`): N distinct 80-byte headers, each hashed twice
// and compared EXACTLY against its OWN share target; the rare FAILURES are
// compacted into the same buffer, run in reverse: failing lane offsets in
// the nonce slots (base 0), the true failure count, and the min top limb
// over every in-range lane, passing or failing.
//
// What bounds the verify: per share, three whole SHA-256 compressions
// (header block 1, header block 2, the 32-byte digest) — about 4,000 int32
// operations after the constant words fold (sha256_cuda.verify_ops_per_share)
// — against 112 bytes of input (20 header words, 8 target limbs), so the
// operations bound it: ~0.13 ms at 2^20 shares, and the ALU pipe among
// them, as in the search. At the pool ledger's batches (128 to 4,096
// shares) one launch is a few microseconds of work: there one lane's
// chain of dependent rounds and the launch itself set the time, and the
// host's enqueue of the call must stay under them. The design:
//   - ONE launch a call, reading the caller's row-major [lanes, 20] words
//     and [lanes, 8] limbs in place (no transposes): each thread loads its
//     own share's row as five and two 16-byte words (rows are 80 and 32
//     bytes, 16-byte aligned). Staging a block's contiguous span in shared
//     memory first, by a Hopper bulk copy (cp.async.bulk on an mbarrier)
//     or by coalesced 16-byte loads, bought nothing: 112 bytes a share
//     against ~4,000 operations, and in turns on the H100 either staging
//     ran 1.5-2% slower at 2^20 shares than these loads (PERF.md);
//   - one thread per share; every share is a different header, so no
//     midstate can be hoisted as the search hoists it. The constant words
//     of the second and third blocks (padding, the 640- and 256-bit
//     lengths) and the IV are literals, so they fold; rounds 0..3 from the
//     IV keep plain adds so the IV folds with them, and every other add is
//     a * one + b and the schedule's right shifts __umulhi by 2^29 and
//     2^22, with one and the multipliers launch parameters (ptxas folds
//     literals), so they issue on the FMA pipe as IMAD and IMAD.HI and the
//     ALU pipe keeps the rotates and the logic, as in the search;
//   - blocks of 128 threads while the batch gives each SM at most one
//     block, 256 above. Under one wave a call's time is one lane's chain
//     (~4,900 straight-line instructions that each SM fetches for
//     itself) plus the launch, and one warp for each scheduler of an SM
//     measured fastest there (PERF.md); at 2^20 shares 256 runs 8.6%
//     faster than 128 and 9% faster than 32;
//   - failures take slots with atomicAdd on a count, straight in the
//     output (arbitrary order); the min top limb is reduced per warp and
//     per block and leaves each block as one atomicMax of its complement.
//     Both accumulators and a ticket of finished blocks sit in a 3-word
//     workspace that is all zero between launches. Each block fences its
//     writes and takes a ticket; the last block sorts the <= k slots by
//     offset, writes every other word of the 2k+3 (unused slots, count,
//     0, min), and zeroes the workspace for the next launch. A launch that
//     fails leaves the workspace as it was; the wrapper zeroes it again.
// For n <= k the buffer equals the TPU kernel's word for word; for n > k
// only the count and the min are defined. Only the `lanes` in-range shares
// are read: rows past count-1 never count, as in the reference.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "sha256_device.cuh"

namespace {

constexpr int kJobWords = 22;
constexpr int kHoistedWords = 43;  // sizeof(Hoisted) / 4
constexpr int kThreads = 256;        // init, and verify at most
constexpr int kSearchThreads = 256;  // search: one nonce a thread a step

struct JobParams {
  // [0:8] midstate, [8:11] header words 16..18, [11] nonce base,
  // [12:20] target limbs most-significant-first, [20] last in-range
  // launch offset (count-1), [21] empty flag
  uint32_t w[kJobWords];
};

constexpr uint32_t kIV7 = 0x5BE0CD19u;

// What a search launch computes once from its job words (sha256_cuda.
// search_params, on the host), after the 22 job words themselves: the
// first compression up to its first nonce-dependent operation, and the
// job-only terms of the later schedule words.
struct Hoisted {
  uint32_t s3[8];   // state (a..h) after rounds 0..2 from the midstate
  uint32_t a4, e4;  // a and e after round 3, less the nonce (W3)
  uint32_t kw[14];  // K[i] + W[i] for i = 4..17 (W4..W15 padding, W16, W17)
  uint32_t wc[16];  // W[i] for i = 18..33: the sum of its job-only terms
  uint32_t one;     // 1: a * one + b is an IMAD (ptxas folds a literal 1)
  uint32_t m29;     // 2^29: __umulhi(x, m29) = x >> 3, on the FMA pipe
  uint32_t m22;     // 2^22: __umulhi(x, m22) = x >> 10
};

struct SearchParams {
  JobParams job;
  Hoisted h;
};

// The search's adds and the schedule's right shifts go to the FMA pipe as
// IMAD and IMAD.HI; the rotates and the logic (SHF, LOP3) can only issue on
// the ALU pipe, which they fill alone. fshr(x, 2^n) is x >> (32 - n).
__device__ __forceinline__ uint32_t fadd(uint32_t a, uint32_t one, uint32_t b) {
  return a * one + b;
}
__device__ __forceinline__ uint32_t fshr(uint32_t x, uint32_t m) {
  return __umulhi(x, m);
}

// One round from round 4 on, every add as fadd; u = h + K[i] + W[i].
__device__ __forceinline__ void round_f(uint32_t s[8], uint32_t u,
                                        uint32_t one) {
  const uint32_t t1 = fadd(big_sigma1(s[4]), one,
                           fadd(ch(s[4], s[5], s[6]), one, u));
  const uint32_t a =
      fadd(big_sigma0(s[0]), one, fadd(maj(s[0], s[1], s[2]), one, t1));
  s[7] = s[6];
  s[6] = s[5];
  s[5] = s[4];
  s[4] = fadd(s[3], one, t1);
  s[3] = s[2];
  s[2] = s[1];
  s[1] = s[0];
  s[0] = a;
}

// Adds x into a running sum that may be empty (`have`, known at compile
// time after unrolling), so no add of a zero is issued.
__device__ __forceinline__ void accumulate(uint32_t& acc, bool& have,
                                           uint32_t x, uint32_t one) {
  acc = have ? fadd(x, one, acc) : x;
  have = true;
}

// Which schedule words vary with the nonce: in the first compression W3
// (the nonce) and W18 on; in the second the digest words W0..W7 and W16 on.
__device__ __forceinline__ bool first_varies(int i) { return i == 3 || i >= 18; }
__device__ __forceinline__ bool second_varies(int i) { return i < 8 || i >= 16; }

// The second compression's constant words: padding and the 256-bit length.
__device__ __forceinline__ uint32_t second_literal(int i) {
  return i == 8 ? 0x80000000u : i == 15 ? 256u : 0u;
}

__device__ __forceinline__ uint32_t s0f(uint32_t x, const Hoisted& h) {
  return rotr(x, 7) ^ rotr(x, 18) ^ fshr(x, h.m29);
}
__device__ __forceinline__ uint32_t s1f(uint32_t x, const Hoisted& h) {
  return rotr(x, 17) ^ rotr(x, 19) ^ fshr(x, h.m22);
}

// Digest word 7 of sha256d(header) for nonce n, from the hoisted state:
// the first compression runs from round 3's two nonce adds, the second
// rounds 0..60 (word 7 = IV[7] + h after round 63 = IV[7] + the e of
// round 60); what only feeds words 0..6 is dead code the compiler drops.
__device__ __forceinline__ uint32_t sha256d_word7(const SearchParams& p,
                                                  uint32_t n) {
  const Hoisted& h = p.h;
  const uint32_t one = h.one;
  uint32_t s[8] = {h.a4 + n, h.s3[0], h.s3[1], h.s3[2],
                   h.e4 + n, h.s3[4], h.s3[5], h.s3[6]};
  uint32_t w[16];
  w[3] = n;
#pragma unroll
  for (int i = 4; i < 64; ++i) {
    if (i < 18) {
      round_f(s, fadd(s[7], one, h.kw[i - 4]), one);
      continue;
    }
    // W[i] = s1(W[i-2]) + W[i-7] + s0(W[i-15]) + W[i-16]: the terms that
    // vary, onto the hoisted sum of the rest
    uint32_t acc = 0;
    bool have = i <= 33;
    if (have) acc = h.wc[i - 18];
    if (first_varies(i - 16)) accumulate(acc, have, w[(i - 16) & 15], one);
    if (first_varies(i - 15)) accumulate(acc, have, s0f(w[(i - 15) & 15], h), one);
    if (first_varies(i - 7)) accumulate(acc, have, w[(i - 7) & 15], one);
    if (first_varies(i - 2)) accumulate(acc, have, s1f(w[(i - 2) & 15], h), one);
    w[i & 15] = acc;
    round_f(s, fadd(s[7], one, fadd(acc, one, kK[i])), one);
  }
  uint32_t d[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) d[i] = fadd(p.job.w[i], one, s[i]);

  uint32_t t[8] = SHA256_IV_INIT;
  uint32_t x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = i < 8 ? d[i] : second_literal(i);
#pragma unroll
  for (int i = 0; i < 61; ++i) {
    if (i >= 16) {
      // literal terms fold into one constant; each varying term is an fadd
      uint32_t lit = 0;
      if (!second_varies(i - 16)) lit += second_literal(i - 16);
      if (!second_varies(i - 15)) lit += small_sigma0(second_literal(i - 15));
      if (!second_varies(i - 7)) lit += second_literal(i - 7);
      if (!second_varies(i - 2)) lit += small_sigma1(second_literal(i - 2));
      uint32_t acc = lit;
      bool have = lit != 0;
      if (second_varies(i - 16)) accumulate(acc, have, x[(i - 16) & 15], one);
      if (second_varies(i - 15)) accumulate(acc, have, s0f(x[(i - 15) & 15], h), one);
      if (second_varies(i - 7)) accumulate(acc, have, x[(i - 7) & 15], one);
      if (second_varies(i - 2)) accumulate(acc, have, s1f(x[(i - 2) & 15], h), one);
      x[i & 15] = acc;
    }
    if (i < 4) {
      // the IV is literal: plain adds fold with it
      const uint32_t t1 = t[7] + big_sigma1(t[4]) + ch(t[4], t[5], t[6]) +
                          kK[i] + x[i & 15];
      const uint32_t t2 = big_sigma0(t[0]) + maj(t[0], t[1], t[2]);
      t[7] = t[6];
      t[6] = t[5];
      t[5] = t[4];
      t[4] = t[3] + t1;
      t[3] = t[2];
      t[2] = t[1];
      t[1] = t[0];
      t[0] = t1 + t2;
    } else {
      round_f(t, fadd(t[7], one, fadd(x[i & 15], one, kK[i])), one);
    }
  }
  return kIV7 + t[4];
}

// The rare path: full 8-word digest and the exact 256-bit compare, then a
// winner slot. Not inlined, so its registers stay out of the hot loop.
__device__ __noinline__ void escalate(const JobParams& p, uint32_t nonce,
                                      uint32_t h0, uint32_t* out, int k) {
  uint32_t w1[16] = {p.w[8], p.w[9], p.w[10], nonce, 0x80000000u, 0, 0, 0,
                     0,      0,      0,       0,     0,           0, 0, 640};
  uint32_t d[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) d[i] = p.w[i];
  sha256_compress(d, w1);
  uint32_t w[16] = {d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7],
                    0x80000000u, 0, 0, 0, 0, 0, 0, 256};
  uint32_t s[8] = SHA256_IV_INIT;
  sha256_compress(s, w);
  // compare limbs most-significant-first: limb j = bswap(digest[7 - j])
  uint32_t hl[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) hl[j] = bswap32(s[7 - j]);
  if (limbs_le(hl, &p.w[12])) take_slot(out, k, nonce, h0);
}

// Each thread walks nonces base + first, + stride, ... with a 32-bit
// counter: a window holds up to 2^32 nonces, so only the count of a
// thread's nonces needs 64 bits, once. The loop runs as many steps as the
// warp's first thread needs (the most of any lane), the lanes past their
// own count idle through the last one, and __syncwarp() ends each step:
// a lane that escalates would otherwise leave its warp split in two for
// the rest of the launch (independent thread scheduling does not
// reconverge after the call on its own), running every later step twice.
__global__ void __launch_bounds__(kSearchThreads)
    search_kernel(const SearchParams p, unsigned long long lanes,
                  uint32_t* out, int k) {
  const uint32_t t0 = p.job.w[12];
  const unsigned long long first =
      static_cast<unsigned long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const unsigned long long stride =
      static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  const auto steps = [&](unsigned long long from) {
    return from < lanes ? static_cast<uint32_t>((lanes - from - 1) / stride + 1)
                        : 0u;
  };
  const uint32_t mine = steps(first);
  const uint32_t warp_steps = steps(first & ~31ull);
  uint32_t nonce = p.job.w[11] + static_cast<uint32_t>(first);
  uint32_t best = kNoWinner;
  for (uint32_t i = 0; i < warp_steps;
       ++i, nonce += static_cast<uint32_t>(stride)) {
    const uint32_t h0 = bswap32(sha256d_word7(p, nonce));
    if (i < mine) {
      best = min(best, h0);
      if (h0 <= t0) escalate(p.job, nonce, h0, out, k);
    }
    __syncwarp();
  }
  // min top limb: every thread reaches here (no early exit)
  block_min_to<kSearchThreads>(best, &out[2 * k + 2]);
}

// What a verify launch takes besides its pointers: 1 and the two shift
// multipliers, as launch parameters so ptxas cannot fold them (see fadd).
struct Pipes {
  uint32_t one;  // 1
  uint32_t m29;  // 2^29: __umulhi(x, m29) = x >> 3
  uint32_t m22;  // 2^22: __umulhi(x, m22) = x >> 10
};

// The three blocks of a verify: the header's first 64 bytes (every word
// varies), its last 16 bytes with padding and the 640-bit length, and the
// 32-byte digest with padding and the 256-bit length.
enum Block { kHeader1, kHeader2, kDigest };

template <Block kB>
__device__ __forceinline__ bool word_varies(int i) {
  return i >= 16 || kB == kHeader1 || i < (kB == kHeader2 ? 4 : 8);
}

template <Block kB>
__device__ __forceinline__ uint32_t word_literal(int i) {
  if (kB == kHeader2) return i == 4 ? 0x80000000u : i == 15 ? 640u : 0u;
  if (kB == kDigest) return i == 8 ? 0x80000000u : i == 15 ? 256u : 0u;
  return 0u;
}

__device__ __forceinline__ uint32_t s0p(uint32_t x, const Pipes& p) {
  return rotr(x, 7) ^ rotr(x, 18) ^ fshr(x, p.m29);
}
__device__ __forceinline__ uint32_t s1p(uint32_t x, const Pipes& p) {
  return rotr(x, 17) ^ rotr(x, 19) ^ fshr(x, p.m22);
}

// One whole compression with feed-forward, s = compress(s, x), its adds
// and shifts on the FMA pipe; x holds the block's varying words (its
// literal words are never read from it) and is clobbered. From the IV
// (header block 1 and the digest block) the state's literal words fold
// into rounds 0..3, which keep plain adds; the literal words of x fold
// into K[i] + W[i].
template <Block kB>
__device__ __forceinline__ void compress_p(uint32_t s[8], uint32_t x[16],
                                           const Pipes& p) {
  constexpr bool kFromIV = kB != kHeader2;
  const uint32_t one = p.one;
  uint32_t t[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) t[i] = s[i];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    if (i >= 16) {
      // W[i] = W[i-16] + s0(W[i-15]) + W[i-7] + s1(W[i-2]): the literal
      // terms fold into one constant, each varying term is an fadd
      uint32_t lit = 0;
      if (!word_varies<kB>(i - 16)) lit += word_literal<kB>(i - 16);
      if (!word_varies<kB>(i - 15)) lit += small_sigma0(word_literal<kB>(i - 15));
      if (!word_varies<kB>(i - 7)) lit += word_literal<kB>(i - 7);
      if (!word_varies<kB>(i - 2)) lit += small_sigma1(word_literal<kB>(i - 2));
      uint32_t acc = lit;
      bool have = lit != 0;
      if (word_varies<kB>(i - 16)) accumulate(acc, have, x[(i - 16) & 15], one);
      if (word_varies<kB>(i - 15)) accumulate(acc, have, s0p(x[(i - 15) & 15], p), one);
      if (word_varies<kB>(i - 7)) accumulate(acc, have, x[(i - 7) & 15], one);
      if (word_varies<kB>(i - 2)) accumulate(acc, have, s1p(x[(i - 2) & 15], p), one);
      x[i & 15] = acc;
    }
    if (kFromIV && i < 4) {
      const uint32_t t1 = t[7] + big_sigma1(t[4]) + ch(t[4], t[5], t[6]) +
                          kK[i] + x[i & 15];
      const uint32_t t2 = big_sigma0(t[0]) + maj(t[0], t[1], t[2]);
      t[7] = t[6];
      t[6] = t[5];
      t[5] = t[4];
      t[4] = t[3] + t1;
      t[3] = t[2];
      t[2] = t[1];
      t[1] = t[0];
      t[0] = t1 + t2;
    } else if (i < 16 && !word_varies<kB>(i)) {
      round_f(t, fadd(t[7], one, kK[i] + word_literal<kB>(i)), one);
    } else {
      round_f(t, fadd(t[7], one, fadd(x[i & 15], one, kK[i])), one);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = kFromIV ? s[i] + t[i] : fadd(s[i], one, t[i]);
}

constexpr int kRowWords = 20;  // header words a share
constexpr int kRowLimbs = 8;   // target limbs a share

// ws, the verify workspace: [0] failures counted, [1] ~(min top limb),
// [2] blocks finished; all zero between launches.
template <int kT>
__global__ void __launch_bounds__(kT)
    verify_kernel(const uint4* __restrict__ words,
                  const uint4* __restrict__ limbs, uint32_t lanes,
                  uint32_t* out, uint32_t* ws, int k, const Pipes p) {
  __shared__ uint32_t warp_min[kT / 32];
  __shared__ bool last;
  const uint32_t first = blockIdx.x * kT;  // < lanes, or 0 when lanes == 0
  const uint32_t lane = first + threadIdx.x;
  uint32_t best = kNoWinner;
  if (threadIdx.x < lanes - first) {
    // the share's row: five and two 16-byte loads, each thread its own
    const uint4* r = words + static_cast<size_t>(lane) * (kRowWords / 4);
    uint32_t w[16];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = __ldg(&r[q]);
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
    uint32_t s[8] = SHA256_IV_INIT;
    compress_p<kHeader1>(s, w, p);
    const uint4 tail = __ldg(&r[4]);
    uint32_t w2[16] = {tail.x, tail.y, tail.z, tail.w};
    compress_p<kHeader2>(s, w2, p);
    uint32_t d[8] = SHA256_IV_INIT;
    uint32_t w3[16] = {s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7]};
    compress_p<kDigest>(d, w3, p);
    // compare limbs most-significant-first: limb j = bswap(digest[7 - j])
    const uint4* lr = limbs + static_cast<size_t>(lane) * (kRowLimbs / 4);
    const uint4 l0 = __ldg(&lr[0]), l1 = __ldg(&lr[1]);
    const uint32_t t[8] = {l0.x, l0.y, l0.z, l0.w, l1.x, l1.y, l1.z, l1.w};
    uint32_t h[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) h[j] = bswap32(d[7 - j]);
    best = h[0];
    if (!limbs_le(h, t)) {
      const uint32_t idx = atomicAdd(&ws[0], 1u);
      if (idx < static_cast<uint32_t>(k)) {
        out[idx] = lane;
        out[k + idx] = h[0];
      }
      __threadfence();  // the slot before this block's ticket
    }
  }
  // min top limb: warp, block, then one atomicMax of its complement
  best = __reduce_min_sync(0xFFFFFFFFu, best);
  if ((threadIdx.x & 31) == 0) warp_min[threadIdx.x >> 5] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t v = kNoWinner;
#pragma unroll
    for (int i = 0; i < kT / 32; ++i) v = min(v, warp_min[i]);
    if (v != kNoWinner) atomicMax(&ws[1], ~v);
    __threadfence();
    last = atomicAdd(&ws[2], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: every other block's slots and accumulators are visible
  __threadfence();
  const uint32_t n = __ldcg(&ws[0]);
  const int m = n < static_cast<uint32_t>(k) ? static_cast<int>(n) : k;
  if (threadIdx.x == 0) {
    // order the m filled slots by lane offset (insertion sort: a batch
    // rarely fails more than a few shares), as the reference compacts
    for (int i = 1; i < m; ++i) {
      const uint32_t wn = __ldcg(&out[i]);
      const uint32_t wl = __ldcg(&out[k + i]);
      int j = i - 1;
      for (uint32_t o; j >= 0 && (o = __ldcg(&out[j])) > wn; --j) {
        out[j + 1] = o;
        out[k + j + 1] = __ldcg(&out[k + j]);
      }
      out[j + 1] = wn;
      out[k + j + 1] = wl;
    }
  }
  for (int i = m + threadIdx.x; i < k; i += kT) {
    out[i] = 0;
    out[k + i] = kNoWinner;
  }
  __syncthreads();  // every thread has read n
  if (threadIdx.x == 0) {
    out[2 * k] = n;
    out[2 * k + 1] = 0;
    out[2 * k + 2] = ~__ldcg(&ws[1]);
    ws[0] = ws[1] = ws[2] = 0;
  }
}

// An empty kernel: its launch-to-completion time is the floor under any
// one-launch call (chip_smoke.py phase 17).
__global__ void empty_kernel() {}

int sm_count(int* err) {
  static int sms = 0;  // queried once per process (one device per process)
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) *err = static_cast<int>(e);
  }
  return sms;
}

template <int kT>
void launch_verify(const uint32_t* words, const uint32_t* limbs,
                   unsigned long long lanes, int k, uint32_t* out,
                   uint32_t* ws, cudaStream_t s) {
  const unsigned int blocks =
      lanes ? static_cast<unsigned int>((lanes + kT - 1) / kT) : 1u;
  const Pipes p{1u, 1u << 29, 1u << 22};
  verify_kernel<kT><<<blocks, kT, 0, s>>>(
      reinterpret_cast<const uint4*>(words),
      reinterpret_cast<const uint4*>(limbs), static_cast<uint32_t>(lanes),
      out, ws, k, p);
}

int grid_blocks(unsigned long long lanes, int* err) {
  // one resident wave of persistent blocks, or fewer when the window is
  // small; queried once per process (one device per process here)
  static int wave = 0;
  if (wave == 0) {
    const int sms = sm_count(err);
    if (*err != 0) return 0;
    int per_sm = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, search_kernel, kSearchThreads, 0);
    if (e != cudaSuccess) {
      *err = static_cast<int>(e);
      return 0;
    }
    wave = sms * (per_sm > 0 ? per_sm : 1);
  }
  const unsigned long long need =
      (lanes + kSearchThreads - 1) / kSearchThreads;
  return need < static_cast<unsigned long long>(wave) ? static_cast<int>(need)
                                                      : wave;
}

}  // namespace

extern "C" {

// Launch init, search and finalize on `stream` without synchronizing.
// params: host pointer to the 22 job words followed by what
// sha256_cuda.search_params hoists from them (copied into the kernel
// parameters at launch); out: device pointer to 2k+3 words. Returns a
// cudaError_t (0 = every launch was accepted).
int otedama_sha256d_search(const uint32_t* params, unsigned long long batch,
                           int k, uint32_t* out, void* stream) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  SearchParams p;
  static_assert(sizeof(SearchParams) == (kJobWords + kHoistedWords) * 4,
                "SearchParams must be the packed words");
  memcpy(&p, params, sizeof(p));
  unsigned long long lanes = 0;
  if (p.job.w[21] == 0) {
    const unsigned long long in_range =
        static_cast<unsigned long long>(p.job.w[20]) + 1;
    lanes = batch < in_range ? batch : in_range;
  }
  init_buffer<<<1, kThreads, 0, s>>>(out, k);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (lanes > 0) {
    int err = 0;
    const int blocks = grid_blocks(lanes, &err);
    if (err != 0) return err;
    search_kernel<<<blocks, kSearchThreads, 0, s>>>(p, lanes, out, k);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  finalize_buffer<<<1, 1, 0, s>>>(out, k, p.job.w[11]);
  return static_cast<int>(cudaGetLastError());
}

// Validate `lanes` shares (lanes < 2^32) in ONE launch on `stream`,
// without synchronizing: words is a device pointer to row-major [lanes, 20]
// big-endian header words, limbs to [lanes, 8] target limbs
// (most-significant-first), both 16-byte aligned; out to 2k+3 words, every
// one of which the launch writes; ws to the stream's 3-word workspace, all
// zero (the launch leaves it so). Returns a cudaError_t (0 = the launch was
// accepted).
int otedama_sha256d_verify(const uint32_t* words, const uint32_t* limbs,
                           unsigned long long lanes, int k, uint32_t* out,
                           uint32_t* ws, void* stream) {
  if (k < 1 || lanes > 0xFFFFFFFFull ||
      ((reinterpret_cast<uintptr_t>(words) |
        reinterpret_cast<uintptr_t>(limbs)) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = 0;
  const int sms = sm_count(&err);
  if (err != 0) return err;
  // 128 threads a block (a warp for each of an SM's four schedulers)
  // while the batch gives each SM at most one block, 256 above
  if (lanes <= 128ull * sms)
    launch_verify<128>(words, limbs, lanes, k, out, ws, s);
  else
    launch_verify<kThreads>(words, limbs, lanes, k, out, ws, s);
  return static_cast<int>(cudaGetLastError());
}

// Launch the empty kernel on `stream` (one block of 32 threads).
int otedama_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* otedama_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
