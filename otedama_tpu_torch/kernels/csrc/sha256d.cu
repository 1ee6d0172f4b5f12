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
// What bounds the search: integer ALU operations. Per nonce it runs ~120
// SHA-256 rounds on 32-bit words and moves no memory (22 job words in as
// kernel parameters, 2k+3 words out per launch). The design keeps
// everything off the memory system and out of the hot loop that does not
// have to be there:
//   - the 22 job words ride in the constant bank as a by-value parameter,
//     so a launch needs no host-to-device copy;
//   - the first 3 rounds of the first compression and its first schedule
//     words depend only on job words; they are loop-invariant in the
//     grid-stride loop and the compiler hoists them;
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
// walking a grid-stride loop over 64-bit launch offsets — a window holds
// up to 2^32 nonces, so its count does not fit in 32 bits.
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
// operations bound it: ~0.13 ms at 2^20 shares. At the pool ledger's
// batches (128 to 4,096 shares) one launch is a few microseconds of work,
// and the launches themselves set the time. The design:
//   - one thread per share; every share is a different header, so no
//     midstate can be hoisted as the search hoists it;
//   - header words and limbs arrive word-major, [20, lanes] and
//     [8, lanes] (the wrapper transposes on the device), so each of a
//     warp's loads is one contiguous 128-byte line;
//   - the constant words of the second and third blocks (padding, the
//     640- and 256-bit lengths) and the IV are literals, so they fold;
//   - slots, the block min and the finalize sort are the search's, so
//     for n <= k the buffer equals the TPU kernel's word for word.
// Only the `lanes` in-range shares are launched: rows past count-1 never
// count, as in the reference.

#include <cstdint>
#include <cuda_runtime.h>

#include "sha256_device.cuh"

namespace {

constexpr int kJobWords = 22;
constexpr int kThreads = 256;

struct JobParams {
  // [0:8] midstate, [8:11] header words 16..18, [11] nonce base,
  // [12:20] target limbs most-significant-first, [20] last in-range
  // launch offset (count-1), [21] empty flag
  uint32_t w[kJobWords];
};

constexpr uint32_t kIV7 = 0x5BE0CD19u;

// First compression: header block 2 (tail words, nonce, padding) from the
// midstate, with feed-forward. Returns the 8 words of the first digest.
__device__ __forceinline__ void first_hash(const JobParams& p, uint32_t nonce,
                                           uint32_t d[8]) {
  uint32_t w[16] = {p.w[8], p.w[9], p.w[10], nonce, 0x80000000u, 0, 0, 0,
                    0,      0,      0,       0,     0,           0, 0, 640};
  uint32_t s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = p.w[i];
  sha256_rounds<64>(s, w);
#pragma unroll
  for (int i = 0; i < 8; ++i) d[i] = p.w[i] + s[i];
}

// Digest word 7 of sha256d(header) only: word 7 = IV[7] + h after round 63,
// and h after round 63 is the e produced by round 60. So the second
// compression runs rounds 0..60 and returns IV[7] + s[4]; what only feeds
// words 0..6 is dead code the compiler drops.
__device__ __forceinline__ uint32_t sha256d_word7(const JobParams& p,
                                                  uint32_t nonce) {
  uint32_t d[8];
  first_hash(p, nonce, d);
  uint32_t w[16] = {d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7],
                    0x80000000u, 0, 0, 0, 0, 0, 0, 256};
  uint32_t s[8] = SHA256_IV_INIT;
  sha256_rounds<61>(s, w);
  return kIV7 + s[4];
}

// The rare path: full 8-word digest and the exact 256-bit compare, then a
// winner slot. Not inlined, so its registers stay out of the hot loop.
__device__ __noinline__ void escalate(const JobParams& p, uint32_t nonce,
                                      uint32_t h0, uint32_t* out, int k) {
  uint32_t d[8];
  first_hash(p, nonce, d);
  uint32_t w[16] = {d[0], d[1], d[2], d[3], d[4], d[5], d[6], d[7],
                    0x80000000u, 0, 0, 0, 0, 0, 0, 256};
  uint32_t s[8] = SHA256_IV_INIT;
  sha256_rounds<64>(s, w);
  const uint32_t iv[8] = SHA256_IV_INIT;
  // compare limbs most-significant-first: limb j = bswap(digest[7 - j])
  uint32_t h[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j] = bswap32(iv[7 - j] + s[7 - j]);
  if (limbs_le(h, &p.w[12])) take_slot(out, k, nonce, h0);
}

__global__ void __launch_bounds__(kThreads)
    search_kernel(const JobParams p, unsigned long long lanes, uint32_t* out,
                  int k) {
  const uint32_t base = p.w[11];
  const uint32_t t0 = p.w[12];
  const unsigned long long stride =
      static_cast<unsigned long long>(gridDim.x) * blockDim.x;
  uint32_t best = kNoWinner;
  for (unsigned long long off =
           static_cast<unsigned long long>(blockIdx.x) * blockDim.x +
           threadIdx.x;
       off < lanes; off += stride) {
    const uint32_t nonce = base + static_cast<uint32_t>(off);
    const uint32_t h0 = bswap32(sha256d_word7(p, nonce));
    best = min(best, h0);
    if (h0 <= t0) escalate(p, nonce, h0, out, k);
  }
  // min top limb: every thread reaches here (no early exit)
  block_min_to<kThreads>(best, &out[2 * k + 2]);
}

__global__ void __launch_bounds__(kThreads)
    verify_kernel(const uint32_t* __restrict__ words,
                  const uint32_t* __restrict__ limbs,
                  unsigned long long lanes, uint32_t* out, int k) {
  const unsigned long long lane =
      static_cast<unsigned long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  uint32_t best = kNoWinner;
  if (lane < lanes) {
    uint32_t w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = words[i * lanes + lane];
    uint32_t s[8] = SHA256_IV_INIT;
    sha256_compress(s, w);
    uint32_t w2[16] = {words[16 * lanes + lane], words[17 * lanes + lane],
                       words[18 * lanes + lane], words[19 * lanes + lane],
                       0x80000000u, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 640};
    sha256_compress(s, w2);
    uint32_t w3[16] = {s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7],
                       0x80000000u, 0, 0, 0, 0, 0, 0, 256};
    uint32_t d[8] = SHA256_IV_INIT;
    sha256_compress(d, w3);
    // compare limbs most-significant-first: limb j = bswap(digest[7 - j])
    uint32_t h[8], t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      h[j] = bswap32(d[7 - j]);
      t[j] = limbs[j * lanes + lane];
    }
    best = h[0];
    if (!limbs_le(h, t)) take_slot(out, k, static_cast<uint32_t>(lane), h[0]);
  }
  // min top limb: every thread reaches here (no early exit)
  block_min_to<kThreads>(best, &out[2 * k + 2]);
}

int grid_blocks(unsigned long long lanes, int* err) {
  // one resident wave of persistent blocks, or fewer when the window is
  // small; queried once per process (one device per process here)
  static int wave = 0;
  if (wave == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, search_kernel,
                                                        kThreads, 0);
    if (e != cudaSuccess) {
      *err = static_cast<int>(e);
      return 0;
    }
    wave = sms * (per_sm > 0 ? per_sm : 1);
  }
  const unsigned long long need = (lanes + kThreads - 1) / kThreads;
  return need < static_cast<unsigned long long>(wave) ? static_cast<int>(need)
                                                      : wave;
}

}  // namespace

extern "C" {

// Launch init, search and finalize on `stream` without synchronizing.
// job_words: host pointer to 22 words (copied into the kernel parameters
// at launch); out: device pointer to 2k+3 words. Returns a cudaError_t
// (0 = every launch was accepted).
int otedama_sha256d_search(const uint32_t* job_words, unsigned long long batch,
                           int k, uint32_t* out, void* stream) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  JobParams p;
  for (int i = 0; i < kJobWords; ++i) p.w[i] = job_words[i];
  unsigned long long lanes = 0;
  if (p.w[21] == 0) {
    const unsigned long long in_range =
        static_cast<unsigned long long>(p.w[20]) + 1;
    lanes = batch < in_range ? batch : in_range;
  }
  init_buffer<<<1, kThreads, 0, s>>>(out, k);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (lanes > 0) {
    int err = 0;
    const int blocks = grid_blocks(lanes, &err);
    if (err != 0) return err;
    search_kernel<<<blocks, kThreads, 0, s>>>(p, lanes, out, k);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  finalize_buffer<<<1, 1, 0, s>>>(out, k, p.w[11]);
  return static_cast<int>(cudaGetLastError());
}

// Validate `lanes` shares (lanes < 2^32): words is a device pointer to
// [20, lanes] big-endian header words, limbs to [8, lanes] target limbs
// (most-significant-first), out to 2k+3 words. Launches init, verify and
// finalize on `stream` without synchronizing; returns a cudaError_t
// (0 = every launch was accepted).
int otedama_sha256d_verify(const uint32_t* words, const uint32_t* limbs,
                           unsigned long long lanes, int k, uint32_t* out,
                           void* stream) {
  if (k < 1 || lanes > 0xFFFFFFFFull)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  init_buffer<<<1, kThreads, 0, s>>>(out, k);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (lanes > 0) {
    const unsigned int blocks =
        static_cast<unsigned int>((lanes + kThreads - 1) / kThreads);
    verify_kernel<<<blocks, kThreads, 0, s>>>(words, limbs, lanes, out, k);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  finalize_buffer<<<1, 1, 0, s>>>(out, k, 0u);
  return static_cast<int>(cudaGetLastError());
}

const char* otedama_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
