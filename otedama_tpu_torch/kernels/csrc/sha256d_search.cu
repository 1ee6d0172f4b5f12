// sha256d nonce search for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel otedama_tpu/kernels/sha256_pallas.py
// `_search_kernel` (reached through `sha256d_pallas_search`): for every
// nonce of a launch window it hashes header(midstate, tail, nonce) twice,
// decides winners EXACTLY against the 256-bit target, and returns one
// fixed uint32[2k+3] buffer:
//   [win_nonce[k] | win_limb[k] | n_winners, 0, min_top_limb]
// with winners in ascending launch-offset order (when n <= k), the true
// in-range winner count (n > k is the caller's overflow signal), and the
// min top compare limb over in-range lanes. Unused slots hold 0 in the
// nonce half and 0xFFFFFFFF in the limb half.
//
// What bounds it: integer ALU operations. Per nonce it runs ~120 SHA-256
// rounds on 32-bit words and moves no memory (22 job words in as kernel
// parameters, 2k+3 words out per launch). The design keeps everything off
// the memory system and out of the hot loop that does not have to be
// there:
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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kJobWords = 22;
constexpr int kThreads = 256;
constexpr uint32_t kNoWinner = 0xFFFFFFFFu;

struct JobParams {
  // [0:8] midstate, [8:11] header words 16..18, [11] nonce base,
  // [12:20] target limbs most-significant-first, [20] last in-range
  // launch offset (count-1), [21] empty flag
  uint32_t w[kJobWords];
};

__constant__ uint32_t kK[64] = {
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
};

// the IV as literals, so the second compression's constant state folds
#define SHA256_IV_INIT                                                   \
  {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,                   \
   0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u}
constexpr uint32_t kIV7 = 0x5BE0CD19u;

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}
__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}
__device__ __forceinline__ uint32_t big_sigma0(uint32_t x) {
  return rotr(x, 2) ^ rotr(x, 13) ^ rotr(x, 22);
}
__device__ __forceinline__ uint32_t big_sigma1(uint32_t x) {
  return rotr(x, 6) ^ rotr(x, 11) ^ rotr(x, 25);
}
__device__ __forceinline__ uint32_t small_sigma0(uint32_t x) {
  return rotr(x, 7) ^ rotr(x, 18) ^ (x >> 3);
}
__device__ __forceinline__ uint32_t small_sigma1(uint32_t x) {
  return rotr(x, 17) ^ rotr(x, 19) ^ (x >> 10);
}
__device__ __forceinline__ uint32_t ch(uint32_t e, uint32_t f, uint32_t g) {
  return g ^ (e & (f ^ g));
}
__device__ __forceinline__ uint32_t maj(uint32_t a, uint32_t b, uint32_t c) {
  return (a & b) | (c & (a | b));
}

// `rounds` rounds of one SHA-256 compression over state s (in place, no
// feed-forward). w is the 16-word ring, expanded in place. Fully unrolled:
// every index is a compile-time constant, so s and w live in registers and
// constant words fold.
template <int rounds>
__device__ __forceinline__ void sha256_rounds(uint32_t s[8], uint32_t w[16]) {
#pragma unroll
  for (int i = 0; i < rounds; ++i) {
    if (i >= 16) {
      w[i & 15] += small_sigma0(w[(i - 15) & 15]) + w[(i - 7) & 15] +
                   small_sigma1(w[(i - 2) & 15]);
    }
    const uint32_t t1 = s[7] + big_sigma1(s[4]) + ch(s[4], s[5], s[6]) +
                        kK[i] + w[i & 15];
    const uint32_t t2 = big_sigma0(s[0]) + maj(s[0], s[1], s[2]);
    s[7] = s[6];
    s[6] = s[5];
    s[5] = s[4];
    s[4] = s[3] + t1;
    s[3] = s[2];
    s[2] = s[1];
    s[1] = s[0];
    s[0] = t1 + t2;
  }
}

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
  bool le = true;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const uint32_t h = bswap32(iv[7 - j] + s[7 - j]);
    const uint32_t t = p.w[12 + j];
    if (h != t) {
      le = h < t;
      break;
    }
  }
  if (!le) return;
  const uint32_t idx = atomicAdd(&out[2 * k], 1u);
  if (idx < static_cast<uint32_t>(k)) {
    out[idx] = nonce;
    out[k + idx] = h0;
  }
}

__global__ void init_buffer(uint32_t* out, int k) {
  for (int i = threadIdx.x; i < 2 * k + 3; i += blockDim.x) {
    uint32_t v = 0;
    if ((i >= k && i < 2 * k) || i == 2 * k + 2) v = kNoWinner;
    out[i] = v;
  }
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
  // min top limb: warp reduce, block reduce through shared memory, one
  // atomic per block. Every thread reaches here (no early exit), so the
  // full-mask warp reductions are well defined.
  __shared__ uint32_t warp_min[kThreads / 32];
  best = __reduce_min_sync(0xFFFFFFFFu, best);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_min[warp] = best;
  __syncthreads();
  if (warp == 0) {
    uint32_t v = lane < (blockDim.x >> 5) ? warp_min[lane] : kNoWinner;
    v = __reduce_min_sync(0xFFFFFFFFu, v);
    if (lane == 0 && v != kNoWinner) atomicMin(&out[2 * k + 2], v);
  }
}

// One thread: order the <= k filled slots by launch offset (nonce - base,
// mod 2^32), matching the reference's lane-order compaction. With n > k
// only the count is defined, as in the reference.
__global__ void finalize_buffer(uint32_t* out, int k, uint32_t base) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  const uint32_t n = out[2 * k];
  const int m = n < static_cast<uint32_t>(k) ? static_cast<int>(n) : k;
  for (int i = 1; i < m; ++i) {
    const uint32_t wn = out[i];
    const uint32_t wl = out[k + i];
    int j = i - 1;
    while (j >= 0 && out[j] - base > wn - base) {
      out[j + 1] = out[j];
      out[k + j + 1] = out[k + j];
      --j;
    }
    out[j + 1] = wn;
    out[k + j + 1] = wl;
  }
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

const char* otedama_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
