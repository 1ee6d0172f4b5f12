// Device code shared by the port's kernels (sha256d.cu, scrypt.cu): SHA-256 rounds, and the uint32[2k+3]
// winner buffer that every search launch fills (a verify launch fills it
// with failing lane offsets, base 0):
//   [win_nonce[k] | win_limb[k] | n_winners, 0, min_top_limb]
// Winners take slots with atomicAdd on the count (arbitrary order) and a
// one-thread finalize launch sorts the <= k slots by launch offset, so for
// n <= k the buffer equals the TPU kernels' lane-order compaction word for
// word; for n > k only the count (and the min) is defined. Unused slots
// hold 0 in the nonce half and 0xFFFFFFFF in the limb half.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kNoWinner = 0xFFFFFFFFu;

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

// the IV as literals, so constant state folds
#define SHA256_IV_INIT                                                   \
  {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,                   \
   0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u}

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

// One whole compression with feed-forward: s = compress(s, w). w is
// clobbered.
__device__ __forceinline__ void sha256_compress(uint32_t s[8], uint32_t w[16]) {
  uint32_t t[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) t[i] = s[i];
  sha256_rounds<64>(t, w);
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] += t[i];
}

// Lexicographic h <= t over 8 most-significant-first limbs.
__device__ __forceinline__ bool limbs_le(const uint32_t h[8],
                                         const uint32_t t[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (h[j] != t[j]) return h[j] < t[j];
  }
  return true;
}

// A winner takes the next slot; arrivals past k only count.
__device__ __forceinline__ void take_slot(uint32_t* out, int k, uint32_t nonce,
                                          uint32_t h0) {
  const uint32_t idx = atomicAdd(&out[2 * k], 1u);
  if (idx < static_cast<uint32_t>(k)) {
    out[idx] = nonce;
    out[k + idx] = h0;
  }
}

// Min top limb of a block into out[2k+2]: warp reduce, block reduce
// through shared memory, one atomicMin per block. Every thread of the block
// must call it (no early exit), so the full-mask reductions are defined;
// kThreadsPerBlock is the block size, a multiple of 32.
template <int kThreadsPerBlock>
__device__ __forceinline__ void block_min_to(uint32_t best, uint32_t* dst) {
  __shared__ uint32_t warp_min[kThreadsPerBlock / 32];
  best = __reduce_min_sync(0xFFFFFFFFu, best);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_min[warp] = best;
  __syncthreads();
  if (warp == 0) {
    uint32_t v = lane < kThreadsPerBlock / 32 ? warp_min[lane] : kNoWinner;
    v = __reduce_min_sync(0xFFFFFFFFu, v);
    if (lane == 0 && v != kNoWinner) atomicMin(dst, v);
  }
}

__global__ void init_buffer(uint32_t* out, int k) {
  for (int i = threadIdx.x; i < 2 * k + 3; i += blockDim.x) {
    uint32_t v = 0;
    if ((i >= k && i < 2 * k) || i == 2 * k + 2) v = kNoWinner;
    out[i] = v;
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

}  // namespace
