// Kernels B7a-B7c: ethash on the card, the epoch DAG, the nonce search
// (light and full) and share validation. They replace the device tier that
// the JAX package runs through XLA, without Pallas
// (otedama_tpu/kernels/ethash.py):
//   - B7a, dag_kernel: build_dataset_device (:611) over _derive_items_device
//     (:356): dataset item i is keccak-512 of the cache row i % rows with
//     its first word xored by i, 256 FNV folds with cache rows picked by
//     FNV of (i ^ j, mix[j % 16]), keccak-512 again. One thread an item,
//     written straight into the page-major DAG (items 2p and 2p + 1 are
//     page p: the same bytes as item-major), exactly n_items of them;
//   - B7b, search_full_kernel and search_light_kernel:
//     hashimoto_winners_device (:501) over _hashimoto_device_words (:415):
//     s = keccak-512(header hash || 64-bit LE nonce), the nonce being
//     (base + lane) mod 2^32 zero-extended; 64 accesses, each folding the
//     128-byte page FNV(a ^ s[0], mix[a % 32]) % n_pages into the 32-word
//     mix; the cmix fold; keccak-256 of s || cmix; the result compared
//     EXACTLY with the target (limbs: the byte-swapped result words,
//     _result_limbs :462); WINNERS compacted as lane offsets. The full tier
//     reads each page from the DAG, the light tier derives its two items
//     from the cache (B7a's code as a device function);
//   - B7c, verify_kernel: hashimoto_verify_device (:542), the light core
//     over rows of (header hash, nonce, target limbs); FAILURES compacted as
//     row offsets. The min top limb covers every in-range lane.
// The buffer is the shared uint32[2k+3] (sha256_device.cuh): slots taken
// with atomicAdd, a one-thread finalize sorts them by offset, so for n <= k
// it equals the reference's lane-order compaction word for word.
//
// What bounds them on an H100 (chip_smoke.py phases 34-36):
//   - B7a: integer instructions (two keccak-f1600s and 256 x 16 FNV words an
//     item; counted from the SASS of the counting build below). Its
//     256-row gathers a item (~275 GB an epoch-0 build) are L2 reads: the
//     16 MiB cache fits the 50 MB L2. One thread an item keeps enough rows
//     in flight to hide their latency;
//   - B7b full: device memory. The 1 GiB DAG does not fit L2, so each hash
//     reads 64 random 128-byte pages (8,192 bytes) from HBM. The mix lives
//     in registers: the 64 accesses are unrolled, so mix[a % 32] is a
//     register and not a local-memory index; a page is 8 x 16-byte
//     ld.global.nc;
//   - B7b light and B7c: integer instructions (128 items a hash). Their
//     access loop stays rolled (an item is ~25k instructions); mix[a % 32]
//     is picked from the 32 registers by masks (pick).
// `% rows` and `% n_pages` divide by a run-time prime: the plain `%`, exact
// for every 32-bit dividend. Every loop is fully inlined: no call, no
// stack, no local array (chip_smoke.py phase 1 fails otherwise).
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "sha256_device.cuh"

// A counting build (-DETHASH_COUNT, ethash_cuda.instruction_counts) unrolls
// every loop and holds only dag_kernel and search_full_kernel, each then
// straight-line code whose SASS is what a thread executes.
#ifdef ETHASH_COUNT
#define ETHASH_ROLLED _Pragma("unroll")
#else
#define ETHASH_ROLLED _Pragma("unroll 1")
#endif

namespace {

constexpr int kThreads = 128;
constexpr uint32_t kFnvPrime = 0x01000193u;
constexpr int kParents = 256;
constexpr int kAccesses = 64;
// lanes a launch of the search and verify kernels (a call walks its lanes
// in launches of at most this many, offsets first + i)
constexpr uint64_t kLaunchLanes = 1ull << 30;

__constant__ uint64_t kRC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull, 0x8000000080008000ull,
    0x000000000000808Bull, 0x0000000080000001ull, 0x8000000080008081ull, 0x8000000000008009ull,
    0x000000000000008Aull, 0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull, 0x8000000000008003ull,
    0x8000000000008002ull, 0x8000000000000080ull, 0x000000000000800Aull, 0x800000008000000Aull,
    0x8000000080008081ull, 0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};

// the search job: the header hash's 8 LE words, the nonce base, the target
// limbs (most-significant first)
struct EthJob {
  uint32_t hh[8];
  uint32_t base;
  uint32_t target[8];
};
constexpr int kJobWords = 17;

__device__ __forceinline__ uint32_t fnv(uint32_t a, uint32_t b) {
  return (a * kFnvPrime) ^ b;
}
__device__ __forceinline__ uint64_t rotl64(uint64_t x, int n) {
  return (x << n) | (x >> (64 - n));
}
__device__ __forceinline__ uint64_t join64(uint32_t lo, uint32_t hi) {
  return static_cast<uint64_t>(lo) | (static_cast<uint64_t>(hi) << 32);
}

// Keccak-f[1600] in place, the round loop rolled (the light tier inlines
// four permutations an access)
__device__ __forceinline__ void f1600(uint64_t A[25]) {
  ETHASH_ROLLED
  for (int rnd = 0; rnd < 24; ++rnd) {
    const uint64_t C0 = A[0] ^ A[5] ^ A[10] ^ A[15] ^ A[20];
    const uint64_t C1 = A[1] ^ A[6] ^ A[11] ^ A[16] ^ A[21];
    const uint64_t C2 = A[2] ^ A[7] ^ A[12] ^ A[17] ^ A[22];
    const uint64_t C3 = A[3] ^ A[8] ^ A[13] ^ A[18] ^ A[23];
    const uint64_t C4 = A[4] ^ A[9] ^ A[14] ^ A[19] ^ A[24];
    const uint64_t D0 = C4 ^ rotl64(C1, 1);
    const uint64_t D1 = C0 ^ rotl64(C2, 1);
    const uint64_t D2 = C1 ^ rotl64(C3, 1);
    const uint64_t D3 = C2 ^ rotl64(C4, 1);
    const uint64_t D4 = C3 ^ rotl64(C0, 1);
    const uint64_t B0 = A[0] ^ D0;
    const uint64_t B1 = rotl64(A[6] ^ D1, 44);
    const uint64_t B2 = rotl64(A[12] ^ D2, 43);
    const uint64_t B3 = rotl64(A[18] ^ D3, 21);
    const uint64_t B4 = rotl64(A[24] ^ D4, 14);
    const uint64_t B5 = rotl64(A[3] ^ D3, 28);
    const uint64_t B6 = rotl64(A[9] ^ D4, 20);
    const uint64_t B7 = rotl64(A[10] ^ D0, 3);
    const uint64_t B8 = rotl64(A[16] ^ D1, 45);
    const uint64_t B9 = rotl64(A[22] ^ D2, 61);
    const uint64_t B10 = rotl64(A[1] ^ D1, 1);
    const uint64_t B11 = rotl64(A[7] ^ D2, 6);
    const uint64_t B12 = rotl64(A[13] ^ D3, 25);
    const uint64_t B13 = rotl64(A[19] ^ D4, 8);
    const uint64_t B14 = rotl64(A[20] ^ D0, 18);
    const uint64_t B15 = rotl64(A[4] ^ D4, 27);
    const uint64_t B16 = rotl64(A[5] ^ D0, 36);
    const uint64_t B17 = rotl64(A[11] ^ D1, 10);
    const uint64_t B18 = rotl64(A[17] ^ D2, 15);
    const uint64_t B19 = rotl64(A[23] ^ D3, 56);
    const uint64_t B20 = rotl64(A[2] ^ D2, 62);
    const uint64_t B21 = rotl64(A[8] ^ D3, 55);
    const uint64_t B22 = rotl64(A[14] ^ D4, 39);
    const uint64_t B23 = rotl64(A[15] ^ D0, 41);
    const uint64_t B24 = rotl64(A[21] ^ D1, 2);
    A[0] = B0 ^ (~B1 & B2);
    A[1] = B1 ^ (~B2 & B3);
    A[2] = B2 ^ (~B3 & B4);
    A[3] = B3 ^ (~B4 & B0);
    A[4] = B4 ^ (~B0 & B1);
    A[5] = B5 ^ (~B6 & B7);
    A[6] = B6 ^ (~B7 & B8);
    A[7] = B7 ^ (~B8 & B9);
    A[8] = B8 ^ (~B9 & B5);
    A[9] = B9 ^ (~B5 & B6);
    A[10] = B10 ^ (~B11 & B12);
    A[11] = B11 ^ (~B12 & B13);
    A[12] = B12 ^ (~B13 & B14);
    A[13] = B13 ^ (~B14 & B10);
    A[14] = B14 ^ (~B10 & B11);
    A[15] = B15 ^ (~B16 & B17);
    A[16] = B16 ^ (~B17 & B18);
    A[17] = B17 ^ (~B18 & B19);
    A[18] = B18 ^ (~B19 & B15);
    A[19] = B19 ^ (~B15 & B16);
    A[20] = B20 ^ (~B21 & B22);
    A[21] = B21 ^ (~B22 & B23);
    A[22] = B22 ^ (~B23 & B24);
    A[23] = B23 ^ (~B24 & B20);
    A[24] = B24 ^ (~B20 & B21);
    A[0] ^= kRC[rnd];
  }
}

// keccak-512 (original 0x01 padding, rate 72) of the n32 words of w (40 or
// 64 bytes), its 16 digest words into w
template <int n32>
__device__ __forceinline__ void keccak512(uint32_t w[16]) {
  uint64_t A[25];
#pragma unroll
  for (int i = 0; i < 25; ++i)
    A[i] = 2 * i + 1 < n32 ? join64(w[2 * i], w[2 * i + 1]) : 0;
  A[n32 / 2] ^= 0x01;
  A[8] ^= 0x8000000000000000ull;
  f1600(A);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    w[2 * i] = static_cast<uint32_t>(A[i]);
    w[2 * i + 1] = static_cast<uint32_t>(A[i] >> 32);
  }
}

// one dataset item (_derive_items_device): B7a's work, and the light tier's
// twice an access
__device__ __forceinline__ void derive_item(const uint4* __restrict__ cache,
                                            uint32_t rows, uint32_t idx,
                                            uint32_t mix[16]) {
  const uint4* row = cache + static_cast<size_t>(idx % rows) * 4;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint4 v = __ldg(row + q);
    mix[4 * q] = v.x;
    mix[4 * q + 1] = v.y;
    mix[4 * q + 2] = v.z;
    mix[4 * q + 3] = v.w;
  }
  mix[0] ^= idx;
  keccak512<16>(mix);
  ETHASH_ROLLED
  for (int j0 = 0; j0 < kParents; j0 += 16) {
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      const uint32_t parent = fnv(idx ^ static_cast<uint32_t>(j0 + jj), mix[jj]) % rows;
      const uint4* p = cache + static_cast<size_t>(parent) * 4;
      uint4 v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = __ldg(p + q);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        mix[4 * q] = fnv(mix[4 * q], v[q].x);
        mix[4 * q + 1] = fnv(mix[4 * q + 1], v[q].y);
        mix[4 * q + 2] = fnv(mix[4 * q + 2], v[q].z);
        mix[4 * q + 3] = fnv(mix[4 * q + 3], v[q].w);
      }
    }
  }
  keccak512<16>(mix);
}

// s = keccak-512(header hash || nonce as 64-bit LE)
__device__ __forceinline__ void seed_words(const uint32_t hh[8], uint32_t nonce_lo,
                                           uint32_t nonce_hi, uint32_t s[16]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = hh[i];
  s[8] = nonce_lo;
  s[9] = nonce_hi;
#pragma unroll
  for (int i = 10; i < 16; ++i) s[i] = 0;
  keccak512<10>(s);
}

// the cmix fold and the keccak-256 seal of s || cmix (96 bytes, rate 136):
// the compare-order limbs of the result into h
__device__ __forceinline__ void seal(const uint32_t s[16], const uint32_t mix[32],
                                     uint32_t h[8]) {
  uint32_t cmix[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    cmix[i] = fnv(fnv(fnv(mix[4 * i], mix[4 * i + 1]), mix[4 * i + 2]), mix[4 * i + 3]);
  uint64_t A[25];
#pragma unroll
  for (int i = 0; i < 8; ++i) A[i] = join64(s[2 * i], s[2 * i + 1]);
#pragma unroll
  for (int i = 0; i < 4; ++i) A[8 + i] = join64(cmix[2 * i], cmix[2 * i + 1]);
  A[12] = 0x01;
#pragma unroll
  for (int i = 13; i < 25; ++i) A[i] = 0;
  A[16] = 0x8000000000000000ull;
  f1600(A);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[2 * i] = bswap32(static_cast<uint32_t>(A[i]));
    h[2 * i + 1] = bswap32(static_cast<uint32_t>(A[i] >> 32));
  }
}

__device__ __forceinline__ void init_mix(const uint32_t s[16], uint32_t mix[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) mix[i] = s[i & 15];
}

// mix[a % 32] for a rolled loop's a, from registers: each word masked by
// a predicate made in inline PTX. (A plain select chain is turned back into
// an indexed load, and the mix then lives in a local-memory array.)
__device__ __forceinline__ uint32_t pick(const uint32_t mix[32], uint32_t a) {
  uint32_t m = 0;
#pragma unroll
  for (uint32_t w = 0; w < 32; ++w) {
    uint32_t take;
    asm("{\n\t.reg .pred p;\n\tsetp.eq.u32 p, %1, %2;\n\tselp.b32 %0, -1, 0, p;\n\t}"
        : "=r"(take)
        : "r"(a & 31), "r"(w));
    m |= mix[w] & take;
  }
  return m;
}

// the light core: each page's two items derived from the cache
__device__ __forceinline__ void hashimoto_light(const uint4* __restrict__ cache,
                                                uint32_t rows, uint32_t n_pages,
                                                const uint32_t s[16], uint32_t h[8]) {
  uint32_t mix[32];
  init_mix(s, mix);
  ETHASH_ROLLED
  for (uint32_t a = 0; a < kAccesses; ++a) {
    const uint32_t page = fnv(a ^ s[0], pick(mix, a)) % n_pages;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t item[16];
      derive_item(cache, rows, 2 * page + half, item);
#pragma unroll
      for (int w = 0; w < 16; ++w) mix[16 * half + w] = fnv(mix[16 * half + w], item[w]);
    }
  }
  seal(s, mix, h);
}

// the full core: each page 8 x 16 bytes from the DAG, read past L1
__device__ __forceinline__ void hashimoto_full(const uint4* __restrict__ dag,
                                               uint32_t n_pages, const uint32_t s[16],
                                               uint32_t h[8]) {
  uint32_t mix[32];
  init_mix(s, mix);
#pragma unroll
  for (int a = 0; a < kAccesses; ++a) {
    const uint32_t page = fnv(static_cast<uint32_t>(a) ^ s[0], mix[a % 32]) % n_pages;
    const uint4* p = dag + static_cast<size_t>(page) * 8;
    uint4 v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = __ldg(p + q);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      mix[4 * q] = fnv(mix[4 * q], v[q].x);
      mix[4 * q + 1] = fnv(mix[4 * q + 1], v[q].y);
      mix[4 * q + 2] = fnv(mix[4 * q + 2], v[q].z);
      mix[4 * q + 3] = fnv(mix[4 * q + 3], v[q].w);
    }
  }
  seal(s, mix, h);
}

}  // namespace

// B7a: items first .. first + n - 1 of the DAG
extern "C" __global__ void __launch_bounds__(kThreads)
    dag_kernel(const uint4* __restrict__ cache, uint32_t rows, uint32_t first,
               uint32_t n, uint4* __restrict__ dag) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t idx = first + i;
  uint32_t item[16];
  derive_item(cache, rows, idx, item);
  uint4* out = dag + static_cast<size_t>(idx) * 4;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    out[q] = make_uint4(item[4 * q], item[4 * q + 1], item[4 * q + 2], item[4 * q + 3]);
}

// B7b, full: lanes first .. first + n - 1 of the window
extern "C" __global__ void __launch_bounds__(kThreads)
    search_full_kernel(const EthJob job, const uint4* __restrict__ dag,
                       uint32_t n_pages, uint32_t first, uint32_t n, uint32_t* out,
                       int k) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  uint32_t best = kNoWinner;
  if (i < n) {
    uint32_t s[16], h[8];
    seed_words(job.hh, job.base + first + i, 0u, s);
    hashimoto_full(dag, n_pages, s, h);
    best = h[0];
    if (limbs_le(h, job.target)) take_slot(out, k, first + i, h[0]);
  }
  block_min_to<kThreads>(best, &out[2 * k + 2]);
}

#ifndef ETHASH_COUNT

// B7b, light: as the full tier, each page derived from the cache
extern "C" __global__ void __launch_bounds__(kThreads)
    search_light_kernel(const EthJob job, const uint4* __restrict__ cache,
                        uint32_t rows, uint32_t n_pages, uint32_t first, uint32_t n,
                        uint32_t* out, int k) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  uint32_t best = kNoWinner;
  if (i < n) {
    uint32_t s[16], h[8];
    seed_words(job.hh, job.base + first + i, 0u, s);
    hashimoto_light(cache, rows, n_pages, s, h);
    best = h[0];
    if (limbs_le(h, job.target)) take_slot(out, k, first + i, h[0]);
  }
  block_min_to<kThreads>(best, &out[2 * k + 2]);
}

// B7c: rows first .. first + n - 1: hh [rows, 8] LE header-hash words,
// nonces [rows, 2] (the 64-bit LE nonce as two words), limbs [rows, 8]
extern "C" __global__ void __launch_bounds__(kThreads)
    verify_kernel(const uint32_t* __restrict__ hh, const uint32_t* __restrict__ nonces,
                  const uint32_t* __restrict__ limbs, const uint4* __restrict__ cache,
                  uint32_t rows, uint32_t n_pages, uint32_t first, uint32_t n,
                  uint32_t* out, int k) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  uint32_t best = kNoWinner;
  if (i < n) {
    const size_t r = static_cast<size_t>(first) + i;
    uint32_t hw[8], t[8], s[16], h[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      hw[w] = __ldg(&hh[r * 8 + w]);
      t[w] = __ldg(&limbs[r * 8 + w]);
    }
    seed_words(hw, __ldg(&nonces[r * 2]), __ldg(&nonces[r * 2 + 1]), s);
    hashimoto_light(cache, rows, n_pages, s, h);
    best = h[0];
    if (!limbs_le(h, t)) take_slot(out, k, first + static_cast<uint32_t>(i), h[0]);
  }
  block_min_to<kThreads>(best, &out[2 * k + 2]);
}

namespace {

unsigned int blocks_for(uint64_t threads) {
  return static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
}

// the kernels by number, for their attributes: 1 dag, 2 search full, 3
// search light, 4 verify
const void* kernel_fn(int which) {
  switch (which) {
    case 1: return reinterpret_cast<const void*>(dag_kernel);
    case 2: return reinterpret_cast<const void*>(search_full_kernel);
    case 3: return reinterpret_cast<const void*>(search_light_kernel);
    case 4: return reinterpret_cast<const void*>(verify_kernel);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// B7a on `stream`, without synchronizing: items first .. first + n - 1 of
// the DAG (device, n_items x 16 words, page-major = item-major) from the
// cache (device, rows x 16 words, 16-byte aligned). Returns a cudaError_t.
int otedama_ethash_dag(const uint32_t* cache, unsigned int rows,
                       unsigned long long first, unsigned long long n, uint32_t* dag,
                       void* stream) {
  if (rows == 0 || first + n > (1ull << 32)) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  dag_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(cache), rows, static_cast<uint32_t>(first),
      static_cast<uint32_t>(n), reinterpret_cast<uint4*>(dag));
  return static_cast<int>(cudaGetLastError());
}

// B7b on `stream`, without synchronizing: `lanes` lanes (< 2^32) of the job
// (host pointer to its 17 words), the buffer's init, the search kernels and
// the finalize into out (device, 2k+3 words). full != 0: src is the DAG's
// pages (device, n_pages x 32 words); else the cache (rows x 16 words).
// Returns a cudaError_t.
int otedama_ethash_search(const uint32_t* job, int full, const uint32_t* src,
                          unsigned int rows, unsigned int n_pages,
                          unsigned long long lanes, int k, uint32_t* out, void* stream) {
  if (k < 1 || n_pages == 0 || (!full && rows == 0) || lanes >= (1ull << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  EthJob j;
  static_assert(sizeof(EthJob) == kJobWords * 4, "EthJob must be the packed words");
  memcpy(&j, job, sizeof(j));
  init_buffer<<<1, 64, 0, st>>>(out, k);
  for (uint64_t first = 0; first < lanes; first += kLaunchLanes) {
    const uint64_t n = lanes - first < kLaunchLanes ? lanes - first : kLaunchLanes;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    if (full)
      search_full_kernel<<<blocks_for(n), kThreads, 0, st>>>(
          j, s4, n_pages, static_cast<uint32_t>(first), static_cast<uint32_t>(n), out, k);
    else
      search_light_kernel<<<blocks_for(n), kThreads, 0, st>>>(
          j, s4, rows, n_pages, static_cast<uint32_t>(first), static_cast<uint32_t>(n),
          out, k);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  finalize_buffer<<<1, 1, 0, st>>>(out, k, 0u);
  return static_cast<int>(cudaGetLastError());
}

// B7c on `stream`, without synchronizing: the first `count` rows of hh
// (device, [rows, 8]), nonces ([rows, 2]) and limbs ([rows, 8]) against the
// cache; failing row offsets into out. Returns a cudaError_t.
int otedama_ethash_verify(const uint32_t* hh, const uint32_t* nonces,
                          const uint32_t* limbs, unsigned long long count,
                          const uint32_t* cache, unsigned int rows,
                          unsigned int n_pages, int k, uint32_t* out, void* stream) {
  if (k < 1 || rows == 0 || n_pages == 0 || count >= (1ull << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  init_buffer<<<1, 64, 0, st>>>(out, k);
  for (uint64_t first = 0; first < count; first += kLaunchLanes) {
    const uint64_t n = count - first < kLaunchLanes ? count - first : kLaunchLanes;
    verify_kernel<<<blocks_for(n), kThreads, 0, st>>>(
        hh, nonces, limbs, reinterpret_cast<const uint4*>(cache), rows, n_pages,
        static_cast<uint32_t>(first), static_cast<uint32_t>(n), out, k);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  finalize_buffer<<<1, 1, 0, st>>>(out, k, 0u);
  return static_cast<int>(cudaGetLastError());
}

// A kernel's attributes on the current device (numbered as kernel_fn): its
// threads a block, registers a thread, local memory (stack and spills) a
// thread, and resident blocks an SM. Returns a cudaError_t.
int otedama_ethash_kernel_info(int which, int* threads, int* regs, int* local_bytes,
                               int* blocks_per_sm) {
  const void* fn = kernel_fn(which);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  *threads = kThreads;
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, kThreads, 0));
}

const char* otedama_ethash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

#endif  // ETHASH_COUNT
