// Kernels B7a-B7c: ethash on the card, the epoch DAG, the nonce search
// (light and full) and share validation. They replace the device tier that
// the JAX package runs through XLA, without Pallas
// (otedama_tpu/kernels/ethash.py):
//   - B7a, dag_kernel: build_dataset_device (:611) over _derive_items_device
//     (:356): dataset item i is keccak-512 of the cache row i % rows with
//     its first word xored by i, 256 FNV folds with cache rows picked by
//     FNV of (i ^ j, mix[j % 16]), keccak-512 again. A quad of threads
//     four items, written straight into the page-major DAG (items 2p and
//     2p + 1 are page p: the same bytes as item-major), exactly n_items;
//   - B7b, search_full_kernel and search_light_kernel:
//     hashimoto_winners_device (:501) over _hashimoto_device_words (:415):
//     s = keccak-512(header hash || 64-bit LE nonce), the nonce being
//     (base + lane) mod 2^32 zero-extended; 64 accesses, each folding the
//     128-byte page FNV(a ^ s[0], mix[a % 32]) % n_pages into the 32-word
//     mix; the cmix fold; keccak-256 of s || cmix; the result compared
//     EXACTLY with the target (limbs: the byte-swapped result words,
//     _result_limbs :462); WINNERS compacted as lane offsets. The full tier
//     reads each page from the DAG, the light tier derives its two items
//     from the cache (B7a's item core);
//   - B7c, verify_kernel: hashimoto_verify_device (:542), B7b light's core
//     over rows of (header hash, 64-bit nonce, target limbs); FAILURES
//     compacted as row offsets. The min top limb covers every in-range lane.
// The buffer is the shared uint32[2k+3] (sha256_device.cuh): slots taken
// with atomicAdd, a one-thread finalize sorts them by offset, so for n <= k
// it equals the reference's lane-order compaction word for word.
//
// What bounds them on an H100 (chip_smoke.py phases 34-36):
//   - B7a and B7b light: the L2's rate for random 64-byte cache rows. An
//     item reads 256 of them (16 KiB: ~275 GB an epoch-0 DAG, 2 MiB a light
//     hash); the 16 MiB cache stays in the 50 MB L2. Both run
//     one cooperative item core (derive_quad): a quad of threads (lanes 4m
//     .. 4m + 3, q = lane % 4) derives four items. Each thread runs the
//     first and the last keccak-512 of its own item; between them a 4 x 4
//     transpose by shuffles gives thread q quarter q (words 4q .. 4q + 3) of
//     all four mixes, each parent's mix word is broadcast from the thread
//     that holds it, and each thread loads quarter q of the four parent
//     rows. One warp-wide load then covers 8 whole rows (one L1 wavefront an
//     item-parent, where a thread an item touched 32 lines a load), and a
//     thread keeps four independent chains in flight. `% rows` and `%
//     n_pages` are a multiply-high by a magic number that the C entry
//     points make on the host (fastmod). B7a's quad stores its four items as 256
//     contiguous bytes. B7b light runs two threads a hash, each holding one
//     half of the 32-word mix and deriving that half's item of each page,
//     so a quad is two hashes x two items: the four items of one access.
//     The page's mix word comes from its owner by a shuffle after a 15-select
//     tree over the owner's 16 words (pick16); the seed keccak-512 and the
//     keccak-256 seal run once a hash, on the pair's first thread. The
//     access loop stays rolled: unrolled, the light core is too large;
//   - B7b full: device memory. The 1 GiB DAG does not fit L2, so each hash
//     reads 64 random 128-byte pages (8,192 bytes) from HBM. The mix lives
//     in registers: the 64 accesses are unrolled, so mix[a % 32] is a
//     register and not a local-memory index; a page is 8 x 16-byte
//     ld.global.nc;
//   - B7c: latency. The ledger calls it on ~1,024 shares, 16 blocks on 132
//     SMs, so a call lasts as long as one share's dependent chain: 64
//     accesses, each deriving the page that the last one's mix picked, and
//     256 parent rows an item, each picked by the mix the last row left:
//     16,384 dependent row reads through L2 once a page's two items are
//     derived side by side. It runs B7b light's pair of threads a share
//     (light_pair, a quad two shares), so that each step is a shuffle, a
//     fastmod and a row load; a pair past the count hashes the call's
//     last row again and judges nothing.
// Every loop is fully inlined: no call, no stack, no local array
// (chip_smoke.py phase 1 fails otherwise).
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "sha256_device.cuh"

// A counting build (-DETHASH_COUNT, ethash_cuda.instruction_counts) unrolls
// every loop and holds only straight-line kernels whose SASS is what a
// thread executes: dag_kernel (an item of the quad core), search_full_kernel
// and light1_count_kernel / light2_count_kernel (a thread of B7b light and
// B7c with one and two accesses: their difference is an access).
#ifdef ETHASH_COUNT
#define ETHASH_ROLLED _Pragma("unroll")
#else
#define ETHASH_ROLLED _Pragma("unroll 1")
#endif

namespace {

constexpr int kThreads = 128;
constexpr uint32_t kFull = 0xFFFFFFFFu;
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

// a % d for every 32-bit a and d >= 1 by a multiply-high (Lemire's fastmod):
// magic = floor((2^64 - 1) / d) + 1 mod 2^64, made on the host (magic_of);
// four IMADs where `%` by a run-time d takes ~15
// instructions
__device__ __forceinline__ uint32_t fastmod(uint32_t a, uint64_t magic, uint32_t d) {
  const uint64_t low = magic * a;
  const uint64_t t = (low & 0xFFFFFFFFull) * d;
  return static_cast<uint32_t>(((low >> 32) * d + (t >> 32)) >> 32);
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
__device__ __forceinline__ uint32_t cmix_word(const uint32_t m[4]) {
  return fnv(fnv(fnv(m[0], m[1]), m[2]), m[3]);
}

__device__ __forceinline__ void seal_cmix(const uint32_t s[16], const uint32_t cmix[8],
                                          uint32_t h[8]) {
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

__device__ __forceinline__ void seal(const uint32_t s[16], const uint32_t mix[32],
                                     uint32_t h[8]) {
  uint32_t cmix[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) cmix[i] = cmix_word(mix + 4 * i);
  seal_cmix(s, cmix, h);
}

__device__ __forceinline__ void init_mix(const uint32_t s[16], uint32_t mix[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) mix[i] = s[i & 15];
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

// -- the quad core (B7a, B7b light, B7c) -----------------------------------------

// p != 0 ? a : b in a predicated select that the compiler keeps as one (a
// select chain in C++ is turned back into an indexed load, and the words
// into a local-memory array)
__device__ __forceinline__ uint32_t sel(uint32_t p, uint32_t a, uint32_t b) {
  uint32_t r;
  asm("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %3, 0;\n\tselp.b32 %0, %1, %2, p;\n\t}"
      : "=r"(r)
      : "r"(a), "r"(b), "r"(p));
  return r;
}

// x[a % 16] for a run-time a: a tree of 15 selects on a's low four bits
__device__ __forceinline__ uint32_t pick16(const uint32_t x[16], uint32_t a) {
  uint32_t t[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) t[i] = sel(a & 1u, x[2 * i + 1], x[2 * i]);
#pragma unroll
  for (int i = 0; i < 4; ++i) t[i] = sel(a & 2u, t[2 * i + 1], t[2 * i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) t[i] = sel(a & 4u, t[2 * i + 1], t[2 * i]);
  return sel(a & 8u, t[1], t[0]);
}

// A quad's 4 x 4 transpose of 16-byte quarters: thread q's quarter j (words
// 4j .. 4j + 3 of x) becomes thread j's quarter q. Two xor-butterfly stages
// of 8 shuffles; its own inverse. q = lane % 4; every lane of the warp calls
// it.
__device__ __forceinline__ void quad_transpose(uint32_t x[16], uint32_t q) {
#pragma unroll
  for (uint32_t k = 1; k <= 2; k <<= 1) {
    const uint32_t up = q & k;
#pragma unroll
    for (uint32_t b = 0; b < 4; ++b) {
      if (b & k) continue;
#pragma unroll
      for (uint32_t w = 0; w < 4; ++w) {
        const uint32_t lo = x[4 * b + w];
        const uint32_t hi = x[4 * (b | k) + w];
        const uint32_t got = __shfl_xor_sync(kFull, up ? lo : hi, k);
        x[4 * b + w] = up ? got : lo;
        x[4 * (b | k) + w] = up ? hi : got;
      }
    }
  }
}

// Four dataset items by a quad of threads: item i is idx[i], thread q's own
// item is own = idx[q] (passed apart: idx is never indexed at run time), and
// thread q ends with its own item's 16 words in x. Each thread runs its own
// item's keccak-512s. Between them thread q holds quarter q of all four
// mixes: at parent j each item's word mix[j % 16] is broadcast from the
// thread that holds it, and each thread loads quarter q of the four parent
// rows, so the quad reads four whole 64-byte rows and a thread has four
// independent loads in flight. Every lane of the warp calls it.
__device__ __forceinline__ void derive_quad(const uint4* __restrict__ cache, uint32_t rows,
                                            uint64_t rows_magic, uint32_t q, uint32_t own,
                                            const uint32_t idx[4], uint32_t x[16]) {
  const uint4* row = cache + static_cast<size_t>(fastmod(own, rows_magic, rows)) * 4;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint4 v = __ldg(row + r);
    x[4 * r] = v.x;
    x[4 * r + 1] = v.y;
    x[4 * r + 2] = v.z;
    x[4 * r + 3] = v.w;
  }
  x[0] ^= own;
  keccak512<16>(x);
  quad_transpose(x, q);
  const uint4* quarter = cache + q;
  ETHASH_ROLLED
  for (int j0 = 0; j0 < kParents; j0 += 16) {
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      uint4 v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t word = __shfl_sync(kFull, x[4 * i + (jj & 3)], jj >> 2, 4);
        const uint32_t parent = fastmod(fnv(idx[i] ^ static_cast<uint32_t>(j0 + jj), word),
                                        rows_magic, rows);
        v[i] = __ldg(quarter + static_cast<size_t>(parent) * 4);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[4 * i] = fnv(x[4 * i], v[i].x);
        x[4 * i + 1] = fnv(x[4 * i + 1], v[i].y);
        x[4 * i + 2] = fnv(x[4 * i + 2], v[i].z);
        x[4 * i + 3] = fnv(x[4 * i + 3], v[i].w);
      }
    }
  }
  quad_transpose(x, q);
  keccak512<16>(x);
}

// One access of B7b light for the pair of threads (lanes 4m + 2p, 4m + 2p +
// 1; q = lane % 4, half = q & 1) that holds half `half` of a hash's mix:
// each hash's page from its word mix[a % 32] (word a % 16 of half (a / 16) %
// 2, from the thread that holds it), then the quad's four items (the two
// pages' two halves) by the quad core, this thread's folded into its half.
__device__ __forceinline__ void light_access(uint32_t a, uint32_t mix[16], uint32_t s0a,
                                             uint32_t s0b, const uint4* __restrict__ cache,
                                             uint32_t rows, uint64_t rows_magic,
                                             uint32_t n_pages, uint64_t pages_magic,
                                             uint32_t q) {
  const uint32_t mine = pick16(mix, a);
  const uint32_t owner = (a >> 4) & 1u;
  const uint32_t pa = fastmod(fnv(a ^ s0a, __shfl_sync(kFull, mine, owner, 4)),
                              pages_magic, n_pages);
  const uint32_t pb = fastmod(fnv(a ^ s0b, __shfl_sync(kFull, mine, 2 + owner, 4)),
                              pages_magic, n_pages);
  const uint32_t idx[4] = {2 * pa, 2 * pa + 1, 2 * pb, 2 * pb + 1};
  uint32_t item[16];
  derive_quad(cache, rows, rows_magic, q, 2 * ((q & 2) ? pb : pa) + (q & 1), idx, item);
#pragma unroll
  for (int w = 0; w < 16; ++w) mix[w] = fnv(mix[w], item[w]);
}

// The light hash (B7b light, B7c) for the pair of threads that hashes the
// header hash hh with the 64-bit nonce (lo, hi): the pair's first thread
// (half 0) runs the seed keccak-512 and the keccak-256 seal from its hh,
// each thread holds half `half` of the 32-word mix and derives that half's
// item of every page, beside the quad's other pair. The result's limbs land
// in h on the first thread only. Every lane of the warp calls it. accesses:
// 64, the loop rolled; the counting build's 1 or 2 are written out (a loop
// of two is left rolled there), from the opaque access a0.
template <int accesses>
__device__ __forceinline__ void light_pair(const uint32_t hh[8], uint32_t lo, uint32_t hi,
                                           const uint4* __restrict__ cache, uint32_t rows,
                                           uint64_t rows_magic, uint32_t n_pages,
                                           uint64_t pages_magic, uint32_t q, uint32_t a0,
                                           uint32_t h[8]) {
  const uint32_t half = q & 1;
  uint32_t s[16] = {};
  if (half == 0) seed_words(hh, lo, hi, s);
#pragma unroll
  for (int w = 0; w < 16; ++w) s[w] = __shfl_sync(kFull, s[w], q & 2, 4);
  const uint32_t s0a = __shfl_sync(kFull, s[0], 0, 4);
  const uint32_t s0b = __shfl_sync(kFull, s[0], 2, 4);
  // the mix's half (init_mix: each half starts as s), and this thread's
  // half of s for the seal
  uint32_t mix[16], sk[8];
#pragma unroll
  for (int w = 0; w < 16; ++w) mix[w] = s[w];
#pragma unroll
  for (int w = 0; w < 8; ++w) sk[w] = half ? s[8 + w] : s[w];
  if constexpr (accesses <= 2) {
    light_access(a0, mix, s0a, s0b, cache, rows, rows_magic, n_pages, pages_magic, q);
    if constexpr (accesses == 2)
      light_access(a0 + 1, mix, s0a, s0b, cache, rows, rows_magic, n_pages, pages_magic, q);
  } else {
    ETHASH_ROLLED
    for (uint32_t a = a0; a < a0 + static_cast<uint32_t>(accesses); ++a)
      light_access(a, mix, s0a, s0b, cache, rows, rows_magic, n_pages, pages_magic, q);
  }
  // cmix: words 0-3 from half 0's mix, 4-7 from half 1's
  uint32_t cmix[8], sfull[16];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    cmix[c] = cmix_word(mix + 4 * c);
    cmix[4 + c] = __shfl_xor_sync(kFull, cmix[c], 1);
  }
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    sfull[w] = sk[w];
    sfull[8 + w] = __shfl_xor_sync(kFull, sk[w], 1);
  }
  if (half == 0) seal_cmix(sfull, cmix, h);
}

}  // namespace

// B7a: items first .. first + n - 1 of the DAG, a quad of threads four
extern "C" __global__ void __launch_bounds__(kThreads)
    dag_kernel(const uint4* __restrict__ cache, uint32_t rows, uint64_t rows_magic,
               uint32_t first, uint32_t n, uint4* __restrict__ dag) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t base = first + (i & ~3u);
  const uint32_t idx[4] = {base, base + 1, base + 2, base + 3};
  uint32_t item[16];
  // every lane of a quad takes part (the last quad may reach past n)
  derive_quad(cache, rows, rows_magic, i & 3u, first + i, idx, item);
  if (i >= n) return;
  uint4* out = dag + static_cast<size_t>(first + i) * 4;
#pragma unroll
  for (int r = 0; r < 4; ++r)
    out[r] = make_uint4(item[4 * r], item[4 * r + 1], item[4 * r + 2], item[4 * r + 3]);
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

// B7b, light: lanes first .. first + n - 1 of the window, two threads a lane
template <int accesses>
__device__ __forceinline__ void search_light(const EthJob& job, const uint4* __restrict__ cache,
                                             uint32_t rows, uint64_t rows_magic,
                                             uint32_t n_pages, uint64_t pages_magic,
                                             uint32_t first, uint32_t n, uint32_t* out,
                                             int k, uint32_t a0) {
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t i = t >> 1;
  uint32_t h[8];
  // every pair takes part (the last quad may reach past n)
  light_pair<accesses>(job.hh, job.base + first + i, 0u, cache, rows, rows_magic, n_pages,
                       pages_magic, threadIdx.x & 3u, a0, h);
  uint32_t best = kNoWinner;
  if ((t & 1u) == 0 && i < n) {
    best = h[0];
    if (limbs_le(h, job.target)) take_slot(out, k, first + i, h[0]);
  }
  block_min_to<kThreads>(best, &out[2 * k + 2]);
}

#ifdef ETHASH_COUNT

// the counting build's own kernels: a thread of B7b light with one and with
// two accesses (from the access `first`, opaque to the compiler as a loop's
// index is)
extern "C" __global__ void __launch_bounds__(kThreads)
    light1_count_kernel(const EthJob job, const uint4* __restrict__ cache, uint32_t rows,
                        uint64_t rows_magic, uint32_t n_pages, uint64_t pages_magic,
                        uint32_t first, uint32_t n, uint32_t* out, int k) {
  search_light<1>(job, cache, rows, rows_magic, n_pages, pages_magic, first, n, out, k,
                  first);
}

extern "C" __global__ void __launch_bounds__(kThreads)
    light2_count_kernel(const EthJob job, const uint4* __restrict__ cache, uint32_t rows,
                        uint64_t rows_magic, uint32_t n_pages, uint64_t pages_magic,
                        uint32_t first, uint32_t n, uint32_t* out, int k) {
  search_light<2>(job, cache, rows, rows_magic, n_pages, pages_magic, first, n, out, k,
                  first);
}

#else

extern "C" __global__ void __launch_bounds__(kThreads)
    search_light_kernel(const EthJob job, const uint4* __restrict__ cache, uint32_t rows,
                        uint64_t rows_magic, uint32_t n_pages, uint64_t pages_magic,
                        uint32_t first, uint32_t n, uint32_t* out, int k) {
  search_light<kAccesses>(job, cache, rows, rows_magic, n_pages, pages_magic, first, n, out,
                          k, 0u);
}

// B7c: rows first .. first + n - 1 (n >= 1): hh [rows, 8] LE header-hash
// words, nonces [rows, 2] (the 64-bit LE nonce as two words), limbs [rows,
// 8]. Two threads a share, a quad two (light_pair); the pair's first thread
// loads the row and judges it. A pair past n hashes row first + n - 1 again
// (every pair of a quad takes part in its shuffles) and reads no row past
// the call's.
extern "C" __global__ void __launch_bounds__(kThreads)
    verify_kernel(const uint32_t* __restrict__ hh, const uint32_t* __restrict__ nonces,
                  const uint32_t* __restrict__ limbs, const uint4* __restrict__ cache,
                  uint32_t rows, uint64_t rows_magic, uint32_t n_pages, uint64_t pages_magic,
                  uint32_t first, uint32_t n, uint32_t* out, int k) {
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t i = t >> 1;
  const bool judge = (t & 1u) == 0 && i < n;
  const size_t r = static_cast<size_t>(first) + (i < n ? i : n - 1);
  uint32_t hw[8] = {}, lo = 0, hi = 0, h[8];
  if ((t & 1u) == 0) {
#pragma unroll
    for (int w = 0; w < 8; ++w) hw[w] = __ldg(&hh[r * 8 + w]);
    lo = __ldg(&nonces[r * 2]);
    hi = __ldg(&nonces[r * 2 + 1]);
  }
  light_pair<kAccesses>(hw, lo, hi, cache, rows, rows_magic, n_pages, pages_magic,
                        threadIdx.x & 3u, 0u, h);
  uint32_t best = kNoWinner;
  if (judge) {
    uint32_t tg[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) tg[w] = __ldg(&limbs[r * 8 + w]);
    best = h[0];
    if (!limbs_le(h, tg)) take_slot(out, k, first + i, h[0]);
  }
  block_min_to<kThreads>(best, &out[2 * k + 2]);
}

// Not a port: a probe of the rate at which the L2 serves B7a's and B7b
// light's reads. Each quad reads 4 random 64-byte rows of buf (2^row_bits
// rows; 16 MiB at 18) at a time, a quarter a thread as derive_quad does,
// `steps` times; the rows come from an LCG and not from the data, so many
// are in flight. sink is written only if a thread's xor of its words hits a
// constant: the loads stay.
extern "C" __global__ void __launch_bounds__(kThreads)
    l2_probe_kernel(const uint4* __restrict__ buf, uint32_t row_bits, uint32_t steps,
                    uint32_t* sink) {
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  uint32_t r[4];
#pragma unroll
  for (uint32_t i = 0; i < 4; ++i) r[i] = (t >> 2) * 0x9E3779B9u + i * 0x85EBCA6Bu;
  const uint4* quarter = buf + (threadIdx.x & 3u);
  uint32_t acc = 0;
#pragma unroll 4
  for (uint32_t s = 0; s < steps; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r[i] = r[i] * 1664525u + 1013904223u;
      const uint4 v = __ldg(quarter + static_cast<size_t>(r[i] >> (32 - row_bits)) * 4);
      acc ^= v.x ^ v.y ^ v.z ^ v.w;
    }
  }
  if (acc == 0x5EED5EEDu) sink[t] = acc;
}

// Not a port: a probe of the latency of B7c's step, one dependent cache-row
// read. Each quad of the one warp launched walks a chain of `steps` rows
// (a multiple of 16) of the cache, a quarter a thread, as derive_quad
// reads them: step j's row is fastmod(fnv(j, word), rows) of word j % 16 of
// the row it loaded last, broadcast by a shuffle from the thread that holds
// it, and the row is folded into the thread's quarter. sink as the L2
// probe's.
extern "C" __global__ void __launch_bounds__(kThreads)
    chase_probe_kernel(const uint4* __restrict__ cache, uint32_t rows, uint64_t rows_magic,
                       uint32_t steps, uint32_t* sink) {
  const uint4* quarter = cache + (threadIdx.x & 3u);
  uint4 v = __ldg(quarter + static_cast<size_t>(threadIdx.x >> 2) * 4);
  uint32_t x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll 1
  for (uint32_t j0 = 0; j0 < steps; j0 += 16) {
#pragma unroll
    for (uint32_t jj = 0; jj < 16; ++jj) {
      const uint32_t word = __shfl_sync(kFull, x[jj & 3], jj >> 2, 4);
      v = __ldg(quarter + static_cast<size_t>(fastmod(fnv(j0 + jj, word), rows_magic, rows)) * 4);
      x[0] = fnv(x[0], v.x);
      x[1] = fnv(x[1], v.y);
      x[2] = fnv(x[2], v.z);
      x[3] = fnv(x[3], v.w);
    }
  }
  const uint32_t acc = x[0] ^ x[1] ^ x[2] ^ x[3];
  if (acc == 0x5EED5EEDu) sink[threadIdx.x] = acc;
}

namespace {

unsigned int blocks_for(uint64_t threads) {
  return static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
}

// the fastmod magic of d >= 1
uint64_t magic_of(uint32_t d) { return ~0ull / d + 1; }

// the kernels by number, for their attributes: 1 dag, 2 search full, 3
// search light, 4 verify, 5 the L2 probe
const void* kernel_fn(int which) {
  switch (which) {
    case 1: return reinterpret_cast<const void*>(dag_kernel);
    case 2: return reinterpret_cast<const void*>(search_full_kernel);
    case 3: return reinterpret_cast<const void*>(search_light_kernel);
    case 4: return reinterpret_cast<const void*>(verify_kernel);
    case 5: return reinterpret_cast<const void*>(l2_probe_kernel);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// B7a on `stream`, without synchronizing: items first .. first + n - 1 of
// the DAG (device, n_items x 16 words, page-major = item-major) from the
// cache (device, rows x 16 words, 16-byte aligned). Returns a cudaError_t.
int otedama_ethash_dag(const uint32_t* cache, unsigned int rows, unsigned long long first,
                       unsigned long long n, uint32_t* dag, void* stream) {
  if (rows == 0 || first + n > (1ull << 32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  dag_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(cache), rows, magic_of(rows), static_cast<uint32_t>(first),
      static_cast<uint32_t>(n), reinterpret_cast<uint4*>(dag));
  return static_cast<int>(cudaGetLastError());
}

// B7b on `stream`, without synchronizing: `lanes` lanes (< 2^32) of the job
// (host pointer to its 17 words), the buffer's init, the search kernels and
// the finalize into out (device, 2k+3 words). full != 0: src is the DAG's
// pages (device, n_pages x 32 words); else the cache (rows x 16 words).
// Returns a cudaError_t.
int otedama_ethash_search(const uint32_t* job, int full, const uint32_t* src,
                          unsigned int rows, unsigned int n_pages, unsigned long long lanes,
                          int k, uint32_t* out, void* stream) {
  if (k < 1 || n_pages == 0 || lanes >= (1ull << 32) || (!full && rows == 0))
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
      search_light_kernel<<<blocks_for(2 * n), kThreads, 0, st>>>(
          j, s4, rows, magic_of(rows), n_pages, magic_of(n_pages), static_cast<uint32_t>(first),
          static_cast<uint32_t>(n), out, k);
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
    verify_kernel<<<blocks_for(2 * n), kThreads, 0, st>>>(
        hh, nonces, limbs, reinterpret_cast<const uint4*>(cache), rows, magic_of(rows),
        n_pages, magic_of(n_pages), static_cast<uint32_t>(first), static_cast<uint32_t>(n),
        out, k);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  finalize_buffer<<<1, 1, 0, st>>>(out, k, 0u);
  return static_cast<int>(cudaGetLastError());
}

// The L2 probe on `stream`, without synchronizing: `blocks` blocks of
// l2_probe_kernel over buf (device, 2^row_bits rows of 16 words), each quad
// reading 4 x `steps` rows; sink: device, blocks x 128 words. Returns a
// cudaError_t.
int otedama_ethash_l2_probe(const uint32_t* buf, unsigned int row_bits, unsigned int blocks,
                            unsigned int steps, uint32_t* sink, void* stream) {
  if (row_bits == 0 || row_bits > 26 || blocks == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  l2_probe_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(buf), row_bits, steps, sink);
  return static_cast<int>(cudaGetLastError());
}

// The chase probe on `stream`, without synchronizing: one warp of
// chase_probe_kernel over the cache (device, rows x 16 words), each quad
// walking `steps` (a multiple of 16) dependent rows; sink: device, 32
// words. Returns a cudaError_t.
int otedama_ethash_chase_probe(const uint32_t* cache, unsigned int rows, unsigned int steps,
                               uint32_t* sink, void* stream) {
  if (rows < 8 || steps % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  chase_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(cache), rows, magic_of(rows), steps, sink);
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
