// Kernel B6: the x11 chain on the card, for the nonce search and for share
// validation. It replaces the device tier that the JAX package runs through
// XLA, without Pallas: otedama_tpu/kernels/x11/jnp_chain.py x11_winner_step
// (:853) and x11_verify_step (:878) over x11_digest_chain (:814).
//
// What it computes is that package's chain, bit for bit, under each of the
// five shavite counter orders (an argument): blake512 of the 80-byte header,
// then bmw512, groestl512, skein512, jh512, keccak512, luffa512, cubehash512,
// shavite512, simd512 and echo512 of each 64-byte digest, the first 32 bytes
// compared EXACTLY (256-bit, little-endian value) against a target, and the
// lanes compacted into the shared uint32[2k+3] buffer (sha256_device.cuh):
//   - the search: lane i hashes the 76-byte prefix with nonce word base + i
//     (mod 2^32, big-endian at bytes 76:80), built here on the card;
//     WINNERS go into the table as lane offsets;
//   - the verify: lane i hashes its own row of 20 big-endian header words
//     against its own 8 target limbs; FAILURES go into the table as lane
//     offsets.
// Winners take slots with atomicAdd and a one-thread finalize launch sorts
// them by offset, so for n <= k the buffer equals the reference's lane-order
// compaction word for word; the min top limb covers the in-range lanes.
//
// Design: a kernel a stage, each sized for its own registers and fully
// inlined (no call, no stack, no local array). Between the kernels each
// lane's 64-byte value lives in a state buffer of eight 64-bit words a lane
// (word-major: word w of lane i at w * cap + i), which the caller owns (the
// backend, or the call) and the wrapper walks through in chunks small
// enough to stay in L2 (x11_cuda.chunk_plan). The first kernel makes the
// header (search) or reads its row (verify) and runs blake; the last runs
// echo, compares and compacts. What bounds it: integer instructions on the
// ALU and FMA pipes, and for groestl the shared-memory reads of its table
// lookups. So:
//   - groestl, shavite and echo read their T-tables from shared memory
//     copies replicated across the banks (x11_cuda.table_block builds them):
//     groestl's four 64-bit tables (tables 4-7 are tables 0-3 with their
//     halves swapped) sixteen times, one copy per bank pair, read by lane
//     mod 16; the four AES tables thirty-two times, one copy per bank, read
//     by lane mod 32. A warp's lookup is then free of bank conflicts. They
//     run as 512-thread blocks, one an SM (128 KiB of tables), looping over
//     the lanes; a lookup's address is an IMAD by a stride passed at run
//     time (the FMA pipe, beside the ALU pipe's byte extraction);
//   - simd runs on a group of 8 threads a lane: its 256-point NTT over
//     Z_257 splits as 256 = 8 x 32 with 64 nonzero inputs, so thread j
//     computes outputs j + 8m (m < 32) alone, a 32-point NTT in registers
//     (reductions mod 257 as (x & 255) - (x >> 8), ranges known); it then
//     holds exactly the expanded words that the compression's column j
//     reads, and the compression runs a column a thread, the lane
//     permutation a __shfl_xor_sync within the group;
//   - the other stages run a thread a lane on their words in registers.
// chip_smoke.py phase 1 prints every kernel's registers, spills, stack and
// resident warps, phase 33 the chain's and each stage's time beside the
// bound.
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "sha256_device.cuh"

// A counting build (-DX11_COUNT=S, x11_cuda.chain_instructions) unrolls
// every round loop and holds only x11_count_kernel, stage S of the chain
// (1-11 in chain order; 0: none) of one lane in straight-line code (simd:
// one of its group's 8 threads): its SASS is the instructions a lane (a
// thread) executes there. It is compiled for its SASS and never launched.
#ifdef X11_COUNT
#define X11_ROUNDS _Pragma("unroll")
#else
#define X11_ROUNDS
#endif

namespace {

// the table block (uint32 words; x11_cuda.table_block builds it)
constexpr int kGroOff = 0;           // [4][256][16] groestl, 64-bit entries
constexpr int kAesOff = 32768;       // [4][256][32] AES T-tables
constexpr int kJhIvOff = 65536;      // [16] jh IV, big-endian 64-bit words
constexpr int kJhCOff = 65568;       // [42][4] jh round constants, 64-bit
constexpr int kCubeIvOff = 65904;    // [32] cubehash IV
constexpr int kSimdCOff = 65936;     // [64][8] 41^(n j) mod 257
constexpr int kTwistOff = 66448;     // [256] simd twist 163^k mod 257
constexpr int kWFinalOff = 66704;    // [256] simd final block's words
constexpr int kTableWords = 66960;
// the replicated tables a block copies into shared memory (either region)
constexpr int kTabBytes = 131072;
// a lookup's stride in bytes (x11_cuda.ROW_BYTES): entry (t, x) of table t
// at byte t * 32768 + x * 128 + copy * (8 or 4)
constexpr uint32_t kRowBytes = 128;

__constant__ uint64_t kBlakeIV[8] = {
    0x6A09E667F3BCC908ull, 0xBB67AE8584CAA73Bull, 0x3C6EF372FE94F82Bull, 0xA54FF53A5F1D36F1ull,
    0x510E527FADE682D1ull, 0x9B05688C2B3E6C1Full, 0x1F83D9ABFB41BD6Bull, 0x5BE0CD19137E2179ull,
};
__constant__ uint64_t kBlakeC[16] = {
    0x243F6A8885A308D3ull, 0x13198A2E03707344ull, 0xA4093822299F31D0ull, 0x082EFA98EC4E6C89ull,
    0x452821E638D01377ull, 0xBE5466CF34E90C6Cull, 0xC0AC29B7C97C50DDull, 0x3F84D5B5B5470917ull,
    0x9216D5D98979FB1Bull, 0xD1310BA698DFB5ACull, 0x2FFD72DBD01ADFB7ull, 0xB8E1AFED6A267E96ull,
    0xBA7C9045F12C7F99ull, 0x24A19947B3916CF7ull, 0x0801F2E2858EFC16ull, 0x636920D871574E69ull,
};
__constant__ uint64_t kSkeinIV[8] = {
    0x4903ADFF749C51CEull, 0x0D95DE399746DF03ull, 0x8FD1934127C79BCEull, 0x9A255629FF352CB1ull,
    0x5DB62599DF6CA7B0ull, 0xEABE394CA9D5C3F4ull, 0x991112C71A75B523ull, 0xAE18A40B660FCC33ull,
};
__constant__ uint64_t kKeccakRC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull, 0x8000000080008000ull,
    0x000000000000808Bull, 0x0000000080000001ull, 0x8000000080008081ull, 0x8000000000008009ull,
    0x000000000000008Aull, 0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull, 0x8000000000008003ull,
    0x8000000000008002ull, 0x8000000000000080ull, 0x000000000000800Aull, 0x800000008000000Aull,
    0x8000000080008081ull, 0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};
__constant__ uint32_t kLuffaIV[5][8] = {
    0x6D251E69u, 0x44B051E0u, 0x4EAA6FB4u, 0xDBF78465u, 0x6E292011u, 0x90152DF4u, 0xEE058139u, 0xDEF610BBu,
    0xC3B44B95u, 0xD9D2F256u, 0x70EEE9A0u, 0xDE099FA3u, 0x5D9B0557u, 0x8FC944B3u, 0xCF1CCF0Eu, 0x746CD581u,
    0xF7EFC89Du, 0x5DBA5781u, 0x04016CE5u, 0xAD659C05u, 0x0306194Fu, 0x666D1836u, 0x24AA230Au, 0x8B264AE7u,
    0x858075D5u, 0x36D79CCEu, 0xE571F7D7u, 0x204B1F67u, 0x35870C6Au, 0x57E9E923u, 0x14BCB808u, 0x7CDE72CEu,
    0x6C68E9BEu, 0x5EC41E22u, 0xC825B7C7u, 0xAFFB4363u, 0xF5DF3999u, 0x0FC688F1u, 0xB07224CCu, 0x03E86CEAu,
};
__constant__ uint32_t kLuffaCNS[5][8][2] = {
    0x303994A6u, 0xE0337818u, 0xC0E65299u, 0x441BA90Du, 0x6CC33A12u, 0x7F34D442u, 0xDC56983Eu, 0x9389217Fu,
    0x1E00108Fu, 0xE5A8BCE6u, 0x7800423Du, 0x5274BAF4u, 0x8F5B7882u, 0x26889BA7u, 0x96E1DB12u, 0x9A226E9Du,
    0xB6DE10EDu, 0x01685F3Du, 0x70F47AAEu, 0x05A17CF4u, 0x0707A3D4u, 0xBD09CACAu, 0x1C1E8F51u, 0xF4272B28u,
    0x707A3D45u, 0x144AE5CCu, 0xAEB28562u, 0xFAA7AE2Bu, 0xBACA1589u, 0x2E48F1C1u, 0x40A46F3Eu, 0xB923C704u,
    0xFC20D9D2u, 0xE25E72C1u, 0x34552E25u, 0xE623BB72u, 0x7AD8818Fu, 0x5C58A4A4u, 0x8438764Au, 0x1E38E2E7u,
    0xBB6DE032u, 0x78E38B9Du, 0xEDB780C8u, 0x27586719u, 0xD9847356u, 0x36EDA57Fu, 0xA2C78434u, 0x703AACE7u,
    0xB213AFA5u, 0xE028C9BFu, 0xC84EBE95u, 0x44756F91u, 0x4E608A22u, 0x7E8FCE32u, 0x56D858FEu, 0x956548BEu,
    0x343B138Fu, 0xFE191BE2u, 0xD0EC4E3Du, 0x3CB226E5u, 0x2CEB4882u, 0x5944A28Eu, 0xB3AD2208u, 0xA1C4C355u,
    0xF0D2E9E3u, 0x5090D577u, 0xAC11D7FAu, 0x2D1925ABu, 0x1BCB66F2u, 0xB46496ACu, 0x6F2D9BC9u, 0xD1925AB0u,
    0x78602649u, 0x29131AB6u, 0x8EDAE952u, 0x0FC053C3u, 0x3B6BA548u, 0x3F014F0Cu, 0xEDAE9520u, 0xFC053C31u,
};
__constant__ uint32_t kShaviteIV[16] = {
    0x72FCCDD8u, 0x79CA4727u, 0x128A077Bu, 0x40D55AECu, 0xD1901A06u, 0x430AE307u, 0xB29F5CD1u, 0xDF07FBFCu,
    0x8E45D73Du, 0x681AB538u, 0xBDE86578u, 0xDD577E47u, 0xE275EADEu, 0x502D9FCDu, 0xB9357178u, 0x022A4B9Au,
};
__constant__ uint32_t kSimdIV[32] = {
    0x0BA16B95u, 0x72F999ADu, 0x9FECC2AEu, 0xBA3264FCu, 0x5E894929u, 0x8E9F30E5u, 0x2F1DAA37u, 0xF0F2C558u,
    0xAC506643u, 0xA90635A5u, 0xE25B878Bu, 0xAAB7878Fu, 0x88817F7Au, 0x0A02892Bu, 0x559A7550u, 0x598F657Eu,
    0x7EEF60A1u, 0x6B70E3E8u, 0x9C1714D1u, 0xB958E2A8u, 0xAB02675Eu, 0xED1C014Fu, 0xCD8D65BBu, 0xFDB7A257u,
    0x09254899u, 0xD699C7BCu, 0x9019B6DCu, 0x2B9022E4u, 0x8FA14956u, 0x21BF9BD3u, 0xB94D0943u, 0x6FFDDC22u,
};

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int n) {
  return (x << n) | (x >> (64 - n));
}
__device__ __forceinline__ uint64_t rotl640(uint64_t x) { return x; }
__device__ __forceinline__ uint32_t rotl32(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}
__device__ __forceinline__ uint64_t bswap64(uint64_t x) {
  return (static_cast<uint64_t>(bswap32(static_cast<uint32_t>(x))) << 32) |
         bswap32(static_cast<uint32_t>(x >> 32));
}
__device__ __forceinline__ uint32_t lo32(uint64_t x) {
  return static_cast<uint32_t>(x);
}
__device__ __forceinline__ uint32_t hi32(uint64_t x) {
  return static_cast<uint32_t>(x >> 32);
}
__device__ __forceinline__ uint64_t join64(uint32_t lo, uint32_t hi) {
  return static_cast<uint64_t>(lo) | (static_cast<uint64_t>(hi) << 32);
}

// Work moved from the SM's ALU pipe to its FMA pipe (IMAD, IMAD.HI) where
// it paid on the card (jh's bit swaps; blake's and skein's adds, luffa's
// and cubehash's rotates ran slower there): the powers of two as launch
// parameters, so that ptxas keeps the multiplies (it folds literals into
// shifts on the ALU pipe).
struct Fma {
  uint32_t pow2[32];     // 2^r
};

// ---- 1. blake512 of the 80-byte header ---------------------------------------

#define BLAKE_G(a, b, c, d, x, y)                       \
  do {                                                  \
    v[a] += v[b] + (m[x] ^ kBlakeC[y]);                 \
    v[d] = rotl64(v[d] ^ v[a], 32);                     \
    v[c] += v[d];                                       \
    v[b] = rotl64(v[b] ^ v[c], 39);                     \
    v[a] += v[b] + (m[y] ^ kBlakeC[x]);                 \
    v[d] = rotl64(v[d] ^ v[a], 48);                     \
    v[c] += v[d];                                       \
    v[b] = rotl64(v[b] ^ v[c], 53);                     \
  } while (0)

// hw: the header's ten big-endian 64-bit words; h: the digest as eight
// little-endian 64-bit words (the form every later stage takes)
__device__ __forceinline__ void blake512_80(const uint64_t hw[10], uint64_t h[8]) {
  uint64_t m[16];
#pragma unroll
  for (int i = 0; i < 10; ++i) m[i] = hw[i];
  m[10] = 0x8000000000000000ull;
  m[11] = 0;
  m[12] = 0;
  m[13] = 1;
  m[14] = 0;
  m[15] = 640;
  uint64_t v[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = kBlakeIV[i];
  v[8] = kBlakeC[0];
  v[9] = kBlakeC[1];
  v[10] = kBlakeC[2];
  v[11] = kBlakeC[3];
  v[12] = 640ull ^ kBlakeC[4];
  v[13] = 640ull ^ kBlakeC[5];
  v[14] = kBlakeC[6];
  v[15] = kBlakeC[7];
  BLAKE_G(0, 4, 8, 12, 0, 1);
  BLAKE_G(1, 5, 9, 13, 2, 3);
  BLAKE_G(2, 6, 10, 14, 4, 5);
  BLAKE_G(3, 7, 11, 15, 6, 7);
  BLAKE_G(0, 5, 10, 15, 8, 9);
  BLAKE_G(1, 6, 11, 12, 10, 11);
  BLAKE_G(2, 7, 8, 13, 12, 13);
  BLAKE_G(3, 4, 9, 14, 14, 15);
  BLAKE_G(0, 4, 8, 12, 14, 10);
  BLAKE_G(1, 5, 9, 13, 4, 8);
  BLAKE_G(2, 6, 10, 14, 9, 15);
  BLAKE_G(3, 7, 11, 15, 13, 6);
  BLAKE_G(0, 5, 10, 15, 1, 12);
  BLAKE_G(1, 6, 11, 12, 0, 2);
  BLAKE_G(2, 7, 8, 13, 11, 7);
  BLAKE_G(3, 4, 9, 14, 5, 3);
  BLAKE_G(0, 4, 8, 12, 11, 8);
  BLAKE_G(1, 5, 9, 13, 12, 0);
  BLAKE_G(2, 6, 10, 14, 5, 2);
  BLAKE_G(3, 7, 11, 15, 15, 13);
  BLAKE_G(0, 5, 10, 15, 10, 14);
  BLAKE_G(1, 6, 11, 12, 3, 6);
  BLAKE_G(2, 7, 8, 13, 7, 1);
  BLAKE_G(3, 4, 9, 14, 9, 4);
  BLAKE_G(0, 4, 8, 12, 7, 9);
  BLAKE_G(1, 5, 9, 13, 3, 1);
  BLAKE_G(2, 6, 10, 14, 13, 12);
  BLAKE_G(3, 7, 11, 15, 11, 14);
  BLAKE_G(0, 5, 10, 15, 2, 6);
  BLAKE_G(1, 6, 11, 12, 5, 10);
  BLAKE_G(2, 7, 8, 13, 4, 0);
  BLAKE_G(3, 4, 9, 14, 15, 8);
  BLAKE_G(0, 4, 8, 12, 9, 0);
  BLAKE_G(1, 5, 9, 13, 5, 7);
  BLAKE_G(2, 6, 10, 14, 2, 4);
  BLAKE_G(3, 7, 11, 15, 10, 15);
  BLAKE_G(0, 5, 10, 15, 14, 1);
  BLAKE_G(1, 6, 11, 12, 11, 12);
  BLAKE_G(2, 7, 8, 13, 6, 8);
  BLAKE_G(3, 4, 9, 14, 3, 13);
  BLAKE_G(0, 4, 8, 12, 2, 12);
  BLAKE_G(1, 5, 9, 13, 6, 10);
  BLAKE_G(2, 6, 10, 14, 0, 11);
  BLAKE_G(3, 7, 11, 15, 8, 3);
  BLAKE_G(0, 5, 10, 15, 4, 13);
  BLAKE_G(1, 6, 11, 12, 7, 5);
  BLAKE_G(2, 7, 8, 13, 15, 14);
  BLAKE_G(3, 4, 9, 14, 1, 9);
  BLAKE_G(0, 4, 8, 12, 12, 5);
  BLAKE_G(1, 5, 9, 13, 1, 15);
  BLAKE_G(2, 6, 10, 14, 14, 13);
  BLAKE_G(3, 7, 11, 15, 4, 10);
  BLAKE_G(0, 5, 10, 15, 0, 7);
  BLAKE_G(1, 6, 11, 12, 6, 3);
  BLAKE_G(2, 7, 8, 13, 9, 2);
  BLAKE_G(3, 4, 9, 14, 8, 11);
  BLAKE_G(0, 4, 8, 12, 13, 11);
  BLAKE_G(1, 5, 9, 13, 7, 14);
  BLAKE_G(2, 6, 10, 14, 12, 1);
  BLAKE_G(3, 7, 11, 15, 3, 9);
  BLAKE_G(0, 5, 10, 15, 5, 0);
  BLAKE_G(1, 6, 11, 12, 15, 4);
  BLAKE_G(2, 7, 8, 13, 8, 6);
  BLAKE_G(3, 4, 9, 14, 2, 10);
  BLAKE_G(0, 4, 8, 12, 6, 15);
  BLAKE_G(1, 5, 9, 13, 14, 9);
  BLAKE_G(2, 6, 10, 14, 11, 3);
  BLAKE_G(3, 7, 11, 15, 0, 8);
  BLAKE_G(0, 5, 10, 15, 12, 2);
  BLAKE_G(1, 6, 11, 12, 13, 7);
  BLAKE_G(2, 7, 8, 13, 1, 4);
  BLAKE_G(3, 4, 9, 14, 10, 5);
  BLAKE_G(0, 4, 8, 12, 10, 2);
  BLAKE_G(1, 5, 9, 13, 8, 4);
  BLAKE_G(2, 6, 10, 14, 7, 6);
  BLAKE_G(3, 7, 11, 15, 1, 5);
  BLAKE_G(0, 5, 10, 15, 15, 11);
  BLAKE_G(1, 6, 11, 12, 9, 14);
  BLAKE_G(2, 7, 8, 13, 3, 12);
  BLAKE_G(3, 4, 9, 14, 13, 0);
  BLAKE_G(0, 4, 8, 12, 0, 1);
  BLAKE_G(1, 5, 9, 13, 2, 3);
  BLAKE_G(2, 6, 10, 14, 4, 5);
  BLAKE_G(3, 7, 11, 15, 6, 7);
  BLAKE_G(0, 5, 10, 15, 8, 9);
  BLAKE_G(1, 6, 11, 12, 10, 11);
  BLAKE_G(2, 7, 8, 13, 12, 13);
  BLAKE_G(3, 4, 9, 14, 14, 15);
  BLAKE_G(0, 4, 8, 12, 14, 10);
  BLAKE_G(1, 5, 9, 13, 4, 8);
  BLAKE_G(2, 6, 10, 14, 9, 15);
  BLAKE_G(3, 7, 11, 15, 13, 6);
  BLAKE_G(0, 5, 10, 15, 1, 12);
  BLAKE_G(1, 6, 11, 12, 0, 2);
  BLAKE_G(2, 7, 8, 13, 11, 7);
  BLAKE_G(3, 4, 9, 14, 5, 3);
  BLAKE_G(0, 4, 8, 12, 11, 8);
  BLAKE_G(1, 5, 9, 13, 12, 0);
  BLAKE_G(2, 6, 10, 14, 5, 2);
  BLAKE_G(3, 7, 11, 15, 15, 13);
  BLAKE_G(0, 5, 10, 15, 10, 14);
  BLAKE_G(1, 6, 11, 12, 3, 6);
  BLAKE_G(2, 7, 8, 13, 7, 1);
  BLAKE_G(3, 4, 9, 14, 9, 4);
  BLAKE_G(0, 4, 8, 12, 7, 9);
  BLAKE_G(1, 5, 9, 13, 3, 1);
  BLAKE_G(2, 6, 10, 14, 13, 12);
  BLAKE_G(3, 7, 11, 15, 11, 14);
  BLAKE_G(0, 5, 10, 15, 2, 6);
  BLAKE_G(1, 6, 11, 12, 5, 10);
  BLAKE_G(2, 7, 8, 13, 4, 0);
  BLAKE_G(3, 4, 9, 14, 15, 8);
  BLAKE_G(0, 4, 8, 12, 9, 0);
  BLAKE_G(1, 5, 9, 13, 5, 7);
  BLAKE_G(2, 6, 10, 14, 2, 4);
  BLAKE_G(3, 7, 11, 15, 10, 15);
  BLAKE_G(0, 5, 10, 15, 14, 1);
  BLAKE_G(1, 6, 11, 12, 11, 12);
  BLAKE_G(2, 7, 8, 13, 6, 8);
  BLAKE_G(3, 4, 9, 14, 3, 13);
  BLAKE_G(0, 4, 8, 12, 2, 12);
  BLAKE_G(1, 5, 9, 13, 6, 10);
  BLAKE_G(2, 6, 10, 14, 0, 11);
  BLAKE_G(3, 7, 11, 15, 8, 3);
  BLAKE_G(0, 5, 10, 15, 4, 13);
  BLAKE_G(1, 6, 11, 12, 7, 5);
  BLAKE_G(2, 7, 8, 13, 15, 14);
  BLAKE_G(3, 4, 9, 14, 1, 9);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = bswap64(kBlakeIV[i] ^ v[i] ^ v[i + 8]);
}

// ---- 2. bmw512 ----------------------------------------------------------------

__device__ __forceinline__ uint64_t bmw_s0(uint64_t x) {
  return (x >> 1) ^ (x << 3) ^ rotl64(x, 4) ^ rotl64(x, 37);
}
__device__ __forceinline__ uint64_t bmw_s1(uint64_t x) {
  return (x >> 1) ^ (x << 2) ^ rotl64(x, 13) ^ rotl64(x, 43);
}
__device__ __forceinline__ uint64_t bmw_s2(uint64_t x) {
  return (x >> 2) ^ (x << 1) ^ rotl64(x, 19) ^ rotl64(x, 53);
}
__device__ __forceinline__ uint64_t bmw_s3(uint64_t x) {
  return (x >> 2) ^ (x << 2) ^ rotl64(x, 28) ^ rotl64(x, 59);
}
__device__ __forceinline__ uint64_t bmw_s4(uint64_t x) { return (x >> 1) ^ x; }
__device__ __forceinline__ uint64_t bmw_s5(uint64_t x) { return (x >> 2) ^ x; }

// H = f2(f1(f0(M, H)), M, H), in place
__device__ __forceinline__ void bmw_compress(uint64_t H[16], const uint64_t M[16]) {
  uint64_t T[16], Q[32];
#pragma unroll
  for (int i = 0; i < 16; ++i) T[i] = M[i] ^ H[i];
  Q[0] = bmw_s0(T[5] - T[7] + T[10] + T[13] + T[14]) + H[1];
  Q[1] = bmw_s1(T[6] - T[8] + T[11] + T[14] - T[15]) + H[2];
  Q[2] = bmw_s2(T[0] + T[7] + T[9] - T[12] + T[15]) + H[3];
  Q[3] = bmw_s3(T[0] - T[1] + T[8] - T[10] + T[13]) + H[4];
  Q[4] = bmw_s4(T[1] + T[2] + T[9] - T[11] - T[14]) + H[5];
  Q[5] = bmw_s0(T[3] - T[2] + T[10] - T[12] + T[15]) + H[6];
  Q[6] = bmw_s1(T[4] - T[0] - T[3] - T[11] + T[13]) + H[7];
  Q[7] = bmw_s2(T[1] - T[4] - T[5] - T[12] - T[14]) + H[8];
  Q[8] = bmw_s3(T[2] - T[5] - T[6] + T[13] - T[15]) + H[9];
  Q[9] = bmw_s4(T[0] - T[3] + T[6] - T[7] + T[14]) + H[10];
  Q[10] = bmw_s0(T[8] - T[1] - T[4] - T[7] + T[15]) + H[11];
  Q[11] = bmw_s1(T[8] - T[0] - T[2] - T[5] + T[9]) + H[12];
  Q[12] = bmw_s2(T[1] + T[3] - T[6] - T[9] + T[10]) + H[13];
  Q[13] = bmw_s3(T[2] + T[4] + T[7] + T[10] + T[11]) + H[14];
  Q[14] = bmw_s4(T[3] - T[5] + T[8] - T[11] - T[12]) + H[15];
  Q[15] = bmw_s0(T[12] - T[4] - T[6] - T[9] + T[13]) + H[0];
  Q[16] = bmw_s1(Q[0]) + bmw_s2(Q[1]) + bmw_s3(Q[2]) + bmw_s0(Q[3]) + bmw_s1(Q[4]) + bmw_s2(Q[5]) + bmw_s3(Q[6]) + bmw_s0(Q[7]) + bmw_s1(Q[8]) + bmw_s2(Q[9]) + bmw_s3(Q[10]) + bmw_s0(Q[11]) + bmw_s1(Q[12]) + bmw_s2(Q[13]) + bmw_s3(Q[14]) + bmw_s0(Q[15]) + ((rotl64(M[0], 1) + rotl64(M[3], 4) - rotl64(M[10], 11) + 0x5555555555555550ull) ^ H[7]);
  Q[17] = bmw_s1(Q[1]) + bmw_s2(Q[2]) + bmw_s3(Q[3]) + bmw_s0(Q[4]) + bmw_s1(Q[5]) + bmw_s2(Q[6]) + bmw_s3(Q[7]) + bmw_s0(Q[8]) + bmw_s1(Q[9]) + bmw_s2(Q[10]) + bmw_s3(Q[11]) + bmw_s0(Q[12]) + bmw_s1(Q[13]) + bmw_s2(Q[14]) + bmw_s3(Q[15]) + bmw_s0(Q[16]) + ((rotl64(M[1], 2) + rotl64(M[4], 5) - rotl64(M[11], 12) + 0x5AAAAAAAAAAAAAA5ull) ^ H[8]);
  Q[18] = Q[2] + rotl64(Q[3], 5) + Q[4] + rotl64(Q[5], 11) + Q[6] + rotl64(Q[7], 27) + Q[8] + rotl64(Q[9], 32) + Q[10] + rotl64(Q[11], 37) + Q[12] + rotl64(Q[13], 43) + Q[14] + rotl64(Q[15], 53) + bmw_s4(Q[16]) + bmw_s5(Q[17]) + ((rotl64(M[2], 3) + rotl64(M[5], 6) - rotl64(M[12], 13) + 0x5FFFFFFFFFFFFFFAull) ^ H[9]);
  Q[19] = Q[3] + rotl64(Q[4], 5) + Q[5] + rotl64(Q[6], 11) + Q[7] + rotl64(Q[8], 27) + Q[9] + rotl64(Q[10], 32) + Q[11] + rotl64(Q[12], 37) + Q[13] + rotl64(Q[14], 43) + Q[15] + rotl64(Q[16], 53) + bmw_s4(Q[17]) + bmw_s5(Q[18]) + ((rotl64(M[3], 4) + rotl64(M[6], 7) - rotl64(M[13], 14) + 0x655555555555554Full) ^ H[10]);
  Q[20] = Q[4] + rotl64(Q[5], 5) + Q[6] + rotl64(Q[7], 11) + Q[8] + rotl64(Q[9], 27) + Q[10] + rotl64(Q[11], 32) + Q[12] + rotl64(Q[13], 37) + Q[14] + rotl64(Q[15], 43) + Q[16] + rotl64(Q[17], 53) + bmw_s4(Q[18]) + bmw_s5(Q[19]) + ((rotl64(M[4], 5) + rotl64(M[7], 8) - rotl64(M[14], 15) + 0x6AAAAAAAAAAAAAA4ull) ^ H[11]);
  Q[21] = Q[5] + rotl64(Q[6], 5) + Q[7] + rotl64(Q[8], 11) + Q[9] + rotl64(Q[10], 27) + Q[11] + rotl64(Q[12], 32) + Q[13] + rotl64(Q[14], 37) + Q[15] + rotl64(Q[16], 43) + Q[17] + rotl64(Q[18], 53) + bmw_s4(Q[19]) + bmw_s5(Q[20]) + ((rotl64(M[5], 6) + rotl64(M[8], 9) - rotl64(M[15], 16) + 0x6FFFFFFFFFFFFFF9ull) ^ H[12]);
  Q[22] = Q[6] + rotl64(Q[7], 5) + Q[8] + rotl64(Q[9], 11) + Q[10] + rotl64(Q[11], 27) + Q[12] + rotl64(Q[13], 32) + Q[14] + rotl64(Q[15], 37) + Q[16] + rotl64(Q[17], 43) + Q[18] + rotl64(Q[19], 53) + bmw_s4(Q[20]) + bmw_s5(Q[21]) + ((rotl64(M[6], 7) + rotl64(M[9], 10) - rotl64(M[0], 1) + 0x755555555555554Eull) ^ H[13]);
  Q[23] = Q[7] + rotl64(Q[8], 5) + Q[9] + rotl64(Q[10], 11) + Q[11] + rotl64(Q[12], 27) + Q[13] + rotl64(Q[14], 32) + Q[15] + rotl64(Q[16], 37) + Q[17] + rotl64(Q[18], 43) + Q[19] + rotl64(Q[20], 53) + bmw_s4(Q[21]) + bmw_s5(Q[22]) + ((rotl64(M[7], 8) + rotl64(M[10], 11) - rotl64(M[1], 2) + 0x7AAAAAAAAAAAAAA3ull) ^ H[14]);
  Q[24] = Q[8] + rotl64(Q[9], 5) + Q[10] + rotl64(Q[11], 11) + Q[12] + rotl64(Q[13], 27) + Q[14] + rotl64(Q[15], 32) + Q[16] + rotl64(Q[17], 37) + Q[18] + rotl64(Q[19], 43) + Q[20] + rotl64(Q[21], 53) + bmw_s4(Q[22]) + bmw_s5(Q[23]) + ((rotl64(M[8], 9) + rotl64(M[11], 12) - rotl64(M[2], 3) + 0x7FFFFFFFFFFFFFF8ull) ^ H[15]);
  Q[25] = Q[9] + rotl64(Q[10], 5) + Q[11] + rotl64(Q[12], 11) + Q[13] + rotl64(Q[14], 27) + Q[15] + rotl64(Q[16], 32) + Q[17] + rotl64(Q[18], 37) + Q[19] + rotl64(Q[20], 43) + Q[21] + rotl64(Q[22], 53) + bmw_s4(Q[23]) + bmw_s5(Q[24]) + ((rotl64(M[9], 10) + rotl64(M[12], 13) - rotl64(M[3], 4) + 0x855555555555554Dull) ^ H[0]);
  Q[26] = Q[10] + rotl64(Q[11], 5) + Q[12] + rotl64(Q[13], 11) + Q[14] + rotl64(Q[15], 27) + Q[16] + rotl64(Q[17], 32) + Q[18] + rotl64(Q[19], 37) + Q[20] + rotl64(Q[21], 43) + Q[22] + rotl64(Q[23], 53) + bmw_s4(Q[24]) + bmw_s5(Q[25]) + ((rotl64(M[10], 11) + rotl64(M[13], 14) - rotl64(M[4], 5) + 0x8AAAAAAAAAAAAAA2ull) ^ H[1]);
  Q[27] = Q[11] + rotl64(Q[12], 5) + Q[13] + rotl64(Q[14], 11) + Q[15] + rotl64(Q[16], 27) + Q[17] + rotl64(Q[18], 32) + Q[19] + rotl64(Q[20], 37) + Q[21] + rotl64(Q[22], 43) + Q[23] + rotl64(Q[24], 53) + bmw_s4(Q[25]) + bmw_s5(Q[26]) + ((rotl64(M[11], 12) + rotl64(M[14], 15) - rotl64(M[5], 6) + 0x8FFFFFFFFFFFFFF7ull) ^ H[2]);
  Q[28] = Q[12] + rotl64(Q[13], 5) + Q[14] + rotl64(Q[15], 11) + Q[16] + rotl64(Q[17], 27) + Q[18] + rotl64(Q[19], 32) + Q[20] + rotl64(Q[21], 37) + Q[22] + rotl64(Q[23], 43) + Q[24] + rotl64(Q[25], 53) + bmw_s4(Q[26]) + bmw_s5(Q[27]) + ((rotl64(M[12], 13) + rotl64(M[15], 16) - rotl64(M[6], 7) + 0x955555555555554Cull) ^ H[3]);
  Q[29] = Q[13] + rotl64(Q[14], 5) + Q[15] + rotl64(Q[16], 11) + Q[17] + rotl64(Q[18], 27) + Q[19] + rotl64(Q[20], 32) + Q[21] + rotl64(Q[22], 37) + Q[23] + rotl64(Q[24], 43) + Q[25] + rotl64(Q[26], 53) + bmw_s4(Q[27]) + bmw_s5(Q[28]) + ((rotl64(M[13], 14) + rotl64(M[0], 1) - rotl64(M[7], 8) + 0x9AAAAAAAAAAAAAA1ull) ^ H[4]);
  Q[30] = Q[14] + rotl64(Q[15], 5) + Q[16] + rotl64(Q[17], 11) + Q[18] + rotl64(Q[19], 27) + Q[20] + rotl64(Q[21], 32) + Q[22] + rotl64(Q[23], 37) + Q[24] + rotl64(Q[25], 43) + Q[26] + rotl64(Q[27], 53) + bmw_s4(Q[28]) + bmw_s5(Q[29]) + ((rotl64(M[14], 15) + rotl64(M[1], 2) - rotl64(M[8], 9) + 0x9FFFFFFFFFFFFFF6ull) ^ H[5]);
  Q[31] = Q[15] + rotl64(Q[16], 5) + Q[17] + rotl64(Q[18], 11) + Q[19] + rotl64(Q[20], 27) + Q[21] + rotl64(Q[22], 32) + Q[23] + rotl64(Q[24], 37) + Q[25] + rotl64(Q[26], 43) + Q[27] + rotl64(Q[28], 53) + bmw_s4(Q[29]) + bmw_s5(Q[30]) + ((rotl64(M[15], 16) + rotl64(M[2], 3) - rotl64(M[9], 10) + 0xA55555555555554Bull) ^ H[6]);
  uint64_t XL = Q[16];
#pragma unroll
  for (int i = 17; i < 24; ++i) XL ^= Q[i];
  uint64_t XH = XL;
#pragma unroll
  for (int i = 24; i < 32; ++i) XH ^= Q[i];
  H[0] = ((XH << 5) ^ (Q[16] >> 5) ^ M[0]) + (XL ^ Q[24] ^ Q[0]);
  H[1] = ((XH >> 7) ^ (Q[17] << 8) ^ M[1]) + (XL ^ Q[25] ^ Q[1]);
  H[2] = ((XH >> 5) ^ (Q[18] << 5) ^ M[2]) + (XL ^ Q[26] ^ Q[2]);
  H[3] = ((XH >> 1) ^ (Q[19] << 5) ^ M[3]) + (XL ^ Q[27] ^ Q[3]);
  H[4] = ((XH >> 3) ^ Q[20] ^ M[4]) + (XL ^ Q[28] ^ Q[4]);
  H[5] = ((XH << 6) ^ (Q[21] >> 6) ^ M[5]) + (XL ^ Q[29] ^ Q[5]);
  H[6] = ((XH >> 4) ^ (Q[22] << 6) ^ M[6]) + (XL ^ Q[30] ^ Q[6]);
  H[7] = ((XH >> 11) ^ (Q[23] << 2) ^ M[7]) + (XL ^ Q[31] ^ Q[7]);
  H[8] = rotl64(H[4], 9) + (XH ^ Q[24] ^ M[8]) + ((XL << 8) ^ Q[23] ^ Q[8]);
  H[9] = rotl64(H[5], 10) + (XH ^ Q[25] ^ M[9]) + ((XL >> 6) ^ Q[16] ^ Q[9]);
  H[10] = rotl64(H[6], 11) + (XH ^ Q[26] ^ M[10]) + ((XL << 6) ^ Q[17] ^ Q[10]);
  H[11] = rotl64(H[7], 12) + (XH ^ Q[27] ^ M[11]) + ((XL << 4) ^ Q[18] ^ Q[11]);
  H[12] = rotl64(H[0], 13) + (XH ^ Q[28] ^ M[12]) + ((XL >> 3) ^ Q[19] ^ Q[12]);
  H[13] = rotl64(H[1], 14) + (XH ^ Q[29] ^ M[13]) + ((XL >> 4) ^ Q[20] ^ Q[13]);
  H[14] = rotl64(H[2], 15) + (XH ^ Q[30] ^ M[14]) + ((XL >> 7) ^ Q[21] ^ Q[14]);
  H[15] = rotl64(H[3], 16) + (XH ^ Q[31] ^ M[15]) + ((XL >> 2) ^ Q[22] ^ Q[15]);
}

__device__ __forceinline__ void bmw512_64(uint64_t h[8]) {
  uint64_t M[16], H[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) M[i] = h[i];
  M[8] = 0x80;
#pragma unroll
  for (int i = 9; i < 15; ++i) M[i] = 0;
  M[15] = 512;
#pragma unroll
  for (int i = 0; i < 16; ++i)
    H[i] = 0x8081828384858687ull + static_cast<uint64_t>(i) * 0x0808080808080808ull;
  bmw_compress(H, M);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    M[i] = H[i];
    H[i] = 0xAAAAAAAAAAAAAAA0ull + static_cast<uint64_t>(i);
  }
  bmw_compress(H, M);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = H[8 + i];
}

// ---- 3. groestl512: sixteen 64-bit columns, row r at bits 8r --------------------

// A thread's view of the replicated groestl tables in shared memory: its
// copy (lane mod 16) and the stride of an entry, a run-time value so that
// an address is one IMAD.
struct GroTab {
  const char* base;
  uint32_t row;
};

__device__ __forceinline__ uint64_t gro_ld(GroTab g, uint32_t x, int t) {
  return *reinterpret_cast<const uint64_t*>(g.base + x * g.row + t * 32768);
}

// byte i of x, one instruction (PRMT for the middle bytes of a half)
__device__ __forceinline__ uint32_t byte32(uint32_t x, int i) {
  return i == 0 ? x & 0xFFu : i == 3 ? x >> 24 : __byte_perm(x, 0, 0x4440 + i);
}
__device__ __forceinline__ uint32_t byte_of(uint64_t x, int i) {
  return byte32(i < 4 ? lo32(x) : hi32(x), i & 3);
}

// the column that row i's byte comes from, relative to the output column:
// P shifts row i by i (row 7 by 11), Q by 1, 3, 5, 11, 0, 2, 4, 6
__device__ __forceinline__ constexpr int gro_shift(bool q, int i) {
  return q ? (i < 3 ? 2 * i + 1 : i == 3 ? 11 : 2 * (i - 4)) : (i < 7 ? i : 11);
}

// 14 rounds of P (kQ false) or Q: AddRoundConstant, then SubBytes,
// ShiftBytes and MixBytes through the tables; table i + 4 is table i with
// its halves swapped
template <bool kQ>
__device__ __forceinline__ void groestl_perm(uint64_t x[16], GroTab g) {
  X11_ROUNDS
  for (int r = 0; r < 14; ++r) {
#pragma unroll
    for (int c = 0; c < 16; ++c)
      x[c] = kQ ? ~x[c] ^ (static_cast<uint64_t>((c << 4) ^ r) << 56)
                : x[c] ^ static_cast<uint64_t>((c << 4) ^ r);
    uint64_t t[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      uint64_t a = 0, b = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a ^= gro_ld(g, byte_of(x[(c + gro_shift(kQ, i)) & 15], i), i);
#pragma unroll
      for (int i = 4; i < 8; ++i)
        b ^= gro_ld(g, byte_of(x[(c + gro_shift(kQ, i)) & 15], i), i - 4);
      t[c] = a ^ rotl64(b, 32);
    }
#pragma unroll
    for (int c = 0; c < 16; ++c) x[c] = t[c];
  }
}

__device__ __forceinline__ void groestl512_64(uint64_t h[8], GroTab g) {
  uint64_t a[16], q[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint64_t m = i < 8 ? h[i] : i == 8 ? 0x80 : i == 15 ? 1ull << 56 : 0;
    a[i] = m ^ (i == 15 ? (2ull << 48) : 0);
    q[i] = m;
  }
  groestl_perm<true>(q, g);
  groestl_perm<false>(a, g);
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] ^= q[i] ^ (i == 15 ? (2ull << 48) : 0);
#pragma unroll
  for (int i = 0; i < 8; ++i) q[i] = a[8 + i];
  groestl_perm<false>(a, g);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = a[8 + i] ^ q[i];
}

// ---- 4. skein512: Threefish-512 in UBI mode -------------------------------------

#define SKEIN_INJECT(s, ta, tb, k0, k1, k2, k3, k4, k5, k6, k7) \
  do {                                                        \
    v[0] += k[k0];                                            \
    v[1] += k[k1];                                            \
    v[2] += k[k2];                                            \
    v[3] += k[k3];                                            \
    v[4] += k[k4];                                            \
    v[5] += k[k5] + t[ta];                                    \
    v[6] += k[k6] + t[tb];                                    \
    v[7] += k[k7] + static_cast<uint64_t>(s);                 \
  } while (0)

// one round: MIX on the four pairs, then the word permutation (2,1,4,7,6,5,0,3)
#define SKEIN_MIX(r0, r1, r2, r3)                                          \
  do {                                                                     \
    v[0] += v[1];                                                          \
    v[1] = rotl64(v[1], r0) ^ v[0];                                        \
    v[2] += v[3];                                                          \
    v[3] = rotl64(v[3], r1) ^ v[2];                                        \
    v[4] += v[5];                                                          \
    v[5] = rotl64(v[5], r2) ^ v[4];                                        \
    v[6] += v[7];                                                          \
    v[7] = rotl64(v[7], r3) ^ v[6];                                        \
    const uint64_t p0 = v[2], p1 = v[1], p2 = v[4], p3 = v[7], p4 = v[6],  \
                   p5 = v[5], p6 = v[0], p7 = v[3];                        \
    v[0] = p0;                                                             \
    v[1] = p1;                                                             \
    v[2] = p2;                                                             \
    v[3] = p3;                                                             \
    v[4] = p4;                                                             \
    v[5] = p5;                                                             \
    v[6] = p6;                                                             \
    v[7] = p7;                                                             \
  } while (0)

// UBI: out = Threefish_key(tweak)(block) ^ block
__device__ __forceinline__ void skein_ubi(const uint64_t key[8], uint64_t t0,
                                          uint64_t t1, const uint64_t block[8],
                                          uint64_t out[8]) {
  uint64_t k[9], t[3], v[8];
  k[8] = 0x1BD11BDAA9FC1A22ull;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    k[i] = key[i];
    k[8] ^= key[i];
    v[i] = block[i];
  }
  t[0] = t0;
  t[1] = t1;
  t[2] = t0 ^ t1;
  SKEIN_INJECT(0, 0, 1, 0, 1, 2, 3, 4, 5, 6, 7);
  SKEIN_MIX(46, 36, 19, 37);
  SKEIN_MIX(33, 27, 14, 42);
  SKEIN_MIX(17, 49, 36, 39);
  SKEIN_MIX(44, 9, 54, 56);
  SKEIN_INJECT(1, 1, 2, 1, 2, 3, 4, 5, 6, 7, 8);
  SKEIN_MIX(39, 30, 34, 24);
  SKEIN_MIX(13, 50, 10, 17);
  SKEIN_MIX(25, 29, 39, 43);
  SKEIN_MIX(8, 35, 56, 22);
  SKEIN_INJECT(2, 2, 0, 2, 3, 4, 5, 6, 7, 8, 0);
  SKEIN_MIX(46, 36, 19, 37);
  SKEIN_MIX(33, 27, 14, 42);
  SKEIN_MIX(17, 49, 36, 39);
  SKEIN_MIX(44, 9, 54, 56);
  SKEIN_INJECT(3, 0, 1, 3, 4, 5, 6, 7, 8, 0, 1);
  SKEIN_MIX(39, 30, 34, 24);
  SKEIN_MIX(13, 50, 10, 17);
  SKEIN_MIX(25, 29, 39, 43);
  SKEIN_MIX(8, 35, 56, 22);
  SKEIN_INJECT(4, 1, 2, 4, 5, 6, 7, 8, 0, 1, 2);
  SKEIN_MIX(46, 36, 19, 37);
  SKEIN_MIX(33, 27, 14, 42);
  SKEIN_MIX(17, 49, 36, 39);
  SKEIN_MIX(44, 9, 54, 56);
  SKEIN_INJECT(5, 2, 0, 5, 6, 7, 8, 0, 1, 2, 3);
  SKEIN_MIX(39, 30, 34, 24);
  SKEIN_MIX(13, 50, 10, 17);
  SKEIN_MIX(25, 29, 39, 43);
  SKEIN_MIX(8, 35, 56, 22);
  SKEIN_INJECT(6, 0, 1, 6, 7, 8, 0, 1, 2, 3, 4);
  SKEIN_MIX(46, 36, 19, 37);
  SKEIN_MIX(33, 27, 14, 42);
  SKEIN_MIX(17, 49, 36, 39);
  SKEIN_MIX(44, 9, 54, 56);
  SKEIN_INJECT(7, 1, 2, 7, 8, 0, 1, 2, 3, 4, 5);
  SKEIN_MIX(39, 30, 34, 24);
  SKEIN_MIX(13, 50, 10, 17);
  SKEIN_MIX(25, 29, 39, 43);
  SKEIN_MIX(8, 35, 56, 22);
  SKEIN_INJECT(8, 2, 0, 8, 0, 1, 2, 3, 4, 5, 6);
  SKEIN_MIX(46, 36, 19, 37);
  SKEIN_MIX(33, 27, 14, 42);
  SKEIN_MIX(17, 49, 36, 39);
  SKEIN_MIX(44, 9, 54, 56);
  SKEIN_INJECT(9, 0, 1, 0, 1, 2, 3, 4, 5, 6, 7);
  SKEIN_MIX(39, 30, 34, 24);
  SKEIN_MIX(13, 50, 10, 17);
  SKEIN_MIX(25, 29, 39, 43);
  SKEIN_MIX(8, 35, 56, 22);
  SKEIN_INJECT(10, 1, 2, 1, 2, 3, 4, 5, 6, 7, 8);
  SKEIN_MIX(46, 36, 19, 37);
  SKEIN_MIX(33, 27, 14, 42);
  SKEIN_MIX(17, 49, 36, 39);
  SKEIN_MIX(44, 9, 54, 56);
  SKEIN_INJECT(11, 2, 0, 2, 3, 4, 5, 6, 7, 8, 0);
  SKEIN_MIX(39, 30, 34, 24);
  SKEIN_MIX(13, 50, 10, 17);
  SKEIN_MIX(25, 29, 39, 43);
  SKEIN_MIX(8, 35, 56, 22);
  SKEIN_INJECT(12, 0, 1, 3, 4, 5, 6, 7, 8, 0, 1);
  SKEIN_MIX(46, 36, 19, 37);
  SKEIN_MIX(33, 27, 14, 42);
  SKEIN_MIX(17, 49, 36, 39);
  SKEIN_MIX(44, 9, 54, 56);
  SKEIN_INJECT(13, 1, 2, 4, 5, 6, 7, 8, 0, 1, 2);
  SKEIN_MIX(39, 30, 34, 24);
  SKEIN_MIX(13, 50, 10, 17);
  SKEIN_MIX(25, 29, 39, 43);
  SKEIN_MIX(8, 35, 56, 22);
  SKEIN_INJECT(14, 2, 0, 5, 6, 7, 8, 0, 1, 2, 3);
  SKEIN_MIX(46, 36, 19, 37);
  SKEIN_MIX(33, 27, 14, 42);
  SKEIN_MIX(17, 49, 36, 39);
  SKEIN_MIX(44, 9, 54, 56);
  SKEIN_INJECT(15, 0, 1, 6, 7, 8, 0, 1, 2, 3, 4);
  SKEIN_MIX(39, 30, 34, 24);
  SKEIN_MIX(13, 50, 10, 17);
  SKEIN_MIX(25, 29, 39, 43);
  SKEIN_MIX(8, 35, 56, 22);
  SKEIN_INJECT(16, 1, 2, 7, 8, 0, 1, 2, 3, 4, 5);
  SKEIN_MIX(46, 36, 19, 37);
  SKEIN_MIX(33, 27, 14, 42);
  SKEIN_MIX(17, 49, 36, 39);
  SKEIN_MIX(44, 9, 54, 56);
  SKEIN_INJECT(17, 2, 0, 8, 0, 1, 2, 3, 4, 5, 6);
  SKEIN_MIX(39, 30, 34, 24);
  SKEIN_MIX(13, 50, 10, 17);
  SKEIN_MIX(25, 29, 39, 43);
  SKEIN_MIX(8, 35, 56, 22);
  SKEIN_INJECT(18, 0, 1, 0, 1, 2, 3, 4, 5, 6, 7);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = v[i] ^ block[i];
}

__device__ __forceinline__ void skein512_64(uint64_t h[8]) {
  uint64_t iv[8], g[8], zero[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    iv[i] = kSkeinIV[i];
    zero[i] = 0;
  }
  skein_ubi(iv, 64, (48ull << 56) | (1ull << 62) | (1ull << 63), h, g);
  skein_ubi(g, 8, (63ull << 56) | (1ull << 62) | (1ull << 63), zero, h);
}

// ---- 5. jh512, bitsliced --------------------------------------------------------

#define JH_SB(x0, x1, x2, x3, c)  \
  do {                            \
    x3 = ~x3;                     \
    x0 ^= (c) & ~x2;              \
    const uint64_t tmp = (c) ^ (x0 & x1); \
    x0 ^= x2 & x3;                \
    x3 ^= ~x1 & x2;               \
    x1 ^= x0 & x2;                \
    x2 ^= x0 & ~x3;               \
    x0 ^= x1 | x3;                \
    x3 ^= x1 & x2;                \
    x1 ^= tmp & x0;               \
    x2 ^= tmp;                    \
  } while (0)

#define JH_LB(x0, x1, x2, x3, x4, x5, x6, x7) \
  do {                                        \
    x4 ^= x1;                                 \
    x5 ^= x2;                                 \
    x6 ^= x3 ^ x0;                            \
    x7 ^= x0;                                 \
    x0 ^= x5;                                 \
    x1 ^= x6;                                 \
    x2 ^= x7 ^ x4;                            \
    x3 ^= x4;                                 \
  } while (0)

// the bit swap at distance s = 2^n (n < 5) within each 32-bit half (the
// masked bits never cross it): ((x & m) << s) | ((x >> s) & m) as
// (x & m) * 2^s + hi((x & (m << s)) * 2^(32 - s)), the shifts and the
// merge on the FMA pipe
template <int n>
__device__ __forceinline__ uint32_t jh_swap32(uint32_t x, const Fma& f) {
  constexpr uint32_t m = n == 0 ? 0x55555555u
                       : n == 1 ? 0x33333333u
                       : n == 2 ? 0x0F0F0F0Fu
                       : n == 3 ? 0x00FF00FFu
                                : 0x0000FFFFu;
  constexpr int sh = 1 << n;
  return __umulhi(x & (m << sh), f.pow2[32 - sh]) + (x & m) * f.pow2[sh];
}
template <int n>
__device__ __forceinline__ uint64_t jh_swap(uint64_t x, const Fma& f) {
  if constexpr (n == 5) {
    return rotl64(x, 32);
  } else {
    return join64(jh_swap32<n>(lo32(x), f), jh_swap32<n>(hi32(x), f));
  }
}

// one round r (n = r mod 7): S-boxes and L on both halves, then the odd
// words' bit swap at distance 2^n (n = 6: their halves swap)
template <int n>
__device__ __forceinline__ void jh_round(uint64_t x[16], const uint64_t* c,
                                         const Fma& f) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const uint64_t ce = c[hf], co = c[2 + hf];
    JH_SB(x[0 + hf], x[4 + hf], x[8 + hf], x[12 + hf], ce);
    JH_SB(x[2 + hf], x[6 + hf], x[10 + hf], x[14 + hf], co);
    JH_LB(x[0 + hf], x[4 + hf], x[8 + hf], x[12 + hf], x[2 + hf], x[6 + hf],
          x[10 + hf], x[14 + hf]);
  }
#pragma unroll
  for (int j = 1; j < 8; j += 2) {
    if (n == 6) {
      const uint64_t t = x[2 * j];
      x[2 * j] = x[2 * j + 1];
      x[2 * j + 1] = t;
    } else {
      x[2 * j] = jh_swap<n < 6 ? n : 0>(x[2 * j], f);
      x[2 * j + 1] = jh_swap<n < 6 ? n : 0>(x[2 * j + 1], f);
    }
  }
}

__device__ __forceinline__ void jh_e8(uint64_t x[16], const uint64_t* tb, const Fma& f) {
  const uint64_t* c = tb + kJhCOff / 2;
  X11_ROUNDS
  for (int r = 0; r < 42; r += 7) {
    jh_round<0>(x, c + 4 * (r + 0), f);
    jh_round<1>(x, c + 4 * (r + 1), f);
    jh_round<2>(x, c + 4 * (r + 2), f);
    jh_round<3>(x, c + 4 * (r + 3), f);
    jh_round<4>(x, c + 4 * (r + 4), f);
    jh_round<5>(x, c + 4 * (r + 5), f);
    jh_round<6>(x, c + 4 * (r + 6), f);
  }
}

__device__ __forceinline__ void jh512_64(uint64_t h[8], const uint64_t* tb, const Fma& f) {
  uint64_t x[16], m[8];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = __ldg(&tb[kJhIvOff / 2 + i]);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = bswap64(h[i]);
    x[i] ^= m[i];
  }
  jh_e8(x, tb, f);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[8 + i] ^= m[i];
  // the padding block: 0x80, zeros, the 128-bit big-endian bit length 512
  x[0] ^= 0x80ull << 56;
  x[7] ^= 512;
  jh_e8(x, tb, f);
  x[8] ^= 0x80ull << 56;
  x[15] ^= 512;
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = bswap64(x[8 + i]);
}

// ---- 6. keccak512 (the original padding, 0x01) --------------------------------

__device__ __forceinline__ void keccak512_64(uint64_t h[8]) {
  uint64_t A[25];
#pragma unroll
  for (int i = 0; i < 8; ++i) A[i] = h[i];
  A[8] = 0x8000000000000001ull;
#pragma unroll
  for (int i = 9; i < 25; ++i) A[i] = 0;
  X11_ROUNDS
  for (int rnd = 0; rnd < 24; ++rnd) {
    uint64_t C0 = A[0] ^ A[5] ^ A[10] ^ A[15] ^ A[20];
    uint64_t C1 = A[1] ^ A[6] ^ A[11] ^ A[16] ^ A[21];
    uint64_t C2 = A[2] ^ A[7] ^ A[12] ^ A[17] ^ A[22];
    uint64_t C3 = A[3] ^ A[8] ^ A[13] ^ A[18] ^ A[23];
    uint64_t C4 = A[4] ^ A[9] ^ A[14] ^ A[19] ^ A[24];
    const uint64_t D0 = C4 ^ rotl64(C1, 1);
    const uint64_t D1 = C0 ^ rotl64(C2, 1);
    const uint64_t D2 = C1 ^ rotl64(C3, 1);
    const uint64_t D3 = C2 ^ rotl64(C4, 1);
    const uint64_t D4 = C3 ^ rotl64(C0, 1);
    const uint64_t B0 = rotl640((A[0] ^ D0));
    const uint64_t B1 = rotl64((A[6] ^ D1), 44);
    const uint64_t B2 = rotl64((A[12] ^ D2), 43);
    const uint64_t B3 = rotl64((A[18] ^ D3), 21);
    const uint64_t B4 = rotl64((A[24] ^ D4), 14);
    const uint64_t B5 = rotl64((A[3] ^ D3), 28);
    const uint64_t B6 = rotl64((A[9] ^ D4), 20);
    const uint64_t B7 = rotl64((A[10] ^ D0), 3);
    const uint64_t B8 = rotl64((A[16] ^ D1), 45);
    const uint64_t B9 = rotl64((A[22] ^ D2), 61);
    const uint64_t B10 = rotl64((A[1] ^ D1), 1);
    const uint64_t B11 = rotl64((A[7] ^ D2), 6);
    const uint64_t B12 = rotl64((A[13] ^ D3), 25);
    const uint64_t B13 = rotl64((A[19] ^ D4), 8);
    const uint64_t B14 = rotl64((A[20] ^ D0), 18);
    const uint64_t B15 = rotl64((A[4] ^ D4), 27);
    const uint64_t B16 = rotl64((A[5] ^ D0), 36);
    const uint64_t B17 = rotl64((A[11] ^ D1), 10);
    const uint64_t B18 = rotl64((A[17] ^ D2), 15);
    const uint64_t B19 = rotl64((A[23] ^ D3), 56);
    const uint64_t B20 = rotl64((A[2] ^ D2), 62);
    const uint64_t B21 = rotl64((A[8] ^ D3), 55);
    const uint64_t B22 = rotl64((A[14] ^ D4), 39);
    const uint64_t B23 = rotl64((A[15] ^ D0), 41);
    const uint64_t B24 = rotl64((A[21] ^ D1), 2);
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
    A[0] ^= kKeccakRC[rnd];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = A[i];
}

// ---- 7. luffa512: five 256-bit sub-states of 32-bit words ----------------------

__device__ __forceinline__ void luffa_m2(uint32_t x[8]) {
  const uint32_t t = x[7];
  x[7] = x[6];
  x[6] = x[5];
  x[5] = x[4];
  x[4] = x[3] ^ t;
  x[3] = x[2] ^ t;
  x[2] = x[1];
  x[1] = x[0] ^ t;
  x[0] = t;
}

__device__ __forceinline__ void luffa_mi5(uint32_t V[5][8], const uint32_t M[8]) {
  uint32_t t[8], d[5][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) t[i] = V[0][i] ^ V[1][i] ^ V[2][i] ^ V[3][i] ^ V[4][i];
  luffa_m2(t);
#pragma unroll
  for (int j = 0; j < 5; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      V[j][i] ^= t[i];
      d[j][i] = V[j][i];
    }
#pragma unroll
  for (int j = 0; j < 5; ++j) luffa_m2(d[j]);
#pragma unroll
  for (int j = 0; j < 5; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) d[j][i] ^= V[(j + 1) % 5][i];
#pragma unroll
  for (int j = 0; j < 5; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) V[j][i] = d[j][i];
#pragma unroll
  for (int j = 0; j < 5; ++j) luffa_m2(d[j]);
#pragma unroll
  for (int j = 0; j < 5; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) d[j][i] ^= V[(j + 4) % 5][i];
  uint32_t m[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = M[i];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
#pragma unroll
    for (int i = 0; i < 8; ++i) V[j][i] = d[j][i] ^ m[i];
    luffa_m2(m);
  }
}

__device__ __forceinline__ void luffa_sub_crumb(uint32_t& a0, uint32_t& a1,
                                                uint32_t& a2, uint32_t& a3) {
  uint32_t tmp = a0;
  a0 |= a1;
  a2 ^= a3;
  a1 = ~a1;
  a0 ^= a3;
  a3 &= tmp;
  a1 ^= a3;
  a3 ^= a2;
  a2 &= a0;
  a0 = ~a0;
  a2 ^= a1;
  a1 |= a3;
  tmp ^= a1;
  a3 ^= a2;
  a2 &= a1;
  a1 ^= a0;
  a0 = tmp;
}

__device__ __forceinline__ void luffa_mix_word(uint32_t& u, uint32_t& v) {
  v ^= u;
  u = rotl32(u, 2) ^ v;
  v = rotl32(v, 14) ^ u;
  u = rotl32(u, 10) ^ v;
  v = rotl32(v, 1);
}

__device__ __forceinline__ void luffa_q(uint32_t x[8], int j) {
#pragma unroll
  for (int i = 4; i < 8; ++i) x[i] = j ? rotl32(x[i], j) : x[i];
#pragma unroll
  for (int step = 0; step < 8; ++step) {
    luffa_sub_crumb(x[0], x[1], x[2], x[3]);
    luffa_sub_crumb(x[5], x[6], x[7], x[4]);
#pragma unroll
    for (int i = 0; i < 4; ++i) luffa_mix_word(x[i], x[i + 4]);
    x[0] ^= kLuffaCNS[j][step][0];
    x[4] ^= kLuffaCNS[j][step][1];
  }
}

__device__ __forceinline__ void luffa512_64(uint64_t h[8]) {
  uint32_t V[5][8], w[16], M[8], out[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    w[2 * i] = bswap32(lo32(h[i]));
    w[2 * i + 1] = bswap32(hi32(h[i]));
  }
#pragma unroll
  for (int j = 0; j < 5; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) V[j][i] = kLuffaIV[j][i];
#pragma unroll
  for (int blk = 0; blk < 5; ++blk) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      M[i] = blk < 2 ? w[8 * blk + i] : (blk == 2 && i == 0 ? 0x80000000u : 0u);
    luffa_mi5(V, M);
#pragma unroll
    for (int j = 0; j < 5; ++j) luffa_q(V[j], j);
    if (blk >= 3) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        out[8 * (blk - 3) + i] = V[0][i] ^ V[1][i] ^ V[2][i] ^ V[3][i] ^ V[4][i];
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = join64(bswap32(out[2 * i]), bswap32(out[2 * i + 1]));
}

// ---- 8. cubehash512 -------------------------------------------------------------

__device__ __forceinline__ void cube_round(uint32_t x[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i + 16] += x[i];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = rotl32(x[i], 7);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t t = x[i];
    x[i] = x[i ^ 8];
    x[i ^ 8] = t;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] ^= x[i + 16];
#pragma unroll
  for (int i = 16; i < 32; ++i) {
    if (i & 2) continue;
    const uint32_t t = x[i];
    x[i] = x[i ^ 2];
    x[i ^ 2] = t;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i + 16] += x[i];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = rotl32(x[i], 11);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (i & 4) continue;
    const uint32_t t = x[i];
    x[i] = x[i ^ 4];
    x[i ^ 4] = t;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] ^= x[i + 16];
#pragma unroll
  for (int i = 16; i < 32; i += 2) {
    const uint32_t t = x[i];
    x[i] = x[i + 1];
    x[i + 1] = t;
  }
}

__device__ __forceinline__ void cubehash512_64(uint64_t h[8], const uint32_t* tb) {
  uint32_t x[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = __ldg(&tb[kCubeIvOff + i]);
#pragma unroll
  for (int blk = 0; blk < 2; ++blk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] ^= lo32(h[4 * blk + i]);
      x[2 * i + 1] ^= hi32(h[4 * blk + i]);
    }
    X11_ROUNDS for (int r = 0; r < 16; ++r) cube_round(x);
  }
  x[0] ^= 0x80;
  X11_ROUNDS for (int r = 0; r < 16; ++r) cube_round(x);
  x[31] ^= 1;
  X11_ROUNDS for (int r = 0; r < 160; ++r) cube_round(x);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = join64(x[2 * i], x[2 * i + 1]);
}

// ---- the AES round on four little-endian 32-bit columns -------------------------

// A thread's view of the replicated AES tables in shared memory: its copy
// (lane mod 32) and the stride of an entry (a run-time value: one IMAD an
// address). Table t is T0 rotated left by 8t bits.
struct AesTab {
  const char* base;
  uint32_t row;
};

__device__ __forceinline__ uint32_t aes_ld(AesTab T, uint32_t x, int t) {
  return *reinterpret_cast<const uint32_t*>(T.base + x * T.row + t * 32768);
}

__device__ __forceinline__ void aes_round(AesTab T, uint32_t& x0, uint32_t& x1,
                                          uint32_t& x2, uint32_t& x3) {
  const uint32_t y0 = aes_ld(T, x0 & 0xFF, 0) ^ aes_ld(T, byte32(x1, 1), 1) ^
                      aes_ld(T, byte32(x2, 2), 2) ^ aes_ld(T, x3 >> 24, 3);
  const uint32_t y1 = aes_ld(T, x1 & 0xFF, 0) ^ aes_ld(T, byte32(x2, 1), 1) ^
                      aes_ld(T, byte32(x3, 2), 2) ^ aes_ld(T, x0 >> 24, 3);
  const uint32_t y2 = aes_ld(T, x2 & 0xFF, 0) ^ aes_ld(T, byte32(x3, 1), 1) ^
                      aes_ld(T, byte32(x0, 2), 2) ^ aes_ld(T, x1 >> 24, 3);
  const uint32_t y3 = aes_ld(T, x3 & 0xFF, 0) ^ aes_ld(T, byte32(x0, 1), 1) ^
                      aes_ld(T, byte32(x1, 2), 2) ^ aes_ld(T, x2 >> 24, 3);
  x0 = y0;
  x1 = y1;
  x2 = y2;
  x3 = y3;
}

// ---- 9. shavite512: 14 Feistel rounds, the 448 subkey words made in windows
// of 32 as they are used ----------------------------------------------------------

// F: x ^ k0, then AES with k1, k2, k3 between, and a last keyless AES
__device__ __forceinline__ void shavite_f4(AesTab T, const uint32_t p[4],
                                           const uint32_t* k, uint32_t f[4]) {
  // written out (no loop): a loop here, left rolled inside a round loop
  // that the counting build unrolls, indexed k at run time from local memory
  uint32_t t0 = p[0] ^ k[0], t1 = p[1] ^ k[1], t2 = p[2] ^ k[2], t3 = p[3] ^ k[3];
  aes_round(T, t0, t1, t2, t3);
  t0 ^= k[4];
  t1 ^= k[5];
  t2 ^= k[6];
  t3 ^= k[7];
  aes_round(T, t0, t1, t2, t3);
  t0 ^= k[8];
  t1 ^= k[9];
  t2 ^= k[10];
  t3 ^= k[11];
  aes_round(T, t0, t1, t2, t3);
  t0 ^= k[12];
  t1 ^= k[13];
  t2 ^= k[14];
  t3 ^= k[15];
  aes_round(T, t0, t1, t2, t3);
  f[0] = t0;
  f[1] = t1;
  f[2] = t2;
  f[3] = t3;
}

// cnt_order: the counter orders of the four injections (subkey words 32, 164,
// 316, 440; window 1 quad 0, window 5 quad 1, window 9 quad 7, window 13 quad
// 6), two bits an entry: entry (i, j) at bits 2 * (4i + j) names the counter
// word that word j of injection i takes. The counter is (512, 0, 0, 0), and
// word 3 of each injection is complemented.
__device__ __forceinline__ uint32_t shavite_cnt(uint32_t cnt_order, int i, int j) {
  const uint32_t v = ((cnt_order >> (2 * (4 * i + j))) & 3u) == 0 ? 512u : 0u;
  return j == 3 ? ~v : v;
}

__device__ __forceinline__ void shavite512_64(uint64_t h[8], AesTab T,
                                           uint32_t cnt_order) {
  uint32_t rk[32], p[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    rk[2 * i] = lo32(h[i]);
    rk[2 * i + 1] = hi32(h[i]);
  }
  rk[16] = 0x80;
#pragma unroll
  for (int i = 17; i < 32; ++i) rk[i] = 0;
  rk[27] = 512u << 16;
  rk[31] = 512u << 16;
#pragma unroll
  for (int i = 0; i < 16; ++i) p[i] = kShaviteIV[i];
  X11_ROUNDS
  for (int r = 0; r < 14; ++r) {
    if (r & 1) {
      // a nonlinear window, in place: quad q reads old words 4q..4q+3 and
      // the four words before it (old for q = 0, new after)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        uint32_t x0 = rk[4 * q + 1], x1 = rk[4 * q + 2], x2 = rk[4 * q + 3],
                 x3 = rk[4 * q];
        aes_round(T, x0, x1, x2, x3);
        rk[4 * q] = x0 ^ rk[(4 * q + 28) & 31];
        rk[4 * q + 1] = x1 ^ rk[(4 * q + 29) & 31];
        rk[4 * q + 2] = x2 ^ rk[(4 * q + 30) & 31];
        rk[4 * q + 3] = x3 ^ rk[(4 * q + 31) & 31];
        const int inj = (r == 1 && q == 0) ? 0 : (r == 5 && q == 1) ? 1
                      : (r == 9 && q == 7) ? 2 : (r == 13 && q == 6) ? 3 : -1;
        if (inj >= 0) {
#pragma unroll
          for (int j = 0; j < 4; ++j) rk[4 * q + j] ^= shavite_cnt(cnt_order, inj, j);
        }
      }
    } else if (r > 0) {
      // a linear window, in place: word t takes old t ^ word t - 7 (new
      // when t >= 7, old when not: then it sits at t + 25)
#pragma unroll
      for (int t = 0; t < 32; ++t) rk[t] ^= rk[(t + 25) & 31];
    }
    uint32_t f1[4], f2[4];
    shavite_f4(T, p + 4, rk, f1);
    shavite_f4(T, p + 12, rk + 16, f2);
    uint32_t np[16];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      np[j] = p[12 + j];
      np[4 + j] = p[j] ^ f1[j];
      np[8 + j] = p[4 + j];
      np[12 + j] = p[8 + j] ^ f2[j];
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) p[i] = np[i];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
    h[i] = join64(kShaviteIV[2 * i] ^ p[2 * i], kShaviteIV[2 * i + 1] ^ p[2 * i + 1]);
}

// ---- 10. simd512, a group of 8 threads a lane ----------------------------------
//
// The expansion y[k] = twist(k) * sum_n x[n] 41^(nk) mod 257 (x the 64
// digest bytes, zero past them), centred to [-128, 128], splits with
// n = 32a + b, k = j + 8m as
//   y[j + 8m] = twist * sum_b (x[b] 41^(bj) + x[32 + b] 41^((32+b)j)) (41^8)^(bm)
// (a < 2: the bytes past 64 are zero), so thread j of the group computes its
// 32 outputs alone: 32 products by its constants 41^(nj) (the table block's
// [64][8] rows), then a 32-point NTT by 41^8 in registers. Reductions mod
// 257 are red(x) = (x & 255) - (x >> 8) (256 = -1 mod 257), where the
// value's range allows: a product of the inputs stays under 2^17, every
// later value under 2^20 (tests/test_torch_x11_tables.py holds the same
// steps to the plain version). Thread j then holds the expanded words the
// compression's column j reads: word 8m + j packs y[j + 8m] and
// y[j + 8(m ^ 16)].

// 41^(8e) mod 257, the 32-point NTT's twiddles
__constant__ int kW8[32] = {
    1, 60, 2, 120, 4, 240, 8, 223, 16, 189, 32, 121, 64, 242, 128, 227,
    256, 197, 255, 137, 253, 17, 249, 34, 241, 68, 225, 136, 193, 15, 129, 30,
};

__device__ __forceinline__ int red257(int x) { return (x & 255) - (x >> 8); }

__device__ __forceinline__ constexpr int rev5(int i) {
  return ((i & 1) << 4) | ((i & 2) << 2) | (i & 4) | ((i & 8) >> 2) | ((i & 16) >> 4);
}

// this thread's y[j + 8m], m < 32, centred to [-128, 128]
__device__ __forceinline__ void simd_expand_j(const uint64_t h[8], int j,
                                              const uint32_t* tb, int y[32]) {
  const uint32_t* c = tb + kSimdCOff + j;      // 41^(nj) at c[8n]
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int b = rev5(i);
    const int x0 = static_cast<int>((h[b >> 3] >> (8 * (b & 7))) & 0xFF);
    const int x1 = static_cast<int>((h[4 + (b >> 3)] >> (8 * (b & 7))) & 0xFF);
    y[i] = red257(x0 * static_cast<int>(__ldg(&c[8 * b])) +
                  x1 * static_cast<int>(__ldg(&c[8 * (32 + b)])));
  }
  // level lg: 16 butterflies of half-width 2^lg (loops of fixed counts, so
  // that both unroll: LLVM unrolls an inner loop before the loop around it)
#pragma unroll
  for (int lg = 0; lg < 5; ++lg) {
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const int i = q & ((1 << lg) - 1);
      const int lo = ((q >> lg) << (lg + 1)) + i, hi = lo + (1 << lg);
      const int e = i << (4 - lg);
      const int u = y[lo];
      const int t = e == 0 ? y[hi] : red257(y[hi] * kW8[e]);
      y[lo] = u + t;
      y[hi] = u - t;
    }
  }
#pragma unroll
  for (int m = 0; m < 32; ++m) {
    const int v = red257(red257(red257(y[m] * static_cast<int>(
        __ldg(&tb[kTwistOff + j + 8 * m])))));         // in [-1, 256]
    y[m] = v > 128 ? v - 257 : v;
  }
}

// one step of column j: A' = ROL(D + W + f(A, B, C), s) + ROL(A, r) of
// column j ^ p; B' = ROL(A, r); C' = B; D' = C
#define SIMD_STEP(use_if, r, s, p, w)                                       \
  do {                                                                      \
    const uint32_t tA = rotl32(A, r);                                       \
    const uint32_t f = use_if ? (((B ^ C) & A) ^ C)                         \
                              : ((C & B) | ((C | B) & A));                  \
    const uint32_t nA =                                                     \
        rotl32(D + (w) + f, s) + __shfl_xor_sync(0xFFFFFFFFu, tA, p, 8);    \
    D = C;                                                                  \
    C = B;                                                                  \
    B = tA;                                                                 \
    A = nA;                                                                 \
  } while (0)

// the 32 steps and the 4 feed-forward steps of one compression of column
// j; W(i) is expanded word i (i = wbase + j), sA..sD the saved column
#define SIMD_ROUNDS                                                          \
  SIMD_STEP(true, 3, 23, 1, W(32)); SIMD_STEP(true, 23, 17, 6, W(48));     \
  SIMD_STEP(true, 17, 27, 2, W(0)); SIMD_STEP(true, 27, 3, 3, W(16));      \
  SIMD_STEP(false, 3, 23, 5, W(56)); SIMD_STEP(false, 23, 17, 7, W(40));   \
  SIMD_STEP(false, 17, 27, 4, W(24)); SIMD_STEP(false, 27, 3, 1, W(8));    \
  SIMD_STEP(true, 28, 19, 6, W(120)); SIMD_STEP(true, 19, 22, 2, W(88));   \
  SIMD_STEP(true, 22, 7, 3, W(96)); SIMD_STEP(true, 7, 28, 5, W(64));      \
  SIMD_STEP(false, 28, 19, 7, W(72)); SIMD_STEP(false, 19, 22, 4, W(104)); \
  SIMD_STEP(false, 22, 7, 1, W(80)); SIMD_STEP(false, 7, 28, 6, W(112));   \
  SIMD_STEP(true, 29, 9, 2, W(136)); SIMD_STEP(true, 9, 15, 3, W(144));    \
  SIMD_STEP(true, 15, 5, 5, W(184)); SIMD_STEP(true, 5, 29, 7, W(160));    \
  SIMD_STEP(false, 29, 9, 4, W(176)); SIMD_STEP(false, 9, 15, 1, W(168));  \
  SIMD_STEP(false, 15, 5, 6, W(128)); SIMD_STEP(false, 5, 29, 2, W(152));  \
  SIMD_STEP(true, 4, 13, 3, W(240)); SIMD_STEP(true, 13, 10, 5, W(192));   \
  SIMD_STEP(true, 10, 25, 7, W(200)); SIMD_STEP(true, 25, 4, 4, W(248));   \
  SIMD_STEP(false, 4, 13, 1, W(216)); SIMD_STEP(false, 13, 10, 6, W(232)); \
  SIMD_STEP(false, 10, 25, 2, W(224)); SIMD_STEP(false, 25, 4, 3, W(208)); \
  SIMD_STEP(true, 4, 13, 5, sA); SIMD_STEP(true, 13, 10, 7, sB);           \
  SIMD_STEP(true, 10, 25, 4, sC); SIMD_STEP(true, 25, 4, 1, sD)

// simd512 of the digest h, column j (j = the thread's rank in its group of
// 8, the group's threads adjacent in one warp); m0, m8: the digest's 32-bit
// words j and 8 + j. Returns the new digest's words j (a) and 8 + j (b).
// Every thread of the warp must call it (the steps shuffle).
__device__ __forceinline__ void simd512_64_j(const uint64_t h[8], int j, uint32_t m0,
                                             uint32_t m8, const uint32_t* tb,
                                             uint32_t& a, uint32_t& b) {
  int y[32];
  simd_expand_j(h, j, tb, y);
  uint32_t sA = kSimdIV[j], sB = kSimdIV[8 + j], sC = kSimdIV[16 + j],
           sD = kSimdIV[24 + j];
  uint32_t A = sA ^ m0, B = sB ^ m8, C = sC, D = sD;
#define W(i)                                                          \
  __byte_perm(static_cast<uint32_t>(y[(i) >> 3]),                     \
              static_cast<uint32_t>(y[((i) >> 3) ^ 16]), 0x5410)
  SIMD_ROUNDS;
#undef W
  // the final block (the length, 512, in word 0): its words a table
  sA = A;
  sB = B;
  sC = C;
  sD = D;
  A ^= j == 0 ? 512u : 0u;
  const uint32_t* wf = tb + kWFinalOff + j;
#define W(i) __ldg(&wf[(i)])
  SIMD_ROUNDS;
#undef W
  a = A;
  b = B;
}

// ---- 11. echo512: sixteen 128-bit words of four 32-bit columns ------------------

__device__ __forceinline__ uint32_t mul2x4(uint32_t x) {
  return ((x & 0x7F7F7F7Fu) << 1) ^ (((x >> 7) & 0x01010101u) * 0x1Bu);
}

// the digest's first 32 bytes as eight little-endian 32-bit words
__device__ __forceinline__ void echo512_64(const uint64_t h[8], AesTab T,
                                        uint32_t d[8]) {
  uint32_t s[16][4], M0[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    s[i][0] = 512;
    s[i][1] = s[i][2] = s[i][3] = 0;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s[8 + i][0] = lo32(h[2 * i]);
    s[8 + i][1] = hi32(h[2 * i]);
    s[8 + i][2] = lo32(h[2 * i + 1]);
    s[8 + i][3] = hi32(h[2 * i + 1]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) M0[i] = s[8 + i / 4][i % 4];
#pragma unroll
  for (int i = 12; i < 16; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0;
  s[12][0] = 0x80;
  s[14][3] = 512u << 16;
  s[15][0] = 512;
  uint32_t k = 512;
  X11_ROUNDS
  for (int r = 0; r < 10; ++r) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      aes_round(T, s[i][0], s[i][1], s[i][2], s[i][3]);
      s[i][0] ^= k + i;
      aes_round(T, s[i][0], s[i][1], s[i][2], s[i][3]);
    }
    k += 16;
    // BIG.ShiftRows: new word (row r, col c) = old word (r, (c + r) % 4),
    // word index r + 4c
    uint32_t t[16][4];
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
#pragma unroll
        for (int b = 0; b < 4; ++b) t[rr + 4 * c][b] = s[rr + 4 * ((c + rr) % 4)][b];
    // BIG.MixColumns: the AES MDS across the four words of each column,
    // byte-wise (four bytes packed a 32-bit word)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t a0 = t[4 * c][b], a1 = t[4 * c + 1][b], a2 = t[4 * c + 2][b],
                       a3 = t[4 * c + 3][b];
        const uint32_t m0 = mul2x4(a0), m1 = mul2x4(a1), m2 = mul2x4(a2),
                       m3 = mul2x4(a3);
        s[4 * c][b] = m0 ^ m1 ^ a1 ^ a2 ^ a3;
        s[4 * c + 1][b] = a0 ^ m1 ^ m2 ^ a2 ^ a3;
        s[4 * c + 2][b] = a0 ^ a1 ^ m2 ^ m3 ^ a3;
        s[4 * c + 3][b] = m0 ^ a0 ^ a1 ^ a2 ^ m3;
      }
  }
  // V ^ M ^ state[0:8] ^ state[8:16], words 0 and 1
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t v = (i % 4) == 0 ? 512u : 0u;
    d[i] = v ^ M0[i] ^ s[i / 4][i % 4] ^ s[8 + i / 4][i % 4];
  }
}

// ---- the kernels ------------------------------------------------------------

// the search's job: the prefix's 19 big-endian words, the nonce base, the
// target's limbs (most-significant-first), the shavite counter order
struct X11Job {
  uint32_t w[19];
  uint32_t base;
  uint32_t target[8];
  uint32_t cnt_order;
};
constexpr int kJobWords = 29;
// threads a block: the stages a thread a lane, simd's groups of 8, and the
// table stages (one block an SM: its 128 KiB of tables)
constexpr int kThreads = 128;
constexpr int kTabThreads = 512;
constexpr int kSimdGroup = 8;
// the other kernels' blocks an SM at least: 16 warps, so at most 128
// registers a thread; bmw 12 warps (it needs 161 registers), blake 8 (it
// spills at 168), groestl 12 (a 384-thread block: at 512 it spills)
constexpr int kMinBlocks = 4;
constexpr int kBmwBlocks = 3;
constexpr int kBlakeBlocks = 2;
constexpr int kGroThreads = 384;

// a lane's 64-byte value in the state buffer: word w at st[w * cap + lane]
__device__ __forceinline__ void load_state(const uint64_t* st, uint32_t cap,
                                           uint32_t lane, uint64_t h[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = st[static_cast<size_t>(i) * cap + lane];
}
__device__ __forceinline__ void store_state(uint64_t* st, uint32_t cap,
                                            uint32_t lane, const uint64_t h[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) st[static_cast<size_t>(i) * cap + lane] = h[i];
}

// the block's copy of a 128 KiB table region of the table block
__device__ __forceinline__ const char* copy_tables(const uint32_t* tb, int off) {
  extern __shared__ uint4 tab[];
  const uint4* src = reinterpret_cast<const uint4*>(tb + off);
#pragma unroll 4
  for (int i = threadIdx.x; i < kTabBytes / 16; i += blockDim.x) tab[i] = src[i];
  __syncthreads();
  return reinterpret_cast<const char*>(tab);
}

#ifdef X11_COUNT

}  // namespace

// stage X11_COUNT of one lane (simd: of one thread of its group) between a
// load of its input and a store of its output (x11_cuda.chain_instructions
// subtracts stage 0's count); external, so that the build keeps it though
// nothing launches it
extern "C" __global__ void __launch_bounds__(kThreads, kMinBlocks)
    x11_count_kernel(const uint64_t* __restrict__ in, uint64_t* out,
                     uint32_t cnt_order, const uint32_t* __restrict__ tb,
                     uint32_t row, const Fma f) {
  extern __shared__ uint4 tab[];
  const uint4* src = reinterpret_cast<const uint4*>(tb + (X11_COUNT == 3 ? kGroOff : kAesOff));
#pragma unroll
  for (int j = 0; j < kTabBytes / 16 / kThreads; ++j)
    tab[j * kThreads + threadIdx.x] = src[j * kThreads + threadIdx.x];
  __syncthreads();
  const char* sm = reinterpret_cast<const char*>(tab);
  const int lane = blockIdx.x * kThreads + threadIdx.x;
  uint64_t x[10], h[8];
#pragma unroll
  for (int i = 0; i < 10; ++i) x[i] = in[lane * 10 + i];
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = x[i];
  const AesTab aes{sm + (threadIdx.x & 31) * 4, row};
#if X11_COUNT == 1
  blake512_80(x, h);
#elif X11_COUNT == 2
  bmw512_64(h);
#elif X11_COUNT == 3
  groestl512_64(h, GroTab{sm + (threadIdx.x & 15) * 8, row});
#elif X11_COUNT == 4
  skein512_64(h);
#elif X11_COUNT == 5
  jh512_64(h, reinterpret_cast<const uint64_t*>(tb), f);
#elif X11_COUNT == 6
  keccak512_64(h);
#elif X11_COUNT == 7
  luffa512_64(h);
#elif X11_COUNT == 8
  cubehash512_64(h, tb);
#elif X11_COUNT == 9
  shavite512_64(h, aes, cnt_order);
#elif X11_COUNT == 10
  uint32_t a, b;
  simd512_64_j(h, threadIdx.x & 7, lo32(x[8]), hi32(x[9]), tb, a, b);
  h[0] = join64(a, b);
#elif X11_COUNT == 11
  uint32_t d[8];
  echo512_64(h, aes, d);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = join64(d[2 * i], d[2 * i + 1]);
#endif
#pragma unroll
  for (int i = 0; i < 8; ++i) out[lane * 8 + i] = h[i];
}

#else  // the kernels

// stage 1, the search: lane i of the chunk is launch offset first + i, its
// nonce word base + first + i; blake of its header
__global__ void __launch_bounds__(kThreads, kBlakeBlocks)
    blake_search_kernel(const X11Job job, uint32_t first, uint32_t n,
                        uint64_t* __restrict__ st, uint32_t cap) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint64_t hw[10], h[8];
#pragma unroll
  for (int w = 0; w < 9; ++w) hw[w] = join64(job.w[2 * w + 1], job.w[2 * w]);
  hw[9] = join64(job.base + first + i, job.w[18]);
  blake512_80(hw, h);
  store_state(st, cap, i, h);
}

// stage 1, the verify: lane i of the chunk is row first + i
__global__ void __launch_bounds__(kThreads, kBlakeBlocks)
    blake_verify_kernel(const uint32_t* __restrict__ words, uint32_t first,
                        uint32_t n, uint64_t* __restrict__ st, uint32_t cap) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const uint32_t* row = words + static_cast<size_t>(first + i) * 20;
  uint64_t hw[10], h[8];
#pragma unroll
  for (int w = 0; w < 10; ++w) hw[w] = join64(__ldg(&row[2 * w + 1]), __ldg(&row[2 * w]));
  blake512_80(hw, h);
  store_state(st, cap, i, h);
}

// stages 2, 4-8: a thread a lane, in place
template <int kStage>
__global__ void __launch_bounds__(kThreads, kStage == 2 ? kBmwBlocks : kMinBlocks)
    stage_kernel(uint64_t* __restrict__ st, uint32_t n, uint32_t cap,
                 const uint32_t* __restrict__ tb, const Fma f) {
  const uint32_t i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  uint64_t h[8];
  load_state(st, cap, i, h);
  if (kStage == 2) bmw512_64(h);
  if (kStage == 4) skein512_64(h);
  if (kStage == 5) jh512_64(h, reinterpret_cast<const uint64_t*>(tb), f);
  if (kStage == 6) keccak512_64(h);
  if (kStage == 7) luffa512_64(h);
  if (kStage == 8) cubehash512_64(h, tb);
  store_state(st, cap, i, h);
}

// stage 3: groestl, a block an SM looping over the lanes
__global__ void __launch_bounds__(kGroThreads, 1)
    groestl_kernel(uint64_t* __restrict__ st, uint32_t n, uint32_t cap,
                   const uint32_t* __restrict__ tb, uint32_t row) {
  const GroTab g{copy_tables(tb, kGroOff) + (threadIdx.x & 15) * 8, row};
  for (uint32_t i = blockIdx.x * kGroThreads + threadIdx.x; i < n;
       i += gridDim.x * kGroThreads) {
    uint64_t h[8];
    load_state(st, cap, i, h);
    groestl512_64(h, g);
    store_state(st, cap, i, h);
  }
}

// stage 9: shavite, as groestl
__global__ void __launch_bounds__(kTabThreads, 1)
    shavite_kernel(uint64_t* __restrict__ st, uint32_t n, uint32_t cap,
                   const uint32_t* __restrict__ tb, uint32_t row,
                   uint32_t cnt_order) {
  const AesTab T{copy_tables(tb, kAesOff) + (threadIdx.x & 31) * 4, row};
  for (uint32_t i = blockIdx.x * kTabThreads + threadIdx.x; i < n;
       i += gridDim.x * kTabThreads) {
    uint64_t h[8];
    load_state(st, cap, i, h);
    shavite512_64(h, T, cnt_order);
    store_state(st, cap, i, h);
  }
}

// stage 10: simd, a group of 8 adjacent threads a lane; a lane past n
// computes on lane n - 1's value (every thread shuffles) and stores nothing
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    simd_kernel(uint64_t* __restrict__ st, uint32_t n, uint32_t cap,
                const uint32_t* __restrict__ tb) {
  const uint32_t t = blockIdx.x * kThreads + threadIdx.x;
  const uint32_t i = t / kSimdGroup, j = t % kSimdGroup;
  const uint32_t lane = i < n ? i : n - 1;
  uint64_t h[8];
  load_state(st, cap, lane, h);
  // the digest's 32-bit words j and 8 + j: halves of 64-bit words j / 2 and
  // 4 + j / 2
  uint32_t* st32 = reinterpret_cast<uint32_t*>(st);
  const size_t w0 = (static_cast<size_t>(j / 2) * cap + lane) * 2 + (j & 1);
  const size_t w8 = (static_cast<size_t>(4 + j / 2) * cap + lane) * 2 + (j & 1);
  uint32_t a, b;
  simd512_64_j(h, j, st32[w0], st32[w8], tb, a, b);
  if (i < n) {
    st32[w0] = a;
    st32[w8] = b;
  }
}

// stage 11 and the compare: echo, as groestl; the digest's first 32 bytes
// against the job's target (search: winners) or the row's limbs (verify:
// failures), taken as launch offsets first + i; the block's min top limb
template <bool kVerify>
__global__ void __launch_bounds__(kTabThreads, 1)
    echo_kernel(const X11Job job, const uint32_t* __restrict__ limbs,
                uint32_t first, uint32_t n, const uint64_t* __restrict__ st,
                uint32_t cap, uint32_t* out, int k,
                const uint32_t* __restrict__ tb, uint32_t row) {
  const AesTab T{copy_tables(tb, kAesOff) + (threadIdx.x & 31) * 4, row};
  uint32_t best = kNoWinner;
  for (uint32_t i = blockIdx.x * kTabThreads + threadIdx.x; i < n;
       i += gridDim.x * kTabThreads) {
    uint64_t h[8];
    load_state(st, cap, i, h);
    uint32_t d[8], hl[8], t[8];
    echo512_64(h, T, d);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      hl[j] = d[7 - j];
      t[j] = kVerify ? __ldg(&limbs[static_cast<size_t>(first + i) * 8 + j])
                     : job.target[j];
    }
    best = min(best, hl[0]);
    if (limbs_le(hl, t) != kVerify) take_slot(out, k, first + i, hl[0]);
  }
  block_min_to<kTabThreads>(best, &out[2 * k + 2]);
}

unsigned int blocks_for(uint32_t threads, int per_block) {
  return static_cast<unsigned int>((static_cast<uint64_t>(threads) + per_block - 1) /
                                   per_block);
}

// the table stages' grid: one block an SM, no more than the lanes fill
unsigned int table_grid(uint32_t n, int threads) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const unsigned int need = blocks_for(n, threads);
  return need < static_cast<unsigned int>(sms) ? need : static_cast<unsigned int>(sms);
}

// the kernels by stage (1-11; 12, 13: the verify's first and last), for
// their launch shape and their attributes
const void* stage_fn(int stage) {
  switch (stage) {
    case 1: return reinterpret_cast<const void*>(blake_search_kernel);
    case 2: return reinterpret_cast<const void*>(stage_kernel<2>);
    case 3: return reinterpret_cast<const void*>(groestl_kernel);
    case 4: return reinterpret_cast<const void*>(stage_kernel<4>);
    case 5: return reinterpret_cast<const void*>(stage_kernel<5>);
    case 6: return reinterpret_cast<const void*>(stage_kernel<6>);
    case 7: return reinterpret_cast<const void*>(stage_kernel<7>);
    case 8: return reinterpret_cast<const void*>(stage_kernel<8>);
    case 9: return reinterpret_cast<const void*>(shavite_kernel);
    case 10: return reinterpret_cast<const void*>(simd_kernel);
    case 11: return reinterpret_cast<const void*>(echo_kernel<false>);
    case 12: return reinterpret_cast<const void*>(blake_verify_kernel);
    case 13: return reinterpret_cast<const void*>(echo_kernel<true>);
    default: return nullptr;
  }
}
bool table_stage(int stage) { return stage == 3 || stage == 9 || stage == 11 || stage == 13; }
int stage_threads(int stage) {
  return stage == 3 ? kGroThreads : table_stage(stage) ? kTabThreads : kThreads;
}
int stage_smem(int stage) { return table_stage(stage) ? kTabBytes : 0; }

// the FMA pipe's launch parameters
Fma make_fma() {
  Fma f;
  for (int r = 0; r < 32; ++r) f.pow2[r] = 1u << r;
  return f;
}
const Fma kFma = make_fma();

// Launch stage `stage` over the chunk's n lanes (offsets first..first+n-1)
// on s; the chunk's state at st (stride cap). job: the search's job (stages
// 1, 11) or, for the verify, its counter order; words, limbs: the verify's
// rows (stages 12, 13).
cudaError_t launch_stage(int stage, const X11Job& job, const uint32_t* words,
                         const uint32_t* limbs, uint32_t first, uint32_t n,
                         uint64_t* st, uint32_t cap, uint32_t* out, int k,
                         const uint32_t* tb, cudaStream_t s) {
  if (table_stage(stage)) {
    cudaError_t e = cudaFuncSetAttribute(stage_fn(stage),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         stage_smem(stage));
    if (e != cudaSuccess) return e;
  }
  const unsigned int b = blocks_for(n, kThreads), g = table_grid(n, kTabThreads);
  switch (stage) {
    case 1: blake_search_kernel<<<b, kThreads, 0, s>>>(job, first, n, st, cap); break;
    case 12: blake_verify_kernel<<<b, kThreads, 0, s>>>(words, first, n, st, cap); break;
    case 2: stage_kernel<2><<<b, kThreads, 0, s>>>(st, n, cap, tb, kFma); break;
    case 3:
      groestl_kernel<<<table_grid(n, kGroThreads), kGroThreads, kTabBytes, s>>>(
          st, n, cap, tb, kRowBytes);
      break;
    case 4: stage_kernel<4><<<b, kThreads, 0, s>>>(st, n, cap, tb, kFma); break;
    case 5: stage_kernel<5><<<b, kThreads, 0, s>>>(st, n, cap, tb, kFma); break;
    case 6: stage_kernel<6><<<b, kThreads, 0, s>>>(st, n, cap, tb, kFma); break;
    case 7: stage_kernel<7><<<b, kThreads, 0, s>>>(st, n, cap, tb, kFma); break;
    case 8: stage_kernel<8><<<b, kThreads, 0, s>>>(st, n, cap, tb, kFma); break;
    case 9:
      shavite_kernel<<<g, kTabThreads, kTabBytes, s>>>(st, n, cap, tb, kRowBytes,
                                                       job.cnt_order);
      break;
    case 10:
      simd_kernel<<<blocks_for(n * kSimdGroup, kThreads), kThreads, 0, s>>>(st, n, cap, tb);
      break;
    case 11:
      echo_kernel<false><<<g, kTabThreads, kTabBytes, s>>>(job, limbs, first, n, st, cap,
                                                           out, k, tb, kRowBytes);
      break;
    case 13:
      echo_kernel<true><<<g, kTabThreads, kTabBytes, s>>>(job, limbs, first, n, st, cap,
                                                          out, k, tb, kRowBytes);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// the chain over one chunk: the first stage, 2-10, the last
cudaError_t launch_chain(bool verify, const X11Job& job, const uint32_t* words,
                         const uint32_t* limbs, uint32_t first, uint32_t n,
                         uint64_t* st, uint32_t cap, uint32_t* out, int k,
                         const uint32_t* tb, cudaStream_t s) {
  for (int stage = 1; stage <= 11; ++stage) {
    const int which = verify && stage == 1 ? 12 : verify && stage == 11 ? 13 : stage;
    const cudaError_t e = launch_stage(which, job, words, limbs, first, n, st, cap,
                                       out, k, tb, s);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

bool chunk_ok(unsigned long long first, unsigned long long n, unsigned long long cap,
              int k) {
  return k >= 1 && n >= 1 && n <= cap && cap <= 0xFFFFFFFFull &&
         first + n <= (1ull << 32) && n * kSimdGroup <= 0xFFFFFFFFull;
}

}  // namespace

extern "C" {

// The buffer's init before a search's or a verify's chunks, and its
// finalize after them (the slots sorted by offset), on `stream`.
int otedama_x11_begin(uint32_t* out, int k, void* stream) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  init_buffer<<<1, 64, 0, static_cast<cudaStream_t>(stream)>>>(out, k);
  return static_cast<int>(cudaGetLastError());
}

int otedama_x11_end(uint32_t* out, int k, void* stream) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  finalize_buffer<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(out, k, 0u);
  return static_cast<int>(cudaGetLastError());
}

// One chunk of a search on `stream`, without synchronizing: launch offsets
// first..first+n-1 (first + n <= 2^32) of the job (host pointer to its 29
// words, copied into the kernel parameters); state: device pointer to the
// chunk's 8 x cap 64-bit words (n <= cap); out: device pointer to 2k+3
// words; tables: device pointer to the table block. Returns a cudaError_t.
int otedama_x11_search_chunk(const uint32_t* job, unsigned long long first,
                             unsigned long long n, int k, uint32_t* out,
                             const uint32_t* tables, uint64_t* state,
                             unsigned long long cap, void* stream) {
  if (!chunk_ok(first, n, cap, k)) return static_cast<int>(cudaErrorInvalidValue);
  X11Job j;
  static_assert(sizeof(X11Job) == kJobWords * 4, "X11Job must be the packed words");
  memcpy(&j, job, sizeof(j));
  return static_cast<int>(launch_chain(false, j, nullptr, nullptr,
                                       static_cast<uint32_t>(first),
                                       static_cast<uint32_t>(n), state,
                                       static_cast<uint32_t>(cap), out, k, tables,
                                       static_cast<cudaStream_t>(stream)));
}

// One chunk of a verify on `stream`, without synchronizing: rows
// first..first+n-1 of words (device, row-major [rows, 20] big-endian header
// words) against limbs (device, [rows, 8], most-significant-first); failing
// row offsets go into out. Returns a cudaError_t.
int otedama_x11_verify_chunk(const uint32_t* words, const uint32_t* limbs,
                             unsigned long long first, unsigned long long n, int k,
                             uint32_t* out, unsigned int cnt_order,
                             const uint32_t* tables, uint64_t* state,
                             unsigned long long cap, void* stream) {
  if (!chunk_ok(first, n, cap, k)) return static_cast<int>(cudaErrorInvalidValue);
  X11Job j{};
  j.cnt_order = cnt_order;
  return static_cast<int>(launch_chain(true, j, words, limbs,
                                       static_cast<uint32_t>(first),
                                       static_cast<uint32_t>(n), state,
                                       static_cast<uint32_t>(cap), out, k, tables,
                                       static_cast<cudaStream_t>(stream)));
}

// Stage `stage` alone (1-11 of the search; 12, 13 the verify's first and
// last) over n lanes of the state, for its time; the job and out as for a
// search chunk at offset 0, limbs and words as for a verify chunk.
int otedama_x11_stage(int stage, const uint32_t* job, const uint32_t* words,
                      const uint32_t* limbs, unsigned long long n, int k,
                      uint32_t* out, const uint32_t* tables, uint64_t* state,
                      unsigned long long cap, void* stream) {
  if (!chunk_ok(0, n, cap, k) || stage_fn(stage) == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  X11Job j;
  memcpy(&j, job, sizeof(j));
  return static_cast<int>(launch_stage(stage, j, words, limbs, 0,
                                       static_cast<uint32_t>(n), state,
                                       static_cast<uint32_t>(cap), out, k, tables,
                                       static_cast<cudaStream_t>(stream)));
}

// A stage's kernel (numbered as for otedama_x11_stage) on the current
// device: its threads a block, registers a thread, local memory (stack
// and spills) a thread, shared memory a block, and its resident blocks an
// SM. Returns a cudaError_t.
int otedama_x11_kernel_info(int stage, int* threads, int* regs, int* local_bytes,
                            int* smem_bytes, int* blocks_per_sm) {
  const void* fn = stage_fn(stage);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const bool tab = table_stage(stage);
  if (tab) {
    cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         stage_smem(stage));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return static_cast<int>(e);
  *threads = stage_threads(stage);
  *regs = a.numRegs;
  *local_bytes = static_cast<int>(a.localSizeBytes);
  *smem_bytes = static_cast<int>(a.sharedSizeBytes) + stage_smem(stage);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, *threads, stage_smem(stage)));
}

const char* otedama_x11_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

#endif  // X11_COUNT
