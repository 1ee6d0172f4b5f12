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
//   - x11_search_kernel: lane i hashes the 76-byte prefix with nonce word
//     base + i (mod 2^32, big-endian at bytes 76:80), built here on the
//     card; WINNERS go into the table as lane offsets;
//   - x11_verify_kernel: lane i hashes its own row of 20 big-endian header
//     words against its own 8 target limbs; FAILURES go into the table as
//     lane offsets.
// Winners take slots with atomicAdd and a one-thread finalize launch sorts
// them by offset, so for n <= k the buffer equals the reference's lane-order
// compaction word for word; the min top limb covers the in-range lanes.
//
// Design (a first, simple one): one thread a lane, each stage a __device__
// function on native 64-bit (or 32-bit) words in registers, the stages in
// the form kernels/x11_torch.py writes them (its docstring): groestl through
// eight 256-entry 64-bit tables and the AES rounds of shavite and echo
// through the four AES T-tables, all in shared memory, loaded once a block
// from the table block the wrapper builds (x11_cuda.table_block); jh
// bitsliced, its round constants and IV read from that block; simd's NTT
// over Z_257 as radix-2 butterflies on a per-thread array, the final
// block's expanded words a table. What bounds it: integer operations (no
// byte of the chain leaves the SM but the header and the table), plus the
// shared-memory table lookups of groestl, shavite and echo; chip_smoke.py
// phase 1 prints its registers and spills and phase 33 its time beside the
// bound.
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "sha256_device.cuh"

// A counting build (-DX11_COUNT=S, x11_cuda.chain_instructions) unrolls
// every round loop and inlines every stage, and holds only
// x11_count_kernel, stage S of the chain (1-11 in chain order; 0: none) of
// one lane in straight-line code: its SASS is the instructions a lane
// executes there. It is compiled for its SASS and never launched.
#ifdef X11_COUNT
#define X11_ROUNDS _Pragma("unroll")
#define X11_NOINLINE __forceinline__
#else
#define X11_ROUNDS
#define X11_NOINLINE __noinline__
#endif

namespace {

// the table block (uint64 words; x11_cuda.table_block builds it)
constexpr int kGroOff = 0;           // [8][256] groestl tables
constexpr int kAesOff = 2048;        // [256] AES T0 (32-bit values)
constexpr int kJhIvOff = 2304;       // [16] jh IV, big-endian words
constexpr int kJhCOff = 2320;        // [42][4] jh round constants
constexpr int kTwistOff = 2488;      // [256] simd twist 163^k mod 257
constexpr int kWFinalOff = 2744;     // [256] simd final block's words
constexpr int kCubeIvOff = 3000;     // [32] cubehash IV
constexpr int kOmegaOff = 3032;      // [256] 41^k mod 257
constexpr int kTableWords = 3288;

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

// what a block keeps in shared memory: groestl's eight tables and AES's four
struct Tables {
  uint64_t gro[8][256];
  uint32_t aes[4][256];
};

template <int kT>
__device__ __forceinline__ void load_tables(Tables& s, const uint64_t* tb) {
  // every launch has kT threads a block: loops of fixed counts
  static_assert(256 % kT == 0, "kT must divide the tables");
#pragma unroll
  for (int j = 0; j < 2048 / kT; ++j) {
    const int i = j * kT + threadIdx.x;
    s.gro[i >> 8][i & 255] = tb[kGroOff + i];
  }
#pragma unroll
  for (int j = 0; j < 256 / kT; ++j) {
    const int i = j * kT + threadIdx.x;
    const uint32_t t = static_cast<uint32_t>(tb[kAesOff + i]);
    s.aes[0][i] = t;
    s.aes[1][i] = rotl32(t, 8);
    s.aes[2][i] = rotl32(t, 16);
    s.aes[3][i] = rotl32(t, 24);
  }
  __syncthreads();
}

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

__device__ X11_NOINLINE void groestl_perm_p(uint64_t x[16], const uint64_t (*G)[256]) {
  X11_ROUNDS
  for (int r = 0; r < 14; ++r) {
#pragma unroll
    for (int c = 0; c < 16; ++c) x[c] ^= static_cast<uint64_t>((c << 4) ^ r);
    uint64_t t[16];
    t[0] = G[0][(uint32_t)(x[0] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[1] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[2] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[3] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[4] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[5] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[6] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[11] >> 56) & 0xFF];
    t[1] = G[0][(uint32_t)(x[1] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[2] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[3] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[4] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[5] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[6] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[7] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[12] >> 56) & 0xFF];
    t[2] = G[0][(uint32_t)(x[2] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[3] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[4] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[5] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[6] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[7] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[8] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[13] >> 56) & 0xFF];
    t[3] = G[0][(uint32_t)(x[3] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[4] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[5] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[6] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[7] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[8] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[9] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[14] >> 56) & 0xFF];
    t[4] = G[0][(uint32_t)(x[4] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[5] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[6] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[7] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[8] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[9] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[10] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[15] >> 56) & 0xFF];
    t[5] = G[0][(uint32_t)(x[5] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[6] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[7] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[8] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[9] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[10] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[11] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[0] >> 56) & 0xFF];
    t[6] = G[0][(uint32_t)(x[6] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[7] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[8] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[9] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[10] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[11] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[12] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[1] >> 56) & 0xFF];
    t[7] = G[0][(uint32_t)(x[7] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[8] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[9] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[10] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[11] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[12] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[13] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[2] >> 56) & 0xFF];
    t[8] = G[0][(uint32_t)(x[8] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[9] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[10] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[11] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[12] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[13] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[14] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[3] >> 56) & 0xFF];
    t[9] = G[0][(uint32_t)(x[9] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[10] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[11] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[12] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[13] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[14] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[15] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[4] >> 56) & 0xFF];
    t[10] = G[0][(uint32_t)(x[10] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[11] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[12] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[13] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[14] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[15] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[0] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[5] >> 56) & 0xFF];
    t[11] = G[0][(uint32_t)(x[11] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[12] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[13] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[14] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[15] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[0] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[1] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[6] >> 56) & 0xFF];
    t[12] = G[0][(uint32_t)(x[12] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[13] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[14] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[15] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[0] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[1] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[2] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[7] >> 56) & 0xFF];
    t[13] = G[0][(uint32_t)(x[13] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[14] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[15] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[0] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[1] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[2] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[3] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[8] >> 56) & 0xFF];
    t[14] = G[0][(uint32_t)(x[14] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[15] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[0] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[1] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[2] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[3] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[4] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[9] >> 56) & 0xFF];
    t[15] = G[0][(uint32_t)(x[15] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[0] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[1] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[2] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[3] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[4] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[5] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[10] >> 56) & 0xFF];
#pragma unroll
    for (int c = 0; c < 16; ++c) x[c] = t[c];
  }
}

__device__ X11_NOINLINE void groestl_perm_q(uint64_t x[16], const uint64_t (*G)[256]) {
  X11_ROUNDS
  for (int r = 0; r < 14; ++r) {
#pragma unroll
    for (int c = 0; c < 16; ++c)
      x[c] = ~x[c] ^ (static_cast<uint64_t>((c << 4) ^ r) << 56);
    uint64_t t[16];
    t[0] = G[0][(uint32_t)(x[1] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[3] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[5] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[11] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[0] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[2] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[4] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[6] >> 56) & 0xFF];
    t[1] = G[0][(uint32_t)(x[2] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[4] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[6] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[12] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[1] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[3] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[5] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[7] >> 56) & 0xFF];
    t[2] = G[0][(uint32_t)(x[3] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[5] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[7] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[13] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[2] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[4] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[6] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[8] >> 56) & 0xFF];
    t[3] = G[0][(uint32_t)(x[4] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[6] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[8] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[14] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[3] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[5] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[7] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[9] >> 56) & 0xFF];
    t[4] = G[0][(uint32_t)(x[5] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[7] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[9] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[15] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[4] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[6] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[8] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[10] >> 56) & 0xFF];
    t[5] = G[0][(uint32_t)(x[6] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[8] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[10] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[0] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[5] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[7] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[9] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[11] >> 56) & 0xFF];
    t[6] = G[0][(uint32_t)(x[7] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[9] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[11] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[1] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[6] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[8] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[10] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[12] >> 56) & 0xFF];
    t[7] = G[0][(uint32_t)(x[8] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[10] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[12] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[2] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[7] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[9] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[11] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[13] >> 56) & 0xFF];
    t[8] = G[0][(uint32_t)(x[9] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[11] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[13] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[3] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[8] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[10] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[12] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[14] >> 56) & 0xFF];
    t[9] = G[0][(uint32_t)(x[10] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[12] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[14] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[4] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[9] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[11] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[13] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[15] >> 56) & 0xFF];
    t[10] = G[0][(uint32_t)(x[11] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[13] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[15] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[5] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[10] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[12] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[14] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[0] >> 56) & 0xFF];
    t[11] = G[0][(uint32_t)(x[12] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[14] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[0] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[6] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[11] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[13] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[15] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[1] >> 56) & 0xFF];
    t[12] = G[0][(uint32_t)(x[13] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[15] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[1] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[7] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[12] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[14] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[0] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[2] >> 56) & 0xFF];
    t[13] = G[0][(uint32_t)(x[14] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[0] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[2] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[8] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[13] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[15] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[1] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[3] >> 56) & 0xFF];
    t[14] = G[0][(uint32_t)(x[15] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[1] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[3] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[9] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[14] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[0] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[2] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[4] >> 56) & 0xFF];
    t[15] = G[0][(uint32_t)(x[0] >> 0) & 0xFF]
        ^ G[1][(uint32_t)(x[2] >> 8) & 0xFF]
        ^ G[2][(uint32_t)(x[4] >> 16) & 0xFF]
        ^ G[3][(uint32_t)(x[10] >> 24) & 0xFF]
        ^ G[4][(uint32_t)(x[15] >> 32) & 0xFF]
        ^ G[5][(uint32_t)(x[1] >> 40) & 0xFF]
        ^ G[6][(uint32_t)(x[3] >> 48) & 0xFF]
        ^ G[7][(uint32_t)(x[5] >> 56) & 0xFF];
#pragma unroll
    for (int c = 0; c < 16; ++c) x[c] = t[c];
  }
}

__device__ __forceinline__ void groestl512_64(uint64_t h[8], const uint64_t (*G)[256]) {
  uint64_t m[16], a[16], q[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) m[i] = h[i];
  m[8] = 0x80;
#pragma unroll
  for (int i = 9; i < 15; ++i) m[i] = 0;
  m[15] = 1ull << 56;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const uint64_t iv = i == 15 ? (2ull << 48) : 0;
    a[i] = m[i] ^ iv;
    q[i] = m[i];
  }
  groestl_perm_p(a, G);
  groestl_perm_q(q, G);
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    a[i] ^= q[i] ^ (i == 15 ? (2ull << 48) : 0);
    q[i] = a[i];
  }
  groestl_perm_p(a, G);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = a[8 + i] ^ q[8 + i];
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

template <int n>
__device__ __forceinline__ uint64_t jh_swap(uint64_t x) {
  constexpr uint64_t m = n == 0 ? 0x5555555555555555ull
                       : n == 1 ? 0x3333333333333333ull
                       : n == 2 ? 0x0F0F0F0F0F0F0F0Full
                       : n == 3 ? 0x00FF00FF00FF00FFull
                       : n == 4 ? 0x0000FFFF0000FFFFull
                                : 0x00000000FFFFFFFFull;
  return ((x & m) << (1 << n)) | ((x >> (1 << n)) & m);
}

// one round r (n = r mod 7): S-boxes and L on both halves, then the odd
// words' bit swap at distance 2^n (n = 6: their halves swap)
template <int n>
__device__ __forceinline__ void jh_round(uint64_t x[16], const uint64_t* c) {
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
      x[2 * j] = jh_swap<n < 6 ? n : 0>(x[2 * j]);
      x[2 * j + 1] = jh_swap<n < 6 ? n : 0>(x[2 * j + 1]);
    }
  }
}

__device__ __forceinline__ void jh_e8(uint64_t x[16], const uint64_t* tb) {
  const uint64_t* c = tb + kJhCOff;
  X11_ROUNDS
  for (int r = 0; r < 42; r += 7) {
    jh_round<0>(x, c + 4 * (r + 0));
    jh_round<1>(x, c + 4 * (r + 1));
    jh_round<2>(x, c + 4 * (r + 2));
    jh_round<3>(x, c + 4 * (r + 3));
    jh_round<4>(x, c + 4 * (r + 4));
    jh_round<5>(x, c + 4 * (r + 5));
    jh_round<6>(x, c + 4 * (r + 6));
  }
}

__device__ __forceinline__ void jh512_64(uint64_t h[8], const uint64_t* tb) {
  uint64_t x[16], m[8];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = __ldg(&tb[kJhIvOff + i]);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = bswap64(h[i]);
    x[i] ^= m[i];
  }
  jh_e8(x, tb);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[8 + i] ^= m[i];
  // the padding block: 0x80, zeros, the 128-bit big-endian bit length 512
  x[0] ^= 0x80ull << 56;
  x[7] ^= 512;
  jh_e8(x, tb);
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

__device__ __forceinline__ void cubehash512_64(uint64_t h[8], const uint64_t* tb) {
  uint32_t x[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) x[i] = static_cast<uint32_t>(__ldg(&tb[kCubeIvOff + i]));
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

__device__ __forceinline__ void aes_round(const uint32_t (*T)[256], uint32_t& x0,
                                          uint32_t& x1, uint32_t& x2, uint32_t& x3) {
  const uint32_t y0 = T[0][x0 & 0xFF] ^ T[1][(x1 >> 8) & 0xFF] ^
                      T[2][(x2 >> 16) & 0xFF] ^ T[3][x3 >> 24];
  const uint32_t y1 = T[0][x1 & 0xFF] ^ T[1][(x2 >> 8) & 0xFF] ^
                      T[2][(x3 >> 16) & 0xFF] ^ T[3][x0 >> 24];
  const uint32_t y2 = T[0][x2 & 0xFF] ^ T[1][(x3 >> 8) & 0xFF] ^
                      T[2][(x0 >> 16) & 0xFF] ^ T[3][x1 >> 24];
  const uint32_t y3 = T[0][x3 & 0xFF] ^ T[1][(x0 >> 8) & 0xFF] ^
                      T[2][(x1 >> 16) & 0xFF] ^ T[3][x2 >> 24];
  x0 = y0;
  x1 = y1;
  x2 = y2;
  x3 = y3;
}

// ---- 9. shavite512: 14 Feistel rounds, the 448 subkey words made in windows
// of 32 as they are used ----------------------------------------------------------

// F: x ^ k0, then AES with k1, k2, k3 between, and a last keyless AES
__device__ __forceinline__ void shavite_f4(const uint32_t (*T)[256], const uint32_t p[4],
                                           const uint32_t* k, uint32_t f[4]) {
  uint32_t t0 = p[0] ^ k[0], t1 = p[1] ^ k[1], t2 = p[2] ^ k[2], t3 = p[3] ^ k[3];
#pragma unroll
  for (int r = 1; r < 4; ++r) {
    aes_round(T, t0, t1, t2, t3);
    t0 ^= k[4 * r];
    t1 ^= k[4 * r + 1];
    t2 ^= k[4 * r + 2];
    t3 ^= k[4 * r + 3];
  }
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

__device__ X11_NOINLINE void shavite512_64(uint64_t h[8], const uint32_t (*T)[256],
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

// ---- 10. simd512 ----------------------------------------------------------------

#define SIMD_STEP(use_if, r, s, p, wbase)                                     \
  do {                                                                        \
    uint32_t tA[8], nA[8];                                                    \
    _Pragma("unroll") for (int j = 0; j < 8; ++j) tA[j] = rotl32(A[j], r);    \
    _Pragma("unroll") for (int j = 0; j < 8; ++j) {                           \
      const uint32_t f = use_if ? (((B[j] ^ C[j]) & A[j]) ^ C[j])             \
                                : ((C[j] & B[j]) | ((C[j] | B[j]) & A[j]));   \
      nA[j] = rotl32(D[j] + W(wbase + j) + f, s) + tA[j ^ p];                 \
    }                                                                         \
    _Pragma("unroll") for (int j = 0; j < 8; ++j) {                           \
      D[j] = C[j];                                                            \
      C[j] = B[j];                                                            \
      B[j] = tA[j];                                                           \
      A[j] = nA[j];                                                           \
    }                                                                         \
  } while (0)

#define SIMD_FF(r, s, p, fs)                                                  \
  do {                                                                        \
    uint32_t tA[8], nA[8];                                                    \
    _Pragma("unroll") for (int j = 0; j < 8; ++j) tA[j] = rotl32(A[j], r);    \
    _Pragma("unroll") for (int j = 0; j < 8; ++j) {                           \
      const uint32_t f = ((B[j] ^ C[j]) & A[j]) ^ C[j];                       \
      nA[j] = rotl32(D[j] + saved[8 * fs + j] + f, s) + tA[j ^ p];            \
    }                                                                         \
    _Pragma("unroll") for (int j = 0; j < 8; ++j) {                           \
      D[j] = C[j];                                                            \
      C[j] = B[j];                                                            \
      B[j] = tA[j];                                                           \
      A[j] = nA[j];                                                           \
    }                                                                         \
  } while (0)

// the compression's body: state A|B|C|D, m the block's 32 little-endian
// words, W(i) its expanded word i (a macro over what the caller holds)
// the first block: the 64 digest bytes and 64 zeros; its expanded words from
// the NTT of those bytes (y, this thread's 256-entry array)
__device__ X11_NOINLINE void simd_compress_msg(uint32_t state[32], const uint32_t m[32],
                                               const int* y) {
#define W(i) ((static_cast<uint32_t>(y[(i)]) & 0xFFFFu) | \
              ((static_cast<uint32_t>(y[(i) ^ 128]) & 0xFFFFu) << 16))
  uint32_t saved[32], A[8], B[8], C[8], D[8];
#pragma unroll
  for (int i = 0; i < 32; ++i) saved[i] = state[i];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    A[j] = state[j] ^ m[j];
    B[j] = state[8 + j] ^ m[8 + j];
    C[j] = state[16 + j] ^ m[16 + j];
    D[j] = state[24 + j] ^ m[24 + j];
  }
    SIMD_STEP(true, 3, 23, 1, 32);
    SIMD_STEP(true, 23, 17, 6, 48);
    SIMD_STEP(true, 17, 27, 2, 0);
    SIMD_STEP(true, 27, 3, 3, 16);
    SIMD_STEP(false, 3, 23, 5, 56);
    SIMD_STEP(false, 23, 17, 7, 40);
    SIMD_STEP(false, 17, 27, 4, 24);
    SIMD_STEP(false, 27, 3, 1, 8);
    SIMD_STEP(true, 28, 19, 6, 120);
    SIMD_STEP(true, 19, 22, 2, 88);
    SIMD_STEP(true, 22, 7, 3, 96);
    SIMD_STEP(true, 7, 28, 5, 64);
    SIMD_STEP(false, 28, 19, 7, 72);
    SIMD_STEP(false, 19, 22, 4, 104);
    SIMD_STEP(false, 22, 7, 1, 80);
    SIMD_STEP(false, 7, 28, 6, 112);
    SIMD_STEP(true, 29, 9, 2, 136);
    SIMD_STEP(true, 9, 15, 3, 144);
    SIMD_STEP(true, 15, 5, 5, 184);
    SIMD_STEP(true, 5, 29, 7, 160);
    SIMD_STEP(false, 29, 9, 4, 176);
    SIMD_STEP(false, 9, 15, 1, 168);
    SIMD_STEP(false, 15, 5, 6, 128);
    SIMD_STEP(false, 5, 29, 2, 152);
    SIMD_STEP(true, 4, 13, 3, 240);
    SIMD_STEP(true, 13, 10, 5, 192);
    SIMD_STEP(true, 10, 25, 7, 200);
    SIMD_STEP(true, 25, 4, 4, 248);
    SIMD_STEP(false, 4, 13, 1, 216);
    SIMD_STEP(false, 13, 10, 6, 232);
    SIMD_STEP(false, 10, 25, 2, 224);
    SIMD_STEP(false, 25, 4, 3, 208);
  SIMD_FF(4, 13, 5, 0);
  SIMD_FF(13, 10, 7, 1);
  SIMD_FF(10, 25, 4, 2);
  SIMD_FF(25, 4, 1, 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    state[j] = A[j];
    state[8 + j] = B[j];
    state[16 + j] = C[j];
    state[24 + j] = D[j];
  }
#undef W
}

// the final block: the fixed length block, its expanded words a table
__device__ X11_NOINLINE void simd_compress_final(uint32_t state[32], const uint32_t m[32],
                                                 const uint64_t* wf) {
#define W(i) static_cast<uint32_t>(__ldg(&wf[(i)]))
  uint32_t saved[32], A[8], B[8], C[8], D[8];
#pragma unroll
  for (int i = 0; i < 32; ++i) saved[i] = state[i];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    A[j] = state[j] ^ m[j];
    B[j] = state[8 + j] ^ m[8 + j];
    C[j] = state[16 + j] ^ m[16 + j];
    D[j] = state[24 + j] ^ m[24 + j];
  }
    SIMD_STEP(true, 3, 23, 1, 32);
    SIMD_STEP(true, 23, 17, 6, 48);
    SIMD_STEP(true, 17, 27, 2, 0);
    SIMD_STEP(true, 27, 3, 3, 16);
    SIMD_STEP(false, 3, 23, 5, 56);
    SIMD_STEP(false, 23, 17, 7, 40);
    SIMD_STEP(false, 17, 27, 4, 24);
    SIMD_STEP(false, 27, 3, 1, 8);
    SIMD_STEP(true, 28, 19, 6, 120);
    SIMD_STEP(true, 19, 22, 2, 88);
    SIMD_STEP(true, 22, 7, 3, 96);
    SIMD_STEP(true, 7, 28, 5, 64);
    SIMD_STEP(false, 28, 19, 7, 72);
    SIMD_STEP(false, 19, 22, 4, 104);
    SIMD_STEP(false, 22, 7, 1, 80);
    SIMD_STEP(false, 7, 28, 6, 112);
    SIMD_STEP(true, 29, 9, 2, 136);
    SIMD_STEP(true, 9, 15, 3, 144);
    SIMD_STEP(true, 15, 5, 5, 184);
    SIMD_STEP(true, 5, 29, 7, 160);
    SIMD_STEP(false, 29, 9, 4, 176);
    SIMD_STEP(false, 9, 15, 1, 168);
    SIMD_STEP(false, 15, 5, 6, 128);
    SIMD_STEP(false, 5, 29, 2, 152);
    SIMD_STEP(true, 4, 13, 3, 240);
    SIMD_STEP(true, 13, 10, 5, 192);
    SIMD_STEP(true, 10, 25, 7, 200);
    SIMD_STEP(true, 25, 4, 4, 248);
    SIMD_STEP(false, 4, 13, 1, 216);
    SIMD_STEP(false, 13, 10, 6, 232);
    SIMD_STEP(false, 10, 25, 2, 224);
    SIMD_STEP(false, 25, 4, 3, 208);
  SIMD_FF(4, 13, 5, 0);
  SIMD_FF(13, 10, 7, 1);
  SIMD_FF(10, 25, 4, 2);
  SIMD_FF(25, 4, 1, 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    state[j] = A[j];
    state[8 + j] = B[j];
    state[16 + j] = C[j];
    state[24 + j] = D[j];
  }
#undef W
}

__device__ __forceinline__ int mod257(int x) {
  x %= 257;
  return x < 0 ? x + 257 : x;
}

// one butterfly of simd's NTT: y[lo] and y[lo + half] by the twiddle w
__device__ __forceinline__ void simd_butterfly(int y[256], int lo, int half,
                                               uint64_t w) {
  const int u = y[lo];
  const int v = (y[lo + half] * static_cast<int>(w)) % 257;
  y[lo] = mod257(u + v);
  y[lo + half] = mod257(u - v);
}

#ifdef X11_COUNT
template <int kLg>
__device__ __forceinline__ void simd_ntt_level(int y[256], const uint64_t* tb) {
  constexpr int kLen = 1 << kLg, kHalf = kLen >> 1, kStride = 256 >> kLg;
#pragma unroll
  for (int blk = 0; blk < 256; blk += kLen) {
#pragma unroll
    for (int j = 0; j < kHalf; ++j)
      simd_butterfly(y, blk + j, kHalf, __ldg(&tb[kOmegaOff + j * kStride]));
  }
}
#endif

// y[k] = sum_j x[j] * 41^(jk) mod 257 for the 64 bytes x of h (x[j] = 0 past
// 64), radix-2 butterflies on the bit-reversed input; then the twist 163^k,
// centred to [-128, 128]
__device__ X11_NOINLINE void simd_expand(const uint64_t h[8], int y[256], const uint64_t* tb) {
  X11_ROUNDS
  for (int i = 0; i < 256; ++i) {
    const int j = __brev(static_cast<uint32_t>(i)) >> 24;
    y[i] = j < 64 ? static_cast<int>((h[j >> 3] >> (8 * (j & 7))) & 0xFF) : 0;
  }
#ifdef X11_COUNT
  // the levels one by one, their loops of fixed counts (LLVM unrolls an
  // inner loop before the loop around it)
  simd_ntt_level<1>(y, tb);
  simd_ntt_level<2>(y, tb);
  simd_ntt_level<3>(y, tb);
  simd_ntt_level<4>(y, tb);
  simd_ntt_level<5>(y, tb);
  simd_ntt_level<6>(y, tb);
  simd_ntt_level<7>(y, tb);
  simd_ntt_level<8>(y, tb);
#else
  for (int len = 2, stride = 128; len <= 256; len <<= 1, stride >>= 1) {
    const int half = len >> 1;
    for (int blk = 0; blk < 256; blk += len) {
      for (int j = 0; j < half; ++j)
        simd_butterfly(y, blk + j, half, __ldg(&tb[kOmegaOff + j * stride]));
    }
  }
#endif
  X11_ROUNDS
  for (int k = 0; k < 256; ++k) {
    const int s = (y[k] * static_cast<int>(__ldg(&tb[kTwistOff + k]))) % 257;
    y[k] = s > 128 ? s - 257 : s;
  }
}

__device__ __forceinline__ void simd512_64(uint64_t h[8], const uint64_t* tb) {
  int y[256];
  simd_expand(h, y, tb);
  uint32_t state[32], m[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) state[i] = kSimdIV[i];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[2 * i] = lo32(h[i]);
    m[2 * i + 1] = hi32(h[i]);
  }
#pragma unroll
  for (int i = 16; i < 32; ++i) m[i] = 0;
  simd_compress_msg(state, m, y);
  m[0] = 512;
#pragma unroll
  for (int i = 1; i < 32; ++i) m[i] = 0;
  simd_compress_final(state, m, tb + kWFinalOff);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = join64(state[2 * i], state[2 * i + 1]);
}

// ---- 11. echo512: sixteen 128-bit words of four 32-bit columns ------------------

__device__ __forceinline__ uint32_t mul2x4(uint32_t x) {
  return ((x & 0x7F7F7F7Fu) << 1) ^ (((x >> 7) & 0x01010101u) * 0x1Bu);
}

// the digest's first 32 bytes as eight little-endian 32-bit words
__device__ X11_NOINLINE void echo512_64(const uint64_t h[8], const uint32_t (*T)[256],
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

// ---- the chain --------------------------------------------------------------

// hw: the header's ten big-endian 64-bit words; d: the digest's first 32
// bytes as eight little-endian 32-bit words
__device__ __forceinline__ void x11_chain(const uint64_t hw[10], const Tables& sm,
                                          const uint64_t* tb, uint32_t cnt_order,
                                          uint32_t d[8]) {
  uint64_t h[8];
  blake512_80(hw, h);
  bmw512_64(h);
  groestl512_64(h, sm.gro);
  skein512_64(h);
  jh512_64(h, tb);
  keccak512_64(h);
  luffa512_64(h);
  cubehash512_64(h, tb);
  shavite512_64(h, sm.aes, cnt_order);
  simd512_64(h, tb);
  echo512_64(h, sm.aes, d);
}

// the search's job: the prefix's 19 big-endian words, the nonce base, the
// target's limbs (most-significant-first), the shavite counter order
struct X11Job {
  uint32_t w[19];
  uint32_t base;
  uint32_t target[8];
  uint32_t cnt_order;
};
constexpr int kJobWords = 29;
constexpr int kX11Threads = 128;

#ifdef X11_COUNT

}  // namespace

// stage X11_COUNT of one lane between a load of its input and a store of
// its output (x11_cuda.chain_instructions subtracts stage 0's count);
// external, so that the build keeps it though nothing launches it
extern "C" __global__ void __launch_bounds__(kX11Threads)
    x11_count_kernel(const uint64_t* __restrict__ in, uint64_t* out,
                     uint32_t cnt_order, const uint64_t* __restrict__ tb) {
  __shared__ Tables sm;
  load_tables<kX11Threads>(sm, tb);
  const int lane = blockIdx.x * kX11Threads + threadIdx.x;
  uint64_t x[10], h[8];
#pragma unroll
  for (int i = 0; i < 10; ++i) x[i] = in[lane * 10 + i];
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = x[i];
#if X11_COUNT == 1
  blake512_80(x, h);
#elif X11_COUNT == 2
  bmw512_64(h);
#elif X11_COUNT == 3
  groestl512_64(h, sm.gro);
#elif X11_COUNT == 4
  skein512_64(h);
#elif X11_COUNT == 5
  jh512_64(h, tb);
#elif X11_COUNT == 6
  keccak512_64(h);
#elif X11_COUNT == 7
  luffa512_64(h);
#elif X11_COUNT == 8
  cubehash512_64(h, tb);
#elif X11_COUNT == 9
  shavite512_64(h, sm.aes, cnt_order);
#elif X11_COUNT == 10
  simd512_64(h, tb);
#elif X11_COUNT == 11
  uint32_t d[8];
  echo512_64(h, sm.aes, d);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = join64(d[2 * i], d[2 * i + 1]);
#endif
#pragma unroll
  for (int i = 0; i < 8; ++i) out[lane * 8 + i] = h[i];
}

#else  // the kernels

template <int kT>
__global__ void __launch_bounds__(kT)
    x11_search_kernel(const X11Job job, unsigned long long lanes, uint32_t* out,
                      int k, const uint64_t* __restrict__ tb) {
  __shared__ Tables sm;
  load_tables<kT>(sm, tb);
  const unsigned long long lane =
      static_cast<unsigned long long>(blockIdx.x) * kT + threadIdx.x;
  uint32_t best = kNoWinner;
  if (lane < lanes) {
    uint64_t hw[10];
#pragma unroll
    for (int i = 0; i < 9; ++i) hw[i] = join64(job.w[2 * i + 1], job.w[2 * i]);
    hw[9] = join64(job.base + static_cast<uint32_t>(lane), job.w[18]);
    uint32_t d[8], hl[8];
    x11_chain(hw, sm, tb, job.cnt_order, d);
#pragma unroll
    for (int j = 0; j < 8; ++j) hl[j] = d[7 - j];
    best = hl[0];
    if (limbs_le(hl, job.target)) take_slot(out, k, static_cast<uint32_t>(lane), hl[0]);
  }
  block_min_to<kT>(best, &out[2 * k + 2]);
}

template <int kT>
__global__ void __launch_bounds__(kT)
    x11_verify_kernel(const uint32_t* __restrict__ words,
                      const uint32_t* __restrict__ limbs, unsigned long long lanes,
                      uint32_t* out, int k, uint32_t cnt_order,
                      const uint64_t* __restrict__ tb) {
  __shared__ Tables sm;
  load_tables<kT>(sm, tb);
  const unsigned long long lane =
      static_cast<unsigned long long>(blockIdx.x) * kT + threadIdx.x;
  uint32_t best = kNoWinner;
  if (lane < lanes) {
    const uint32_t* row = words + lane * 20;
    uint64_t hw[10];
#pragma unroll
    for (int i = 0; i < 10; ++i) hw[i] = join64(__ldg(&row[2 * i + 1]), __ldg(&row[2 * i]));
    uint32_t d[8], hl[8], t[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = __ldg(&limbs[lane * 8 + j]);
    x11_chain(hw, sm, tb, cnt_order, d);
#pragma unroll
    for (int j = 0; j < 8; ++j) hl[j] = d[7 - j];
    best = hl[0];
    if (!limbs_le(hl, t)) take_slot(out, k, static_cast<uint32_t>(lane), hl[0]);
  }
  block_min_to<kT>(best, &out[2 * k + 2]);
}

unsigned int blocks_for(unsigned long long lanes) {
  return static_cast<unsigned int>((lanes + kX11Threads - 1) / kX11Threads);
}

}  // namespace

extern "C" {

// Launch init, search and finalize on `stream` without synchronizing. job:
// host pointer to the 29 job words (copied into the kernel parameters);
// lanes: the in-range lanes (<= 2^32); out: device pointer to 2k+3 words;
// tables: device pointer to the table block. Returns a cudaError_t.
int otedama_x11_search(const uint32_t* job, unsigned long long lanes, int k,
                       uint32_t* out, const uint64_t* tables, void* stream) {
  if (k < 1 || lanes > (1ull << 32)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  X11Job j;
  static_assert(sizeof(X11Job) == kJobWords * 4, "X11Job must be the packed words");
  memcpy(&j, job, sizeof(j));
  init_buffer<<<1, 64, 0, s>>>(out, k);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (lanes > 0) {
    x11_search_kernel<kX11Threads><<<blocks_for(lanes), kX11Threads, 0, s>>>(
        j, lanes, out, k, tables);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  finalize_buffer<<<1, 1, 0, s>>>(out, k, 0u);
  return static_cast<int>(cudaGetLastError());
}

// Validate `lanes` shares on `stream` without synchronizing: words, a device
// pointer to row-major [lanes, 20] big-endian header words; limbs to
// [lanes, 8] target limbs (most-significant-first); out to 2k+3 words.
// Failing lane offsets go into the table, in lane order. Returns a
// cudaError_t.
int otedama_x11_verify(const uint32_t* words, const uint32_t* limbs,
                       unsigned long long lanes, int k, uint32_t* out,
                       unsigned int cnt_order, const uint64_t* tables, void* stream) {
  if (k < 1 || lanes > 0xFFFFFFFFull) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  init_buffer<<<1, 64, 0, s>>>(out, k);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (lanes > 0) {
    x11_verify_kernel<kX11Threads><<<blocks_for(lanes), kX11Threads, 0, s>>>(
        words, limbs, lanes, out, k, cnt_order, tables);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  finalize_buffer<<<1, 1, 0, s>>>(out, k, 0u);
  return static_cast<int>(cudaGetLastError());
}

const char* otedama_x11_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

#endif  // X11_COUNT
