// The ethash epoch-cache generator, host C++ (counterpart of
// otedama_tpu/native/src/keccak.cc, the reference's native library: its
// keccak and otedama_ethash_make_cache, carried here ahead of the rest of
// that library, ROADMAP A14).
//
// The epoch cache is a strictly SEQUENTIAL keccak-512 chain (row i hashes
// row i-1) plus three mixing passes: ~1M dependent keccaks for a real
// epoch-0 cache, which no parallel hardware speeds up, so it stays on the
// host. kernels/ethash.py make_cache runs it for the card (the python
// chain, _python_make_cache, would take about an hour) and uploads the
// result; the host oracle and the card then share one cache that no card
// code wrote. It must match the python chain bit for bit (the CPU tests
// hold it to the reference's, chip_smoke.py phase 34 to the port's).
// cuda_build.build_host compiles it with nvcc as host code into a shared
// library with a plain C interface, loaded through ctypes.

#include <cstdint>
#include <cstring>

namespace {

constexpr uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

// rotation offsets r[x][y] (lane index = x + 5y)
constexpr int RHO[5][5] = {
    {0, 36, 3, 41, 18},
    {1, 44, 10, 45, 2},
    {62, 6, 43, 15, 61},
    {28, 55, 25, 21, 56},
    {27, 20, 39, 8, 14},
};

inline uint64_t rotl64(uint64_t v, int n) {
  return n ? (v << n) | (v >> (64 - n)) : v;
}

void f1600(uint64_t A[25]) {
  uint64_t B[25], C[5], D[5];
  for (int rnd = 0; rnd < 24; rnd++) {
    for (int x = 0; x < 5; x++)
      C[x] = A[x] ^ A[x + 5] ^ A[x + 10] ^ A[x + 15] ^ A[x + 20];
    for (int x = 0; x < 5; x++)
      D[x] = C[(x + 4) % 5] ^ rotl64(C[(x + 1) % 5], 1);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++) {
        uint64_t v = A[x + 5 * y] ^ D[x];
        B[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(v, RHO[x][y]);
      }
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        A[x + 5 * y] =
            B[x + 5 * y] ^ (~B[(x + 1) % 5 + 5 * y] & B[(x + 2) % 5 + 5 * y]);
    A[0] ^= RC[rnd];
  }
}

// sponge with ORIGINAL Keccak multi-rate padding (0x01 ... 0x80) — the
// convention ethash (and the x11 keccak stage) uses, NOT NIST SHA-3.
void keccak(const uint8_t* data, uint64_t len, uint8_t* out,
            unsigned rate, unsigned outlen) {
  uint64_t A[25];
  std::memset(A, 0, sizeof(A));
  uint8_t block[144];  // max rate (keccak-256: 136)
  while (len >= rate) {
    for (unsigned i = 0; i < rate; i++)
      reinterpret_cast<uint8_t*>(A)[i] ^= data[i];  // little-endian host
    f1600(A);
    data += rate;
    len -= rate;
  }
  std::memset(block, 0, sizeof(block));
  std::memcpy(block, data, len);
  block[len] = 0x01;
  block[rate - 1] |= 0x80;
  for (unsigned i = 0; i < rate; i++)
    reinterpret_cast<uint8_t*>(A)[i] ^= block[i];
  f1600(A);
  std::memcpy(out, A, outlen);
}

inline void keccak512(const uint8_t* data, uint64_t len, uint8_t out[64]) {
  keccak(data, len, out, 72, 64);
}

}  // namespace

extern "C" {

void otedama_keccak512(const uint8_t* data, uint64_t len, uint8_t out[64]) {
  keccak512(data, len, out);
}

void otedama_keccak256(const uint8_t* data, uint64_t len, uint8_t out[32]) {
  keccak(data, len, out, 136, 32);
}

// Ethash epoch cache: out is rows*64 bytes ([rows, 16] u32 LE, the layout
// kernels/ethash.py uses). seed is the 32-byte epoch seed hash.
void otedama_ethash_make_cache(uint64_t rows, const uint8_t seed[32],
                               uint8_t* out) {
  if (rows == 0) return;
  keccak512(seed, 32, out);
  for (uint64_t i = 1; i < rows; i++)
    keccak512(out + (i - 1) * 64, 64, out + i * 64);
  constexpr int CACHE_ROUNDS = 3;
  uint8_t mixed[64];
  for (int r = 0; r < CACHE_ROUNDS; r++) {
    for (uint64_t i = 0; i < rows; i++) {
      uint32_t first;
      std::memcpy(&first, out + i * 64, 4);
      uint64_t v = first % rows;
      const uint8_t* prev = out + ((i + rows - 1) % rows) * 64;
      const uint8_t* other = out + v * 64;
      for (int b = 0; b < 64; b++) mixed[b] = prev[b] ^ other[b];
      keccak512(mixed, 64, out + i * 64);
    }
  }
}

}  // extern "C"
