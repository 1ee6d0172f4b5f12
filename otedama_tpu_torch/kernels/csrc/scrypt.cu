// scrypt (N=1024, r=1, p=1) for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernels of otedama_tpu/kernels/scrypt_pallas.py:
//   - blockmix_kernel: `_bm_kernel` (B3, BlockMix r=1 of word-major
//     [32, B] lanes) and `_bmx_kernel` (B4, BlockMix(X ^ V[j]) with the XOR
//     fused in), as one kernel with an optional second input;
//   - romix_kernel: `_romix_kernel_factory` (B5, the whole ROMix: 1024
//     chained BlockMixes into V, then 1024 x X = BlockMix(X ^ V[X[16] &
//     1023]); `half_v` keeps the even rows and recomputes an odd row as
//     BlockMix of the row before it).
// and adds the two ends of the search (pbkdf2_prologue, search_epilogue)
// and of share validation (verify_prologue, verify_epilogue: each lane a
// submitted header of its own, compared against its own target, the
// FAILURES compacted by lane offset — the scrypt twin of
// sha256d.cu's verify_kernel, with romix_kernel between them).
// PBKDF2 is no Pallas kernel in the reference (jnp inside one XLA program,
// otedama_tpu/kernels/scrypt_jax.py scrypt_1024_1_1): it is CUDA here only
// because 21 SHA-256 compressions per lane in eager torch would cost more
// than ROMix itself.
//
// What bounds it. One Salsa20/8 is 4 double rounds x 32 (add, rotate, xor)
// + 16 adds; one BlockMix two of them plus 32 XORs; ROMix 2,048 BlockMixes
// plus 1,024 x 32 XORs: ~1.74 M int32 ops per hash, against 256 KiB of V
// written once and read once. Counted at 132 SMs x 128 integer
// instructions a clock the ops take less time than HBM needs for the
// bytes, but the rotates and XORs (576 of a lane-step's 864 ops) issue on
// the 64-lane ALU pipe alone, and with them ROMix is bound by the ALU
// pipe on this card once its memory traffic is well formed. `half_v`
// writes half the rows and trades them for ~25% more ops; since the
// quads of a warp split on the parity of their row, a warp pays the
// recomputing BlockMix on almost every mix step.
// The design of romix_kernel:
//   - four threads (a quad) a lane: thread q holds column q of each half
//     of X in Salsa20/8's diagonal layout, so the column round is its own
//     quarter round and the row round exchanges three words by __shfl_sync
//     each way. 47 registers a thread instead of 96 for a whole X, and a
//     lane's 2,048 dependent steps are spread over four threads;
//   - V in global memory (128 KiB per lane cannot stay in shared memory
//     at useful occupancy), laid out [row][lane][32 words] with each row
//     in the quad's order: a quad moves a row as one whole 128-byte line,
//     two 16-byte accesses a thread, and a warp's fill-pass writes are
//     1 KiB contiguous. The one-thread-a-lane design wrote each row as
//     eight 16-byte stores a thread, a warp's store touching 32 lines 128
//     bytes apart; its fill pass alone took about as long as this whole
//     kernel. V's footprint does not matter: regions of 8 lanes (a lane's
//     rows 1 KiB apart rather than lanes x 128 bytes) ran no faster;
//   - blocks of 128 threads (32 lanes). A batch as small as the ledger's
//     1,024 shares takes one lane's serial latency however it is spread:
//     32-thread blocks, on all 132 SMs rather than 32, ran no faster;
//   - 64-bit index arithmetic: rows x lanes x 32 words passes 2^31;
//   - X in and out word-major [32, lanes] (word w of all lanes contiguous),
//     the layout of the TPU kernels' refs, so the loads are coalesced;
//   - the search's winners, as in sha256d.cu: an exact 256-bit
//     compare per lane, slots by atomicAdd, the min top limb through a
//     block reduce and one atomicMin per block, a finalize sort by offset.
// blockmix_kernel (B3, B4: one BlockMix a launch, bound by its 256 or
// 384 bytes a lane in and out) stays one thread a lane, X's 32 words in
// registers, Salsa fully unrolled on 16 registers, word-major loads and
// stores coalesced across the warp.

#include <cstdint>
#include <cuda_runtime.h>

#include "sha256_device.cuh"

namespace {

constexpr int kThreads = 256;          // blockmix, prologue, epilogue
constexpr int kRomixThreads = 128;     // romix: 32 lanes a block
constexpr int kN = 1024;

struct ScryptParams {
  uint32_t h[19];      // big-endian words of header[0:76]
  uint32_t base;       // nonce (header word 19) of lane 0
  uint32_t limbs[8];   // target, most-significant-first
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

// b = Salsa20/8(b), 16 words in registers.
__device__ __forceinline__ void salsa8(uint32_t b[16]) {
  uint32_t x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = b[i];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    // column round
    x[4] ^= rotl(x[0] + x[12], 7);   x[8] ^= rotl(x[4] + x[0], 9);
    x[12] ^= rotl(x[8] + x[4], 13);  x[0] ^= rotl(x[12] + x[8], 18);
    x[9] ^= rotl(x[5] + x[1], 7);    x[13] ^= rotl(x[9] + x[5], 9);
    x[1] ^= rotl(x[13] + x[9], 13);  x[5] ^= rotl(x[1] + x[13], 18);
    x[14] ^= rotl(x[10] + x[6], 7);  x[2] ^= rotl(x[14] + x[10], 9);
    x[6] ^= rotl(x[2] + x[14], 13);  x[10] ^= rotl(x[6] + x[2], 18);
    x[3] ^= rotl(x[15] + x[11], 7);  x[7] ^= rotl(x[3] + x[15], 9);
    x[11] ^= rotl(x[7] + x[3], 13);  x[15] ^= rotl(x[11] + x[7], 18);
    // row round
    x[1] ^= rotl(x[0] + x[3], 7);    x[2] ^= rotl(x[1] + x[0], 9);
    x[3] ^= rotl(x[2] + x[1], 13);   x[0] ^= rotl(x[3] + x[2], 18);
    x[6] ^= rotl(x[5] + x[4], 7);    x[7] ^= rotl(x[6] + x[5], 9);
    x[4] ^= rotl(x[7] + x[6], 13);   x[5] ^= rotl(x[4] + x[7], 18);
    x[11] ^= rotl(x[10] + x[9], 7);  x[8] ^= rotl(x[11] + x[10], 9);
    x[9] ^= rotl(x[8] + x[11], 13);  x[10] ^= rotl(x[9] + x[8], 18);
    x[12] ^= rotl(x[15] + x[14], 7); x[13] ^= rotl(x[12] + x[15], 9);
    x[14] ^= rotl(x[13] + x[12], 13); x[15] ^= rotl(x[14] + x[13], 18);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) b[i] += x[i];
}

// BlockMix r=1 in place: B0 = Salsa20/8(B0 ^ B1) = Y0, then
// B1 = Salsa20/8(B1 ^ Y0) = Y1.
__device__ __forceinline__ void blockmix(uint32_t x[32]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] ^= x[16 + i];
  salsa8(x);
#pragma unroll
  for (int i = 0; i < 16; ++i) x[16 + i] ^= x[i];
  salsa8(x + 16);
}

// out = BlockMix(x ^ v) (v may be null: BlockMix(x)), word-major [32, lanes].
// out may be x itself: a thread reads its lane whole before writing it.
__global__ void __launch_bounds__(kThreads)
    blockmix_kernel(const uint32_t* x, const uint32_t* v, uint32_t* out,
                    unsigned long long lanes) {
  const unsigned long long lane =
      static_cast<unsigned long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  uint32_t b[32];
#pragma unroll
  for (int w = 0; w < 32; ++w) b[w] = x[w * lanes + lane];
  if (v != nullptr) {
#pragma unroll
    for (int w = 0; w < 32; ++w) b[w] ^= v[w * lanes + lane];
  }
  blockmix(b);
#pragma unroll
  for (int w = 0; w < 32; ++w) out[w * lanes + lane] = b[w];
}

// Salsa20/8 of one 16-word half, spread over the four threads of a quad.
// Thread q holds column q of the state in the diagonal layout, words
// (5q, 5q + 4, 5q + 8, 5q + 12) mod 16 as (a, b, c, d): the column round is
// then each thread's own quarter round, and the row round needs row q's
// words 4q + (q + 1..3) % 4, which are d of thread q + 1, c of q + 2 and b
// of q + 3 — three shuffles there and three back. `mask` names the quads
// that take part (whole quads only).
__device__ __forceinline__ void salsa8_quad(uint32_t s[4], unsigned mask,
                                            int q) {
  uint32_t a = s[0], b = s[1], c = s[2], d = s[3];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    b ^= rotl(a + d, 7);
    c ^= rotl(b + a, 9);
    d ^= rotl(c + b, 13);
    a ^= rotl(d + c, 18);
    uint32_t rb = __shfl_sync(mask, d, q + 1, 4);
    uint32_t rc = __shfl_sync(mask, c, q + 2, 4);
    uint32_t rd = __shfl_sync(mask, b, q + 3, 4);
    rb ^= rotl(a + rd, 7);
    rc ^= rotl(rb + a, 9);
    rd ^= rotl(rc + rb, 13);
    a ^= rotl(rd + rc, 18);
    d = __shfl_sync(mask, rb, q + 3, 4);
    c = __shfl_sync(mask, rc, q + 2, 4);
    b = __shfl_sync(mask, rd, q + 1, 4);
  }
  s[0] += a;
  s[1] += b;
  s[2] += c;
  s[3] += d;
}

// BlockMix r=1 of a quad's hash: x0 and x1 are this thread's words of B0
// and B1, in the same diagonal positions, so the XORs between the halves
// stay in the thread.
__device__ __forceinline__ void blockmix_quad(uint32_t x0[4], uint32_t x1[4],
                                              unsigned mask, int q) {
#pragma unroll
  for (int i = 0; i < 4; ++i) x0[i] ^= x1[i];
  salsa8_quad(x0, mask, q);
#pragma unroll
  for (int i = 0; i < 4; ++i) x1[i] ^= x0[i];
  salsa8_quad(x1, mask, q);
}

// The whole ROMix of each lane, X in place (word-major [32, lanes]), four
// threads a lane. v is the scratch, [row][lane][8 x uint4] with rows =
// 1024 (512 for kHalf). Inside a row, thread q's B0 words are uint4 q and
// its B1 words uint4 4 + q: a quad moves a row as one line.
template <bool kHalf>
__global__ void __launch_bounds__(kRomixThreads)
    romix_kernel(uint32_t* xio, uint4* v, unsigned long long lanes) {
  const unsigned long long lane =
      (static_cast<unsigned long long>(blockIdx.x) * blockDim.x +
       threadIdx.x) >> 2;
  const int q = threadIdx.x & 3;
  const bool active = lane < lanes;
  const unsigned mask = __ballot_sync(0xFFFFFFFFu, active);
  if (!active) return;
  const unsigned long long row_stride = 8 * lanes;  // uint4s
  uint4* vl = v + lane * 8 + q;
  uint32_t x0[4], x1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int w = (5 * q + 4 * i) & 15;
    x0[i] = xio[w * lanes + lane];
    x1[i] = xio[(16 + w) * lanes + lane];
  }
#pragma unroll 1
  for (int i = 0; i < kN; ++i) {
    if (!kHalf || (i & 1) == 0) {
      uint4* row = vl + static_cast<unsigned long long>(kHalf ? i >> 1 : i) *
                            row_stride;
      row[0] = make_uint4(x0[0], x0[1], x0[2], x0[3]);
      row[4] = make_uint4(x1[0], x1[1], x1[2], x1[3]);
    }
    blockmix_quad(x0, x1, mask, q);
  }
#pragma unroll 1
  for (int i = 0; i < kN; ++i) {
    // Integerify: the first word of B1, held by thread 0 of the quad
    const uint32_t j = __shfl_sync(mask, x1[0], 0, 4) & (kN - 1);
    const uint4* row =
        vl + static_cast<unsigned long long>(kHalf ? j >> 1 : j) * row_stride;
    const uint4 r0 = row[0], r1 = row[4];
    uint32_t v0[4] = {r0.x, r0.y, r0.z, r0.w};
    uint32_t v1[4] = {r1.x, r1.y, r1.z, r1.w};
    if (kHalf) {
      const unsigned odd = __ballot_sync(mask, j & 1);
      if (j & 1) blockmix_quad(v0, v1, odd, q);  // V[j] = BlockMix(V[j - 1])
    }
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      x0[w] ^= v0[w];
      x1[w] ^= v1[w];
    }
    blockmix_quad(x0, x1, mask, q);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int w = (5 * q + 4 * i) & 15;
    xio[w * lanes + lane] = x0[i];
    xio[(16 + w) * lanes + lane] = x1[i];
  }
}

// The 20 big-endian words of a lane's header: a search lane's are the 19
// parameter words and its nonce, a share's under validation its own 20.
// Indices are compile-time constants after unrolling, so a search lane's
// words stay kernel-parameter operands.
struct SearchHeader {
  const ScryptParams& p;
  uint32_t nonce;
  __device__ __forceinline__ uint32_t operator[](int i) const {
    return i < 19 ? p.h[i] : nonce;
  }
};

struct ShareHeader {
  uint32_t w[20];
  // word i of lane `lane` in word-major [20, lanes]
  __device__ __forceinline__ ShareHeader(const uint32_t* words,
                                         unsigned long long lane,
                                         unsigned long long lanes) {
#pragma unroll
    for (int i = 0; i < 20; ++i) w[i] = words[i * lanes + lane];
  }
  __device__ __forceinline__ uint32_t operator[](int i) const { return w[i]; }
};

// key0 = SHA256(header80) and the HMAC inner and outer states it keys.
template <class Header>
__device__ __forceinline__ void hmac_states(const Header& hdr, uint32_t is[8],
                                            uint32_t os[8]) {
  uint32_t key[8] = SHA256_IV_INIT;
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = hdr[i];
  sha256_compress(key, w);
  uint32_t w2[16] = {hdr[16], hdr[17], hdr[18], hdr[19], 0x80000000u, 0, 0, 0,
                     0,       0,       0,       0,       0,           0, 0, 640};
  sha256_compress(key, w2);
  const uint32_t iv[8] = SHA256_IV_INIT;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    is[i] = iv[i];
    os[i] = iv[i];
  }
  uint32_t wi[16], wo[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    wi[i] = (i < 8 ? key[i] : 0u) ^ 0x36363636u;
    wo[i] = (i < 8 ? key[i] : 0u) ^ 0x5C5C5C5Cu;
  }
  sha256_compress(is, wi);
  sha256_compress(os, wo);
}

// out = compress(os, inner digest || padding): the 96-byte outer message.
__device__ __forceinline__ void hmac_finish(const uint32_t os[8],
                                            const uint32_t inner[8],
                                            uint32_t out[8]) {
  uint32_t w[16] = {inner[0], inner[1], inner[2], inner[3], inner[4],
                    inner[5], inner[6], inner[7], 0x80000000u, 0, 0, 0, 0,
                    0,        0,        768};
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = os[i];
  sha256_compress(out, w);
}

// PBKDF2 pass 1: X = T1 || T2 || T3 || T4, T_i = HMAC(header, header ||
// INT(i)), as little-endian words into column `lane` of word-major
// [32, lanes].
template <class Header>
__device__ __forceinline__ void pbkdf2_x(const Header& hdr,
                                         unsigned long long lane,
                                         unsigned long long lanes,
                                         uint32_t* xout) {
  uint32_t is[8], os[8];
  hmac_states(hdr, is, os);
  uint32_t imid[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) imid[i] = is[i];
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = hdr[i];
  sha256_compress(imid, w);
#pragma unroll 1
  for (uint32_t blk = 1; blk <= 4; ++blk) {
    uint32_t inner[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) inner[i] = imid[i];
    uint32_t wb[16] = {hdr[16], hdr[17], hdr[18], hdr[19], blk, 0x80000000u,
                       0,       0,       0,       0,       0,   0,
                       0,       0,       0,       1184};  // (64+80+4)*8
    sha256_compress(inner, wb);
    uint32_t t[8];
    hmac_finish(os, inner, t);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      xout[(8 * (blk - 1) + i) * lanes + lane] = bswap32(t[i]);
  }
}

// PBKDF2 pass 2 of column `lane` of x: digest = HMAC(header, B' || INT(1)),
// returned as compare limbs, most-significant-first: h[j] =
// bswap(digest[7 - j]).
template <class Header>
__device__ __forceinline__ void pbkdf2_limbs(const Header& hdr,
                                             const uint32_t* x,
                                             unsigned long long lane,
                                             unsigned long long lanes,
                                             uint32_t h[8]) {
  uint32_t is[8], os[8];
  hmac_states(hdr, is, os);
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = bswap32(x[i * lanes + lane]);
  sha256_compress(is, w);
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = bswap32(x[(16 + i) * lanes + lane]);
  sha256_compress(is, w);
  uint32_t wl[16] = {1, 0x80000000u, 0, 0, 0, 0, 0, 0,
                     0, 0,           0, 0, 0, 0, 0, 1568};  // (64+128+4)*8
  sha256_compress(is, wl);
  uint32_t d[8];
  hmac_finish(os, is, d);
#pragma unroll
  for (int j = 0; j < 8; ++j) h[j] = bswap32(d[7 - j]);
}

// The search's PBKDF2 pass 1 for nonces base + lane.
__global__ void __launch_bounds__(kThreads)
    pbkdf2_prologue(const ScryptParams p, unsigned long long lanes,
                    uint32_t* xout) {
  const unsigned long long lane =
      static_cast<unsigned long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  pbkdf2_x(SearchHeader{p, p.base + static_cast<uint32_t>(lane)}, lane, lanes,
           xout);
}

// The search's PBKDF2 pass 2 and the compare against the job's target;
// every lane below `lanes` is in range.
__global__ void __launch_bounds__(kThreads)
    search_epilogue(const ScryptParams p, unsigned long long lanes,
                    const uint32_t* x, uint32_t* out, int k) {
  const unsigned long long lane =
      static_cast<unsigned long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  uint32_t best = kNoWinner;
  if (lane < lanes) {
    const uint32_t nonce = p.base + static_cast<uint32_t>(lane);
    uint32_t h[8];
    pbkdf2_limbs(SearchHeader{p, nonce}, x, lane, lanes, h);
    best = h[0];
    if (limbs_le(h, p.limbs)) take_slot(out, k, nonce, h[0]);
  }
  block_min_to<kThreads>(best, &out[2 * k + 2]);
}

// Share validation's PBKDF2 pass 1: each lane's header is its own, read
// from word-major [20, lanes]; its HMAC key SHA256(header) is per lane.
__global__ void __launch_bounds__(kThreads)
    verify_prologue(const uint32_t* words, unsigned long long lanes,
                    uint32_t* xout) {
  const unsigned long long lane =
      static_cast<unsigned long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  pbkdf2_x(ShareHeader(words, lane, lanes), lane, lanes, xout);
}

// Share validation's PBKDF2 pass 2 and the compare of each lane against its
// own target limbs (word-major [8, lanes]); FAILING lanes take slots with
// their lane offset, and every lane's top limb goes into the min.
__global__ void __launch_bounds__(kThreads)
    verify_epilogue(const uint32_t* words, const uint32_t* limbs,
                    unsigned long long lanes, const uint32_t* x, uint32_t* out,
                    int k) {
  const unsigned long long lane =
      static_cast<unsigned long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  uint32_t best = kNoWinner;
  if (lane < lanes) {
    uint32_t h[8], t[8];
    pbkdf2_limbs(ShareHeader(words, lane, lanes), x, lane, lanes, h);
#pragma unroll
    for (int j = 0; j < 8; ++j) t[j] = limbs[j * lanes + lane];
    best = h[0];
    if (!limbs_le(h, t)) take_slot(out, k, static_cast<uint32_t>(lane), h[0]);
  }
  block_min_to<kThreads>(best, &out[2 * k + 2]);
}

unsigned int blocks_for(unsigned long long lanes, int threads) {
  return static_cast<unsigned int>((lanes + threads - 1) / threads);
}

ScryptParams load_params(const uint32_t* words) {
  ScryptParams p;
  for (int i = 0; i < 19; ++i) p.h[i] = words[i];
  p.base = words[19];
  for (int i = 0; i < 8; ++i) p.limbs[i] = words[20 + i];
  return p;
}

}  // namespace

extern "C" {

// Every entry point launches on `stream` without synchronizing and returns
// a cudaError_t (0 = every launch was accepted). Pointers are device
// pointers unless named host; lanes > 0 unless stated.

// out[32, lanes] = BlockMix(x ^ v) (v may be null).
int otedama_scrypt_blockmix(const uint32_t* x, const uint32_t* v,
                            uint32_t* out, unsigned long long lanes,
                            void* stream) {
  blockmix_kernel<<<blocks_for(lanes, kThreads), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(x, v, out, lanes);
  return static_cast<int>(cudaGetLastError());
}

// x[32, lanes] = ROMix(x) in place, four threads a lane; v: scratch of
// 1024 (half_v: 512) rows x 128
// bytes a lane.
int otedama_scrypt_romix(uint32_t* x, void* v, unsigned long long lanes,
                         int half_v, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned int blocks = blocks_for(4 * lanes, kRomixThreads);
  if (half_v)
    romix_kernel<true><<<blocks, kRomixThreads, 0, s>>>(
        x, static_cast<uint4*>(v), lanes);
  else
    romix_kernel<false><<<blocks, kRomixThreads, 0, s>>>(
        x, static_cast<uint4*>(v), lanes);
  return static_cast<int>(cudaGetLastError());
}

// Start a search: clear the winner buffer out[2k+3] and, for lanes > 0,
// fill x[32, lanes] with PBKDF2 pass 1. host_params: 28 words, the 19
// header words, the nonce base and the 8 target limbs.
int otedama_scrypt_prologue(const uint32_t* host_params,
                            unsigned long long lanes, uint32_t* x,
                            uint32_t* out, int k, void* stream) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  init_buffer<<<1, kThreads, 0, s>>>(out, k);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || lanes == 0) return static_cast<int>(e);
  pbkdf2_prologue<<<blocks_for(lanes, kThreads), kThreads, 0, s>>>(
      load_params(host_params), lanes, x);
  return static_cast<int>(cudaGetLastError());
}

// Finish a search: PBKDF2 pass 2 and the compare of x[32, lanes] into out,
// then the sort of the winner slots by offset.
int otedama_scrypt_epilogue(const uint32_t* host_params,
                            unsigned long long lanes, const uint32_t* x,
                            uint32_t* out, int k, void* stream) {
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const ScryptParams p = load_params(host_params);
  if (lanes > 0) {
    search_epilogue<<<blocks_for(lanes, kThreads), kThreads, 0, s>>>(
        p, lanes, x, out, k);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  finalize_buffer<<<1, 1, 0, s>>>(out, k, p.base);
  return static_cast<int>(cudaGetLastError());
}

// Start a share validation: clear the failure buffer out[2k+3] and, for
// lanes > 0, fill x[32, lanes] with PBKDF2 pass 1 of the headers in
// words[20, lanes].
int otedama_scrypt_verify_prologue(const uint32_t* words,
                                   unsigned long long lanes, uint32_t* x,
                                   uint32_t* out, int k, void* stream) {
  if (k < 1 || lanes > 0xFFFFFFFFull)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  init_buffer<<<1, kThreads, 0, s>>>(out, k);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || lanes == 0) return static_cast<int>(e);
  verify_prologue<<<blocks_for(lanes, kThreads), kThreads, 0, s>>>(words, lanes,
                                                                   x);
  return static_cast<int>(cudaGetLastError());
}

// Finish a share validation: PBKDF2 pass 2 of x[32, lanes], the compare
// against limbs[8, lanes], then the sort of the failure slots by offset.
int otedama_scrypt_verify_epilogue(const uint32_t* words, const uint32_t* limbs,
                                   unsigned long long lanes, const uint32_t* x,
                                   uint32_t* out, int k, void* stream) {
  if (k < 1 || lanes > 0xFFFFFFFFull)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes > 0) {
    verify_epilogue<<<blocks_for(lanes, kThreads), kThreads, 0, s>>>(
        words, limbs, lanes, x, out, k);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  finalize_buffer<<<1, 1, 0, s>>>(out, k, 0u);
  return static_cast<int>(cudaGetLastError());
}

const char* otedama_scrypt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
