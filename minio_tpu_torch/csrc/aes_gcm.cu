// AES-256-GCM seal and open of a batch of packages: kernels C and D of
// minio_tpu_torch.
//
// They replace no TPU kernel: minio_tpu seals on the host with
// `cryptography`'s AESGCM (api/transforms.py EncryptReader/DecryptWriter,
// crypto/sse.py object-key seals, crypto/kms.py data keys). The port may
// use no such package, so the AEAD is written here; the plain PyTorch
// version of both kernels is minio_tpu_torch/ops/aes_gcm.py.
//
// Every package shares the launch's key and has its own descriptor row
// (in_off, length, aad_off, aad_len, out_off), int64. Seal reads the
// plaintext at in + in_off and the package's nonce from nonces[p], and
// writes the wire layout nonce (12) || ciphertext || tag (16) at
// out + out_off, so one copy off the card gives the bytes to store. Open
// reads nonce || ciphertext || tag at in + in_off, writes the plaintext at
// out + out_off and ok[p] = 1 when the tag checks; a package whose tag
// fails gets ok[p] = 0 and its plaintext is overwritten with zeros before
// the kernel ends, so no unauthenticated plaintext leaves it.
//
// What bounds it on this card: the bytes are few (a 64 KiB package is
// read once and written once), the operations many. Each 16-byte block
// costs 14 AES rounds of 16 table lookups and one GF(2^128) product, and
// both are shared-memory lookups. The design:
//
// - The key's work once a launch. The C launcher expands the key and
//   forms H = E(K, 0) on the host (a kernel parameter carries the round
//   keys into the constant bank); a setup kernel of one block forms
//   H^1..H^64 and H^64, H^128, .. H^CT by doubling, CT being the threads
//   of a cluster, and H^CT's nibble tables, into a workspace the wrapper
//   allocates. Its products are exact integer carry-less products (four
//   32 x 32 integer products with the operands' bits four apart,
//   Karatsuba over nine of those), shifted once for GCM's reflected
//   order and folded by x^128 = 1 + x + x^2 + x^7. The main kernel is a
//   programmatic dependent launch: it fills its AES table and runs its
//   first step while the setup runs, and waits for the workspace before
//   its first GHASH product.
// - One package over a cluster of C blocks of 256 threads, C = 2, 4 or 8
//   by the launch's package count (a launch of 16 packages fills 128
//   blocks, one of 127 fills 254), through persistent clusters that walk
//   the packages. GHASH is linear: with the package's blocks X_0..X_{n-1}
//   (AAD, then ciphertext, then the lengths) right-aligned to a multiple
//   of CT (leading zero blocks change nothing), thread g of the cluster
//   takes blocks g, g + CT, g + 2 CT, ..., so a warp's loads and stores
//   cover 512 contiguous bytes, and folds them by Horner with H^CT: Y_g.
//   GHASH = sum_g Y_g H^(CT - g). Each thread multiplies by its weight
//   H^(CT - g) (one product a launch forms it from H^a and H^(64 b)),
//   each block XORs its threads, and block 0 of the cluster XORs the
//   blocks' sums through distributed shared memory, adds E(K, J0) and
//   writes the tag (seal) or ok[p] (open). After a second cluster barrier
//   every block of a failed package zeroes the plaintext it wrote. The
//   weights are the launch's constants: no product depends on a
//   package's length, which contiguous runs a block would need.
// - The Horner product by H^CT reads 16 byte tables (64 KiB, entry [k][b]
//   is b in byte k times H^CT) that each block builds once from the
//   workspace's nibble tables: 16 lookups and XORs, no dependent chain.
// - The AES round table T0 (little-endian words, so blocks stay in memory
//   order) lives in shared memory 32 times, entry x of copy `lane` at byte
//   x * 128 + lane * 4: each lane reads its own bank, and an index is one
//   byte permute and one multiply-add. T1..T3 are rotations of T0 and the
//   S-box of the last round is a byte of it. A block holds 100 KiB, two
//   blocks an SM.
// - A thread's next block is loaded a step ahead; 16-byte loads and
//   stores where aligned, 4-byte or single bytes where not.
//
// CTR starts at inc32(J0) = nonce || 2 (96-bit nonces only, as GCM with
// minio_tpu's 12-byte nonces); the tag is E(K, J0) ^ GHASH with the last
// block [len(A) * 8]_64 || [len(C) * 8]_64. tests/test_torch_aes_gcm.py
// models the split, the products and the tables in Python integers and
// holds them to `cryptography`; minio_tpu_torch/aes_gcm_parts.py times the
// parts on the card from variants of this file.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;        // a block of the main kernels
constexpr int kSetupThreads = 512;
constexpr int kMaxCT = 8 * kThreads; // the largest cluster's threads
constexpr int kBlocksPerSm = 2;

// The workspace, in 16-byte units: the nibble tables of H^CT
// ([k][hi, lo][v], 512), H^a for a = 1..64, H^(64 b) for b = 1..CT / 64.
constexpr int kWsNib = 0;
constexpr int kWsA = kWsNib + 512;
constexpr int kWsB = kWsA + 64;
constexpr int kWsBytes = 16 * (kWsB + kMaxCT / 64);

// Shared memory of a main block: T0 a bank each, the byte tables, the rest.
constexpr int kTeBytes = 256 * 32 * 4;
constexpr int kGtBytes = 16 * 256 * 16;

// FIPS-197's S-box: T0 on the device, the key schedule and H on the host.
#define AES_SBOX \
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b, \
    0xfe, 0xd7, 0xab, 0x76, 0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0, \
    0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0, 0xb7, 0xfd, 0x93, 0x26, \
    0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15, \
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2, \
    0xeb, 0x27, 0xb2, 0x75, 0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0, \
    0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84, 0x53, 0xd1, 0x00, 0xed, \
    0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf, \
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f, \
    0x50, 0x3c, 0x9f, 0xa8, 0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5, \
    0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2, 0xcd, 0x0c, 0x13, 0xec, \
    0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73, \
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14, \
    0xde, 0x5e, 0x0b, 0xdb, 0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c, \
    0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79, 0xe7, 0xc8, 0x37, 0x6d, \
    0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08, \
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f, \
    0x4b, 0xbd, 0x8b, 0x8a, 0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e, \
    0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e, 0xe1, 0xf8, 0x98, 0x11, \
    0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf, \
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f, \
    0xb0, 0x54, 0xbb, 0x16
__constant__ uint8_t c_sbox[256] = {AES_SBOX};
const uint8_t kSbox[256] = {AES_SBOX};
#undef AES_SBOX


// The round keys in little-endian words: a kernel parameter, so a round
// reads its key from the constant bank.
struct RoundKeys {
  uint4 k[15];
};

struct Small {
  uint4 wsum[kThreads / 32];   // each warp's sum
  uint4 part;                  // the block's sum, read by block 0
  uint4 ej0;                   // E(K, J0) of the package (block 0)
  int verdict;                 // the tag checked (block 0)
};

// Dynamic shared memory of a main block: T0 a bank each, then the byte
// tables (4 KiB aligned in the shared window, hence the slack), then the
// rest.
constexpr int kSmemBytes = kTeBytes + kGtBytes + 4096 + (int)sizeof(Small);

struct U128 {  // a GCM block as a big-endian integer: x^0 in the top bit
  uint64_t hi, lo;
};

__device__ __forceinline__ uint32_t bswap(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

__host__ __device__ inline uint8_t xtime(uint8_t a) {
  return (uint8_t)((a << 1) ^ ((a & 0x80) ? 0x1b : 0));
}

// T0 in little-endian words: bytes 2s, s, s, 3s.
__device__ __forceinline__ uint32_t t0_entry(uint8_t v) {
  const uint8_t v2 = xtime(v);
  return (uint32_t)v2 | ((uint32_t)v << 8) | ((uint32_t)v << 16) |
         ((uint32_t)(uint8_t)(v2 ^ v) << 24);
}

__device__ __forceinline__ uint4 xor4(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

__device__ __forceinline__ U128 from_le(uint4 w) {
  return {((uint64_t)bswap(w.x) << 32) | bswap(w.y),
          ((uint64_t)bswap(w.z) << 32) | bswap(w.w)};
}

__device__ __forceinline__ uint4 to_le(U128 v) {
  return make_uint4(bswap((uint32_t)(v.hi >> 32)), bswap((uint32_t)v.hi),
                    bswap((uint32_t)(v.lo >> 32)), bswap((uint32_t)v.lo));
}

// --- shared memory by address ------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

template <int kOff>
__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4+%5];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "r"(a), "n"(kOff));
  return v;
}

// Byte q of x, as the low byte.
__device__ __forceinline__ uint32_t byte_of(uint32_t x, int q) {
  return __byte_perm(x, 0, 0x4440 | q);
}

// --- AES-256 on little-endian words ------------------------------------
// Entry x of T0 at shared address tab + x * 128, one copy a bank (tab =
// the table's address + lane * 4): an index is one byte permute and one
// multiply-add.

__device__ __forceinline__ void aes256(uint32_t tab, const RoundKeys& rk,
                                       uint32_t& s0, uint32_t& s1,
                                       uint32_t& s2, uint32_t& s3) {
#define L(x, q) lds32(byte_of(x, q) * 128 + tab)
  uint4 k = rk.k[0];
  s0 ^= k.x; s1 ^= k.y; s2 ^= k.z; s3 ^= k.w;
#pragma unroll
  for (int r = 1; r < 14; ++r) {
    k = rk.k[r];
    const uint32_t t0 = L(s0, 0) ^ rotl(L(s1, 1), 8) ^ rotl(L(s2, 2), 16) ^
                        rotl(L(s3, 3), 24) ^ k.x;
    const uint32_t t1 = L(s1, 0) ^ rotl(L(s2, 1), 8) ^ rotl(L(s3, 2), 16) ^
                        rotl(L(s0, 3), 24) ^ k.y;
    const uint32_t t2 = L(s2, 0) ^ rotl(L(s3, 1), 8) ^ rotl(L(s0, 2), 16) ^
                        rotl(L(s1, 3), 24) ^ k.z;
    const uint32_t t3 = L(s3, 0) ^ rotl(L(s0, 1), 8) ^ rotl(L(s1, 2), 16) ^
                        rotl(L(s2, 3), 24) ^ k.w;
    s0 = t0; s1 = t1; s2 = t2; s3 = t3;
  }
  k = rk.k[14];
  // The last round: the S-box is byte 1 of T0; byte r of column c comes
  // from row r of column c + r.
#define SB(a, b, c, d)                                   \
  __byte_perm(__byte_perm(a, b, 0x0051), __byte_perm(c, d, 0x0051), 0x5410)
  const uint32_t o0 = SB(L(s0, 0), L(s1, 1), L(s2, 2), L(s3, 3)) ^ k.x;
  const uint32_t o1 = SB(L(s1, 0), L(s2, 1), L(s3, 2), L(s0, 3)) ^ k.y;
  const uint32_t o2 = SB(L(s2, 0), L(s3, 1), L(s0, 2), L(s1, 3)) ^ k.z;
  const uint32_t o3 = SB(L(s3, 0), L(s0, 1), L(s1, 2), L(s2, 3)) ^ k.w;
  s0 = o0; s1 = o1; s2 = o2; s3 = o3;
#undef SB
#undef L
}

// --- GF(2^128) ---------------------------------------------------------

// The carry-less 32 x 32 -> 64 product: the operands' bits four apart in
// four masks, so a column of an integer product sums at most 8 terms and
// no carry reaches the next bit kept.
__device__ __forceinline__ uint64_t bmul32(uint32_t x, uint32_t y) {
  const uint32_t x0 = x & 0x11111111u, x1 = x & 0x22222222u;
  const uint32_t x2 = x & 0x44444444u, x3 = x & 0x88888888u;
  const uint32_t y0 = y & 0x11111111u, y1 = y & 0x22222222u;
  const uint32_t y2 = y & 0x44444444u, y3 = y & 0x88888888u;
#define M(a, b) ((uint64_t)(a) * (b))
  const uint64_t z0 = M(x0, y0) ^ M(x1, y3) ^ M(x2, y2) ^ M(x3, y1);
  const uint64_t z1 = M(x0, y1) ^ M(x1, y0) ^ M(x2, y3) ^ M(x3, y2);
  const uint64_t z2 = M(x0, y2) ^ M(x1, y1) ^ M(x2, y0) ^ M(x3, y3);
  const uint64_t z3 = M(x0, y3) ^ M(x1, y2) ^ M(x2, y1) ^ M(x3, y0);
#undef M
  return (z0 & 0x1111111111111111ull) | (z1 & 0x2222222222222222ull) |
         (z2 & 0x4444444444444444ull) | (z3 & 0x8888888888888888ull);
}

__device__ __forceinline__ U128 clmul64(uint64_t x, uint64_t y) {
  const uint32_t xl = (uint32_t)x, xh = (uint32_t)(x >> 32);
  const uint32_t yl = (uint32_t)y, yh = (uint32_t)(y >> 32);
  const uint64_t lo = bmul32(xl, yl), hi = bmul32(xh, yh);
  const uint64_t mid = bmul32(xl ^ xh, yl ^ yh) ^ lo ^ hi;
  return {hi ^ (mid >> 32), lo ^ (mid << 32)};
}

// top + o x^128 (both reflected): o folded back by x^128 = 1 + x + x^2
// + x^7, O ^ O>>1 ^ O>>2 ^ O>>7, and the 7 bits those shifts push out,
// D = O<<127 ^ O<<126 ^ O<<121, once more.
__device__ __forceinline__ U128 fold(U128 top, U128 o) {
  const uint64_t w1 = o.hi, w0 = o.lo;
  const uint64_t dh = (w0 << 63) ^ (w0 << 62) ^ (w0 << 57);
  U128 r;
  r.hi = top.hi ^ w1 ^ (w1 >> 1) ^ (w1 >> 2) ^ (w1 >> 7) ^ dh ^ (dh >> 1) ^
         (dh >> 2) ^ (dh >> 7);
  r.lo = top.lo ^ w0 ^ ((w0 >> 1) | (w1 << 63)) ^ ((w0 >> 2) | (w1 << 62)) ^
         ((w0 >> 7) | (w1 << 57));
  return r;
}

// a * b in GCM's field: Karatsuba over clmul64, the 255-bit product
// shifted left by one (the reflected order), its low half folded back.
__device__ __forceinline__ U128 gf_mul(U128 a, U128 b) {
  const U128 lo = clmul64(a.lo, b.lo), hi = clmul64(a.hi, b.hi);
  U128 mid = clmul64(a.lo ^ a.hi, b.lo ^ b.hi);
  mid.hi ^= lo.hi ^ hi.hi;
  mid.lo ^= lo.lo ^ hi.lo;
  uint64_t w3 = hi.hi, w2 = hi.lo ^ mid.hi, w1 = lo.hi ^ mid.lo;
  uint64_t w0 = lo.lo;
  w3 = (w3 << 1) | (w2 >> 63);
  w2 = (w2 << 1) | (w1 >> 63);
  w1 = (w1 << 1) | (w0 >> 63);
  w0 <<= 1;
  return fold({w3, w2}, {w1, w0});
}

// A product called, not inlined: the weights and the closing products.
__device__ __noinline__ U128 gf_mul_call(U128 a, U128 b) {
  return gf_mul(a, b);
}

// Bit p of v to bit 2p.
__device__ __forceinline__ uint64_t spread32(uint32_t v) {
  uint64_t x = v;
  x = (x | (x << 16)) & 0x0000FFFF0000FFFFull;
  x = (x | (x << 8)) & 0x00FF00FF00FF00FFull;
  x = (x | (x << 4)) & 0x0F0F0F0F0F0F0F0Full;
  x = (x | (x << 2)) & 0x3333333333333333ull;
  return (x | (x << 1)) & 0x5555555555555555ull;
}

// a^2: a carry-less square has no cross terms, so its product is a's bits
// spread to the even places; then shifted and folded as in gf_mul.
__device__ __forceinline__ U128 gf_sqr(U128 a) {
  uint64_t w3 = spread32((uint32_t)(a.hi >> 32)), w2 = spread32((uint32_t)a.hi);
  uint64_t w1 = spread32((uint32_t)(a.lo >> 32)), w0 = spread32((uint32_t)a.lo);
  w3 = (w3 << 1) | (w2 >> 63);
  w2 = (w2 << 1) | (w1 >> 63);
  w1 = (w1 << 1) | (w0 >> 63);
  w0 <<= 1;
  return fold({w3, w2}, {w1, w0});
}

// c x^j, 0 <= j < 128: c shifted right by j, the j bits pushed out folded
// back.
__device__ __forceinline__ U128 times_xj(U128 c, int j) {
  if (j == 0) return c;
  U128 top, o;
  if (j < 64) {
    top = {c.hi >> j, (c.lo >> j) | (c.hi << (64 - j))};
    o = {c.lo << (64 - j), 0};
  } else {
    top = {0, c.hi >> (j - 64)};
    o = j == 64 ? U128{c.lo, 0}
                : U128{(c.hi << (128 - j)) | (c.lo >> (j - 64)),
                       c.lo << (128 - j)};
  }
  return fold(top, o);
}

// y * H^CT: byte k of y (byte q of little-endian word i) indexes table k,
// at shared address gt + k * 4096.
__device__ __forceinline__ uint4 gmul_tab(uint32_t gt, uint4 y) {
  uint4 z = make_uint4(0, 0, 0, 0);
#define G(i, q, w) \
  z = xor4(z, lds128<(4 * (i) + (q)) * 4096>(byte_of(w, q) * 16 + gt))
  G(0, 0, y.x); G(0, 1, y.x); G(0, 2, y.x); G(0, 3, y.x);
  G(1, 0, y.y); G(1, 1, y.y); G(1, 2, y.y); G(1, 3, y.y);
  G(2, 0, y.z); G(2, 1, y.z); G(2, 2, y.z); G(2, 3, y.z);
  G(3, 0, y.w); G(3, 1, y.w); G(3, 2, y.w); G(3, 3, y.w);
#undef G
  return z;
}

// --- memory ------------------------------------------------------------

// `nb` (0..16) bytes at p as little-endian words, zero past nb.
__device__ __forceinline__ uint4 load_block(const uint8_t* p, int nb) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (nb == 16 && (a & 15) == 0) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4] = {0, 0, 0, 0};
  const bool aligned = (a & 3) == 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (aligned && 4 * k + 4 <= nb) {
      w[k] = reinterpret_cast<const uint32_t*>(p)[k];
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (4 * k + b < nb) w[k] |= (uint32_t)p[4 * k + b] << (8 * b);
      }
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store_block(uint8_t* p, int nb, uint4 v) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (nb == 16 && (a & 15) == 0) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  const bool aligned = (a & 3) == 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (aligned && 4 * k + 4 <= nb) {
      reinterpret_cast<uint32_t*>(p)[k] = w[k];
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        if (4 * k + b < nb) p[4 * k + b] = (uint8_t)(w[k] >> (8 * b));
      }
    }
  }
}

// v with the bytes from nb on zeroed.
__device__ __forceinline__ uint4 keep_bytes(uint4 v, int nb) {
  uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int keep = nb - 4 * k;
    w[k] = keep >= 4 ? w[k] : keep <= 0 ? 0u : w[k] & ((1u << (8 * keep)) - 1);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// --- the setup kernel --------------------------------------------------

// From H (a big-endian integer): H^a for a = 1..64 (warp 0) and
// H^(64 b) for b = 1..ct / 64 (warp 1, H^64 by six squarings), each by
// doubling, and the nibble tables of H^ct, into ws. One block; the main
// kernel starts at once (programmatic dependent launch) and waits for ws
// before its first GHASH pass.
__global__ void __launch_bounds__(kSetupThreads)
aes_gcm_setup_kernel(U128 h, int ct, uint4* __restrict__ ws) {
  asm volatile("griddepcontrol.launch_dependents;");
  __shared__ U128 pa[65];               // H^a at a
  __shared__ U128 pb[kMaxCT / 64 + 1];  // H^(64 b) at b
  __shared__ U128 basis[128];           // H^ct x^j
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nb = ct / 64;
  if (warp == 0) {
    if (lane == 0) pa[1] = h;
    __syncwarp();
    for (int step = 1; step < 64; step <<= 1) {  // H^(i + step) = H^i H^step
      if (lane < step) pa[lane + 1 + step] = gf_mul(pa[lane + 1], pa[step]);
      __syncwarp();
    }
  } else if (warp == 1) {
    if (lane == 0) {
      U128 x = h;
      for (int i = 0; i < 6; ++i) x = gf_sqr(x);
      pb[1] = x;
    }
    __syncwarp();
    for (int step = 1; step < nb; step <<= 1) {
      if (lane < step) pb[lane + 1 + step] = gf_mul(pb[lane + 1], pb[step]);
      __syncwarp();
    }
  }
  __syncthreads();
  if (tid < 128) basis[tid] = times_xj(pb[nb], tid);
  __syncthreads();
  {  // entry [k][half][v]: v's 4 bits at bits 8k + 4 half .. + 3
    const int k = tid >> 5, half = (tid >> 4) & 1, v = tid & 15;
    U128 acc = {0, 0};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if ((v >> (3 - i)) & 1) {
        const U128 b = basis[8 * k + 4 * half + i];
        acc.hi ^= b.hi;
        acc.lo ^= b.lo;
      }
    }
    ws[kWsNib + tid] = to_le(acc);
  }
  if (tid < 64) ws[kWsA + tid] = to_le(pa[tid + 1]);
  if (tid < nb) ws[kWsB + tid] = to_le(pb[tid + 1]);
}

// --- the main kernels --------------------------------------------------

// Once a main block: wait for the setup kernel, build the byte tables of
// H^CT at gt (table k, entry b = tid: its two nibbles' entries), and
// return this thread's weight H^e = H^lo H^(64 hi). Not inlined, to keep
// it out of the loop's registers.
__device__ __noinline__ U128 build_tables(const uint4* ws, uint4* gt,
                                          int tid, int e) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
#pragma unroll 4
  for (int k = 0; k < 16; ++k) {
    gt[k * 256 + tid] = xor4(ws[kWsNib + 32 * k + (tid >> 4)],
                             ws[kWsNib + 32 * k + 16 + (tid & 15)]);
  }
  const int lo = e & 63, hi = e >> 6;
  const U128 a = lo ? from_le(ws[kWsA + lo - 1]) : U128{0, 0};
  const U128 b = hi ? from_le(ws[kWsB + hi - 1]) : U128{0, 0};
  return hi == 0 ? a : lo == 0 ? b : gf_mul(a, b);
}

// Seal (kOpen false) or open (kOpen true) packages over clusters of kC
// blocks; cluster i takes packages i, i + clusters, ...
template <bool kOpen, int kC>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
aes_gcm_kernel(const uint8_t* __restrict__ in,
               const int64_t* __restrict__ desc,
               const uint8_t* __restrict__ nonces,
               const uint8_t* __restrict__ aad, uint8_t* __restrict__ out,
               uint8_t* __restrict__ ok, const uint4* ws,
               long long packages, RoundKeys rk) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* const te = smem;
  const uint32_t gt = (smem_addr(smem + kTeBytes) + 4095u) & ~4095u;
  Small& s = *reinterpret_cast<Small*>(smem + kTeBytes + kGtBytes + 4096);
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int kCT = kC * kThreads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned rank = cluster.block_rank();
  const int g = (int)rank * kThreads + tid;
  const uint32_t tab = smem_addr(te) + ((uint32_t)lane << 2);

  // T0 one copy a bank: lane l of warp w forms entry 32 w + l, and the
  // warp writes each of its 32 entries' 32 copies in turn.
  {
    const uint32_t v = t0_entry(c_sbox[tid]);
#pragma unroll 8
    for (int e = 0; e < 32; ++e) {
      reinterpret_cast<uint32_t*>(te)[((warp * 32 + e) << 5) | lane] =
          __shfl_sync(0xFFFFFFFFu, v, e);
    }
  }
  __syncthreads();
  // The workspace comes from the setup kernel, which may still run: the
  // first step of the first package (AES, no GHASH product yet) overlaps
  // it. Before the block's first GHASH product, build_tables waits for it;
  // every thread of the block takes the same steps, so the barrier after
  // it is the block's.
  uint4* const gtp = reinterpret_cast<uint4*>(
      smem + kTeBytes + (gt - smem_addr(smem + kTeBytes)));
  bool ready = false;
  U128 weight = {0, 0};

  // The next package's descriptor row is loaded a package ahead.
  const long long stride = gridDim.x / kC;
  auto row = [&](long long p, int i) -> int64_t {
    return p < packages ? desc[5 * p + i] : 0;
  };
  long long p = blockIdx.x / kC;
  int64_t d0 = row(p, 0), d1 = row(p, 1), d2 = row(p, 2), d3 = row(p, 3);
  int64_t d4 = row(p, 4);
  for (; p < packages; p += stride) {
    const int64_t in_off = d0, len = d1, aad_off = d2, aad_len = d3;
    const int64_t out_off = d4;
    d0 = row(p + stride, 0); d1 = row(p + stride, 1);
    d2 = row(p + stride, 2); d3 = row(p + stride, 3);
    d4 = row(p + stride, 4);
    const uint8_t* nonce = kOpen ? in + in_off : nonces + 12 * p;
    const uint8_t* src = kOpen ? in + in_off + 12 : in + in_off;
    uint8_t* dst = kOpen ? out + out_off : out + out_off + 12;
    const uint4 nw = load_block(nonce, 12);

    const int64_t a_blocks = (aad_len + 15) >> 4;
    const int64_t c_blocks = (len + 15) >> 4;
    const int64_t n = a_blocks + c_blocks + 1;
    const int64_t steps = (n + kCT - 1) / kCT;
    const int64_t pad = steps * kCT - n;
    // Block j's input: AAD, the message, or the lengths block
    // [len(A) * 8]_64 || [len(C) * 8]_64; zero for j < 0.
    auto fetch = [&](int64_t j) -> uint4 {
      if (j < 0) return make_uint4(0, 0, 0, 0);
      if (j < a_blocks) {
        const int64_t rest = aad_len - 16 * j;
        return load_block(aad + aad_off + 16 * j, rest < 16 ? (int)rest : 16);
      }
      if (j < a_blocks + c_blocks) {
        const int64_t rest = len - 16 * (j - a_blocks);
        return load_block(src + 16 * (j - a_blocks),
                          rest < 16 ? (int)rest : 16);
      }
      const uint64_t abits = (uint64_t)aad_len * 8;
      const uint64_t cbits = (uint64_t)len * 8;
      return make_uint4(bswap((uint32_t)(abits >> 32)), bswap((uint32_t)abits),
                        bswap((uint32_t)(cbits >> 32)), bswap((uint32_t)cbits));
    };
    // Thread g takes blocks j = g + k CT - pad, the next one's input
    // loaded a step ahead: a message block under AES-CTR, then every
    // block into its Horner sum with H^CT (GHASH takes the ciphertext).
    // Thread 0 of block 0 takes E(K, J0) in a leading zero block's slot,
    // or after.
    const bool j0_here = rank == 0 && tid == 0;
    bool j0_done = false;
    uint4 y = make_uint4(0, 0, 0, 0);
    bool seen = false;
    uint4 cur = fetch(g - pad);
    for (int64_t k = 0; k < steps; ++k) {
      const int64_t j = g + k * kCT - pad;
      const uint4 next = fetch(j + kCT);
      if (k > 0 && !ready) {
        weight = build_tables(ws, gtp, tid, kCT - g);
        __syncthreads();
        ready = true;
      }
      if (seen) y = gmul_tab(gt, y);
      if (j >= 0) {
        seen = true;
        uint4 x = cur;
        const int64_t c = j - a_blocks;
        if (c >= 0 && c < c_blocks) {
          const int64_t rest = len - 16 * c;
          const int nb = rest < 16 ? (int)rest : 16;
          uint32_t k0 = nw.x, k1 = nw.y, k2 = nw.z;
          uint32_t k3 = bswap((uint32_t)(c + 2));
          aes256(tab, rk, k0, k1, k2, k3);
          const uint4 r = xor4(cur, make_uint4(k0, k1, k2, k3));
          store_block(dst + 16 * c, nb, r);
          if (!kOpen) x = keep_bytes(r, nb);
        }
        y = xor4(y, x);
      } else if (j0_here && !j0_done) {
        uint32_t j0 = nw.x, j1 = nw.y, j2 = nw.z, j3 = bswap(1u);
        aes256(tab, rk, j0, j1, j2, j3);
        s.ej0 = make_uint4(j0, j1, j2, j3);
        j0_done = true;
      }
      cur = next;
    }
    if (j0_here && !j0_done) {
      uint32_t j0 = nw.x, j1 = nw.y, j2 = nw.z, j3 = bswap(1u);
      aes256(tab, rk, j0, j1, j2, j3);
      s.ej0 = make_uint4(j0, j1, j2, j3);
    }
    if (!ready) {
      weight = build_tables(ws, gtp, tid, kCT - g);
      __syncthreads();
      ready = true;
    }

    // sum_g Y_g H^(CT - g): each thread's product, the block's XOR.
    uint4 z = seen ? to_le(gf_mul_call(from_le(y), weight))
                   : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      z.x ^= __shfl_xor_sync(0xFFFFFFFFu, z.x, o);
      z.y ^= __shfl_xor_sync(0xFFFFFFFFu, z.y, o);
      z.z ^= __shfl_xor_sync(0xFFFFFFFFu, z.z, o);
      z.w ^= __shfl_xor_sync(0xFFFFFFFFu, z.w, o);
    }
    if (lane == 0) s.wsum[warp] = z;
    __syncthreads();
    if (tid == 0) {
      uint4 b = s.wsum[0];
#pragma unroll
      for (int w = 1; w < kThreads / 32; ++w) b = xor4(b, s.wsum[w]);
      s.part = b;
    }
    cluster.sync();  // every block's sum is in
    if (j0_here) {
      uint4 tag = s.ej0;
#pragma unroll
      for (int r = 0; r < kC; ++r) {
        tag = xor4(tag, *cluster.map_shared_rank(&s.part, r));
      }
      if (kOpen) {
        const uint4 want = load_block(src + len, 16);
        const int good = ((tag.x ^ want.x) | (tag.y ^ want.y) |
                          (tag.z ^ want.z) | (tag.w ^ want.w)) == 0;
        ok[p] = good ? 1 : 0;
        s.verdict = good;
      } else {
        store_block(out + out_off, 12, nw);
        store_block(dst + len, 16, tag);
      }
    }
    cluster.sync();  // the verdict is out; the sums may be reused
    if (kOpen && !*cluster.map_shared_rank(&s.verdict, 0)) {
      for (int64_t k = 0; k < steps; ++k) {  // zero what this thread wrote
        const int64_t c = g + k * kCT - pad - a_blocks;
        if (c < 0 || c >= c_blocks) continue;
        const int64_t rest = len - 16 * c;
        store_block(dst + 16 * c, rest < 16 ? (int)rest : 16,
                    make_uint4(0, 0, 0, 0));
      }
    }
  }
  cluster.sync();  // no block leaves while another reads its memory
}

// --- the key's work on the host ----------------------------------------

struct HostKey {
  RoundKeys rk;  // little-endian words
  U128 h;        // E(K, 0), big-endian
};

// The round keys (FIPS-197 5.2 for Nk = 8) and H = E(K, 0), once a launch.
HostKey host_key(const uint8_t* key) {
  const uint8_t* sb = kSbox;
  uint32_t w[60];
  for (int i = 0; i < 8; ++i) {
    w[i] = ((uint32_t)key[4 * i] << 24) | ((uint32_t)key[4 * i + 1] << 16) |
           ((uint32_t)key[4 * i + 2] << 8) | key[4 * i + 3];
  }
  uint8_t rcon = 1;
  for (int i = 8; i < 60; ++i) {
    uint32_t t = w[i - 1];
    if (i % 8 == 0) t = (t << 8) | (t >> 24);
    if (i % 4 == 0) {
      t = ((uint32_t)sb[t >> 24] << 24) | ((uint32_t)sb[(t >> 16) & 255] << 16) |
          ((uint32_t)sb[(t >> 8) & 255] << 8) | sb[t & 255];
    }
    if (i % 8 == 0) {
      t ^= (uint32_t)rcon << 24;
      rcon = xtime(rcon);
    }
    w[i] = w[i - 8] ^ t;
  }
  HostKey hk;
  uint32_t* le = reinterpret_cast<uint32_t*>(hk.rk.k);
  for (int i = 0; i < 60; ++i) le[i] = __builtin_bswap32(w[i]);
  // E(K, 0) on the state bytes (byte r of column c at r + 4c).
  uint8_t st[16] = {0};
  auto add = [&](int r) {
    for (int c = 0; c < 4; ++c) {
      for (int b = 0; b < 4; ++b) st[b + 4 * c] ^= (uint8_t)(w[4 * r + c] >> (24 - 8 * b));
    }
  };
  add(0);
  for (int r = 1; r < 15; ++r) {
    uint8_t t[16];
    for (int c = 0; c < 4; ++c) {  // SubBytes and ShiftRows
      for (int b = 0; b < 4; ++b) t[b + 4 * c] = sb[st[b + 4 * ((c + b) % 4)]];
    }
    for (int c = 0; c < 4 && r < 14; ++c) {  // MixColumns
      const uint8_t a0 = t[4 * c], a1 = t[4 * c + 1], a2 = t[4 * c + 2];
      const uint8_t a3 = t[4 * c + 3];
      t[4 * c] = xtime(a0) ^ xtime(a1) ^ a1 ^ a2 ^ a3;
      t[4 * c + 1] = a0 ^ xtime(a1) ^ xtime(a2) ^ a2 ^ a3;
      t[4 * c + 2] = a0 ^ a1 ^ xtime(a2) ^ xtime(a3) ^ a3;
      t[4 * c + 3] = xtime(a0) ^ a0 ^ a1 ^ a2 ^ xtime(a3);
    }
    for (int i = 0; i < 16; ++i) st[i] = t[i];
    add(r);
  }
  hk.h = {0, 0};
  for (int i = 0; i < 8; ++i) {
    hk.h.hi = (hk.h.hi << 8) | st[i];
    hk.h.lo = (hk.h.lo << 8) | st[8 + i];
  }
  return hk;
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 1;
  }();
  return n;
}

// Blocks a package: the fewest that still give every SM its two blocks,
// so that each thread has the most blocks to fold against its one
// closing product.
int cluster_size(long long packages) {
  const long long slots = (long long)kBlocksPerSm * sm_count();
  if (packages * 2 * 10 >= slots * 9) return 2;
  if (packages * 4 * 10 >= slots * 9) return 4;
  return 8;
}

template <bool kOpen, int kC>
int launch_main(const uint8_t* in, const int64_t* desc,
                const uint8_t* nonces, const uint8_t* aad, uint8_t* out,
                uint8_t* ok, const uint4* ws, long long packages,
                const RoundKeys& rk, cudaStream_t stream) {
  static const int attr = cudaFuncSetAttribute(
      aes_gcm_kernel<kOpen, kC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (attr != 0) return attr;
  const long long resident = (long long)kBlocksPerSm * sm_count() / kC;
  const long long clusters = packages < resident ? packages : resident;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * kC));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = kC;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  at[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = at;
  cfg.numAttrs = 2;
  return (int)cudaLaunchKernelEx(&cfg, aes_gcm_kernel<kOpen, kC>, in, desc,
                                 nonces, aad, out, ok, ws, packages, rk);
}

template <bool kOpen>
int launch(const uint8_t* in, const int64_t* desc, const uint8_t* nonces,
           const uint8_t* aad, uint8_t* out, uint8_t* ok, long long packages,
           const uint8_t* key, void* ws, cudaStream_t stream) {
  if (packages <= 0) return 0;
  const int c = cluster_size(packages);
  const HostKey hk = host_key(key);
  aes_gcm_setup_kernel<<<1, kSetupThreads, 0, stream>>>(hk.h, c * kThreads,
                                                        (uint4*)ws);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const uint4* w = (const uint4*)ws;
  switch (c) {
    case 2:
      return launch_main<kOpen, 2>(in, desc, nonces, aad, out, ok, w,
                                   packages, hk.rk, stream);
    case 4:
      return launch_main<kOpen, 4>(in, desc, nonces, aad, out, ok, w,
                                   packages, hk.rk, stream);
    default:
      return launch_main<kOpen, 8>(in, desc, nonces, aad, out, ok, w,
                                   packages, hk.rk, stream);
  }
}

}  // namespace

// Bytes of the workspace both entry points take (16-byte aligned).
extern "C" int aes_gcm_workspace_bytes() { return kWsBytes; }

// Blocks a package of a launch of `packages` takes (a cluster).
extern "C" int aes_gcm_cluster_size(long long packages) {
  return cluster_size(packages);
}

// Kernel C. in: plaintexts; desc int64 [P, 5]; nonces uint8 [P, 12]; aad:
// the AADs; out: the wire layout; key: 32 bytes in host memory; ws: the
// workspace.
extern "C" int aes_gcm_seal_launch(const void* in, const void* desc,
                                   const void* nonces, const void* aad,
                                   void* out, long long packages,
                                   const void* key, void* ws, void* stream) {
  return launch<false>((const uint8_t*)in, (const int64_t*)desc,
                       (const uint8_t*)nonces, (const uint8_t*)aad,
                       (uint8_t*)out, nullptr, packages,
                       (const uint8_t*)key, ws, (cudaStream_t)stream);
}

// Kernel D. in: the wire layout; desc int64 [P, 5]; aad: the AADs; out:
// plaintexts; ok uint8 [P]; key: 32 bytes in host memory; ws: the
// workspace.
extern "C" int aes_gcm_open_launch(const void* in, const void* desc,
                                   const void* aad, void* out, void* ok,
                                   long long packages, const void* key,
                                   void* ws, void* stream) {
  return launch<true>((const uint8_t*)in, (const int64_t*)desc, nullptr,
                      (const uint8_t*)aad, (uint8_t*)out, (uint8_t*)ok,
                      packages, (const uint8_t*)key, ws,
                      (cudaStream_t)stream);
}
