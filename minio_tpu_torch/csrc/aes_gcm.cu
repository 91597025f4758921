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
// costs 14 AES rounds of 16 table lookups and one GF(2^128) product of
// 31 nibble steps. The design:
//
// - One block of 256 threads a package (a 1 MiB gather is 16 packages,
//   so batches are deep: phase 5 of chip_smoke.py times 16 and 4,097).
// - The AES round table T0 lives in shared memory 32 times, entry x of
//   copy `lane` at word (x << 5) | lane: each lane reads its own bank, so
//   the random lookups of a warp never conflict. T1..T3 are rotations of
//   T0 and the S-box of the last round is a byte of it.
// - GHASH is linear: with the package's blocks X_0..X_{n-1} (AAD, then
//   ciphertext, then the lengths) right-aligned to n' = 256 r blocks
//   (leading zero blocks change nothing), thread t takes the r blocks
//   [t r, (t+1) r), encrypts the counter blocks among them, and folds all
//   of them by Horner with H: Y_t. GHASH = sum_t Y_t G^(255 - t) with
//   G = H^r, which a tree of 8 levels sums in shared memory, level l
//   multiplying by G^(2^l). Every product is the 4-bit table method: a
//   16-entry table of multiples of the constant and 31 shift-and-reduce
//   steps, in GCM's reflected bit order (the 128-bit block read
//   big-endian, the coefficient of x^0 in its top bit).
// - Thread 0 expands the key, forms H = E(K, 0), E(K, J0) and H's table,
//   then builds G's tables while the other threads run their blocks.
//
// CTR starts at inc32(J0) = nonce || 2 (96-bit nonces only, as GCM with
// minio_tpu's 12-byte nonces); the tag is E(K, J0) ^ GHASH with the last
// block [len(A) * 8]_64 || [len(C) * 8]_64.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLevels = 8;  // log2(kThreads)

__constant__ uint8_t c_sbox[256] = {
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b,
    0xfe, 0xd7, 0xab, 0x76, 0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0,
    0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0, 0xb7, 0xfd, 0x93, 0x26,
    0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2,
    0xeb, 0x27, 0xb2, 0x75, 0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0,
    0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84, 0x53, 0xd1, 0x00, 0xed,
    0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f,
    0x50, 0x3c, 0x9f, 0xa8, 0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5,
    0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2, 0xcd, 0x0c, 0x13, 0xec,
    0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14,
    0xde, 0x5e, 0x0b, 0xdb, 0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c,
    0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79, 0xe7, 0xc8, 0x37, 0x6d,
    0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f,
    0x4b, 0xbd, 0x8b, 0x8a, 0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e,
    0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e, 0xe1, 0xf8, 0x98, 0x11,
    0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f,
    0xb0, 0x54, 0xbb, 0x16,
};

struct Key {
  uint8_t b[32];
};

struct Smem {
  uint32_t te[256 * 32];           // T0, one copy a bank (32 KiB)
  uint32_t rk[60];                 // round keys, big-endian words
  uint64_t hh[16], hl[16];         // table of H's multiples
  uint64_t gh[kLevels][16], gl[kLevels][16];  // tables of G^(2^l)
  uint64_t yh[kThreads], yl[kThreads];        // Horner partials, the tree
  uint32_t ej0[4];                 // E(K, J0)
  uint64_t h_hi, h_lo;             // H
  int ok;
};

__device__ __forceinline__ uint32_t ror(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ uint32_t bswap(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

__device__ __forceinline__ uint8_t xtime(uint8_t a) {
  return (uint8_t)((a << 1) ^ ((a & 0x80) ? 0x1b : 0));
}

__device__ __forceinline__ uint32_t sub_word(uint32_t w) {
  return ((uint32_t)c_sbox[w >> 24] << 24) |
         ((uint32_t)c_sbox[(w >> 16) & 255] << 16) |
         ((uint32_t)c_sbox[(w >> 8) & 255] << 8) | c_sbox[w & 255];
}

// FIPS-197 5.2 for Nk = 8: 60 words.
__device__ void expand_key(const Key& key, uint32_t* rk) {
  for (int i = 0; i < 8; ++i) {
    rk[i] = ((uint32_t)key.b[4 * i] << 24) |
            ((uint32_t)key.b[4 * i + 1] << 16) |
            ((uint32_t)key.b[4 * i + 2] << 8) | key.b[4 * i + 3];
  }
  uint8_t rcon = 1;
  for (int i = 8; i < 60; ++i) {
    uint32_t t = rk[i - 1];
    if (i % 8 == 0) {
      t = sub_word((t << 8) | (t >> 24)) ^ ((uint32_t)rcon << 24);
      rcon = xtime(rcon);
    } else if (i % 8 == 4) {
      t = sub_word(t);
    }
    rk[i] = rk[i - 8] ^ t;
  }
}

// One AES-256 block: big-endian words in, big-endian words out.
__device__ __forceinline__ void aes256(const uint32_t* __restrict__ te,
                                       const uint32_t* __restrict__ rk,
                                       int lane, const uint32_t in[4],
                                       uint32_t out[4]) {
#define T(x) te[((x) << 5) | lane]
  uint32_t s0 = in[0] ^ rk[0], s1 = in[1] ^ rk[1];
  uint32_t s2 = in[2] ^ rk[2], s3 = in[3] ^ rk[3];
#pragma unroll
  for (int r = 1; r < 14; ++r) {
    const uint32_t t0 = T(s0 >> 24) ^ ror(T((s1 >> 16) & 255), 8) ^
                        ror(T((s2 >> 8) & 255), 16) ^ ror(T(s3 & 255), 24) ^
                        rk[4 * r];
    const uint32_t t1 = T(s1 >> 24) ^ ror(T((s2 >> 16) & 255), 8) ^
                        ror(T((s3 >> 8) & 255), 16) ^ ror(T(s0 & 255), 24) ^
                        rk[4 * r + 1];
    const uint32_t t2 = T(s2 >> 24) ^ ror(T((s3 >> 16) & 255), 8) ^
                        ror(T((s0 >> 8) & 255), 16) ^ ror(T(s1 & 255), 24) ^
                        rk[4 * r + 2];
    const uint32_t t3 = T(s3 >> 24) ^ ror(T((s0 >> 16) & 255), 8) ^
                        ror(T((s1 >> 8) & 255), 16) ^ ror(T(s2 & 255), 24) ^
                        rk[4 * r + 3];
    s0 = t0; s1 = t1; s2 = t2; s3 = t3;
  }
#define SB(x) ((T(x) >> 8) & 255)
  out[0] = ((SB(s0 >> 24) << 24) | (SB((s1 >> 16) & 255) << 16) |
            (SB((s2 >> 8) & 255) << 8) | SB(s3 & 255)) ^ rk[56];
  out[1] = ((SB(s1 >> 24) << 24) | (SB((s2 >> 16) & 255) << 16) |
            (SB((s3 >> 8) & 255) << 8) | SB(s0 & 255)) ^ rk[57];
  out[2] = ((SB(s2 >> 24) << 24) | (SB((s3 >> 16) & 255) << 16) |
            (SB((s0 >> 8) & 255) << 8) | SB(s1 & 255)) ^ rk[58];
  out[3] = ((SB(s3 >> 24) << 24) | (SB((s0 >> 16) & 255) << 16) |
            (SB((s1 >> 8) & 255) << 8) | SB(s2 & 255)) ^ rk[59];
#undef SB
#undef T
}

// The 16 multiples of c = (hi, lo) by the 4-bit polynomials: entry n has
// the top bit of n as the coefficient of x^0, so entry 8 is c.
__device__ void build_table(uint64_t hi, uint64_t lo, uint64_t* th,
                            uint64_t* tl) {
  th[0] = 0; tl[0] = 0;
  th[8] = hi; tl[8] = lo;
  for (int i = 4; i >= 1; i >>= 1) {  // times x: one bit toward the end
    const uint64_t red = (lo & 1) ? 0xE100000000000000ull : 0;
    lo = (hi << 63) | (lo >> 1);
    hi = (hi >> 1) ^ red;
    th[i] = hi; tl[i] = lo;
  }
  for (int i = 3; i < 16; ++i) {
    const int top = 1 << (31 - __clz(i));
    if (i == top) continue;
    th[i] = th[top] ^ th[i - top];
    tl[i] = tl[top] ^ tl[i - top];
  }
}

// x <- x * c, with c's table (th, tl) in shared memory. Nibble i of the
// big-endian 128-bit x holds the coefficients of x^(4i) .. x^(4i+3);
// Horner from nibble 31 down, each step a multiply by x^4: a shift of 4
// and the reduction of the 4 bits shifted out, r * 0x1C20 carry-less
// (x^128 = 1 + x + x^2 + x^7) in the top 16 bits.
__device__ __forceinline__ void gmult(uint64_t& xh, uint64_t& xl,
                                      const uint64_t* __restrict__ th,
                                      const uint64_t* __restrict__ tl) {
  int n = (int)(xl & 15);
  uint64_t zh = th[n], zl = tl[n];
#pragma unroll
  for (int i = 30; i >= 0; --i) {
    n = i < 16 ? (int)((xh >> (60 - 4 * i)) & 15)
               : (int)((xl >> (124 - 4 * i)) & 15);
    const uint32_t r = (uint32_t)(zl & 15);
    const uint32_t red = ((r & 1) * 0x1C20u) ^ ((r & 2) * 0x1C20u) ^
                         ((r & 4) * 0x1C20u) ^ ((r & 8) * 0x1C20u);
    zl = (zh << 60) | (zl >> 4);
    zh = (zh >> 4) ^ ((uint64_t)red << 48);
    zh ^= th[n];
    zl ^= tl[n];
  }
  xh = zh;
  xl = zl;
}

// `nbytes` (0..16) bytes at p as big-endian words, zero-padded.
__device__ __forceinline__ void load_block(const uint8_t* p, int nbytes,
                                           uint32_t w[4]) {
  if (nbytes == 16 && ((uintptr_t)p & 3) == 0) {
    const uint32_t* q = reinterpret_cast<const uint32_t*>(p);
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = bswap(q[k]);
    return;
  }
  uint8_t b[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) b[k] = k < nbytes ? p[k] : 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w[k] = ((uint32_t)b[4 * k] << 24) | ((uint32_t)b[4 * k + 1] << 16) |
           ((uint32_t)b[4 * k + 2] << 8) | b[4 * k + 3];
  }
}

__device__ __forceinline__ void store_block(uint8_t* p, int nbytes,
                                            const uint32_t w[4]) {
  if (nbytes == 16 && ((uintptr_t)p & 3) == 0) {
    uint32_t* q = reinterpret_cast<uint32_t*>(p);
#pragma unroll
    for (int k = 0; k < 4; ++k) q[k] = bswap(w[k]);
    return;
  }
  for (int k = 0; k < nbytes; ++k) {
    p[k] = (uint8_t)(w[k >> 2] >> (24 - 8 * (k & 3)));
  }
}

// Seal (kOpen false) or open (kOpen true) package blockIdx.x.
template <bool kOpen>
__global__ void __launch_bounds__(kThreads)
aes_gcm_kernel(const uint8_t* __restrict__ in,
               const int64_t* __restrict__ desc,
               const uint8_t* __restrict__ nonces,
               const uint8_t* __restrict__ aad, uint8_t* __restrict__ out,
               uint8_t* __restrict__ ok, Key key) {
  __shared__ Smem s;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int64_t p = blockIdx.x;
  const int64_t in_off = desc[5 * p], aad_off = desc[5 * p + 2];
  const int64_t out_off = desc[5 * p + 4];
  const int64_t len = desc[5 * p + 1], aad_len = desc[5 * p + 3];
  const uint8_t* nonce = kOpen ? in + in_off : nonces + 12 * p;
  const uint8_t* src = kOpen ? in + in_off + 12 : in + in_off;
  uint8_t* dst = kOpen ? out + out_off : out + out_off + 12;

  // The round table, one copy a bank; all lanes of a warp fill one entry.
  for (int i = tid; i < 256 * 32; i += kThreads) {
    const uint8_t v = c_sbox[i >> 5];
    const uint8_t v2 = xtime(v);
    s.te[i] = ((uint32_t)v2 << 24) | ((uint32_t)v << 16) |
              ((uint32_t)v << 8) | (uint32_t)(v2 ^ v);
  }
  if (tid == 0) expand_key(key, s.rk);
  __syncthreads();

  uint32_t nw[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    nw[k] = ((uint32_t)nonce[4 * k] << 24) |
            ((uint32_t)nonce[4 * k + 1] << 16) |
            ((uint32_t)nonce[4 * k + 2] << 8) | nonce[4 * k + 3];
  }
  if (tid == 0) {
    uint32_t blk[4] = {0, 0, 0, 0}, h[4];
    aes256(s.te, s.rk, lane, blk, h);
    s.h_hi = ((uint64_t)h[0] << 32) | h[1];
    s.h_lo = ((uint64_t)h[2] << 32) | h[3];
    build_table(s.h_hi, s.h_lo, s.hh, s.hl);
    const uint32_t j0[4] = {nw[0], nw[1], nw[2], 1u};
    aes256(s.te, s.rk, lane, j0, s.ej0);
  }
  __syncthreads();

  const int64_t a_blocks = (aad_len + 15) >> 4;
  const int64_t c_blocks = (len + 15) >> 4;
  const int64_t n = a_blocks + c_blocks + 1;
  const int64_t r = (n + kThreads - 1) / kThreads;
  const int64_t pad = r * kThreads - n;

  if (tid == 0) {  // G = H^r and its squares' tables, for the tree
    uint64_t gh = s.h_hi, gl = s.h_lo;
    for (int64_t k = 1; k < r; ++k) gmult(gh, gl, s.hh, s.hl);
    for (int l = 0; l < kLevels; ++l) {
      build_table(gh, gl, s.gh[l], s.gl[l]);
      if (l + 1 < kLevels) gmult(gh, gl, s.gh[l], s.gl[l]);
    }
  }

  uint64_t zh = 0, zl = 0;
  for (int64_t v = tid * r; v < (tid + 1) * r; ++v) {
    const int64_t j = v - pad;
    if (j < 0) continue;  // the leading zero blocks
    uint32_t x[4];
    if (j < a_blocks) {
      const int64_t rest = aad_len - 16 * j;
      load_block(aad + aad_off + 16 * j, rest < 16 ? (int)rest : 16, x);
    } else if (j < a_blocks + c_blocks) {
      const int64_t c = j - a_blocks;
      const int64_t rest = len - 16 * c;
      const int nb = rest < 16 ? (int)rest : 16;
      const uint32_t ctr[4] = {nw[0], nw[1], nw[2], (uint32_t)(c + 2)};
      uint32_t ks[4], d[4];
      aes256(s.te, s.rk, lane, ctr, ks);
      load_block(src + 16 * c, nb, d);
#pragma unroll
      for (int k = 0; k < 4; ++k) d[k] ^= ks[k];
      store_block(dst + 16 * c, nb, d);
      if (kOpen) {
        load_block(src + 16 * c, nb, x);  // GHASH takes the ciphertext
      } else {
        // The ciphertext, zero past its end: word k keeps its first
        // `keep` bytes.
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int keep = min(max(nb - 4 * k, 0), 4);
          x[k] = keep == 4 ? d[k]
                 : keep == 0 ? 0u
                             : d[k] & (0xFFFFFFFFu << (8 * (4 - keep)));
        }
      }
    } else {  // [len(A) * 8]_64 || [len(C) * 8]_64
      const uint64_t abits = (uint64_t)aad_len * 8, cbits = (uint64_t)len * 8;
      x[0] = (uint32_t)(abits >> 32); x[1] = (uint32_t)abits;
      x[2] = (uint32_t)(cbits >> 32); x[3] = (uint32_t)cbits;
    }
    zh ^= ((uint64_t)x[0] << 32) | x[1];
    zl ^= ((uint64_t)x[2] << 32) | x[3];
    gmult(zh, zl, s.hh, s.hl);
  }
  s.yh[tid] = zh;
  s.yl[tid] = zl;
  __syncthreads();

  // sum_t Y_t G^(255 - t): level l joins pairs 2^l apart, the left one
  // times G^(2^l).
#pragma unroll 1
  for (int l = 0; l < kLevels; ++l) {
    const int step = 1 << l;
    if ((tid & (2 * step - 1)) == 0) {
      uint64_t a = s.yh[tid], b = s.yl[tid];
      gmult(a, b, s.gh[l], s.gl[l]);
      s.yh[tid] = a ^ s.yh[tid + step];
      s.yl[tid] = b ^ s.yl[tid + step];
    }
    __syncthreads();
  }

  if (tid == 0) {
    const uint32_t tag[4] = {
        (uint32_t)(s.yh[0] >> 32) ^ s.ej0[0], (uint32_t)s.yh[0] ^ s.ej0[1],
        (uint32_t)(s.yl[0] >> 32) ^ s.ej0[2], (uint32_t)s.yl[0] ^ s.ej0[3]};
    if (kOpen) {
      uint32_t want[4];
      load_block(src + len, 16, want);
      const uint32_t diff = (tag[0] ^ want[0]) | (tag[1] ^ want[1]) |
                            (tag[2] ^ want[2]) | (tag[3] ^ want[3]);
      s.ok = diff == 0;
      ok[p] = diff == 0 ? 1 : 0;
    } else {
      uint8_t* o = out + out_off;
      for (int k = 0; k < 12; ++k) o[k] = nonce[k];
      store_block(o + 12 + len, 16, tag);
    }
  }
  if (kOpen) {
    __syncthreads();
    if (!s.ok) {
      for (int64_t i = tid; i < len; i += kThreads) dst[i] = 0;
    }
  }
}

Key to_key(const uint8_t* key) {
  Key k;
  for (int i = 0; i < 32; ++i) k.b[i] = key[i];
  return k;
}

}  // namespace

// Kernel C. in: plaintexts; desc int64 [P, 5]; nonces uint8 [P, 12]; aad:
// the AADs; out: the wire layout; key: 32 bytes in host memory.
extern "C" int aes_gcm_seal_launch(const void* in, const void* desc,
                                   const void* nonces, const void* aad,
                                   void* out, long long packages,
                                   const void* key, void* stream) {
  if (packages <= 0) return 0;
  aes_gcm_kernel<false><<<(unsigned)packages, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)in, (const int64_t*)desc, (const uint8_t*)nonces,
      (const uint8_t*)aad, (uint8_t*)out, nullptr,
      to_key((const uint8_t*)key));
  return (int)cudaGetLastError();
}

// Kernel D. in: the wire layout; desc int64 [P, 5]; aad: the AADs; out:
// plaintexts; ok uint8 [P]; key: 32 bytes in host memory.
extern "C" int aes_gcm_open_launch(const void* in, const void* desc,
                                   const void* aad, void* out, void* ok,
                                   long long packages, const void* key,
                                   void* stream) {
  if (packages <= 0) return 0;
  aes_gcm_kernel<true><<<(unsigned)packages, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)in, (const int64_t*)desc, nullptr,
      (const uint8_t*)aad, (uint8_t*)out, (uint8_t*)ok,
      to_key((const uint8_t*)key));
  return (int)cudaGetLastError();
}
