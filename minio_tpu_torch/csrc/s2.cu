// Snappy block compression and framed-chunk decompression with CRC32C:
// kernels E and F of minio_tpu_torch.
//
// They replace no TPU kernel: minio_tpu compresses objects on the host with
// its native C codec (minio_tpu/native/snappy.c, through ops/s2.py
// compress_block, decompress_block and crc32c). The port may not load that
// library, so the codec is written here; the plain versions of both kernels
// are minio_tpu_torch/ops/s2.py's compress_plain and decompress_plain,
// snappy.c line for line in Python.
//
// E, s2_compress_launch: chunk c of desc [N, 3] (in_off, length, out_off),
// at most 64 KiB, gives the snappy block of its bytes at dst + out_off (its
// slot is max_compressed(length) = 32 + length + length / 6 bytes),
// lens[c] its length and crcs[c] the masked CRC32C of the raw bytes. The
// block is byte for byte mtpu_snappy_compress's: a varint length, then
// literal and copy tags from a 16,384-entry uint16 hash table of
// (v * 0x1e35a7bd) >> 18 over each position's little-endian 32-bit word,
// reset for the chunk (an empty entry reads as position 0); a match needs
// cand < pos, pos - cand <= 0xffff and equal words, extends while the
// bytes agree before the chunk's end and below 0xffff, and seeds the hash
// of up to three positions inside it; literals below 8 bytes only, runs
// split at 65,536; copies split at 68, 64 and 60 so that no tag is under
// 4 bytes. The host assembles the frames (a chunk is stored compressed
// only when its block is shorter).
//
// F, s2_decompress_launch: frame f of desc [N, 5] (type, body offset, body
// length, out_off, out_len) is a body of type 0x00 (masked CRC, snappy
// block) or 0x01 (masked CRC, raw bytes). F decodes the block (or takes
// the raw bytes) into shared memory, with mtpu_snappy_decompress's checks
// against out_len (at most 64 KiB), copies the raw bytes to
// dst + out_off and checks their masked CRC32C: status[f] is 0, 1 (CRC
// mismatch) or 2 (a malformed block, or raw bytes of another length). A
// frame writes its own slot and nothing else.
//
// What bounds them on this card: neither is bound by bytes or operations
// but by the length of one dependent chain. Each chunk is a
// data-dependent sequential match loop (a hash, a table read and write, a
// compare per position; a byte per step in a decode), so the design is
// one chunk a block with one thread running the chain:
// - E stages the chunk in shared memory (coalesced loads by the block),
//   where a position's word is two aligned 32-bit loads and a funnel
//   shift; the hash table (32 KiB) lives there too, so a block holds
//   97 KiB and an SM two. A match extends 4 bytes a step. Warp 1 computes
//   the CRC while thread 0 compresses.
// - F decodes into shared memory (a copy reads back what it wrote), then
//   the block copies the frame out and warp 0 computes the CRC.
// - The CRC is split over a warp: lane l takes the CRC register of the
//   l-th of 32 segments (lane 0 from 0xffffffff, the others from 0) with a
//   256-entry table in shared memory, multiplies it by x^(8 * bytes after
//   the segment) mod P (zlib's multmodp, from a table of x^(2^k) mod P),
//   and the lanes' products XOR to the register of the whole.
//   ops/s2.py's segmented_crc32c models this and tests/test_torch_s2.py
//   holds the model to the byte-at-a-time CRC.
// - Persistent blocks (two an SM for E, three for F) walk the chunks, so
//   the tables are built once a block.
// A faster design (several chunks a block with the hash loop split by
// warp-wide candidate search) is left to a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 65536;
constexpr int kPad = 8;  // zero bytes after a staged chunk: word reads
constexpr int kHashBits = 14;
constexpr int kHashSize = 1 << kHashBits;
constexpr int kMinMatch = 4;
constexpr uint32_t kPoly = 0x82f63b78u;  // CRC-32C, reflected
constexpr uint32_t kMaskDelta = 0xa282ead8u;

constexpr int kStatusOk = 0;
constexpr int kStatusCrc = 1;
constexpr int kStatusCorrupt = 2;

// Shared memory: the CRC table (256 words), x^(2^k) mod P (32 words),
// then E's hash table and the staged chunk, or F's output chunk.
constexpr size_t kTablesBytes = (256 + 32) * 4;
constexpr size_t kSmemCompress =
    kTablesBytes + kHashSize * 2 + kChunk + kPad;
constexpr size_t kSmemDecompress = kTablesBytes + kChunk + kPad;

__device__ uint32_t multmodp(uint32_t a, uint32_t b) {
  // a * b mod P, reflected; a != 0 (every caller's a is a power of x).
  uint32_t m = 1u << 31, p = 0;
  for (;;) {
    if (a & m) {
      p ^= b;
      if ((a & (m - 1)) == 0) break;
    }
    m >>= 1;
    b = (b & 1) ? (b >> 1) ^ kPoly : b >> 1;
  }
  return p;
}

__device__ void build_tables(uint32_t* tab, uint32_t* x2n) {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? (kPoly ^ (c >> 1)) : c >> 1;
    tab[i] = c;
  }
  if (threadIdx.x == 0) {
    uint32_t p = 1u << 30;  // x^1
    x2n[0] = p;
    for (int k = 1; k < 32; ++k) {
      p = multmodp(p, p);
      x2n[k] = p;
    }
  }
}

// CRC32C of s[0, n) by the 32 lanes of one warp (every lane calls it);
// the masked CRC, as the framing stores it.
__device__ uint32_t warp_masked_crc(const uint8_t* s, int n,
                                    const uint32_t* tab,
                                    const uint32_t* x2n) {
  const int lane = threadIdx.x & 31;
  const int seg = (n + 31) / 32;
  const int lo = min(n, lane * seg), hi = min(n, (lane + 1) * seg);
  uint32_t c = lane == 0 ? 0xffffffffu : 0u;
  for (int i = lo; i < hi; ++i) c = tab[(c ^ s[i]) & 0xff] ^ (c >> 8);
  uint32_t shift = 1u << 31;  // x^0
  int k = 3;
  for (int r = n - hi; r; r >>= 1, ++k)
    if (r & 1) shift = multmodp(x2n[k & 31], shift);
  uint32_t v = multmodp(shift, c);
  for (int off = 16; off; off >>= 1) v ^= __shfl_xor_sync(0xffffffffu, v, off);
  const uint32_t crc = v ^ 0xffffffffu;
  return ((crc >> 15) | (crc << 17)) + kMaskDelta;
}

// The little-endian word at byte p of a 4-aligned, padded shared buffer.
__device__ __forceinline__ uint32_t ld32(const uint8_t* b, int p) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(b);
  return __funnelshift_r(w[p >> 2], w[(p >> 2) + 1], (p & 3) * 8);
}

__device__ __forceinline__ uint32_t hash32(uint32_t v) {
  return (v * 0x1e35a7bdu) >> (32 - kHashBits);
}

__device__ int emit_literal(uint8_t* d, int o, const uint8_t* src, int len) {
  while (len > 0) {
    const int run = len > (1 << 16) ? (1 << 16) : len;
    const int l = run - 1;
    if (l < 60) {
      d[o++] = (uint8_t)(l << 2);
    } else if (l < 256) {
      d[o++] = 60 << 2;
      d[o++] = (uint8_t)l;
    } else {
      d[o++] = 61 << 2;
      d[o++] = (uint8_t)(l & 0xff);
      d[o++] = (uint8_t)(l >> 8);
    }
    for (int i = 0; i < run; ++i) d[o + i] = src[i];
    o += run;
    src += run;
    len -= run;
  }
  return o;
}

__device__ __forceinline__ int emit_copy_one(uint8_t* d, int o, int offset,
                                             int len) {
  d[o] = (uint8_t)(((len - 1) << 2) | 2);
  d[o + 1] = (uint8_t)(offset & 0xff);
  d[o + 2] = (uint8_t)(offset >> 8);
  return o + 3;
}

__device__ int emit_copy(uint8_t* d, int o, int offset, int len) {
  while (len >= 68) {
    o = emit_copy_one(d, o, offset, 64);
    len -= 64;
  }
  if (len > 64) {
    o = emit_copy_one(d, o, offset, 60);
    len -= 60;
  }
  return emit_copy_one(d, o, offset, len);
}

// mtpu_snappy_compress of one chunk (len <= kChunk) staged in b.
__device__ int compress_chunk(const uint8_t* b, int len, uint16_t* htab,
                              uint8_t* d) {
  int o = 0;
  uint32_t v = (uint32_t)len;
  while (v >= 0x80) {
    d[o++] = (uint8_t)(v | 0x80);
    v >>= 7;
  }
  d[o++] = (uint8_t)v;
  if (len == 0) return o;
  if (len < kMinMatch + 4) return emit_literal(d, o, b, len);
  int pos = 0, lit = 0;
  const int limit = len - kMinMatch;
  while (pos <= limit) {
    const uint32_t w = ld32(b, pos);
    const uint32_t h = hash32(w);
    const int cand = htab[h];
    htab[h] = (uint16_t)pos;
    if (cand < pos && pos - cand <= 0xffff && ld32(b, cand) == w) {
      int mlen = kMinMatch;
      while (pos + mlen + 4 <= len && mlen + 4 <= 0xffff) {
        const uint32_t x = ld32(b, cand + mlen) ^ ld32(b, pos + mlen);
        if (x) {
          mlen += (__ffs(x) - 1) >> 3;
          break;
        }
        mlen += 4;
      }
      while (pos + mlen < len && b[cand + mlen] == b[pos + mlen] &&
             mlen < 0xffff)
        ++mlen;
      if (pos > lit) o = emit_literal(d, o, b + lit, pos - lit);
      o = emit_copy(d, o, pos - cand, mlen);
      const int seed_end = pos + mlen;
      for (int s = pos + 1;
           s + kMinMatch <= seed_end && s <= limit && s < pos + 4; ++s)
        htab[hash32(ld32(b, s))] = (uint16_t)s;
      pos += mlen;
      lit = pos;
    } else {
      ++pos;
    }
  }
  if (len > lit) o = emit_literal(d, o, b + lit, len - lit);
  return o;
}

__global__ void __launch_bounds__(kThreads)
s2_compress_kernel(const uint8_t* __restrict__ src,
                   const int64_t* __restrict__ desc,
                   uint8_t* __restrict__ dst, int64_t* __restrict__ crcs,
                   int64_t* __restrict__ lens, long long n_chunks) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  uint32_t* x2n = tab + 256;
  uint16_t* htab = reinterpret_cast<uint16_t*>(x2n + 32);
  uint8_t* buf = reinterpret_cast<uint8_t*>(htab + kHashSize);
  build_tables(tab, x2n);
  const int warp = threadIdx.x >> 5;
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int64_t in_off = desc[3 * c];
    const int64_t len64 = desc[3 * c + 1];
    const int64_t out_off = desc[3 * c + 2];
    __syncthreads();  // the last chunk is done with buf and htab
    if (len64 < 0 || len64 > kChunk) {
      if (threadIdx.x == 0) {
        lens[c] = -1;
        crcs[c] = 0;
      }
      continue;
    }
    const int len = (int)len64;
    const uint8_t* s = src + in_off;
    for (int i = threadIdx.x; i < len + kPad; i += blockDim.x)
      buf[i] = i < len ? s[i] : 0;
    uint32_t* h32 = reinterpret_cast<uint32_t*>(htab);
    for (int i = threadIdx.x; i < kHashSize / 2; i += blockDim.x) h32[i] = 0;
    __syncthreads();
    if (threadIdx.x == 0) {
      lens[c] = compress_chunk(buf, len, htab, dst + out_off);
    } else if (warp == 1) {
      const uint32_t crc = warp_masked_crc(buf, len, tab, x2n);
      if ((threadIdx.x & 31) == 0) crcs[c] = (int64_t)crc;
    }
  }
}

// mtpu_snappy_decompress of src[0, n) into out (cap bytes at most):
// the raw length, or -1 for a malformed block.
__device__ int decode_block(const uint8_t* __restrict__ src, int64_t n,
                            uint8_t* out, int cap) {
  uint64_t want = 0;
  int64_t i = 0;
  int shift = 0;
  bool done = false;
  while (i < n && shift < 64) {
    const uint8_t b = __ldg(src + i);
    ++i;
    want |= (uint64_t)(b & 0x7f) << shift;
    if (!(b & 0x80)) {
      done = true;
      break;
    }
    shift += 7;
  }
  if (!done || want > (uint64_t)cap) return -1;
  int64_t o = 0;
  while (i < n) {
    const uint8_t tag = __ldg(src + i++);
    const int kind = tag & 3;
    if (kind == 0) {
      uint64_t len = (tag >> 2) + 1;
      if (len > 60) {
        const int extra = (int)len - 60;
        if (i + extra > n) return -1;
        len = 0;
        for (int k = 0; k < extra; ++k)
          len |= (uint64_t)__ldg(src + i + k) << (8 * k);
        len += 1;
        i += extra;
      }
      if ((uint64_t)i + len > (uint64_t)n || (uint64_t)o + len > want)
        return -1;
      for (uint64_t k = 0; k < len; ++k) out[o + k] = __ldg(src + i + k);
      i += len;
      o += len;
    } else {
      uint64_t len, off;
      if (kind == 1) {
        len = ((tag >> 2) & 7) + 4;
        if (i >= n) return -1;
        off = ((uint64_t)(tag >> 5) << 8) | __ldg(src + i);
        i += 1;
      } else if (kind == 2) {
        len = (tag >> 2) + 1;
        if (i + 2 > n) return -1;
        off = (uint64_t)__ldg(src + i) | ((uint64_t)__ldg(src + i + 1) << 8);
        i += 2;
      } else {
        len = (tag >> 2) + 1;
        if (i + 4 > n) return -1;
        off = (uint64_t)__ldg(src + i) |
              ((uint64_t)__ldg(src + i + 1) << 8) |
              ((uint64_t)__ldg(src + i + 2) << 16) |
              ((uint64_t)__ldg(src + i + 3) << 24);
        i += 4;
      }
      if (off == 0 || off > (uint64_t)o || (uint64_t)o + len > want)
        return -1;
      // An overlapping copy repeats bytes it has just written: in order.
      for (uint64_t k = 0; k < len; ++k) {
        out[o] = out[o - off];
        ++o;
      }
    }
  }
  return o == (int64_t)want ? (int)o : -1;
}

__global__ void __launch_bounds__(kThreads)
s2_decompress_kernel(const uint8_t* __restrict__ src,
                     const int64_t* __restrict__ desc,
                     uint8_t* __restrict__ dst,
                     uint8_t* __restrict__ status, long long n_frames) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  uint32_t* x2n = tab + 256;
  uint8_t* buf = reinterpret_cast<uint8_t*>(x2n + 32);
  __shared__ int st;
  build_tables(tab, x2n);
  for (long long f = blockIdx.x; f < n_frames; f += gridDim.x) {
    const int64_t* d = desc + 5 * f;
    const int64_t type = d[0], off = d[1], blen = d[2], out_off = d[3],
                  out_len = d[4];
    __syncthreads();  // the last frame is done with buf and st
    if (threadIdx.x == 0)
      st = (blen < 4 || out_len < 0 || out_len > kChunk ||
            (type != 0 && type != 1) || (type == 1 && blen - 4 != out_len))
               ? kStatusCorrupt
               : kStatusOk;
    __syncthreads();
    const uint8_t* body = src + off;
    if (st == kStatusOk) {
      if (type == 1) {
        for (int64_t i = threadIdx.x; i < out_len; i += blockDim.x)
          buf[i] = body[4 + i];
      } else if (threadIdx.x == 0) {
        const int got = decode_block(body + 4, blen - 4, buf, (int)out_len);
        if (got != out_len) st = kStatusCorrupt;
      }
    }
    __syncthreads();
    int result = st;  // nothing writes st again before the next frame
    if (result == kStatusOk) {
      uint8_t* o = dst + out_off;
      for (int64_t i = threadIdx.x; i < out_len; i += blockDim.x) o[i] = buf[i];
      if (threadIdx.x < 32) {
        const uint32_t crc = warp_masked_crc(buf, (int)out_len, tab, x2n);
        const uint32_t want = (uint32_t)body[0] | ((uint32_t)body[1] << 8) |
                              ((uint32_t)body[2] << 16) |
                              ((uint32_t)body[3] << 24);
        if (crc != want) result = kStatusCrc;
      }
    }
    if (threadIdx.x == 0) status[f] = (uint8_t)result;
  }
}

int grid_for(long long n, int blocks_per_sm) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long cap = (long long)sms * blocks_per_sm;
  return (int)(n < cap ? n : cap);
}

}  // namespace

extern "C" int s2_compress_launch(const void* src, const void* desc,
                                  void* dst, void* crcs, void* lens,
                                  long long n, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      s2_compress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemCompress);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  s2_compress_kernel<<<grid_for(n, 2), kThreads, kSmemCompress,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)src, (const int64_t*)desc, (uint8_t*)dst,
      (int64_t*)crcs, (int64_t*)lens, n);
  return (int)cudaGetLastError();
}

extern "C" int s2_decompress_launch(const void* src, const void* desc,
                                    void* dst, void* status, long long n,
                                    void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      s2_decompress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmemDecompress);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return 0;
  s2_decompress_kernel<<<grid_for(n, 3), kThreads, kSmemDecompress,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)src, (const int64_t*)desc, (uint8_t*)dst,
      (uint8_t*)status, n);
  return (int)cudaGetLastError();
}
