// HighwayHash-256 of equal-length chunks: kernel B of minio_tpu_torch.
//
// Replaces minio_tpu/ops/highwayhash_jax.py::hash256_batch_jax (a lax.scan
// over 32-byte packets with every u64 emulated as a pair of u32 lanes).
// The packet update, the remainder packet (length add, per-half rotate,
// mod-16 and mod-4 byte placement) and the finalisation (10
// permute-and-update rounds, two modular reductions, little-endian output)
// follow the reference's portable C code, which the JAX function also
// reproduces; the digest is MinIO's on-disk format, bit for bit.
//
// What bounds it on this card: by bytes it is 11.2 MB read at the 12+4
// main shape (B=8 blocks x 16 shards x 87,382 bytes), 3.3 us at 3.35 TB/s.
// But the packets of one chunk form a dependent chain (2,730 packets at
// that shape) and there are only 128 chunks per PUT batch, 8 per reader
// fetch: the kernel is bound by the latency of that chain, and the byte
// bound is out of reach. The design makes each packet cost its integer
// arithmetic and nothing else:
//
// - Chunks are staged through shared memory ahead of the chain. A block
//   owns kGroup chunks and runs two warps. The producer warp keeps up to
//   kStages - 1 tiles of kTile bytes of every chunk in flight with 16-byte
//   cp.async copies into a ring, and announces each tile as soon as it has
//   landed; the chain warp reads its packets from there. Chunks start at any byte offset, so each tile's 16-byte aligned
//   cover is copied and the chain applies the shift (0..15 bytes) when it
//   reads. A 16-byte segment that does not lie wholly inside the hashed
//   byte range is taken with plain byte loads, so nothing outside the
//   caller's rows is read. Named barriers hand each stage back and forth.
// - Each chunk's lanes are split over two threads: lanes {0,1} in one,
//   lanes {2,3} in its neighbour. The packet update and ZipperMergeAndAdd
//   mix only lanes 0<->1 and 2<->3, so the pair runs every full packet and
//   the remainder packet without exchanging anything; only the 10
//   finalisation rounds, whose permutation reads v0's lanes 2,3,0,1,
//   exchange v0 across the pair with a shuffle. Packets stay strictly in
//   order. This halves the instructions on each chain.
// - The zipper is six byte permutes, each product one 32 x 32 -> 64
//   multiply, and packets are read two ahead of the one being mixed: the
//   chain is ~60 instructions a packet, and its dependent latency is what
//   remains.
//
// Rows are `length` bytes at base + i * pitch (pitch >= length), so the
// frames of a bitrot stream ([digest || chunk]*) hash in place at pitch
// 32 + length. The verify entry compares each digest with the one stored
// at want + i * want_pitch on the device and leaves the index of the first
// mismatching row in one int64. Its grouped form checks G groups of rows
// at a group pitch, one grid row and one first-bad int64 a group, so a
// reader fetch verifies every shard reader's frames in one launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 16;              // chunks per block
constexpr int kTile = 512;              // bytes of each chunk per stage
constexpr int kStages = 5;              // ring depth
constexpr int kRow = kTile + 32;        // smem row: 16-byte cover + 5th word
constexpr int kThreads = 64;            // warp 0: chains, warp 1: producer
constexpr int kSmemBytes = kStages * kGroup * kRow;  // 43,520 B

__device__ __forceinline__ uint64_t rot32(uint64_t x) {
  return (x >> 32) | (x << 32);
}

// The reference's ZipperMergeAndAdd ORs disjoint byte fields of its even
// lane e (v0 here) and odd lane o (v1), which is a byte shuffle:
//   add0 += bytes [e3 o4 e2 e5 | o6 e1 o7 e0]
//   add1 += bytes [o3 e4 o2 o5 | o1 e6 o0 e7]
// Here as six byte permutes of the 32-bit halves.
__device__ __forceinline__ void zipper_merge_and_add(uint64_t v1, uint64_t v0,
                                                     uint64_t* add1,
                                                     uint64_t* add0) {
  const uint32_t eL = (uint32_t)v0, eH = (uint32_t)(v0 >> 32);
  const uint32_t oL = (uint32_t)v1, oH = (uint32_t)(v1 >> 32);
  const uint32_t a0 = __byte_perm(__byte_perm(eL, eH, 0x5203), oH, 0x3240);
  const uint32_t b0 = __byte_perm(eL, oH, 0x0716);
  const uint32_t a1 = __byte_perm(__byte_perm(oL, oH, 0x5203), eH, 0x3240);
  const uint32_t b1 = __byte_perm(oL, eH, 0x7061);
  *add0 += ((uint64_t)b0 << 32) | a0;
  *add1 += ((uint64_t)b1 << 32) | a1;
}

// One thread's half of the state: lanes {2h, 2h+1} of v0, v1, mul0, mul1.
struct Half {
  uint64_t v0[2], v1[2], mul0[2], mul1[2];
};

// (x & 0xffffffff) * (y >> 32) as one 32 x 32 -> 64 multiply.
__device__ __forceinline__ uint64_t mul_lo_hi(uint64_t x, uint64_t y) {
  return (uint64_t)(uint32_t)x * (uint32_t)(y >> 32);
}

__device__ __forceinline__ void update(Half& s, uint64_t a, uint64_t b) {
  const uint64_t lanes[2] = {a, b};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    s.v1[i] += s.mul0[i] + lanes[i];
    s.mul0[i] ^= mul_lo_hi(s.v1[i], s.v0[i]);
    s.v0[i] += s.mul1[i];
    s.mul1[i] ^= mul_lo_hi(s.v0[i], s.v1[i]);
  }
  zipper_merge_and_add(s.v1[1], s.v1[0], &s.v0[1], &s.v0[0]);
  zipper_merge_and_add(s.v0[1], s.v0[0], &s.v1[1], &s.v1[0]);
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int c) {
  return (x << c) | (x >> (32 - c));
}

__device__ __forceinline__ uint64_t le64(const uint8_t* p) {
  uint64_t x = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) x |= (uint64_t)p[i] << (8 * i);
  return x;
}

// The reference's UpdateRemainder, 0 < mod32 < 32, on this thread's lanes:
// the packet's bytes 16h .. 16h + 15.
__device__ void update_remainder(Half& s, const uint8_t* tail, int mod32,
                                 int h) {
  const int mod4 = mod32 & 3;
  const int full4 = mod32 & ~3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    s.v0[i] += ((uint64_t)mod32 << 32) + (uint64_t)mod32;
    const uint32_t lo = (uint32_t)s.v1[i];
    const uint32_t hi = (uint32_t)(s.v1[i] >> 32);
    s.v1[i] = ((uint64_t)rotl32(hi, mod32) << 32) | rotl32(lo, mod32);
  }
  uint8_t packet[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) packet[i] = 0;
  for (int i = 0; i < full4; ++i) packet[i] = tail[i];
  if (mod32 & 16) {
    for (int i = 0; i < 4; ++i) packet[28 + i] = tail[mod32 - 4 + i];
  } else if (mod4) {
    const uint8_t* rem = tail + full4;
    packet[16] = rem[0];
    packet[17] = rem[mod4 >> 1];
    packet[18] = rem[mod4 - 1];
  }
  update(s, le64(packet + 16 * h), le64(packet + 16 * h + 8));
}

__device__ __forceinline__ void modular_reduction(uint64_t a3_unmasked,
                                                  uint64_t a2, uint64_t a1,
                                                  uint64_t a0, uint64_t* m1,
                                                  uint64_t* m0) {
  const uint64_t a3 = a3_unmasked & 0x3FFFFFFFFFFFFFFFull;
  *m1 = a1 ^ ((a3 << 1) | (a2 >> 63)) ^ ((a3 << 2) | (a2 >> 62));
  *m0 = a0 ^ (a2 << 1) ^ (a2 << 2);
}

// --- the ring's plumbing --------------------------------------------------

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}

// Named barrier 0 is __syncthreads'; stage s is full at 1 + s and free
// again at 1 + kStages + s.
__device__ __forceinline__ int full_bar(int s) { return 1 + s; }
__device__ __forceinline__ int empty_bar(int s) { return 1 + kStages + s; }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Producer: copy tile `t` of each of the block's `count` chunks into stage
// `s`. Row g of the stage receives the 16-byte aligned cover of bytes
// [t * kTile, t * kTile + tile_bytes) of chunk g; lanes 2g and 2g + 1 copy
// its even and odd segments. Segments wholly inside [lo, hi), the bytes of
// the caller's rows, go by cp.async; any other segment byte by byte, with
// zeros for bytes outside.
__device__ __forceinline__ void produce(uint8_t* ring, int s, int t,
                                        long long full, const uint8_t* first,
                                        long long pitch, int count,
                                        const uint8_t* lo, const uint8_t* hi,
                                        int lane) {
  const int g = lane >> 1;
  if (g >= count) return;
  const long long tile_off = (long long)t * kTile;
  const long long left = full - tile_off;
  const int tile_bytes = left < kTile ? (int)left : kTile;
  const uint8_t* start = first + g * pitch + tile_off;
  const int shift = (int)((uintptr_t)start & 15);
  const int n_segs = (shift + tile_bytes + 15) >> 4;
  const uint8_t* src = start - shift;
  uint8_t* dst = ring + (s * kGroup + g) * kRow;
  if (src >= lo && src + 16 * n_segs <= hi) {
    for (int k = lane & 1; k < n_segs; k += 2)
      cp_async16(dst + 16 * k, src + 16 * k);
    return;
  }
  for (int k = lane & 1; k < n_segs; k += 2) {
    const uint8_t* from = src + 16 * k;
    if (from >= lo && from + 16 <= hi) {
      cp_async16(dst + 16 * k, from);
    } else {
      for (int i = 0; i < 16; ++i)
        dst[16 * k + i] = (from + i >= lo && from + i < hi) ? from[i] : 0;
    }
  }
}

// 16 packet bytes at byte `off` of a shared-memory row (16-byte aligned),
// as two little-endian u64: five aligned words and a funnel shift.
__device__ __forceinline__ void read16(const uint8_t* row, int off,
                                       uint32_t w[5]) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(row) + (off >> 2);
#pragma unroll
  for (int i = 0; i < 5; ++i) w[i] = p[i];
}

__device__ __forceinline__ void lanes_of(const uint32_t w[5], int sub,
                                         uint64_t* a, uint64_t* b) {
  const uint32_t x0 = __funnelshift_r(w[0], w[1], sub);
  const uint32_t x1 = __funnelshift_r(w[1], w[2], sub);
  const uint32_t x2 = __funnelshift_r(w[2], w[3], sub);
  const uint32_t x3 = __funnelshift_r(w[3], w[4], sub);
  *a = ((uint64_t)x1 << 32) | x0;
  *b = ((uint64_t)x3 << 32) | x2;
}

template <bool kVerify, bool kGrouped>
__global__ void __launch_bounds__(kThreads)
    hh256_kernel(const uint8_t* __restrict__ data, long long pitch,
                 long long n_chunks, long long length,
                 uint8_t* __restrict__ out, const uint8_t* __restrict__ want,
                 long long want_pitch, long long* __restrict__ first_bad,
                 long long group_pitch, long long want_group_pitch,
                 uint64_t k0, uint64_t k1, uint64_t k2, uint64_t k3) {
  extern __shared__ __align__(16) uint8_t ring[];
  // Grid row y is group y of a grouped verify: its rows, digests and
  // first-bad word lie group_pitch / want_group_pitch bytes and one word
  // further on. A compile-time flag, so the hash and one-group verify
  // entries carry no group arithmetic at all.
  if (kGrouped) {
    const long long grp = blockIdx.y;
    data += grp * group_pitch;
    want += grp * want_group_pitch;
    first_bad += grp;
  }
  const long long c0 = (long long)blockIdx.x * kGroup;
  const int count = (int)min((long long)kGroup, n_chunks - c0);
  const uint8_t* first = data + c0 * pitch;
  const long long n_packets = length / 32;
  const long long full = 32 * n_packets;  // bytes of full packets per chunk
  const int n_tiles = (int)((full + kTile - 1) / kTile);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (warp == 1) {
    // Producer. Tiles 0 .. kStages - 2 go out first. Then, for each tile
    // t: wait until it has landed and announce it, and only then refill
    // the stage that tile t - 1 held with tile t + kStages - 1 (once the
    // chain warp has released it). The announcement never waits on a
    // refill, so the chains find every tile ready while kStages - 2
    // tiles of every chunk stay in flight. One commit group per tile,
    // empty past the end, keeps the group count uniform.
    const uint8_t* lo = data;
    const uint8_t* hi = data + (n_chunks - 1) * pitch + length;
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < n_tiles) produce(ring, t, t, full, first, pitch, count, lo, hi,
                               lane);
      cp_async_commit();
    }
    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait<kStages - 2>();
      bar_arrive(full_bar(t % kStages));
      const int tn = t + kStages - 1;
      if (tn < n_tiles) {
        const int s = tn % kStages;
        if (tn >= kStages) bar_sync(empty_bar(s));
        produce(ring, s, tn, full, first, pitch, count, lo, hi, lane);
      }
      cp_async_commit();
    }
    return;
  }

  // Chain warp: thread 2g + h runs lanes {2h, 2h+1} of chunk g. Threads
  // past the block's chunks run along on whatever the ring holds (every
  // thread must reach the barriers and shuffles) and store nothing.
  const int g = lane >> 1;
  const int h = lane & 1;
  const bool live = g < count;
  const uint8_t* chunk = first + (live ? g : 0) * pitch;
  const int shift = (int)((uintptr_t)chunk & 15);
  const int sub = 8 * (shift & 3);

  const uint64_t key[2] = {h ? k2 : k0, h ? k3 : k1};
  const uint64_t init0[2] = {h ? 0x13198a2e03707344ull : 0xdbe6d5d5fe4cce2full,
                             h ? 0x243f6a8885a308d3ull : 0xa4093822299f31d0ull};
  const uint64_t init1[2] = {h ? 0xbe5466cf34e90c6cull : 0x3bd39e10cb0ef593ull,
                             h ? 0x452821e638d01377ull : 0xc0acf169b5f18a8cull};
  Half st;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    st.mul0[i] = init0[i];
    st.mul1[i] = init1[i];
    st.v0[i] = init0[i] ^ key[i];
    st.v1[i] = init1[i] ^ rot32(key[i]);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    bar_sync(full_bar(s));
    const uint8_t* row = ring + (s * kGroup + g) * kRow;
    const long long left = n_packets - (long long)t * (kTile / 32);
    const int npk = left < kTile / 32 ? (int)left : kTile / 32;
    // Packets are read two ahead of the one being mixed, so a read has a
    // whole packet's arithmetic to land in wherever it is scheduled; two
    // buffers taken in turn need no register moves.
    const int base = shift + 16 * h;
    uint32_t w0[5], w1[5];
    uint64_t a, b;
    read16(row, base, w0);
    if (npk > 1) read16(row, base + 32, w1);
    int p = 0;
    for (; p + 2 <= npk; p += 2) {
      lanes_of(w0, sub, &a, &b);
      if (p + 2 < npk) read16(row, base + 32 * (p + 2), w0);
      update(st, a, b);
      lanes_of(w1, sub, &a, &b);
      if (p + 3 < npk) read16(row, base + 32 * (p + 3), w1);
      update(st, a, b);
    }
    if (p < npk) {
      lanes_of(w0, sub, &a, &b);
      update(st, a, b);
    }
    if (t + kStages < n_tiles) bar_arrive(empty_bar(s));
  }

  const int mod32 = (int)(length & 31);
  if (mod32) update_remainder(st, chunk + full, mod32, h);

  for (int r = 0; r < 10; ++r) {
    // permute_and_update: lanes 0,1 take rot32 of v0[2], v0[3] and lanes
    // 2,3 of v0[0], v0[1], which the partner thread holds.
    const uint64_t p0 = rot32(__shfl_xor_sync(0xffffffffu, st.v0[0], 1));
    const uint64_t p1 = rot32(__shfl_xor_sync(0xffffffffu, st.v0[1], 1));
    update(st, p0, p1);
  }
  uint64_t d[2];
  modular_reduction(st.v1[1] + st.mul1[1], st.v1[0] + st.mul1[0],
                    st.v0[1] + st.mul0[1], st.v0[0] + st.mul0[0], &d[1],
                    &d[0]);
  const long long c = c0 + g;
  if (!kVerify) {
    if (live) {
      uint64_t* dst = reinterpret_cast<uint64_t*>(out + c * 32 + 16 * h);
      dst[0] = d[0];
      dst[1] = d[1];
    }
    return;
  }
  bool differs = false;
  if (live) {
    const uint8_t* w = want + c * want_pitch + 16 * h;
    differs = le64(w) != d[0] || le64(w + 8) != d[1];
  }
  differs |= __shfl_xor_sync(0xffffffffu, differs ? 1 : 0, 1) != 0;
  if (live && h == 0 && differs) atomicMin(first_bad, c);
}

template <bool kVerify, bool kGrouped>
int launch(const void* data, long long pitch, long long n_chunks,
           long long length, void* out, const void* want, long long want_pitch,
           void* first_bad, long long n_groups, long long group_pitch,
           long long want_group_pitch, uint64_t k0, uint64_t k1, uint64_t k2,
           uint64_t k3, void* stream) {
  if (n_chunks <= 0 || n_groups <= 0) return 0;
  if (n_groups > 65535) return (int)cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)((n_chunks + kGroup - 1) / kGroup),
                  (unsigned)n_groups);
  hh256_kernel<kVerify, kGrouped><<<grid, kThreads, kSmemBytes,
                                    (cudaStream_t)stream>>>(
      (const uint8_t*)data, pitch, n_chunks, length, (uint8_t*)out,
      (const uint8_t*)want, want_pitch, (long long*)first_bad, group_pitch,
      want_group_pitch, k0, k1, k2, k3);
  return (int)cudaGetLastError();
}

}  // namespace

// n_chunks rows of `length` bytes at data + i * pitch (pitch >= length) on
// the device; out uint8 [n_chunks, 32] contiguous; (k0..k3) the key as
// little-endian u64 lanes. Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int hh256_launch(const void* data, long long pitch,
                            long long n_chunks, long long length, void* out,
                            uint64_t k0, uint64_t k1, uint64_t k2,
                            uint64_t k3, void* stream) {
  return launch<false, false>(data, pitch, n_chunks, length, out, nullptr,
                              0, nullptr, 1, 0, 0, k0, k1, k2, k3, stream);
}

// As hh256_launch, but compares digest i with the 32 bytes at
// want + i * want_pitch and lowers the int64 at first_bad (set by the
// caller to n_chunks) to the index of the first row that differs.
extern "C" int hh256_verify_launch(const void* data, long long pitch,
                                   long long n_chunks, long long length,
                                   const void* want, long long want_pitch,
                                   void* first_bad, uint64_t k0, uint64_t k1,
                                   uint64_t k2, uint64_t k3, void* stream) {
  return launch<true, false>(data, pitch, n_chunks, length, nullptr, want,
                             want_pitch, first_bad, 1, 0, 0, k0, k1, k2, k3,
                             stream);
}

// The grouped verify: n_groups groups of n_chunks rows each, group g's
// rows at data + g * group_pitch + i * pitch and its digests at
// want + g * want_group_pitch + i * want_pitch. Lowers first_bad[g] (each
// set by the caller to n_chunks) to the index of group g's first row that
// differs: every reader of a fetch checked in one launch. At most 65,535
// groups (the grid's y extent).
extern "C" int hh256_verify_grouped_launch(
    const void* data, long long pitch, long long n_chunks, long long length,
    const void* want, long long want_pitch, long long n_groups,
    long long group_pitch, long long want_group_pitch, void* first_bad,
    uint64_t k0, uint64_t k1, uint64_t k2, uint64_t k3, void* stream) {
  return launch<true, true>(data, pitch, n_chunks, length, nullptr, want,
                            want_pitch, first_bad, n_groups, group_pitch,
                            want_group_pitch, k0, k1, k2, k3, stream);
}
