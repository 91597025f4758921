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
// in their order against out_len (at most 64 KiB), copies the raw bytes to
// dst + out_off and checks their masked CRC32C: status[f] is 0, 1 (CRC
// mismatch) or 2 (a malformed block, or raw bytes of another length). A
// frame writes its own slot and nothing else, and nothing at all when its
// block does not decode.
//
// What bounds them on this card: neither is bound by bytes or operations
// but by the length of a chunk's dependent chain. snappy.c's decisions are
// serial (a position's table read sees every earlier position's write,
// and a tag's position follows from the tag before it), and on one warp
// each dependent step (a shared load, a ballot, a shuffle, a bit scan)
// costs tens of cycles. So a chunk is a block's, and the design
// keeps few dependent steps on the chain and spreads the rest over the
// lanes and warps:
//
// - E's parse, warp 0 (parse_chunk): a 32-position window. At window
//   start pos, lane l takes position p = pos + l (lanes past limit =
//   len - 4 sit out): its word, its hash, its table entry. Its candidate
//   is the position of the highest lane below it with the same hash (its
//   peers), else the entry as it stood before the window: exactly what
//   the serial loop would read at p had no earlier lane matched, so the
//   lane hits where the serial loop would. With f the first lane that
//   hits (a ballot), the table must end as the serial loop leaves it: in
//   each peer group, the position of the highest seed lane (f + 1 .. f +
//   3, inside the match), else of the highest lane up to f, else the
//   entry as it stood. Peers are rare, so every active lane writes its
//   own position at once and reads the entry back; only where a lane
//   reads another's are the peers found (14 ballots, peers_of: MATCH.ANY
//   is slower) and the writes redone group by group; otherwise lanes past
//   f write back their entry or their seed. No hit moves the window 32
//   positions. A hit extends the match to snappy.c's length exactly,
//   min(first mismatch, len - p, 0xffff): bytes 4-11 are compared in the
//   window itself, then 32 words (128 B) a step with the first mismatch
//   found by ballot. That length fixes the seeds' bounds (s + 4 <= p +
//   len, s <= limit, s < p + 4); seeds past the window follow in order.
//   ops/s2.py's window_parse models the window, and tests/test_torch_s2.py
//   holds it to the serial loop (its matches, the table at every match)
//   and to snappy.c's bytes.
// - E's output, warp 1 (emit_chunk): warp 0 queues each match (position,
//   length, offset) in a ring in shared memory, one 64-bit store that
//   carries the record's number too, so warp 1 sees it land without a
//   fence; warp 1 writes the varint, each match's pending literal 32
//   bytes a store with its tag, and the copy tags (the 68, 64 and 60
//   split), a tag a lane. The parse's chain holds no global store.
// - E's CRC, warps 2 and 3 (64 segments), while warps 0 and 1 work. The
//   chunk staged in shared memory and the 16,384-entry table take 100 KB
//   a block: two blocks an SM.
// - F (decode_block): the block stages the frame's body in shared memory
//   with aligned 16-byte loads (48,640 B of it: the rest of a longer body
//   is read from global memory; bodies longer than kMaxBlock are
//   malformed). A tag's position
//   follows from the tag before it, so warp 0 parses a 32-byte window at
//   once: lane l reads a tag as if one started at i + l (parse_tag: its
//   kind, length, offset, header length and the checks that do not
//   depend on the output so far). The warp then walks the window's tags
//   lane to lane by shuffles, each tag's header and length giving the
//   next tag's lane; it checks the length against the header's and the
//   offset against the output, and copies the tag 32 bytes a step: a
//   copy of len bytes at offset off takes out[o + k] = out[o - off + (k
//   mod off)], every source byte before o, so the lanes are independent
//   even where off < len. ops/s2.py's warp_decode_block models the walk.
//   Every check of snappy.c stays (a truncated varint or tag, want > cap,
//   a literal past the body or past want, off == 0, off > o, o + len >
//   want, o == want at the end): status 2 falls where the plain version
//   sets it. The block decodes into shared memory and copies out only a
//   frame that decoded, into its own slot.
// - F's CRC and copy out run on all four warps (128 segments). The
//   output and up to 48,640 B of the body take 113 KB: two blocks an SM.
// - The CRC is split over lanes: lane g takes the CRC register of the
//   g-th segment (lane 0 from 0xffffffff, the others from 0) with a
//   256-entry table in shared memory, multiplies it by x^(8 * bytes after
//   the segment) mod P (zlib's multmodp, from a table of x^(2^k) mod P),
//   and the lanes' products XOR to the register of the whole. ops/s2.py's
//   segmented_crc32c models this at 64 and 128 lanes and
//   tests/test_torch_s2.py holds the model to the byte-at-a-time CRC.
// - Persistent blocks walk the chunks, so the tables are built once a
//   block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 65536;
constexpr int kHashBits = 14;
constexpr int kHashSize = 1 << kHashBits;
constexpr int kMinMatch = 4;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kPoly = 0x82f63b78u;  // CRC-32C, reflected
constexpr uint32_t kMaskDelta = 0xa282ead8u;

// E's queue of matches from the parsing warp to the emitting one.
constexpr int kRing = 64;

constexpr int kStatusOk = 0;
constexpr int kStatusCrc = 1;
constexpr int kStatusCorrupt = 2;

// A staged span: the aligned 16-byte vectors from the one that holds the
// first byte, at most kStage bytes of them (a chunk, or a raw frame),
// then 48 bytes that the word loads past the span's end may touch (F's
// lanes read a tag's words at up to 31 bytes past the last tag). F stages
// at most kBodyStage bytes of a snappy block, so that two blocks fit an
// SM (a 64 KiB chunk of prose compresses to ~42 KB); the rest of a longer
// body is read from global memory.
constexpr int kStage = kChunk + 16;
constexpr int kStageBytes = kStage + 48;
constexpr int kBodyStage = 48640;

// Shared memory: the CRC table (256 words), x^(2^k) mod P (32 words), the
// warps' CRC registers (4 words), then E's queue, hash table and staged
// chunk, or F's output chunk and staged body.
constexpr size_t kTablesBytes = (256 + 32 + 4) * 4;
constexpr size_t kQueueBytes = 16 + kRing * 8;  // tail; records
constexpr size_t kSmemCompress =
    kTablesBytes + kQueueBytes + kHashSize * 2 + kStageBytes;
constexpr size_t kSmemDecompress =
    kTablesBytes + kStageBytes + kBodyStage + 48;

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

// The CRC register of segment g of G of s[0, n), carried to the end of
// s: the XOR over the G segments is the register of the whole.
__device__ uint32_t crc_part(const uint8_t* s, int n, int g, int G,
                             const uint32_t* tab, const uint32_t* x2n) {
  const int seg = (n + G - 1) / G;
  const int lo = min(n, g * seg), hi = min(n, (g + 1) * seg);
  uint32_t c = g == 0 ? 0xffffffffu : 0u;
  for (int i = lo; i < hi; ++i) c = tab[(c ^ s[i]) & 0xff] ^ (c >> 8);
  uint32_t shift = 1u << 31;  // x^0
  int k = 3;
  for (int r = n - hi; r; r >>= 1, ++k)
    if (r & 1) shift = multmodp(x2n[k & 31], shift);
  return multmodp(shift, c);
}

__device__ __forceinline__ uint32_t warp_xor(uint32_t v) {
  for (int off = 16; off; off >>= 1) v ^= __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ uint32_t masked(uint32_t reg) {
  const uint32_t crc = reg ^ 0xffffffffu;
  return ((crc >> 15) | (crc << 17)) + kMaskDelta;
}

// Stages g[0, n) in s (16-byte aligned): the aligned vectors from the one
// that holds g[0], at most cap bytes of them (a multiple of 16). Byte k of
// g lies at s[shift + k]; returns shift and sets *staged to the bytes of s
// that hold the span. No byte outside g[0, n) is read.
__device__ int stage(uint8_t* s, const uint8_t* g, int64_t n, int cap,
                     int* staged) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(g);
  const int shift = (int)(a & 15);
  const int64_t span = shift + n;
  const int st = span < cap ? (int)span : cap;
  const int nv = n > 0 ? (st + 15) >> 4 : 0;
  const uint4* v = reinterpret_cast<const uint4*>(a - shift);
  uint4* d = reinterpret_cast<uint4*>(s);
#pragma unroll 4
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    if (16 * i >= shift && 16 * i + 16 <= span) {
      d[i] = __ldg(v + i);
    } else {
      // The first or the last vector: only g's own bytes are read, the
      // rest of the vector is zero.
      for (int k = 0; k < 16; ++k) {
        const int64_t q = 16 * i + k - shift;
        s[16 * i + k] = q >= 0 && q < n ? __ldg(g + q) : 0;
      }
    }
  }
  *staged = n > 0 ? st : 0;
  return shift;
}

// Bytes p .. p + 7 of a 4-aligned shared buffer, as two little-endian
// words; p + 11 must lie inside the buffer.
__device__ __forceinline__ void ld64(const uint8_t* b, int p, uint32_t& lo,
                                     uint32_t& hi) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(b) + (p >> 2);
  const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
  const int s = (p & 3) * 8;
  lo = __funnelshift_r(w0, w1, s);
  hi = __funnelshift_r(w1, w2, s);
}

// Bytes p .. p + 11 of a 4-aligned shared buffer, as three words; p + 15
// must lie inside the buffer.
__device__ __forceinline__ void ld96(const uint8_t* b, int p, uint32_t& x,
                                     uint32_t& y, uint32_t& z) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(b) + (p >> 2);
  const uint32_t w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3];
  const int s = (p & 3) * 8;
  x = __funnelshift_r(w0, w1, s);
  y = __funnelshift_r(w1, w2, s);
  z = __funnelshift_r(w2, w3, s);
}

__device__ __forceinline__ uint32_t ld32(const uint8_t* b, int p) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(b) + (p >> 2);
  return __funnelshift_r(w[0], w[1], (p & 3) * 8);
}

__device__ __forceinline__ uint32_t hash32(uint32_t v) {
  return (v * 0x1e35a7bdu) >> (32 - kHashBits);
}

// The literal b[from, from + len) at d + o by the warp: the tag from lane
// 0, the bytes 32 a store. Returns the new o.
__device__ int warp_literal(uint8_t* __restrict__ d, int o, const uint8_t* b,
                            int from, int len) {
  const int lane = threadIdx.x & 31;
  while (len > 0) {
    const int run = min(len, 1 << 16);
    const int l = run - 1;
    const int hdr = l < 60 ? 1 : (l < 256 ? 2 : 3);
    if (lane == 0) {
      d[o] = (uint8_t)(hdr == 1 ? l << 2 : (hdr == 2 ? 60 << 2 : 61 << 2));
      if (hdr > 1) d[o + 1] = (uint8_t)(l & 0xff);
      if (hdr > 2) d[o + 2] = (uint8_t)(l >> 8);
    }
    o += hdr;
    for (int k = lane; k < run; k += kWarp) d[o + k] = b[from + k];
    o += run;
    from += run;
    len -= run;
  }
  return o;
}

// The copy tags of a match (2-byte offsets), a tag a lane: q tags of 64,
// then r = len - 64 q (4 to 67) as one tag, or as 60 and r - 60 where r
// is over 64: snappy.c's split.
__device__ int warp_copy(uint8_t* __restrict__ d, int o, int offset,
                         int len) {
  const int lane = threadIdx.x & 31;
  const int q = len >= 68 ? ((len - 68) >> 6) + 1 : 0;
  const int r = len - 64 * q;
  const int tags = q + (r > 64 ? 2 : 1);
  for (int t = lane; t < tags; t += kWarp) {
    const int n = t < q ? 64 : (r > 64 ? (t == q ? 60 : r - 60) : r);
    uint8_t* e = d + o + 3 * t;
    e[0] = (uint8_t)(((n - 1) << 2) | 2);
    e[1] = (uint8_t)(offset & 0xff);
    e[2] = (uint8_t)(offset >> 8);
  }
  return o + 3 * tags;
}

// The lanes whose 14-bit hash equals this lane's, by 14 ballots: what
// __match_any_sync gives. Only windows where two lanes share a hash need
// it (parse_chunk finds them by a write and a read back).
__device__ __forceinline__ unsigned peers_of(uint32_t h) {
  unsigned m = kFull;
#pragma unroll
  for (int bit = 0; bit < kHashBits; ++bit) {
    const bool set = (h >> bit) & 1;
    const unsigned v = __ballot_sync(kFull, set);
    m &= set ? v : ~v;
  }
  return m;
}

// Bytes p .. p + 11 of the chunk for p = min(pos + lane, limit), as three
// words: lanes past the limit load the last position's, never used.
__device__ __forceinline__ void window_words(const uint8_t* b, int sh,
                                             int pos, int limit, int lane,
                                             uint32_t& w, uint32_t& w2,
                                             uint32_t& w3) {
  ld96(b, sh + min(pos + lane, limit), w, w2, w3);
}

__device__ __forceinline__ int highest(unsigned x) {  // x != 0
  return 31 - __clz(x);
}

__device__ __forceinline__ int lowest(unsigned x) {  // 32 where x = 0
  return x ? 31 - __clz(x & (0u - x)) : 32;
}

// A match found by the parse, queued for the emitting warp as one 64-bit
// word: the position and the length (16 bits each), the offset, and the
// record's number plus one, by which the emitter knows the record has
// landed (one store carries both: no fence). kEndOfChunk ends the queue;
// the ring is cleared for each chunk.
constexpr uint32_t kEndOfChunk = 0xffffu;

// The queue's ordering: a record is one aligned 64-bit store, so the
// emitter reads it whole or not at all, and the number it carries says
// which; the emitter's lanes have read a slot before its lane 0 frees it
// (a __syncwarp, then a fence before the tail's store), and the parse
// writes a slot only after reading a tail past it. No step assumes that
// the lanes run in lockstep.
struct MatchQueue {
  volatile unsigned long long* ring;  // kRing records
  volatile int* tail;  // records emitted, every 16th (the emitter's lane 0)
};

// Lane 0 writes record n; `room` (the same in every lane) caches how far
// the emitter's tail lets the ring go before a slot still unread.
__device__ __forceinline__ void enqueue(const MatchQueue& q, int& n,
                                        int& room, uint32_t x, uint32_t y,
                                        int lane) {
  while (__builtin_expect(n >= room, 0)) room = *q.tail + kRing;
  if (lane == 0)
    q.ring[n & (kRing - 1)] =
        ((unsigned long long)(y | (uint32_t)(n + 1) << 16) << 32) | x;
  ++n;
}

// mtpu_snappy_compress's parse of one chunk (8 <= len <= kChunk) by warp 0
// (every lane calls it): the chunk's byte p is b[sh + p], b 16-byte
// aligned. Each match goes to the queue for warp 1, which writes the
// block (emit_chunk); the parse's own chain holds only the table and the
// matches.
//
// Each dependent step (a shared load, a ballot, a shuffle, a bit scan)
// costs tens of cycles, so a window is built to take few of them: every
// active lane reads its table entry and writes its own position at once,
// and reads the entry back; a lane that reads another lane's position
// shares its hash, and only then are the peers found (peers_of) and the
// window's writes redone group by group. With f the first lane that hits,
// the table ends as the serial loop leaves it: in each peer group, the
// highest seed lane's position, else the highest lane up to f, else the
// entry as it stood (lanes past f write it back).
__device__ void parse_chunk(const uint8_t* b, int sh, int len, int lane,
                            uint16_t* htab, const MatchQueue& q) {
  const unsigned lanes_below = (1u << lane) - 1u;
  const int limit = len - kMinMatch;
  int pos = 0, queued = 0, room = kRing;
  uint32_t w, w2, w3;  // bytes pos + lane .. + 11
  window_words(b, sh, pos, limit, lane, w, w2, w3);
  while (pos <= limit) {
    // The window: lane l at position p = pos + l. Loads are unconditional
    // (lanes past the limit read valid positions), writes predicated, and
    // both ballots go out before either is looked at. A chunk is at most
    // 64 KiB, so p - cand <= 0xffff always holds.
    const int p = pos + lane;
    const bool act = p <= limit;
    const uint32_t h = hash32(w);
    const int tcand = htab[h];
    __syncwarp();  // every lane's read lands before any lane's write
    if (act) htab[h] = (uint16_t)p;
    uint32_t c0, c1, c2;
    ld96(b, sh + tcand, c0, c1, c2);
    uint32_t nw, nw2, nw3;  // the next window's words, if this one misses
    window_words(b, sh, pos + kWarp, limit, lane, nw, nw2, nw3);
    __syncwarp();
    const unsigned shared =
        __ballot_sync(kFull, act && htab[h] != (uint16_t)p);
    unsigned hits = __ballot_sync(kFull, act && tcand < p && c0 == w);
    unsigned peers = 1u << lane;
    int cand = tcand;
    if (shared) {
      // Two lanes share a hash: a lane's candidate is its highest peer
      // below it, whose words are that lane's window words.
      const int n_act = min(kWarp, limit - pos + 1);
      const unsigned active = n_act == kWarp ? kFull : (1u << n_act) - 1u;
      peers = peers_of(h) & active;
      const unsigned below = peers & lanes_below;
      const int src = below ? highest(below) : lane;
      const uint32_t p0 = __shfl_sync(kFull, w, src);
      const uint32_t p1 = __shfl_sync(kFull, w2, src);
      const uint32_t p2 = __shfl_sync(kFull, w3, src);
      if (below) {
        cand = pos + src;
        c0 = p0;
        c1 = p1;
        c2 = p2;
      }
      hits = __ballot_sync(kFull, act && cand < p && c0 == w);
    }
    if (!hits) {
      if (shared && act && (peers >> lane) == 1u) htab[h] = (uint16_t)p;
      __syncwarp();
      pos += kWarp;
      w = nw;
      w2 = nw2;
      w3 = nw3;
      continue;
    }
    // The match length that bytes 4-11 give (12: extend further).
    const uint32_t x2 = c1 ^ w2;
    const int m12 = x2 ? kMinMatch + (lowest(x2) >> 3)
                       : 8 + (lowest(c2 ^ w3) >> 3);
    const int f = lowest(hits);
    const uint32_t pk =
        __shfl_sync(kFull, (uint32_t)cand | ((uint32_t)m12 << 17), f);
    const int cf = (int)(pk & 0x1ffff);
    const int pf = pos + f;
    const int cap = min(len - pf, 0xffff);
    int m = (int)(pk >> 17);
    if (m == 12) {
      // 32 words a step; the first lane at a mismatch or the cap stops it.
      while (m < cap) {
        const int k = m + 4 * lane;
        const bool in = k < cap;
        const uint32_t x =
            in ? ld32(b, sh + cf + k) ^ ld32(b, sh + pf + k) : 0;
        const unsigned stop = __ballot_sync(kFull, !in || x != 0);
        if (stop) {
          const int j = lowest(stop);
          const uint32_t xj = __shfl_sync(kFull, x, j);
          m = m + 4 * j + (lowest(xj) >> 3);  // 4 more where xj = 0
          break;
        }
        m += 4 * kWarp;
      }
    }
    const int mlen = min(m, cap);
    const int next = pf + mlen;
    window_words(b, sh, next, limit, lane, nw, nw2, nw3);
    enqueue(q, queued, room, (uint32_t)pf | ((uint32_t)mlen << 16),
            (uint32_t)(pf - cf), lane);
    // The table: seeds are lanes f + 1 .. f + 3 with s + 4 <= next (and
    // s <= limit: active); lanes past f other than seeds write back.
    const bool seed = act && lane > f && lane <= f + 3 &&
                      p + kMinMatch <= next;
    if (!shared) {
      if (act && lane > f) htab[h] = (uint16_t)(seed ? p : tcand);
    } else {
      const unsigned seeds = __ballot_sync(kFull, seed) & peers;
      const unsigned upto = peers & ((2u << f) - 1u);
      const int val = seeds ? pos + highest(seeds)
                            : (upto ? pos + highest(upto) : tcand);
      if (act && (peers >> lane) == 1u) htab[h] = (uint16_t)val;
    }
    if (__builtin_expect(f > 28, 0)) {
      // Seeds past the window, after the window's writes, in order.
      uint32_t hs = 0;
      const int s = pf + lane;
      if (lane >= 1 && lane <= 3 && f + lane > 31 && s <= limit &&
          s + kMinMatch <= next)
        hs = hash32(ld32(b, sh + s)) | 0x80000000u;
      __syncwarp();
      const uint32_t h1 = __shfl_sync(kFull, hs, 1);
      const uint32_t h2 = __shfl_sync(kFull, hs, 2);
      const uint32_t h3 = __shfl_sync(kFull, hs, 3);
      if (lane == 0) {
        if (h1) htab[h1 & 0xffff] = (uint16_t)(pf + 1);
        if (h2) htab[h2 & 0xffff] = (uint16_t)(pf + 2);
        if (h3) htab[h3 & 0xffff] = (uint16_t)(pf + 3);
      }
    }
    __syncwarp();
    pos = next;
    w = nw;
    w2 = nw2;
    w3 = nw3;
  }
  enqueue(q, queued, room, kEndOfChunk, 0, lane);
}

// mtpu_snappy_compress's output for one chunk by warp 1 (every lane calls
// it), from warp 0's queue of matches: the varint length, each match's
// pending literal (32 bytes a store) and copy tags, the last literal.
// Returns the block's length.
__device__ int emit_chunk(const uint8_t* b, int sh, int len, int lane,
                          const MatchQueue& q, uint8_t* __restrict__ d) {
  // The varint length (len <= 65536: 3 bytes at most), a byte a lane.
  const int o0 = len < (1 << 7) ? 1 : (len < (1 << 14) ? 2 : 3);
  if (lane < o0)
    d[lane] = (uint8_t)(((len >> (7 * lane)) & 0x7f) |
                        (lane + 1 < o0 ? 0x80 : 0));
  int o = o0;
  int lit = 0;
  if (len >= kMinMatch + 4) {
    for (int t = 0;; ++t) {
      unsigned long long w;
      while (((w = q.ring[t & (kRing - 1)]) >> 48) != (uint32_t)(t + 1))
        __nanosleep(32);
      const uint32_t rx = (uint32_t)w, off = (uint32_t)(w >> 32) & 0xffff;
      const int pf = (int)(rx & 0xffff), mlen = (int)(rx >> 16);
      if (pf == (int)kEndOfChunk) break;
      const int ll = pf - lit;
      if (ll <= kWarp && mlen <= 64) {
        // One step: the literal's tag (lane 0) and bytes, then the
        // match's one copy tag (lane 31, which no literal byte takes).
        const int at = o + ll + (ll > 0);
        if (lane == 0 && ll > 0) d[o] = (uint8_t)((ll - 1) << 2);
        if (lane < ll) d[o + 1 + lane] = b[sh + lit + lane];
        if (lane == 31) {
          d[at] = (uint8_t)(((mlen - 1) << 2) | 2);
          d[at + 1] = (uint8_t)(off & 0xff);
          d[at + 2] = (uint8_t)(off >> 8);
        }
        o = at + 3;
      } else {
        if (ll > 0) o = warp_literal(d, o, b, sh + lit, ll);
        o = warp_copy(d, o, (int)off, mlen);
      }
      lit = pf + mlen;
      if ((t & 15) == 15) {
        // Every lane has read records .. t before lane 0 frees their slots.
        __syncwarp();
        if (lane == 0) {
          __threadfence_block();
          *q.tail = t + 1;
        }
      }
    }
  }
  if (len > lit) o = warp_literal(d, o, b, sh + lit, len - lit);
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
  uint32_t* part = x2n + 32;
  MatchQueue q;
  q.tail = reinterpret_cast<volatile int*>(part + 4);
  q.ring = reinterpret_cast<volatile unsigned long long*>(part + 8);
  uint16_t* htab = reinterpret_cast<uint16_t*>(part + 8 + 2 * kRing);
  uint8_t* buf = reinterpret_cast<uint8_t*>(htab + kHashSize);
  build_tables(tab, x2n);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int64_t in_off = desc[3 * c];
    const int64_t len64 = desc[3 * c + 1];
    const int64_t out_off = desc[3 * c + 2];
    __syncthreads();  // the last chunk is done with buf, htab, part, q
    if (len64 < 0 || len64 > kChunk) {
      if (threadIdx.x == 0) {
        lens[c] = -1;
        crcs[c] = 0;
      }
      continue;
    }
    const int len = (int)len64;
    int staged;
    const int sh = stage(buf, src + in_off, len, kStage, &staged);
    uint4* h4 = reinterpret_cast<uint4*>(htab);
    for (int i = threadIdx.x; i < kHashSize * 2 / 16; i += blockDim.x)
      h4[i] = make_uint4(0, 0, 0, 0);
    if (threadIdx.x < kRing) q.ring[threadIdx.x] = 0;
    if (threadIdx.x == 0) *q.tail = 0;
    __syncthreads();
    if (warp == 0) {
      if (len >= kMinMatch + 4) parse_chunk(buf, sh, len, lane, htab, q);
    } else if (warp == 1) {
      const int n = emit_chunk(buf, sh, len, lane, q, dst + out_off);
      if (lane == 0) lens[c] = n;
    } else {
      const uint32_t v = warp_xor(crc_part(buf + sh, len, threadIdx.x - 64,
                                           kThreads - 64, tab, x2n));
      if (lane == 0) part[warp] = v;
      // Warps 2 and 3 only: warps 0 and 1 are still at the block.
      asm volatile("bar.sync 1, %0;" ::"r"(kThreads - 64) : "memory");
      if (threadIdx.x == 64) crcs[c] = (int64_t)masked(part[2] ^ part[3]);
    }
  }
}

// A frame's payload staged by stage(): byte i (from the vector's start) is
// s[i] below `staged`, else g[i] in global memory; `end` is one past the
// payload.
struct Payload {
  const uint8_t* s;
  const uint8_t* g;
  int end;
  int staged;
  int fast;  // ld64 at i reads only staged bytes or padding if i + 8 <= fast

  __device__ __forceinline__ uint8_t byte(int i) const {
    return i < staged ? s[i] : __ldg(g + i);
  }
  // Bytes i .. i + 7; those at or past end are garbage.
  __device__ __forceinline__ void word2(int i, uint32_t& lo,
                                        uint32_t& hi) const {
    if (i + 8 <= fast) {
      ld64(s, i, lo, hi);
      return;
    }
    lo = hi = 0;
    for (int k = 0; k < 8; ++k) {
      const uint32_t v = i + k < end ? byte(i + k) : 0u;
      if (k < 4)
        lo |= v << (8 * k);
      else
        hi |= v << (8 * (k - 4));
    }
  }
};

// A block that decodes to at most kChunk bytes is at most this long: a
// varint of 10 bytes, then at most 6 bytes a raw byte (a literal of one
// byte behind a 5-byte tag). Longer bodies are malformed.
constexpr int kMaxBlock = 10 + 6 * kChunk;

// A tag as if one started at payload byte i, whose bytes (from the tag
// byte) are lo, hi, as two words: a = the length less one (16 bits), the
// kind (2), the tag's header length (3) and a flag for the checks of
// snappy.c that do not depend on the output so far (a truncated tag, a
// literal past the payload, a length or an offset that no 64 KiB block
// takes, an offset of 0); b = the copy's offset (16 bits). No branch.
__device__ __forceinline__ void parse_tag(uint32_t lo, uint32_t hi, int i,
                                          int end, uint32_t& a,
                                          uint32_t& b) {
  const uint32_t tag = lo & 0xff;
  const uint32_t x = __funnelshift_r(lo, hi, 8);  // the 4 bytes after it
  const uint32_t l6 = tag >> 2, kind = tag & 3;
  const uint32_t extra = l6 >= 60 ? l6 - 59 : 0;
  const uint32_t lit_m1 =
      extra ? x & (extra >= 4 ? kFull : (1u << (8 * extra)) - 1u) : l6;
  const uint32_t hdr = kind == 0 ? 1 + extra
                                 : (kind == 1 ? 2 : (kind == 2 ? 3 : 5));
  const uint32_t lm1 = kind == 0 ? lit_m1 : (kind == 1 ? (l6 & 7) + 3 : l6);
  const uint32_t off = kind == 1 ? ((tag >> 5) << 8) | (x & 0xff)
                                 : (kind == 2 ? x & 0xffff : x);
  const int j = i + (int)hdr;  // past the tag
  const bool bad = j > end || lm1 >= (uint32_t)kChunk ||
                   (kind == 0 ? lm1 >= (uint32_t)(end - j)
                              : off == 0 || off >= (uint32_t)kChunk);
  a = lm1 | (kind << 16) | (hdr << 18) | ((uint32_t)bad << 21);
  b = off;
}

// A tag's copy that the common step does not take: a literal longer than
// a step or not all staged, a copy longer than a step, or a copy that
// overlaps its output, out[o + k] = out[o - off + (k mod off)]. Every
// source lies before o; with k < 64 and off < n, (k + 0.5) / off is at
// least 0.5 / 63 from an integer, so a fast reciprocal floors it exactly.
__device__ void copy_tag(const Payload& in, uint8_t* out, int kind, int j,
                         int o, int off, int n, int lane) {
  if (kind == 0) {
    for (int k = lane; k < n; k += kWarp) out[o + k] = in.byte(j + k);
  } else if (off >= n) {
    for (int k = lane; k < n; k += kWarp) out[o + k] = out[o - off + k];
  } else {
    const float fo = (float)off;
    for (int k = lane; k < n; k += kWarp) {
      const int q = (int)__fdividef((float)k + 0.5f, fo);
      out[o + k] = out[o - off + k - q * off];
    }
  }
}

// mtpu_snappy_decompress of the payload [start, end) into out (cap bytes
// at most) by one warp (every lane calls it): the raw length, or -1 for a
// malformed block. A tag's parse is a chain of dependent steps, so the
// parse is taken out of it: at window start i (a tag), lane l parses a
// tag as if one started at i + l (parse_tag), all at once. The warp then
// walks the window's tags lane to lane, each tag's header length and
// length giving the next tag's lane: it takes each tag's words by a
// shuffle, asks for the next one's, checks the two conditions that
// depend on the output so far (the length against the header's, the
// offset against the output), and copies it. The window ends at the
// first tag that starts past it. kStaged: the whole payload is staged.
template <bool kStaged>
__device__ int decode_block(const Payload& in, int start, uint8_t* out,
                            int cap, int lane) {
  const int end = in.end;
  int i = start;
  uint64_t want = 0;
  int shift = 0;
  bool done = false;
  while (i < end && shift < 64) {
    const uint8_t c = in.byte(i);
    ++i;
    want |= (uint64_t)(c & 0x7f) << shift;
    if (!(c & 0x80)) {
      done = true;
      break;
    }
    shift += 7;
  }
  if (!done || want > (uint64_t)cap) return -1;
  const int wnt = (int)want;
  int o = 0;
  while (i < end) {
    uint32_t lo, hi, a, b;
    if (kStaged)
      ld64(in.s, i + lane, lo, hi);
    else
      in.word2(i + lane, lo, hi);
    parse_tag(lo, hi, i + lane, end, a, b);
    int cur = 0;  // the lane of the current tag
    uint32_t ta = __shfl_sync(kFull, a, 0), tb = __shfl_sync(kFull, b, 0);
    for (;;) {
      const int lm1 = (int)(ta & 0xffff), kind = (int)(ta >> 16) & 3;
      // A kind-3 offset is 32 bits: clamped, as an int it stays positive
      // (an offset of kChunk or more is flagged bad either way).
      const int hdr = (int)(ta >> 18) & 7;
      const int off = (int)min(tb, (uint32_t)kChunk);
      const int n = lm1 + 1;
      const int j = i + cur + hdr;
      const int nxt = cur + hdr + (kind == 0 ? n : 0);
      // The next tag's words and this tag's byte, ahead of the checks:
      // j + lane and o - off + lane lie inside the buffers whatever the
      // tag holds (o <= kChunk, 0 < off <= kChunk), the clamps keep them
      // there.
      const uint32_t na = __shfl_sync(kFull, a, nxt & 31);
      const uint32_t nb = __shfl_sync(kFull, b, nxt & 31);
      const uint8_t v = kind == 0 ? in.s[min(j + lane, kBodyStage - 1)]
                                  : out[max(o - off + lane, 0)];
      if ((ta >> 21) || lm1 >= wnt - o || (kind != 0 && off > o)) return -1;
      if (n <= kWarp &&
          (kind == 0 ? kStaged || j + n <= in.staged : off >= n)) {
        if (lane < n) out[o + lane] = v;
      } else {
        copy_tag(in, out, kind, j, o, off, n, lane);
      }
      o += n;
      __syncwarp();
      cur = nxt;
      if (cur >= kWarp || i + cur >= end) break;
      ta = na;
      tb = nb;
    }
    i += cur;
  }
  return o == wnt ? o : -1;
}

// s[off, off + n) (s 16-byte aligned, shared) to d in global memory by the
// block: 16-byte stores where d is aligned.
__device__ void copy_out(uint8_t* __restrict__ d, const uint8_t* s, int off,
                         int n) {
  const int head = min(n, (int)((16 - (reinterpret_cast<uintptr_t>(d) & 15)) & 15));
  if ((int)threadIdx.x < head) d[threadIdx.x] = s[off + threadIdx.x];
  const int nv = (n - head) >> 4;
  uint4* dv = reinterpret_cast<uint4*>(d + head);
  for (int v = threadIdx.x; v < nv; v += blockDim.x) {
    const int p = off + head + 16 * v;
    const uint32_t* w = reinterpret_cast<const uint32_t*>(s) + (p >> 2);
    const int sft = (p & 3) * 8;
    const uint32_t w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3], w4 = w[4];
    dv[v] = make_uint4(__funnelshift_r(w0, w1, sft), __funnelshift_r(w1, w2, sft),
                       __funnelshift_r(w2, w3, sft), __funnelshift_r(w3, w4, sft));
  }
  for (int k = head + 16 * nv + threadIdx.x; k < n; k += blockDim.x)
    d[k] = s[off + k];
}

__global__ void __launch_bounds__(kThreads)
s2_decompress_kernel(const uint8_t* __restrict__ src,
                     const int64_t* __restrict__ desc,
                     uint8_t* __restrict__ dst,
                     uint8_t* __restrict__ status, long long n_frames) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  uint32_t* x2n = tab + 256;
  uint32_t* part = x2n + 32;
  uint8_t* outbuf = reinterpret_cast<uint8_t*>(part + 4);
  uint8_t* body = outbuf + kStageBytes;
  __shared__ int st;
  build_tables(tab, x2n);
  const int warp = threadIdx.x >> 5;
  for (long long f = blockIdx.x; f < n_frames; f += gridDim.x) {
    const int64_t* dd = desc + 5 * f;
    const int64_t type = dd[0], off = dd[1], blen = dd[2], out_off = dd[3],
                  out_len = dd[4];
    __syncthreads();  // the last frame is done with the buffers, part, st
    int result = (blen < 4 || out_len < 0 || out_len > kChunk ||
                  (type != 0 && type != 1) ||
                  (type == 1 && blen - 4 != out_len))
                     ? kStatusCorrupt
                     : kStatusOk;
    const uint8_t* res = outbuf;  // the raw bytes, at res[res_off]
    int res_off = 0;
    if (type == 0 && blen - 4 > kMaxBlock) result = kStatusCorrupt;
    if (result == kStatusOk) {
      // A raw frame's bytes stage into the output buffer, a block's into
      // the body buffer.
      const uint8_t* payload = src + off + 4;
      int staged;
      const int sh = type == 1
                         ? stage(outbuf, payload, blen - 4, kStage, &staged)
                         : stage(body, payload, blen - 4, kBodyStage, &staged);
      __syncthreads();
      if (type == 1) {
        res_off = sh;
      } else {
        if (warp == 0) {
          Payload in;
          in.s = body;
          in.g = payload - sh;
          in.end = sh + (int)(blen - 4);
          in.staged = staged;
          in.fast = staged + (staged == in.end ? 8 : 0);
          const int got =
              staged == in.end
                  ? decode_block<true>(in, sh, outbuf, (int)out_len, threadIdx.x)
                  : decode_block<false>(in, sh, outbuf, (int)out_len, threadIdx.x);
          if (threadIdx.x == 0)
            st = got == out_len ? kStatusOk : kStatusCorrupt;
        }
        __syncthreads();
        result = st;  // nothing writes st again before the next frame
      }
    }
    if (result == kStatusOk) {
      const int n = (int)out_len;
      copy_out(dst + out_off, res, res_off, n);
      const uint32_t v = warp_xor(
          crc_part(res + res_off, n, threadIdx.x, kThreads, tab, x2n));
      if ((threadIdx.x & 31) == 0) part[warp] = v;
      __syncthreads();
      if (threadIdx.x == 0) {
        const uint8_t* b = src + off;
        const uint32_t want = (uint32_t)b[0] | ((uint32_t)b[1] << 8) |
                              ((uint32_t)b[2] << 16) | ((uint32_t)b[3] << 24);
        if (masked(part[0] ^ part[1] ^ part[2] ^ part[3]) != want)
          result = kStatusCrc;
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
  s2_decompress_kernel<<<grid_for(n, 2), kThreads, kSmemDecompress,
                         (cudaStream_t)stream>>>(
      (const uint8_t*)src, (const int64_t*)desc, (uint8_t*)dst,
      (uint8_t*)status, n);
  return (int)cudaGetLastError();
}
