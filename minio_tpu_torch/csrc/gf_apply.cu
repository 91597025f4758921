// GF(2^8) matrix apply over a batch of shards: kernel A of minio_tpu_torch.
//
// Replaces minio_tpu/ops/rs_pallas.py::_gf_kernel (the Pallas kernel, via
// _apply_bits_pallas) and minio_tpu/ops/rs.py::_apply_bits (the XLA einsum
// the JAX engine ships by default). Both compute, for every batch b and
// byte column s,
//
//     out[b, r, s] = XOR_j  coef[r, j] * shards[b, j, s]      in GF(2^8)
//
// expressed as a GF(2) product with the [8R, 8K] bit-matrix (interleaved,
// LSB-first: row 8r+a is output bit a of row r, column 8j+b is input bit b
// of shard j).
//
// What bounds it on this card: by bytes, 8*16*87,382 = 11.2 MB at the 12+4
// main shape (B=8, K=12, R=4, S=87,382), 3.3 us at 3.35 TB/s. The GF(2)
// work is done in registers with SWAR: 67 M three-input logic operations
// a launch at that shape (eight for every output row, shard and four
// columns), plus the bit-plane spreading, about 230 instructions for each
// shard row of 16 columns. That instruction stream, not the bytes, holds
// the kernel: the loads are overlapped with it, and its time grows with
// the output rows and the batch. The design spends no bytes on the TPU's
// bit-plane relayout in memory and no parity step at the end.
//
// Design. Column 8j+b of the bit-matrix, read down the eight rows of
// output row r, is the byte coef[r, j] * 2^b; call it C[r][j][b], kept in
// shared memory replicated into the four bytes of a uint32. A thread takes
// 16 byte columns (four words of each shard row). For each shard j it
// spreads bit b of every byte of x_j into a whole byte (a shift and a
// sign-replicating byte permute), which gives plane_b, and then
//
//     acc[r] ^= plane_b & C[r][j][b]          for b = 0..7
//
// is the GF(2^8) product of four bytes in one three-input logic operation
// per word, with no parity step at the end. A pass keeps up to eight
// output rows in registers (four words each); the constants are
// broadcast reads from shared memory.
//
// Loads. A block takes a tile of kTileCols columns of one batch. The
// [K, tile] shard block comes in as 16-byte cp.async copies into a ring of
// kStages stages of kGroup shard rows, kStages - 1 groups ahead of the
// arithmetic. Rows start at any byte offset (S = 87,382 is 6 mod 16), so
// each row's 16-byte aligned cover is copied and the shift is applied when
// the threads read it; the shift is the same across the block. A segment
// that would leave the shards tensor is taken byte by byte. Shared memory
// is the ring (33,280 B) plus the constants of one pass (32 B a shard and
// row of the pass): 34,816 B at 12+4, and up to 98,816 B at K = 256, where
// the launch raises the kernel's dynamic shared memory limit above 48 KB.
// Every K up to 778 (any R, any B, any S) fits: 163,328 B at K = 508, the
// widest sub-shard view of the msr-pm codec (254+2, alpha 2).
//
// Stores. A thread writes its 16 output bytes as one aligned 16-byte store
// that takes the tail of its neighbour's bytes with a shuffle; where that
// would cross the ragged end of a row or a warp's edge, bytes go one at a
// time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kCols = 16;                       // byte columns per thread
constexpr int kTileCols = kThreads * kCols;     // 2,048 columns per block
constexpr int kRowBytes = kTileCols + 32;       // a row's cover, padded
constexpr int kGroup = 4;                       // shard rows per stage
constexpr int kStages = 4;
constexpr int kRingBytes = kStages * kGroup * kRowBytes;  // 33,280 B
constexpr int kMaxGridY = 65535;

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

// x[0..3] = bytes [off, off + 16) of the 32 bytes in u[0..7], 0 <= off < 16,
// without branches.
__device__ __forceinline__ void extract16(const uint32_t u[8], int off,
                                          uint32_t x[4]) {
  uint32_t v[6], w[5];
#pragma unroll
  for (int i = 0; i < 6; ++i) v[i] = (off & 8) ? u[i + 2] : u[i];
#pragma unroll
  for (int i = 0; i < 5; ++i) w[i] = (off & 4) ? v[i + 1] : v[i];
  const int sh = 8 * (off & 3);
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = __funnelshift_r(w[i], w[i + 1], sh);
}

// Every byte of the result is 0xff where bit 7 of that byte of t is set.
__device__ __forceinline__ uint32_t sign_bytes(uint32_t t) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(t), "r"(0), "r"(0xba98));
  return r;
}

__device__ __forceinline__ uint8_t byte_of(const uint32_t o[4], int i) {
  return (uint8_t)(o[i >> 2] >> (8 * (i & 3)));
}

// Store this thread's 16 output bytes o at columns [s, s + 16) of an output
// row, only columns below S. Every lane of the warp calls it together.
__device__ __forceinline__ void store16(uint8_t* row, long long s,
                                        long long S, const uint32_t o[4],
                                        int lane) {
  uint8_t* a = row + s;
  const int q = (int)((uintptr_t)a & 15);  // the same across the warp
  if (q == 0) {
    if (s + kCols <= S) {
      *reinterpret_cast<uint4*>(a) = make_uint4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int i = 0; i < kCols; ++i)
        if (s + i < S) a[i] = byte_of(o, i);
    }
    return;
  }
  // The aligned word [a - q, a - q + 16) holds the previous lane's last q
  // bytes, then this lane's first 16 - q.
  uint32_t c[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    c[i] = __shfl_up_sync(0xffffffffu, o[i], 1);
    c[4 + i] = o[i];
  }
  const bool aligned = lane >= 1 && s + kCols - q <= S;
  const bool next_aligned = lane < 31 && s + 2 * kCols - q <= S;
  if (aligned) {
    uint32_t y[4];
    extract16(c, kCols - q, y);
    *reinterpret_cast<uint4*>(a - q) = make_uint4(y[0], y[1], y[2], y[3]);
  }
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const bool covered = i < kCols - q ? aligned : next_aligned;
    if (!covered && s + i < S) a[i] = byte_of(o, i);
  }
}

// Copy the aligned covers of shard rows [j0, j0 + n) of the block's tile
// (columns [c0, c0 + cols)) into ring stage `stage`, one warp a row.
// Segments wholly inside [lo, hi), the shards tensor, go by cp.async; any
// other byte by byte.
__device__ __forceinline__ void stage_rows(uint8_t* ring, int stage,
                                           const uint8_t* src, int j0, int n,
                                           long long S, long long c0,
                                           int cols, const uint8_t* lo,
                                           const uint8_t* hi) {
  const int lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g < n; g += kThreads / 32) {
    const uint8_t* start = src + (long long)(j0 + g) * S + c0;
    const int shift = (int)((uintptr_t)start & 15);
    const int n_segs = (shift + cols + 15) >> 4;
    const uint8_t* from = start - shift;
    uint8_t* to = ring + (stage * kGroup + g) * kRowBytes;
    if (from >= lo && from + 16 * n_segs <= hi) {
      for (int k = lane; k < n_segs; k += 32)
        cp_async16(to + 16 * k, from + 16 * k);
      continue;
    }
    for (int k = lane; k < n_segs; k += 32) {
      const uint8_t* f = from + 16 * k;
      if (f >= lo && f + 16 <= hi) {
        cp_async16(to + 16 * k, f);
      } else {
        for (int i = 0; i < 16; ++i)
          to[16 * k + i] = (f + i >= lo && f + i < hi) ? f[i] : 0;
      }
    }
  }
}

// kRows output rows per pass: 1, 2, 4 or 8, the least that covers R (8
// beyond). Every pass runs all kRows rows, with zero constants for rows
// past R, so the inner loop has no branch.
template <int kRows>
__global__ void __launch_bounds__(kThreads)
    gf_apply_kernel(const int8_t* __restrict__ bitmat,
                    const uint8_t* __restrict__ shards,
                    uint8_t* __restrict__ out, long long B, int K, int R,
                    long long S) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;
  // consts[(j * 8 + b) * kRows + rr] = C[r0 + rr][j][b] x 0x01010101
  uint32_t* consts = reinterpret_cast<uint32_t*>(smem + kRingBytes);

  const long long c0 = (long long)blockIdx.x * kTileCols;
  const int cols = (int)min((long long)kTileCols, S - c0);
  const long long s = c0 + (long long)kCols * threadIdx.x;
  const int lane = threadIdx.x & 31;
  const uint8_t* lo = shards;
  const uint8_t* hi = shards + B * K * S;
  const int n_groups = (K + kGroup - 1) / kGroup;

  for (long long b = blockIdx.y; b < B; b += gridDim.y) {
    const uint8_t* src = shards + b * K * S;
    uint8_t* dst = out + b * R * S;
    for (int r0 = 0; r0 < R; r0 += kRows) {
      const int rows = min(kRows, R - r0);
      __syncthreads();  // the last pass's ring and constants are done with
      // The first groups' copies go out before the constants are built, so
      // the two latencies overlap.
#pragma unroll
      for (int g = 0; g < kStages - 1; ++g) {
        if (g < n_groups)
          stage_rows(ring, g, src, g * kGroup, min(kGroup, K - g * kGroup), S,
                     c0, cols, lo, hi);
        cp_async_commit();
      }

      for (int idx = threadIdx.x; idx < K * kRows; idx += kThreads) {
        const int j = idx / kRows;
        const int rr = idx - j * kRows;
        uint32_t col[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        if (rr < rows) {
          const int8_t* p = bitmat + (long long)8 * (r0 + rr) * 8 * K + 8 * j;
#pragma unroll
          for (int a = 0; a < 8; ++a)
#pragma unroll
            for (int bb = 0; bb < 8; ++bb)
              col[bb] |= (p[(long long)a * 8 * K + bb] != 0 ? 1u : 0u) << a;
        }
#pragma unroll
        for (int bb = 0; bb < 8; ++bb)
          consts[(j * 8 + bb) * kRows + rr] = col[bb] * 0x01010101u;
      }

      uint32_t acc[kRows][4];
#pragma unroll
      for (int rr = 0; rr < kRows; ++rr)
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[rr][w] = 0;

      for (int g = 0; g < n_groups; ++g) {
        const int gn = g + kStages - 1;
        if (gn < n_groups)
          stage_rows(ring, gn % kStages, src, gn * kGroup,
                     min(kGroup, K - gn * kGroup), S, c0, cols, lo, hi);
        cp_async_commit();
        cp_async_wait<kStages - 1>();
        __syncthreads();  // group g (and the constants) visible to all
        const int n = min(kGroup, K - g * kGroup);
        for (int jj = 0; jj < n; ++jj) {
          const int j = g * kGroup + jj;
          const uint8_t* row =
              ring + ((g % kStages) * kGroup + jj) * kRowBytes;
          const int q = (int)((uintptr_t)(src + (long long)j * S + c0) & 15);
          const uint4 u0 =
              *reinterpret_cast<const uint4*>(row + kCols * threadIdx.x);
          const uint4 u1 =
              *reinterpret_cast<const uint4*>(row + kCols * threadIdx.x + 16);
          const uint32_t u[8] = {u0.x, u0.y, u0.z, u0.w,
                                 u1.x, u1.y, u1.z, u1.w};
          uint32_t x[4];
          extract16(u, q, x);
          const uint32_t* cj = consts + j * 8 * kRows;
#pragma unroll
          for (int bb = 0; bb < 8; ++bb) {
            uint32_t plane[4];
#pragma unroll
            for (int w = 0; w < 4; ++w)
              plane[w] = sign_bytes(x[w] << (7 - bb));
#pragma unroll
            for (int rr = 0; rr < kRows; ++rr) {
              const uint32_t c = cj[bb * kRows + rr];
#pragma unroll
              for (int w = 0; w < 4; ++w) acc[rr][w] ^= plane[w] & c;
            }
          }
        }
        __syncthreads();  // stage g % kStages is refilled next round
      }

#pragma unroll
      for (int rr = 0; rr < kRows; ++rr)
        if (rr < rows)
          store16(dst + (long long)(r0 + rr) * S, s, S, acc[rr], lane);
    }
  }
}

int rows_per_pass(int R) { return R <= 1 ? 1 : R <= 2 ? 2 : R <= 4 ? 4 : 8; }

template <int kRows>
int launch(const void* bitmat, const void* shards, void* out, long long B,
           int K, int R, long long S, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {  // the default limit of dynamic shared memory
    const cudaError_t err = cudaFuncSetAttribute(
        gf_apply_kernel<kRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((unsigned)((S + kTileCols - 1) / kTileCols),
            (unsigned)(B < kMaxGridY ? B : kMaxGridY));
  gf_apply_kernel<kRows><<<grid, kThreads, (size_t)smem, stream>>>(
      (const int8_t*)bitmat, (const uint8_t*)shards, (uint8_t*)out, B, K, R,
      S);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one launch: the ring and one pass's constants.
extern "C" int gf_apply_smem_bytes(int K, int R) {
  return kRingBytes + K * 8 * rows_per_pass(R) * 4;
}

// bitmat int8 [8R, 8K], shards uint8 [B, K, S], out uint8 [B, R, S], all
// contiguous on the device. Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int gf_apply_launch(const void* bitmat, const void* shards,
                               void* out, long long B, int K, int R,
                               long long S, void* stream) {
  if (B <= 0 || S <= 0 || R <= 0) return 0;
  const int smem = gf_apply_smem_bytes(K, R);
  cudaStream_t st = (cudaStream_t)stream;
  switch (rows_per_pass(R)) {
    case 1: return launch<1>(bitmat, shards, out, B, K, R, S, smem, st);
    case 2: return launch<2>(bitmat, shards, out, B, K, R, S, smem, st);
    case 4: return launch<4>(bitmat, shards, out, B, K, R, S, smem, st);
    default: return launch<8>(bitmat, shards, out, B, K, R, S, smem, st);
  }
}
