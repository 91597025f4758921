"""HighwayHash-256 of a batch of equal-length chunks, the counterpart of
minio_tpu/ops/highwayhash_jax.py.

`hash256_batch(data, key)` maps uint8 [..., L] to the digests [..., 32].
`hash256_pitched` hashes rows of a flat buffer at a row pitch,
`verify_frames` checks a run of bitrot frames [digest || chunk] in place
and returns the index of the first bad chunk, and
`verify_frames_grouped` checks G such runs at a group pitch (every shard
reader of a fetch) with one first-bad index a group. Tensors on a CUDA
device go to kernel B (csrc/highwayhash.cu: chunks staged through shared
memory, each chunk's lanes on two threads); tensors on the CPU go to
`_hash256_plain`.

The plain version holds each u64 as two 32-bit halves in int64 tensors,
masked after every operation, and forms the 32x32 products from 16-bit
limbs: torch has no add, shift or compare for uint32/uint64 on the CPU,
and a 32x32 product overflows int64's sign.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build
from .highwayhash import _INIT0, _INIT1, MAGIC_KEY, key_lanes

# Kernel launches made by this process (see rs_cuda.LAUNCHES).
LAUNCHES = _build.LaunchCounter()

_M32 = 0xFFFFFFFF
_M16 = 0xFFFF


# --- u64 as (hi, lo) int64 tensors holding 32-bit halves ---------------

def _add(a, b):
    lo = a[1] + b[1]
    return ((a[0] + b[0] + (lo >> 32)) & _M32, lo & _M32)


def _xor(a, b):
    return (a[0] ^ b[0], a[1] ^ b[1])


def _mul32(x, y):
    """Full 32x32 -> 64 product of int64 tensors holding uint32 values."""
    xl, xh = x & _M16, x >> 16
    yl, yh = y & _M16, y >> 16
    mid = xl * yh + xh * yl  # < 2^33
    lo = xl * yl + ((mid & _M16) << 16)  # < 2^33
    hi = xh * yh + (mid >> 16) + (lo >> 32)
    return (hi & _M32, lo & _M32)


def _byte(a, i: int):
    half = a[1] if i < 4 else a[0]
    return (half >> (8 * (i & 3))) & 0xFF


def _from_bytes(bs):
    """u64 pair from its 8 bytes, least significant first."""
    lo = bs[0] | (bs[1] << 8) | (bs[2] << 16) | (bs[3] << 24)
    hi = bs[4] | (bs[5] << 8) | (bs[6] << 16) | (bs[7] << 24)
    return (hi, lo)


# ZipperMergeAndAdd as byte permutations of the (even, odd) source lanes:
# each entry names (lane, byte) for output bytes 0..7. The reference ORs
# disjoint byte fields, which is exactly this shuffle.
_ZIP_EVEN = (("e", 3), ("o", 4), ("e", 2), ("e", 5), ("o", 6), ("e", 1),
             ("o", 7), ("e", 0))
_ZIP_ODD = (("o", 3), ("e", 4), ("o", 2), ("o", 5), ("o", 1), ("e", 6),
            ("o", 0), ("e", 7))


def _lanes(a, sl):
    return (a[0][..., sl], a[1][..., sl])


def _zipper_add(dst, src):
    src_lanes = {"e": _lanes(src, slice(0, None, 2)),
                 "o": _lanes(src, slice(1, None, 2))}
    add_e = _from_bytes([_byte(src_lanes[l], i) for l, i in _ZIP_EVEN])
    add_o = _from_bytes([_byte(src_lanes[l], i) for l, i in _ZIP_ODD])
    de = _add(_lanes(dst, slice(0, None, 2)), add_e)
    do = _add(_lanes(dst, slice(1, None, 2)), add_o)
    # Interleave back to lane order 0, 1, 2, 3.
    return tuple(torch.stack([e[..., 0], o[..., 0], e[..., 1], o[..., 1]],
                             dim=-1) for e, o in zip(de, do))


def _update(state, packet):
    v0, v1, mul0, mul1 = state
    v1 = _add(v1, _add(mul0, packet))
    mul0 = _xor(mul0, _mul32(v1[1], v0[0]))  # (v1 & low32) * (v0 >> 32)
    v0 = _add(v0, mul1)
    mul1 = _xor(mul1, _mul32(v0[1], v1[0]))
    v0 = _zipper_add(v0, v1)
    v1 = _zipper_add(v1, v0)
    return (v0, v1, mul0, mul1)


def _const_pair(values: np.ndarray, n: int, device):
    hi = torch.tensor([int(x) >> 32 for x in values], dtype=torch.int64,
                      device=device)
    lo = torch.tensor([int(x) & _M32 for x in values], dtype=torch.int64,
                      device=device)
    return (hi.expand(n, 4).clone(), lo.expand(n, 4).clone())


def _bytes_to_lanes(b):
    """[..., 32] uint8 -> (hi, lo) [..., 4] int64, little-endian u64 lanes."""
    b = b.to(torch.int64).reshape(*b.shape[:-1], 4, 8)
    return _from_bytes([b[..., i] for i in range(8)])


def _rotate32_by(count: int, a):
    return tuple(((h << count) | (h >> (32 - count))) & _M32 for h in a)


def _shl(a, n: int):
    hi, lo = a
    if n >= 32:
        return ((lo << (n - 32)) & _M32, torch.zeros_like(lo))
    return (((hi << n) | (lo >> (32 - n))) & _M32, (lo << n) & _M32)


def _shr(a, n: int):
    hi, lo = a
    if n >= 32:
        return (torch.zeros_like(hi), hi >> (n - 32))
    return (hi >> n, ((lo >> n) | (hi << (32 - n))) & _M32)


def _or(a, b):
    return (a[0] | b[0], a[1] | b[1])


def _modular_reduction(a3u, a2, a1, a0):
    a3 = (a3u[0] & 0x3FFFFFFF, a3u[1])
    m1 = _xor(a1, _xor(_or(_shl(a3, 1), _shr(a2, 63)),
                       _or(_shl(a3, 2), _shr(a2, 62))))
    m0 = _xor(a0, _xor(_shl(a2, 1), _shl(a2, 2)))
    return m0, m1


def _finalize256(state):
    for _ in range(10):
        v0 = state[0]
        perm = (v0[1][..., [2, 3, 0, 1]], v0[0][..., [2, 3, 0, 1]])
        state = _update(state, perm)  # rot64_by_32 swaps the halves
    v0, v1, mul0, mul1 = state

    def lane_sum(a, b, i):
        return _add(_lanes(a, i), _lanes(b, i))

    h0, h1 = _modular_reduction(lane_sum(v1, mul1, 1), lane_sum(v1, mul1, 0),
                                lane_sum(v0, mul0, 1), lane_sum(v0, mul0, 0))
    h2, h3 = _modular_reduction(lane_sum(v1, mul1, 3), lane_sum(v1, mul1, 2),
                                lane_sum(v0, mul0, 3), lane_sum(v0, mul0, 2))
    words = []
    for h in (h0, h1, h2, h3):
        words.extend([h[1], h[0]])  # little-endian: low half first
    w = torch.stack(words, dim=-1)  # [N, 8] 32-bit words
    shifts = torch.arange(4, dtype=torch.int64, device=w.device) * 8
    by = (w[..., :, None] >> shifts) & 0xFF
    return by.reshape(w.shape[0], 32).to(torch.uint8)


def _hash256_plain(flat: torch.Tensor, key: bytes) -> torch.Tensor:
    """Plain PyTorch HighwayHash-256: flat uint8 [N, L] -> [N, 32]."""
    n, length = flat.shape
    dev = flat.device
    k64 = np.array(key_lanes(key), dtype=np.uint64)
    key_pair = _const_pair(k64, n, dev)
    mul0 = _const_pair(_INIT0, n, dev)
    mul1 = _const_pair(_INIT1, n, dev)
    v0 = _xor(mul0, key_pair)
    v1 = _xor(mul1, (key_pair[1], key_pair[0]))
    state = (v0, v1, mul0, mul1)
    n_packets, mod32 = divmod(length, 32)
    if n_packets:
        hi, lo = _bytes_to_lanes(
            flat[:, : n_packets * 32].reshape(n, n_packets, 32))
        for p in range(n_packets):
            state = _update(state, (hi[:, p], lo[:, p]))
    if mod32:
        mod4, full4 = mod32 & 3, mod32 & ~3
        tail = flat[:, n_packets * 32:]
        v0, v1, mul0, mul1 = state
        v0 = _add(v0, (torch.full_like(v0[0], mod32),
                       torch.full_like(v0[1], mod32)))
        v1 = _rotate32_by(mod32, v1)
        packet = torch.zeros((n, 32), dtype=torch.uint8, device=dev)
        packet[:, :full4] = tail[:, :full4]
        if mod32 & 16:
            packet[:, 28:32] = tail[:, mod32 - 4: mod32]
        elif mod4:
            packet[:, 16] = tail[:, full4]
            packet[:, 17] = tail[:, full4 + (mod4 >> 1)]
            packet[:, 18] = tail[:, full4 + mod4 - 1]
        state = _update((v0, v1, mul0, mul1), _bytes_to_lanes(packet))
    return _finalize256(state)


def _check_rows(rows: torch.Tensor, what: str) -> int:
    """The row pitch of a uint8 [N, L] view whose bytes are contiguous
    within each row."""
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError(f"{what} needs uint8 [N, L], got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    n, length = rows.shape
    if length > 1 and rows.stride(1) != 1:
        raise ValueError(f"{what} needs each row's bytes contiguous")
    pitch = rows.stride(0) if n > 1 else length
    if pitch < length:
        raise ValueError(f"{what} needs a row pitch >= {length}, got {pitch}")
    return pitch


def _hash256_cuda(rows: torch.Tensor, key: bytes) -> torch.Tensor:
    """Kernel B: uint8 [N, L] rows at any pitch on a CUDA device ->
    [N, 32]."""
    if rows.device.type != "cuda":
        raise ValueError(f"_hash256_cuda needs a CUDA tensor, got {rows.device}")
    pitch = _check_rows(rows, "_hash256_cuda")
    n, length = rows.shape
    out = torch.empty((n, 32), dtype=torch.uint8, device=rows.device)
    if n == 0:
        return out
    lib = _build.library("highwayhash")
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    _build.check(
        lib.hh256_launch(rows.data_ptr(), pitch, n, length, out.data_ptr(),
                         *key_lanes(key), stream),
        "hh256_launch",
    )
    LAUNCHES.add()
    return out


def _verify_cuda(rows: torch.Tensor, want: torch.Tensor, key: bytes) -> int:
    """Kernel B's verify entry: the index of the first of the [N, L] rows
    whose digest differs from its row of `want` ([N, 32], any pitch), or
    -1. One int64 comes back to the host."""
    if rows.device.type != "cuda" or want.device != rows.device:
        raise ValueError(f"_verify_cuda needs CUDA tensors on one device, "
                         f"got {rows.device} and {want.device}")
    pitch = _check_rows(rows, "_verify_cuda")
    want_pitch = _check_rows(want, "_verify_cuda")
    n, length = rows.shape
    if want.shape != (n, 32):
        raise ValueError(f"want digests [{n}, 32], got {tuple(want.shape)}")
    if n == 0:
        return -1
    first_bad = torch.full((1,), n, dtype=torch.int64, device=rows.device)
    lib = _build.library("highwayhash")
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    _build.check(
        lib.hh256_verify_launch(rows.data_ptr(), pitch, n, length,
                                want.data_ptr(), want_pitch,
                                first_bad.data_ptr(), *key_lanes(key),
                                stream),
        "hh256_verify_launch",
    )
    LAUNCHES.add()
    bad = int(first_bad.item())
    return -1 if bad >= n else bad


def _rows(buf: torch.Tensor, offset: int, pitch: int, n: int,
          length: int) -> torch.Tensor:
    """The [n, length] view of rows at buf[offset + i * pitch]."""
    if buf.dtype != torch.uint8 or buf.dim() != 1 or not buf.is_contiguous():
        raise ValueError("want a contiguous 1-D uint8 buffer")
    if n < 0 or length < 0 or offset < 0 or (n > 1 and pitch < length):
        raise ValueError(f"bad rows: offset {offset}, pitch {pitch}, "
                         f"n {n}, length {length}")
    if n and offset + (n - 1) * pitch + length > buf.numel():
        raise ValueError(f"{n} rows of {length} B at pitch {pitch} from "
                         f"{offset} overrun a buffer of {buf.numel()} B")
    return buf.as_strided((n, length), (pitch, 1),
                          buf.storage_offset() + offset)


def hash256_pitched(buf: torch.Tensor, offset: int, pitch: int, n: int,
                    length: int, key: bytes = MAGIC_KEY) -> torch.Tensor:
    """HighwayHash-256 of the n rows of `length` bytes at
    buf[offset + i * pitch] (the counterpart of minio_tpu's native
    hh256_hash_strided): uint8 [n, 32] on the buffer's device."""
    rows = _rows(buf, offset, pitch, n, length)
    if buf.device.type == "cpu":
        return _hash256_plain(rows, key)
    return _hash256_cuda(rows, key)


def _groups(buf: torch.Tensor, offset: int, group_pitch: int,
            n_groups: int, pitch: int, n: int, length: int) -> torch.Tensor:
    """The [n_groups, n, length] view of rows at
    buf[offset + g * group_pitch + i * pitch]."""
    if buf.dtype != torch.uint8 or buf.dim() != 1 or not buf.is_contiguous():
        raise ValueError("want a contiguous 1-D uint8 buffer")
    if min(n_groups, n, length, offset, group_pitch) < 0 or (
            n > 1 and pitch < length):
        raise ValueError(f"bad groups: offset {offset}, group pitch "
                         f"{group_pitch}, pitch {pitch}, n {n}, "
                         f"length {length}")
    end = offset + (n_groups - 1) * group_pitch + (n - 1) * pitch + length
    if n_groups and n and end > buf.numel():
        raise ValueError(f"{n_groups} groups of {n} rows of {length} B "
                         f"overrun a buffer of {buf.numel()} B")
    return buf.as_strided((n_groups, n, length), (group_pitch, pitch, 1),
                          buf.storage_offset() + offset)


def _verify_grouped_plain(buf: torch.Tensor, offset: int, group_pitch: int,
                          n_groups: int, n: int, length: int,
                          key: bytes) -> torch.Tensor:
    """Plain version of the grouped verify: int64 [n_groups], the index
    of each group's first frame whose digest differs, or n."""
    pitch = 32 + length
    rows = _groups(buf, offset + 32, group_pitch, n_groups, pitch, n,
                   length)
    want = _groups(buf, offset, group_pitch, n_groups, pitch, n, 32)
    out = torch.full((n_groups,), n, dtype=torch.int64, device=buf.device)
    if n_groups == 0 or n == 0:
        return out
    got = _hash256_plain(rows.reshape(n_groups * n, length), key)
    differs = (got.reshape(n_groups, n, 32) != want).any(dim=2)
    idx = torch.arange(n, dtype=torch.int64, device=buf.device)
    return torch.where(differs, idx, n).min(dim=1).values


def _verify_grouped_cuda(buf: torch.Tensor, offset: int, group_pitch: int,
                         n_groups: int, n: int, length: int,
                         key: bytes) -> torch.Tensor:
    """Kernel B's grouped verify entry, queued on the current stream with
    no host sync: int64 [n_groups] on the buffer's device."""
    if buf.device.type != "cuda":
        raise ValueError(f"_verify_grouped_cuda needs a CUDA tensor, got "
                         f"{buf.device}")
    pitch = 32 + length
    _groups(buf, offset, group_pitch, n_groups, pitch, n, pitch)  # bounds
    if n_groups > 65535:
        raise ValueError(f"{n_groups} groups exceed the grid's 65,535")
    first_bad = torch.full((n_groups,), n, dtype=torch.int64,
                           device=buf.device)
    if n_groups == 0 or n == 0:
        return first_bad
    lib = _build.library("highwayhash")
    stream = torch.cuda.current_stream(buf.device).cuda_stream
    base = buf.data_ptr() + offset
    _build.check(
        lib.hh256_verify_grouped_launch(base + 32, pitch, n, length, base,
                                        pitch, n_groups, group_pitch,
                                        group_pitch, first_bad.data_ptr(),
                                        *key_lanes(key), stream),
        "hh256_verify_grouped_launch",
    )
    LAUNCHES.add()
    return first_bad


def verify_frames_grouped(buf: torch.Tensor, n_groups: int,
                          group_pitch: int, n: int, length: int,
                          offset: int = 0,
                          key: bytes = MAGIC_KEY) -> torch.Tensor:
    """buf holds n_groups groups of n bitrot frames [digest (32 B) ||
    chunk (length B)], group g from buf[offset + g * group_pitch]: one
    shard reader's fetch a group. Returns int64 [n_groups] on the
    buffer's device, the index of each group's first chunk whose digest
    differs, or n where all agree. On a CUDA buffer it is one kernel B
    launch on the current stream and nothing waits for it: the caller
    reads every group's answer back with one sync."""
    if buf.device.type == "cpu":
        return _verify_grouped_plain(buf, offset, group_pitch, n_groups, n,
                                     length, key)
    return _verify_grouped_cuda(buf, offset, group_pitch, n_groups, n,
                                length, key)


def verify_frames(buf: torch.Tensor, n: int, length: int,
                  key: bytes = MAGIC_KEY) -> int:
    """buf starts with n bitrot frames [digest (32 B) || chunk (length B)];
    the index of the first chunk whose digest differs, or -1 (the
    counterpart of minio_tpu's native hh256_verify_frames over equal
    chunks). The grouped verify's one-group case, read back at once."""
    if buf.device.type != "cpu":
        return _verify_cuda(_rows(buf, 32, 32 + length, n, length),
                            _rows(buf, 0, 32 + length, n, 32), key)
    bad = int(verify_frames_grouped(buf, 1, 0, n, length, key=key)[0])
    return -1 if bad >= n else bad


def hash256_batch(data: torch.Tensor, key: bytes = MAGIC_KEY) -> torch.Tensor:
    """HighwayHash-256 of each length-L row: uint8 [..., L] -> [..., 32],
    on the tensor's device."""
    if data.dtype != torch.uint8 or data.dim() < 1:
        raise ValueError(f"want uint8 [..., L], got {data.dtype} "
                         f"{tuple(data.shape)}")
    lead = data.shape[:-1]
    flat = data.reshape(int(np.prod(lead, dtype=np.int64)), data.shape[-1])
    if data.device.type == "cpu":
        out = _hash256_plain(flat, key)
    else:
        out = _hash256_cuda(flat.contiguous(), key)
    return out.reshape(*lead, 32)
