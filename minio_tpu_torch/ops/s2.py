"""S2-style framed snappy, the port's copy of minio_tpu/ops/s2.py: the
transparent object compression codec's framing, and the plain versions
of kernels E and F (csrc/s2.cu, ops/s2_cuda.py).

Frame layout (the snappy framing format, S2's interoperable subset):
  0xff len=6 "sNaPpY"                         stream identifier
  0x00 len24 crc32c_masked(raw) snappy(raw)   compressed chunk
  0x01 len24 crc32c_masked(raw) raw           uncompressed chunk
A chunk holds at most 64 KiB of raw bytes.

minio_tpu compresses with its native C block codec (minio_tpu/native/
snappy.c) where it can build one, else with a Python codec that writes
other bytes (a dictionary of exact 4-byte keys in place of the C hash
table). The port writes snappy.c's bytes: `_compress_block_py`,
`_decompress_block_py` and `_crc32c_py` here are snappy.c's
mtpu_snappy_compress, mtpu_snappy_decompress and mtpu_crc32c line for
line. They are the plain versions of kernels E and F, run on the CPU
(`compress_plain`, `decompress_plain` take and give uint8 tensors); a
sequential byte codec has no useful PyTorch formulation, as the plain
HighwayHash is a Python loop.

`window_parse`, `window_block` and `warp_decode_block` model kernels E
and F's warp designs; the tests hold them to the plain versions, and no
path of the port runs them.

`S2Batch` is the host side of a batch on the codec's device: one staged
copy of the raw chunks (or frame bodies) to the card, one launch, one
copy back. `compress_stream` and `decompress_stream` are the one-shot
forms (tests, tools); `FrameDecoder` decodes a stream fed in pieces.
"""

from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device

CHUNK = 64 * 1024
STREAM_ID = b"\xff\x06\x00\x00sNaPpY"
_MASK_DELTA = 0xA282EAD8
_POLY = 0x82F63B78  # CRC-32C (Castagnoli), reflected
HASH_BITS = 14
HASH_SIZE = 1 << HASH_BITS
MIN_MATCH = 4

# Kernel F's status a frame.
STATUS_OK, STATUS_CRC, STATUS_CORRUPT = 0, 1, 2
STATUS_MESSAGES = {STATUS_CRC: "snappy frame CRC mismatch",
                   STATUS_CORRUPT: "corrupt snappy block"}

# Chunks a batch takes: a launch of kernel E or F (8 MiB of raw bytes).
BATCH_CHUNKS = 128


def max_compressed(n: int) -> int:
    """The longest snappy block of n raw bytes (snappy.c's bound)."""
    return 32 + n + n // 6


# ---------------------------------------------------------------------------
# CRC32C

def _crc_table() -> list[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (_POLY ^ (c >> 1)) if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc_table()


def _crc32c_py(data) -> int:
    t = _CRC_TABLE
    c = 0xFFFFFFFF
    for b in bytes(data):
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def mask_crc(c: int) -> int:
    return (((c >> 15) | (c << 17)) + _MASK_DELTA) & 0xFFFFFFFF


def crc32c(data) -> int:
    return _crc32c_py(data)


def _masked_crc(data) -> int:
    return mask_crc(_crc32c_py(data))


# The segmented CRC of kernels E and F, in plain integers: each lane (64
# in E, warps 2 and 3 while warps 0 and 1 write the block; 128 in F, the
# whole block) takes the register of one segment (lane 0 from
# 0xffffffff, the others from 0), multiplies it by x^(8 * bytes after the
# segment) mod P, and the lanes' products XOR to the register of the
# whole. tests/test_torch_s2.py holds this model to _crc32c_py; the
# kernels' arithmetic follows it.

def multmodp(a: int, b: int) -> int:
    """a * b mod P in the reflected representation (zlib's multmodp)."""
    m, p = 1 << 31, 0
    while True:
        if a & m:
            p ^= b
            if (a & (m - 1)) == 0:
                break
        m >>= 1
        b = (b >> 1) ^ _POLY if b & 1 else b >> 1
    return p


def _x2n_table() -> list[int]:
    t = [1 << 30]  # x^1
    for _ in range(31):
        t.append(multmodp(t[-1], t[-1]))
    return t


X2N = _x2n_table()


def x8nmodp(n: int) -> int:
    """x^(8 n) mod P: the register shift of n zero bytes."""
    p, k = 1 << 31, 3
    while n:
        if n & 1:
            p = multmodp(X2N[k & 31], p)
        n >>= 1
        k += 1
    return p


def segmented_crc32c(data, lanes: int = 32) -> int:
    """CRC32C as the kernels compute it, lane by lane."""
    data = bytes(data)
    n = len(data)
    seg = -(-n // lanes) if n else 0
    acc = 0
    for lane in range(lanes):
        lo, hi = min(n, lane * seg), min(n, (lane + 1) * seg)
        c = 0xFFFFFFFF if lane == 0 else 0
        for b in data[lo:hi]:
            c = _CRC_TABLE[(c ^ b) & 0xFF] ^ (c >> 8)
        acc ^= multmodp(x8nmodp(n - hi), c)
    return acc ^ 0xFFFFFFFF


# ---------------------------------------------------------------------------
# snappy block codec: snappy.c, line for line

def _varint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _read_varint(data) -> tuple[int, int]:
    """(value, bytes read); -1 for the count when truncated or longer
    than 64 bits (snappy.c's get_varint)."""
    v = shift = i = 0
    while i < len(data) and shift < 64:
        b = data[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7
    return 0, -1


def _emit_literal(out: bytearray, data) -> None:
    i = 0
    while i < len(data):
        run = min(len(data) - i, 1 << 16)
        l = run - 1
        if l < 60:
            out.append(l << 2)
        elif l < 256:
            out.append(60 << 2)
            out.append(l)
        else:
            out.append(61 << 2)
            out += struct.pack("<H", l)
        out += data[i:i + run]
        i += run


def _emit_copy(out: bytearray, offset: int, length: int) -> None:
    """2-byte-offset copies of 1..64 bytes a tag, split so that the last
    tag is at least 4 bytes (the 68 / 64 + 60 split)."""
    off = struct.pack("<H", offset)

    def one(n: int):
        out.append(((n - 1) << 2) | 2)
        out.extend(off)

    while length >= 68:
        one(64)
        length -= 64
    if length > 64:
        one(60)
        length -= 60
    one(length)


def _match_length(b, cand: int, pos: int, blen: int) -> int:
    """The match extension of snappy.c: from MIN_MATCH while the bytes
    agree, before blen and below 0xffff (found here by slices)."""
    mlen = MIN_MATCH
    cap = min(blen - pos, 0xFFFF)
    step = 64
    while mlen < cap:
        n = min(step, cap - mlen)
        if b[cand + mlen:cand + mlen + n] == b[pos + mlen:pos + mlen + n]:
            mlen += n
            step *= 2
            continue
        if n == 1:
            break
        step = max(1, n // 2)
    return mlen


def _compress_block_py(data) -> bytes:
    """snappy.c's mtpu_snappy_compress: varint length, then per 64 KiB
    block literal and copy tags from a 16,384-entry uint16 hash table
    reset for each block (empty entries read as position 0)."""
    data = bytes(data)
    n = len(data)
    out = bytearray(_varint(n))
    base = 0
    while base < n:
        end = min(base + CHUNK, n)
        blen = end - base
        if blen < MIN_MATCH + 4:
            _emit_literal(out, data[base:end])
            base = end
            continue
        b = data[base:end]
        # load32 and hash32 of every position at once; the loop below
        # reads them at the positions snappy.c visits.
        arr = np.frombuffer(b + b"\0\0\0", dtype=np.uint8).astype(np.uint32)
        load = (arr[:-3] | (arr[1:-2] << 8) | (arr[2:-1] << 16)
                | (arr[3:] << 24))[:blen]
        hashes = ((load * np.uint32(0x1E35A7BD)) >> np.uint32(
            32 - HASH_BITS)).tolist()
        load = load.tolist()
        table = [0] * HASH_SIZE
        pos = lit = 0
        limit = blen - MIN_MATCH
        while pos <= limit:
            h = hashes[pos]
            cand = table[h]
            table[h] = pos
            if cand < pos and pos - cand <= 0xFFFF and \
                    load[cand] == load[pos]:
                mlen = _match_length(b, cand, pos, blen)
                if pos > lit:
                    _emit_literal(out, b[lit:pos])
                _emit_copy(out, pos - cand, mlen)
                # Seed the hashes of a few positions inside the match.
                seed_end = pos + mlen
                s = pos + 1
                while (s + MIN_MATCH <= seed_end and s <= limit
                       and s < pos + 4):
                    table[hashes[s]] = s
                    s += 1
                pos += mlen
                lit = pos
            else:
                pos += 1
        if blen > lit:
            _emit_literal(out, b[lit:blen])
        base = end
    return bytes(out)


def _decompress_block_py(data, cap: int = -1) -> bytes:
    """snappy.c's mtpu_snappy_decompress into at most `cap` bytes (-1:
    the block's own length): ValueError("corrupt snappy block") on a
    truncated or malformed block, an offset outside the output, or a
    length other than the header's."""
    data = bytes(data)
    want, hdr = _read_varint(data)
    if hdr < 0 or (cap >= 0 and want > cap):
        raise ValueError("corrupt snappy block")
    n = len(data)
    i = hdr
    out = bytearray()
    while i < n:
        tag = data[i]
        i += 1
        kind = tag & 3
        if kind == 0:
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                if i + extra > n:
                    raise ValueError("corrupt snappy block")
                length = int.from_bytes(data[i:i + extra], "little") + 1
                i += extra
            if i + length > n or len(out) + length > want:
                raise ValueError("corrupt snappy block")
            out += data[i:i + length]
            i += length
            continue
        if kind == 1:
            length = ((tag >> 2) & 7) + 4
            if i >= n:
                raise ValueError("corrupt snappy block")
            offset = ((tag >> 5) << 8) | data[i]
            i += 1
        elif kind == 2:
            length = (tag >> 2) + 1
            if i + 2 > n:
                raise ValueError("corrupt snappy block")
            offset = int.from_bytes(data[i:i + 2], "little")
            i += 2
        else:
            length = (tag >> 2) + 1
            if i + 4 > n:
                raise ValueError("corrupt snappy block")
            offset = int.from_bytes(data[i:i + 4], "little")
            i += 4
        o = len(out)
        if offset == 0 or offset > o or o + length > want:
            raise ValueError("corrupt snappy block")
        if offset >= length:
            out += out[o - offset:o - offset + length]
        else:
            # An overlapping copy repeats the last `offset` bytes.
            pat = out[o - offset:]
            out += (pat * (length // offset + 1))[:length]
    if len(out) != want:
        raise ValueError("corrupt snappy block")
    return bytes(out)


def compress_block(data) -> bytes:
    return _compress_block_py(data)


def decompress_block(data) -> bytes:
    return _decompress_block_py(data)


# ---------------------------------------------------------------------------
# Models of kernels E and F's warp designs, in plain Python. The kernels
# follow them and tests/test_torch_s2.py holds them to the serial loops
# above and to snappy.c; no CPU path runs them.

WARP = 32


class WindowParse(NamedTuple):
    """Kernel E's parse of one chunk by a warp: each match as (pos, cand,
    length); the hash-table writes as (hash, position) lists, one a match
    (the writes before it and its seeds) and a last one after the last
    match; the windows and the 128-byte extension steps it took."""
    matches: list
    writes: list
    windows: int
    steps: int


def window_parse(chunk) -> WindowParse:
    """Kernel E's 32-position window over one chunk of 8 to CHUNK bytes.

    At window start `pos`, lane l takes position p = pos + l (lanes past
    limit = len - 4 sit out). Its candidate is the position of the
    highest lane below it with the same hash (its peers), else the table
    entry as it stood before the window; it hits where the serial loop
    would: cand < p, p - cand <= 0xffff, equal words. Up to the first
    lane f that hits (or the window's last lane), the highest lane of
    each peer group writes the table: the last write the serial loop
    makes there. A hit extends to snappy.c's length, emits, and seeds up
    to three positions in the serial loop's order; the next window
    starts after the match."""
    b = bytes(chunk)
    blen = len(b)
    if not MIN_MATCH + 4 <= blen <= CHUNK:
        raise ValueError(f"a window parse takes 8 to {CHUNK} B, got {blen}")
    arr = np.frombuffer(b + b"\0\0\0", dtype=np.uint8).astype(np.uint32)
    load = ((arr[:-3] | (arr[1:-2] << 8) | (arr[2:-1] << 16)
             | (arr[3:] << 24))[:blen])
    hashes = ((load * np.uint32(0x1E35A7BD)) >> np.uint32(
        32 - HASH_BITS)).tolist()
    load = load.tolist()
    table = [0] * HASH_SIZE
    limit = blen - MIN_MATCH
    matches, writes, seg = [], [], []
    pos = windows = steps = 0
    while pos <= limit:
        windows += 1
        lanes = min(WARP, limit - pos + 1)
        hs = hashes[pos:pos + lanes]
        last: dict = {}
        cands = []
        for lane, h in enumerate(hs):
            cands.append(pos + last[h] if h in last else table[h])
            last[h] = lane
        f = next((lane for lane in range(lanes)
                  if cands[lane] < pos + lane
                  and pos + lane - cands[lane] <= 0xFFFF
                  and load[cands[lane]] == load[pos + lane]), None)
        upto = lanes - 1 if f is None else f
        highest = {h: lane for lane, h in enumerate(hs[:upto + 1])}
        for lane, h in enumerate(hs[:upto + 1]):
            if highest[h] == lane:
                table[h] = pos + lane
                seg.append((h, pos + lane))
        if f is None:
            pos += WARP
            continue
        p, cand = pos + f, cands[f]
        mlen = _match_length(b, cand, p, blen)
        # The warp's steps: bytes 4-11 are compared in the window; from
        # byte 12, 32 words a step until a lane finds the first mismatch
        # or the cap.
        cap = min(blen - p, 0xFFFF)
        m = 12
        while m < cap and mlen >= 12:
            steps += 1
            if mlen < m + 4 * WARP:
                break
            m += 4 * WARP
        s = p + 1
        while s + MIN_MATCH <= p + mlen and s <= limit and s < p + 4:
            table[hashes[s]] = s
            seg.append((hashes[s], s))
            s += 1
        matches.append((p, cand, mlen))
        writes.append(seg)
        seg = []
        pos = p + mlen
    writes.append(seg)
    return WindowParse(matches, writes, windows, steps)


def window_block(chunk) -> bytes:
    """The snappy block of one chunk (at most CHUNK bytes) from
    window_parse's matches: what kernel E writes."""
    b = bytes(chunk)
    out = bytearray(_varint(len(b)))
    if len(b) < MIN_MATCH + 4:
        _emit_literal(out, b)
        return bytes(out)
    lit = 0
    for p, cand, mlen in window_parse(b).matches:
        if p > lit:
            _emit_literal(out, b[lit:p])
        _emit_copy(out, p - cand, mlen)
        lit = p + mlen
    if len(b) > lit:
        _emit_literal(out, b[lit:])
    return bytes(out)


def _lane_tag(data, i: int) -> tuple:
    """Kernel F's parse of a tag as if one started at data[i]: (length
    less one, kind, header length, offset, bad), bad where a check of
    snappy.c fails that does not depend on the output so far."""
    n = len(data)
    word = int.from_bytes(data[i:i + 5].ljust(5, b"\0"), "little")
    tag, x = word & 0xFF, word >> 8
    l6, kind = tag >> 2, tag & 3
    if kind == 0:
        extra = l6 - 59 if l6 >= 60 else 0
        hdr = 1 + extra
        lm1 = x & ((1 << (8 * extra)) - 1) if extra else l6
        off = 0
    else:
        hdr = {1: 2, 2: 3, 3: 5}[kind]
        lm1 = (l6 & 7) + 3 if kind == 1 else l6
        off = ((tag >> 5) << 8) | (x & 0xFF) if kind == 1 else (
            x & 0xFFFF if kind == 2 else x)
    j = i + hdr
    bad = j > n or lm1 >= CHUNK or (
        lm1 >= n - j if kind == 0 else off == 0 or off >= CHUNK)
    return lm1, kind, hdr, off, bad


def warp_decode_block(data, cap: int = CHUNK) -> bytes:
    """Kernel F's decode of a snappy block into at most `cap` bytes (the
    frame's raw length, at most CHUNK).

    At window start i (a tag), lane l parses a tag as if one started at
    i + l (_lane_tag: the checks that do not depend on the output). The
    warp walks the window's tags lane to lane, each tag's header and
    length giving the next tag's lane, checks the length against the
    header's and the offset against the output, and copies the tag 32
    lanes a step: a copy of `length` bytes at offset `off` takes
    out[o + k] = out[o - off + (k mod off)], every source byte before o,
    so the lanes of a step are independent even where off < length. The
    window ends at the first tag past it. Malformed blocks raise as
    _decompress_block_py does."""
    data = bytes(data)
    if not 0 <= cap <= CHUNK:
        raise ValueError(f"kernel F decodes at most {CHUNK} B, not {cap}")
    want, i = _read_varint(data)
    if i < 0 or want > cap:
        raise ValueError("corrupt snappy block")
    n = len(data)
    # The kernel reads its lanes' words and a literal's bytes from a
    # staged buffer that goes on past the block: so does the model.
    padded = data + bytes(8 * WARP)
    out = bytearray()
    while i < n:
        lanes = [_lane_tag(data, i + lane) for lane in range(WARP)]
        cur = 0
        while True:
            lm1, kind, hdr, off, bad = lanes[cur]
            length, o = lm1 + 1, len(out)
            if bad or lm1 >= want - o or (kind != 0 and off > o):
                raise ValueError("corrupt snappy block")
            j = i + cur + hdr
            for k0 in range(0, length, WARP):
                ks = range(k0, min(length, k0 + WARP))
                if kind == 0:
                    out += padded[j + k0:j + ks.stop]
                else:
                    out += bytes(out[o - off + (k if off >= length
                                                 else k % off)]
                                 for k in ks)
            cur += hdr + (length if kind == 0 else 0)
            if cur >= WARP or i + cur >= n:
                break
        i += cur
    if len(out) != want:
        raise ValueError("corrupt snappy block")
    return bytes(out)


# ---------------------------------------------------------------------------
# Plain versions of kernels E and F on uint8 tensors

def compress_plain(data: torch.Tensor, desc: torch.Tensor, out_size: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel E's function: desc int64 [N, 3] gives each chunk's (in_off,
    length, out_off) in `data`; returns (uint8 [out_size] with each
    chunk's snappy block at its out_off, int64 [N] each chunk's masked
    CRC32C, int64 [N] each block's length). Bytes no block covers are
    zero."""
    raw = data.numpy().tobytes()
    out = bytearray(out_size)
    rows = desc.tolist()
    crcs, lens = [], []
    for in_off, length, out_off in rows:
        chunk = raw[in_off:in_off + length]
        block = _compress_block_py(chunk)
        out[out_off:out_off + len(block)] = block
        crcs.append(_masked_crc(chunk))
        lens.append(len(block))
    return (torch.frombuffer(out, dtype=torch.uint8) if out_size
            else torch.empty(0, dtype=torch.uint8),
            torch.tensor(crcs, dtype=torch.int64),
            torch.tensor(lens, dtype=torch.int64))


def decompress_plain(data: torch.Tensor, desc: torch.Tensor, out_size: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel F's function: desc int64 [N, 5] gives each frame's (type,
    body offset, body length, out_off, out_len), the body the frame's
    masked CRC then its payload; returns (uint8 [out_size] with each good
    frame's raw bytes at its out_off, uint8 [N] status: 0 ok, 1 CRC
    mismatch, 2 a malformed block or a raw length other than out_len).
    Nothing is written outside a frame's [out_off, out_off + out_len)."""
    raw = data.numpy().tobytes()
    out = bytearray(out_size)
    status = []
    for ftype, off, length, out_off, out_len in desc.tolist():
        body = raw[off:off + length]
        try:
            if length < 4 or ftype not in (0, 1) or out_len > CHUNK:
                raise ValueError("not a frame F takes")
            payload = body[4:]
            plain = (_decompress_block_py(payload, out_len) if ftype == 0
                     else payload)
            if len(plain) != out_len:
                raise ValueError("length")
        except ValueError:
            status.append(STATUS_CORRUPT)
            continue
        out[out_off:out_off + out_len] = plain
        want = int.from_bytes(body[:4], "little")
        status.append(STATUS_OK if _masked_crc(plain) == want
                      else STATUS_CRC)
    return (torch.frombuffer(out, dtype=torch.uint8) if out_size
            else torch.empty(0, dtype=torch.uint8),
            torch.tensor(status, dtype=torch.uint8))


# ---------------------------------------------------------------------------
# Batches on the codec's device

class S2Batch:
    """Kernels E and F over batches on `device` (the card unless the
    caller asks for the CPU; raises where there is no card): the inputs
    go over in one pinned copy, one launch runs, the outputs come back
    in pinned memory behind one event."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def _stage(self, desc: np.ndarray, payload) -> tuple:
        """(desc, data) on the device: one pinned buffer, one copy."""
        from . import host_feed

        dbytes = desc.size * 8
        host = torch.empty(dbytes + len(payload), dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        hv = host.numpy()
        hv[:dbytes] = desc.reshape(-1).view(np.uint8)
        hv[dbytes:] = np.frombuffer(payload, dtype=np.uint8)
        if self.device.type == "cuda":
            host_feed.count_h2d(True, host.numel())
            dev = host.to(self.device, non_blocking=True)
        else:
            dev = host
        return (dev[:dbytes].view(torch.int64).reshape(desc.shape),
                dev[dbytes:])

    def _fetch(self, *tensors: torch.Tensor) -> list[np.ndarray]:
        if self.device.type != "cuda":
            return [t.numpy() for t in tensors]
        hosts = []
        for t in tensors:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            hosts.append(h)
        copied = torch.cuda.Event()
        copied.record(torch.cuda.current_stream(self.device))
        copied.synchronize()
        return [h.numpy() for h in hosts]

    def compress_chunks(self, raw, sizes: list[int]
                        ) -> tuple[list[int], list[memoryview]]:
        """Kernel E over the chunks of `raw` (bytes-like), cut back to
        back into `sizes` (each at most CHUNK): each chunk's masked
        CRC32C and snappy block."""
        from . import s2_cuda

        raw = memoryview(raw).cast("B")
        if sum(sizes) != len(raw):
            raise ValueError(f"chunk sizes sum to {sum(sizes)}, the data "
                             f"is {len(raw)} B")
        if any(s > CHUNK for s in sizes):
            raise ValueError(f"a chunk holds at most {CHUNK} B")
        desc = np.zeros((len(sizes), 3), dtype=np.int64)
        in_off = out_off = 0
        for i, s in enumerate(sizes):
            desc[i] = (in_off, s, out_off)
            in_off += s
            out_off += max_compressed(s)
        d_desc, d_data = self._stage(desc, raw)
        out, crcs, lens = s2_cuda.compress(d_data, d_desc, out_off)
        out, crcs, lens = self._fetch(out, crcs, lens)
        view = memoryview(out)
        blocks = [view[o:o + n] for o, n in zip(desc[:, 2].tolist(),
                                                lens.tolist())]
        return crcs.tolist(), blocks

    def decode_frames(self, bodies, frames: list[tuple[int, int, int, int]]
                      ) -> tuple[memoryview, list[int]]:
        """Kernel F over frames of `bodies` (bytes-like): each frame is
        (type, body offset, body length, raw length). Returns the raw
        bytes of the frames back to back and each frame's status."""
        from . import s2_cuda

        bodies = memoryview(bodies).cast("B")
        desc = np.zeros((len(frames), 5), dtype=np.int64)
        out_off = 0
        for i, (ftype, off, length, raw_len) in enumerate(frames):
            desc[i] = (ftype, off, length, out_off, raw_len)
            out_off += raw_len
        d_desc, d_data = self._stage(desc, bodies)
        out, status = s2_cuda.decompress(d_data, d_desc, out_off)
        out, status = self._fetch(out, status)
        return memoryview(out), status.tolist()


def frame(ftype: int, crc: int, payload) -> bytes:
    body_len = 4 + len(payload)
    return (bytes([ftype]) + struct.pack("<I", body_len)[:3]
            + struct.pack("<I", crc) + bytes(payload))


def frame_chunk(raw, device="cuda") -> bytes:
    """One framed chunk; compressed only when the block is shorter than
    the raw chunk (the framing's escape for incompressible data)."""
    crcs, blocks = S2Batch(device).compress_chunks(raw, [len(raw)])
    if len(blocks[0]) < len(raw):
        return frame(0x00, crcs[0], blocks[0])
    return frame(0x01, crcs[0], raw)


def frames_of(raw, sizes: list[int], crcs: list[int],
              blocks: list) -> bytes:
    """The frames of chunks cut from `raw` by `sizes`, frame_chunk's rule
    applied to each."""
    raw = memoryview(raw).cast("B")
    parts = []
    pos = 0
    for s, crc, block in zip(sizes, crcs, blocks):
        chunk = raw[pos:pos + s]
        pos += s
        if len(block) < s:
            parts.append(frame(0x00, crc, block))
        else:
            parts.append(frame(0x01, crc, chunk))
    return b"".join(parts)


def raw_length(ftype: int, head: bytes, body_len: int) -> int:
    """A data frame's raw length from the first bytes of its body (the
    CRC, then the block's varint header) or from the payload's length;
    ValueError on a frame F cannot take."""
    if body_len < 4:
        raise ValueError("short snappy frame")
    if ftype == 0x01:
        n = body_len - 4
    else:
        n, hdr = _read_varint(head[4:14])
        if hdr < 0:
            raise ValueError("corrupt snappy block")
    if n > CHUNK:
        raise ValueError(f"snappy chunk of {n} B exceeds {CHUNK} B")
    return n


class FrameDecoder:
    """Incremental framed-stream decoder: feed() bytes, collect decoded()
    output as it becomes available. Whole data frames wait until a batch
    (BATCH_CHUNKS frames, or `batch_bytes` of bodies) is ready, then
    kernel F decodes the batch in one launch; finish() decodes the rest.
    A frame split across feed() calls, skippable chunks (0x80-0xfe) and
    the stream identifier alone are taken as minio_tpu takes them."""

    def __init__(self, device="cuda", batch_bytes: int = 8 << 20):
        self._codec = S2Batch(device)
        self._batch_bytes = batch_bytes
        self._buf = bytearray()
        self._pos = 0          # parsed up to here
        self._frames = []      # (type, body offset, body len, raw len)
        self._frame_bytes = 0
        self._out = bytearray()
        self._seen_header = False

    def _decode_pending(self) -> None:
        if not self._frames:
            del self._buf[:self._pos]
            self._pos = 0
            return
        raw, status = self._codec.decode_frames(
            memoryview(self._buf)[:self._pos], self._frames)
        pos = 0
        for (_, _, _, n), st in zip(self._frames, status):
            if st != STATUS_OK:
                self._frames = []
                raise ValueError(STATUS_MESSAGES[st])
            self._out += raw[pos:pos + n]
            pos += n
        self._frames = []
        self._frame_bytes = 0
        del self._buf[:self._pos]
        self._pos = 0

    def feed(self, data) -> None:
        self._buf += data
        while True:
            avail = len(self._buf) - self._pos
            if avail < 4:
                break
            p = self._pos
            ctype = self._buf[p]
            clen = int.from_bytes(self._buf[p + 1:p + 4], "little")
            if avail < 4 + clen:
                break
            if ctype == 0xFF:
                self._seen_header = True
            elif 0x80 <= ctype <= 0xFE:
                pass  # skippable, padding included
            elif ctype not in (0x00, 0x01):
                self._decode_pending()
                raise ValueError(f"unknown snappy frame type {ctype:#x}")
            else:
                try:
                    n = raw_length(ctype, bytes(self._buf[
                        p + 4:p + 4 + min(clen, 14)]), clen)
                except ValueError:
                    self._decode_pending()
                    raise
                self._frames.append((ctype, p + 4, clen, n))
                self._frame_bytes += clen
            self._pos = p + 4 + clen
            if (len(self._frames) >= BATCH_CHUNKS
                    or self._frame_bytes >= self._batch_bytes):
                self._decode_pending()

    def decoded(self) -> bytes:
        out = bytes(self._out)
        self._out.clear()
        return out

    def finish(self) -> bytes:
        self._decode_pending()
        if self._buf:
            raise ValueError("truncated snappy stream")
        return self.decoded()


def compress_stream(data, device="cuda") -> bytes:
    """One-shot framed compression (tests, tools)."""
    data = memoryview(data).cast("B")
    codec = S2Batch(device)
    parts = [STREAM_ID]
    step = BATCH_CHUNKS * CHUNK
    for off in range(0, len(data), step):
        piece = data[off:off + step]
        sizes = [min(CHUNK, len(piece) - o)
                 for o in range(0, len(piece), CHUNK)]
        crcs, blocks = codec.compress_chunks(piece, sizes)
        parts.append(frames_of(piece, sizes, crcs, blocks))
    return b"".join(parts)


def decompress_stream(data, device="cuda") -> bytes:
    dec = FrameDecoder(device)
    dec.feed(data)
    return dec.finish()
