"""Streaming HighwayHash256S bitrot framing, the counterpart of the
streaming half of minio_tpu/erasure/bitrot.py (the reference's
cmd/bitrot-streaming.go): each shard file is [H(chunk) || chunk]* with
32-byte HighwayHash-256 digests under MinIO's key.

HighwayHash256S is the one bitrot algorithm the port has
(`BitrotAlgorithm`); an object stamped with another one is refused, never
read unchecked. Every digest is computed on the writer's or reader's
device (kernel B on the card).

Two read paths:
- `read_chunks` reads and verifies one reader's fetch in place, with one
  launch over its full-size chunks and one for a short last chunk at its
  true length, never padded; only the index of the first bad chunk comes
  back. `bitrot_verify` and the drives' `verify_file` use it.
- `read_frames` reads the framed bytes into a slice of a fetch buffer
  that the caller (the erasure ParallelReader) owns, without a check;
  `verify_fetch` then checks every reader of the fetch in one grouped
  launch (and one more for a short last chunk), with one sync.
"""

from __future__ import annotations

from enum import Enum

import numpy as np
import torch

from ..ops.highwayhash_torch import (
    hash256_batch,
    verify_frames,
    verify_frames_grouped,
)
from ..ops.host_feed import count_h2d
from ..utils import ceil_frac
from ..utils.device import resolve_device
from ..utils.errors import ErrFileCorrupt, ErrLessData
from . import device_engine

DIGEST_SIZE = 32


class BitrotAlgorithm(Enum):
    """Bitrot algorithms by the names xl.meta stores (cmd/bitrot.go).
    minio_tpu also reads sha256, blake2b and whole-file highwayhash256;
    the port does not have them yet."""

    HIGHWAYHASH256S = "highwayhash256S"

    @classmethod
    def default(cls) -> "BitrotAlgorithm":
        return cls.HIGHWAYHASH256S

    @classmethod
    def from_string(cls, s: str) -> "BitrotAlgorithm":
        for a in cls:
            if a.value == s:
                return a
        raise ValueError(f"unsupported bitrot algorithm {s!r}")


def bitrot_shard_file_size(size: int, shard_size: int) -> int:
    """On-disk size of a shard file with interleaved digests
    (cmd/bitrot.go bitrotShardFileSize)."""
    if size < 0:
        return -1
    return ceil_frac(size, shard_size) * DIGEST_SIZE + size


def bitrot_stream_offset(offset: int, shard_size: int) -> int:
    """Physical offset in the framed stream of a logical shard offset that
    is a multiple of shard_size (cmd/bitrot-streaming.go)."""
    return (offset // shard_size) * DIGEST_SIZE + offset


def _digests(chunks: np.ndarray, device) -> np.ndarray:
    """HighwayHash-256 of the rows of a uint8 [n, L] array on `device`."""
    if not chunks.flags.writeable:  # torch refuses to wrap read-only memory
        chunks = chunks.copy()
    dev = torch.from_numpy(chunks)
    if device.type == "cuda":
        count_h2d(False, dev.numel())
    dev = dev.to(device)
    device_engine.count("launches_hash")
    return hash256_batch(dev).cpu().numpy()


def _n_full(lengths: list[int], shard_size: int) -> int:
    """How many leading chunks are full-size: they lie at a fixed pitch
    and verify in one launch; a short last chunk takes a second."""
    n = 0
    while n < len(lengths) and lengths[n] == shard_size:
        n += 1
    return n


def _verify_frames(buf: np.ndarray, lengths: list[int], shard_size: int,
                   device) -> list[memoryview]:
    """Check the framed chunks of `buf` ([digest || chunk] per length)
    and return a view of each chunk. The frames are hashed in place on
    `device`: the leading chunks of shard_size bytes in one batch, a short
    last chunk on its own at its true length. Each check returns only the
    index of the first bad chunk."""
    offs, off = [], 0
    for ln in lengths:
        offs.append(off)
        off += DIGEST_SIZE + ln
    n_full = _n_full(lengths, shard_size)
    dev = torch.from_numpy(buf)
    if device.type == "cuda":
        count_h2d(False, dev.numel())
    dev = dev.to(device)
    if n_full:
        device_engine.count("launches_hash")
        bad = verify_frames(dev[: n_full * (DIGEST_SIZE + shard_size)],
                            n_full, shard_size)
        if bad >= 0:
            raise ErrFileCorrupt(f"streaming bitrot mismatch chunk {bad}")
    for i in range(n_full, len(lengths)):
        o, ln = offs[i], lengths[i]
        device_engine.count("launches_hash")
        if verify_frames(dev[o: o + DIGEST_SIZE + ln], 1, ln) >= 0:
            raise ErrFileCorrupt(f"streaming bitrot mismatch chunk {i}")
    mv = memoryview(buf)
    return [mv[o + DIGEST_SIZE: o + DIGEST_SIZE + ln]
            for o, ln in zip(offs, lengths)]


def verify_fetch(rows: np.ndarray, lengths: list[int], shard_size: int,
                 device) -> np.ndarray:
    """Check a fetch of several shard readers at once: row g of `rows`
    ([G, phys], one reader's frames [digest || chunk] per length) is
    group g. The rows go to `device` in one copy (asynchronous from a
    pinned fetch buffer); kernel B checks the leading full-size chunks of
    every group in one grouped launch and a short last chunk, at its
    true length, in a second; both answers come back with one sync.
    Returns, per group, the index of its first bad chunk, or -1."""
    n_groups, phys = rows.shape
    n_full = _n_full(lengths, shard_size)
    t = torch.from_numpy(rows).reshape(-1)
    if device.type == "cuda":
        pinned = t.is_pinned()
        count_h2d(pinned, t.numel())
        t = t.to(device, non_blocking=pinned)
    answers = []
    if n_full:
        device_engine.count("launches_hash")
        device_engine.count("launches_verify")
        full = verify_frames_grouped(t, n_groups, phys, n_full, shard_size)
        answers.append(torch.where(full < n_full, full, len(lengths)))
    if n_full < len(lengths):
        device_engine.count("launches_hash")
        device_engine.count("launches_verify_tail")
        tail = verify_frames_grouped(t, n_groups, phys, 1, lengths[n_full],
                                     offset=n_full * (DIGEST_SIZE
                                                      + shard_size))
        answers.append(torch.where(tail < 1, n_full, len(lengths)))
    if not answers:
        return np.full(n_groups, -1, dtype=np.int64)
    first = torch.stack(answers).min(dim=0).values.cpu().numpy()
    return np.where(first >= len(lengths), -1, first)


class StreamingBitrotWriter:
    """Writes [H(chunk) || chunk] per chunk into a byte sink."""

    def __init__(self, sink, device="cuda"):
        self._sink = sink
        self.device = resolve_device(device)
        self.bytes_written = 0

    @property
    def device_hashable(self) -> bool:
        """The drivers may hand this writer digests computed with the
        batch (write_with_digest): its algorithm is HighwayHash256S."""
        return True

    def write(self, chunk) -> int:
        """Frame one chunk, hashing it on the writer's device."""
        arr = np.frombuffer(memoryview(chunk), dtype=np.uint8)
        if arr.size == 0:
            return 0
        return self.write_with_digest(arr, _digests(arr[None],
                                                    self.device)[0])

    def write_with_digest(self, chunk, digest) -> int:
        """Frame a chunk whose digest was computed with its batch."""
        chunk = memoryview(chunk).cast("B")
        if len(chunk) == 0:
            return 0
        self._sink.write(memoryview(digest).cast("B"))
        self._sink.write(chunk)
        self.bytes_written += len(chunk)
        return len(chunk)

    def close(self):
        if hasattr(self._sink, "close"):
            self._sink.close()


class StreamingBitrotReader:
    """Sequential, chunk-aligned reads with verification, mirroring the
    reference's streamingBitrotReader.

    `open_stream(stream_offset, length)` returns a binary stream with
    readinto() positioned at the physical byte range (a local file, a
    BytesIO); it may raise ErrFileNotFound for a missing shard."""

    # Set by the caller when the stream is a local file or an in-memory
    # buffer: on a one-core host the ParallelReader reads such readers
    # inline instead of through the I/O pool.
    local = False

    def __init__(self, open_stream, till_offset: int, shard_size: int,
                 device="cuda"):
        self._open = open_stream
        self._shard_size = shard_size
        self.device = resolve_device(device)
        # Physical end offset including the digest framing.
        self._till = (ceil_frac(till_offset, shard_size) * DIGEST_SIZE
                      + till_offset)
        self._rc = None
        self._curr = 0

    def _start(self, offset: int) -> None:
        if offset % self._shard_size != 0:
            raise ValueError("offset must be shard-aligned")
        if self._rc is None:
            self._curr = offset
            stream_off = bitrot_stream_offset(offset, self._shard_size)
            self._rc = self._open(stream_off, self._till - stream_off)
        if offset != self._curr:
            raise ValueError("non-sequential bitrot read")

    def _read_into(self, out: np.ndarray) -> None:
        view = memoryview(out).cast("B")
        n = len(view)
        got = 0
        while got < n:
            k = self._rc.readinto(view[got:])
            if not k:
                break
            got += k
        if got != n:
            raise ErrFileCorrupt("short framed read")

    def read_at(self, offset: int, length: int) -> memoryview:
        """Read and verify one chunk."""
        return self.read_chunks(offset, [length])[0]

    def read_chunks(self, offset: int, lengths: list[int]) -> list:
        """Read and verify consecutive chunks with one underlying read and
        one hash launch over the full-size chunks. Returns a memoryview
        per chunk."""
        if not lengths:
            return []
        self._start(offset)
        buf = np.empty(sum(lengths) + DIGEST_SIZE * len(lengths),
                       dtype=np.uint8)
        self._read_into(buf)
        out = _verify_frames(buf, lengths, self._shard_size, self.device)
        self._curr += sum(lengths)
        return out

    def read_frames(self, offset: int, lengths: list[int],
                    out: np.ndarray) -> None:
        """Read the framed bytes of consecutive chunks ([digest || chunk]
        per length) into `out`, a writable uint8 array of exactly that
        size, without a check: the caller verifies them (verify_fetch)
        before it uses a byte."""
        want = sum(lengths) + DIGEST_SIZE * len(lengths)
        if out.size != want:
            raise ValueError(f"fetch slot holds {out.size} B, frames {want}")
        if not lengths:
            return
        self._start(offset)
        self._read_into(out)
        self._curr += sum(lengths)

    def close(self):
        if self._rc is not None and hasattr(self._rc, "close"):
            self._rc.close()
        self._rc = None


def bitrot_verify(stream, want_size: int, part_size: int, shard_size: int,
                  device="cuda") -> None:
    """Verify a whole framed shard stream (cmd/bitrot.go bitrotVerify).
    Raises ErrFileCorrupt on a size or digest mismatch and ErrLessData on
    a short stream."""
    if want_size != bitrot_shard_file_size(part_size, shard_size):
        raise ErrFileCorrupt("bitrot file size mismatch")
    data = bytearray(stream.read(want_size))
    if len(data) != want_size:
        raise ErrLessData("short shard stream")
    n_full, tail = divmod(part_size, shard_size)
    lengths = [shard_size] * n_full + ([tail] if tail else [])
    _verify_frames(np.frombuffer(data, dtype=np.uint8), lengths, shard_size,
                   resolve_device(device))
