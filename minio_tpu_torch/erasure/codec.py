"""Erasure codec, the counterpart of minio_tpu/erasure/codec.py (itself
the reference's `Erasure`, cmd/erasure-coding.go).

Shard geometry, split semantics and the empty/all-missing early-outs are
the reference's. A sub-packetized codec (msr-pm, alpha sub-shards a
shard) rounds every shard length up to a multiple of alpha, as
minio_tpu does. Every GF application, the ragged tail block included,
runs through the device engine on the codec's device, which applies the
sub-shard view around kernel A: the port has no host engine to hand
small work to.
"""

from __future__ import annotations

import functools

import numpy as np

from ..pipeline.buffers import host_buffer
from ..utils import ceil_frac
from ..utils.device import resolve_device
from ..utils.errors import (
    ErrInvShardNum,
    ErrMaxShardNum,
    ErrReconstructRequired,
    ErrShardSize,
    ErrShortData,
    ErrTooFewShards,
)
from . import device_engine, registry


def cached_erasure(data_blocks: int, parity_blocks: int, block_size: int,
                   codec: str = registry.DEFAULT_CODEC,
                   device="cuda") -> "Erasure":
    """The Erasure of one (geometry, codec, device), shared by every PUT,
    GET and heal of an erasure set, so its device matrices are made once
    (minio_tpu's cached_erasure, keyed by device too)."""
    return _cached_erasure(data_blocks, parity_blocks, block_size, codec,
                           resolve_device(device))


@functools.lru_cache(maxsize=64)
def _cached_erasure(data_blocks, parity_blocks, block_size, codec, device):
    return Erasure(data_blocks, parity_blocks, block_size, codec, device)


class Erasure:
    """Erasure coding for one (data, parity, block_size, codec) geometry
    on one device."""

    def __init__(self, data_blocks: int, parity_blocks: int,
                 block_size: int, codec: str = registry.DEFAULT_CODEC,
                 device="cuda"):
        # Parameter checks mirror NewErasure (cmd/erasure-coding.go).
        if data_blocks <= 0 or parity_blocks <= 0:
            raise ErrInvShardNum(
                f"data={data_blocks} parity={parity_blocks} must be > 0"
            )
        entry = registry.get(codec)  # loud on unknown codec ids
        if data_blocks + parity_blocks > entry.max_shards:
            raise ErrMaxShardNum(
                f"data+parity={data_blocks + parity_blocks} exceeds "
                f"{entry.max_shards}"
            )
        if not entry.geometry_ok(data_blocks, parity_blocks):
            raise ErrInvShardNum(
                f"codec {codec!r} does not support geometry "
                f"{data_blocks}+{parity_blocks}"
            )
        self.data_blocks = data_blocks
        self.parity_blocks = parity_blocks
        self.block_size = block_size
        self.total_shards = data_blocks + parity_blocks
        self.codec_id = codec
        # Sub-packetization: shard lengths are multiples of alpha.
        self.subshards = entry.alpha(data_blocks, parity_blocks)
        self.matrix = entry.coding_matrix(data_blocks, parity_blocks)
        self.engine = device_engine.for_geometry(data_blocks, parity_blocks,
                                                 codec, device)
        self.device = self.engine.device

    # --- geometry (cmd/erasure-coding.go:120-149) ---

    def chunk_size(self, block_len: int) -> int:
        """Shard length of a block of `block_len` bytes: its split into k,
        rounded up to the codec's sub-packetization. The pad must be on
        disk: a sub-packetized parity byte depends on data columns past
        the block's end."""
        return self._round_shard(ceil_frac(block_len, self.data_blocks))

    def _round_shard(self, size: int) -> int:
        a = self.subshards
        return ceil_frac(size, a) * a if a > 1 else size

    def shard_size(self) -> int:
        """Actual shard size from the erasure blockSize."""
        return self.chunk_size(self.block_size)

    def shard_file_size(self, total_length: int) -> int:
        """Final erasure size on each disk from the original object size."""
        if total_length == 0:
            return 0
        if total_length == -1:
            return -1
        num_shards = total_length // self.block_size
        last_shard_size = self.chunk_size(total_length % self.block_size)
        return num_shards * self.shard_size() + last_shard_size

    def shard_file_offset(self, start_offset: int, length: int,
                          total_length: int) -> int:
        """Effective per-shard offset where erasure reading ends."""
        shard_size = self.shard_size()
        shard_file_size = self.shard_file_size(total_length)
        end_shard = (start_offset + length) // self.block_size
        till_offset = end_shard * shard_size + shard_size
        return min(till_offset, shard_file_size)

    # --- split / encode ---

    def split(self, data) -> list[np.ndarray]:
        """Split data into k zero-padded data shards plus m empty parity
        shard buffers, matching reedsolomon.Encoder.Split."""
        data = np.frombuffer(memoryview(data), dtype=np.uint8)
        if data.size == 0:
            raise ErrShortData("cannot split empty data")
        per_shard = self.chunk_size(data.size)
        padded = np.zeros(self.total_shards * per_shard, dtype=np.uint8)
        padded[: data.size] = data
        return list(padded.reshape(self.total_shards, per_shard))

    def encode_data(self, data) -> list[np.ndarray]:
        """Split + encode one block into k+m shards; empty input gives
        k+m empty shards (cmd/erasure-coding.go:77-79)."""
        data = np.frombuffer(memoryview(data), dtype=np.uint8)
        if data.size == 0:
            return [np.zeros(0, dtype=np.uint8)
                    for _ in range(self.total_shards)]
        shards = self.split(data)
        parity, _ = self.engine.encode_async(
            np.stack(shards[: self.data_blocks])[None], with_hashes=False)
        parity = np.asarray(parity)[0]
        for i in range(self.parity_blocks):
            shards[self.data_blocks + i] = parity[i]
        return shards

    def encode_batch_async(self, blocks, with_hashes: bool):
        """blocks [B, k, S] -> (parity [B, m, S], digests [B, k+m, 32] or
        None), both in flight to the host: np.asarray on either waits for
        its bytes (device_engine.HostResult)."""
        return self.engine.encode_async(blocks, with_hashes)

    # --- reconstruct / decode (cmd/erasure-coding.go:95-118) ---

    def decode_data_blocks(self, shards: list) -> list:
        """Reconstruct only missing data shards in place. A no-op when no
        shard is missing, or for a one-entry list whose only shard is
        missing (the reference's counting breaks at the first miss)."""
        is_zero = 0
        for b in shards:
            if b is None or len(b) == 0:
                is_zero = 1
                break
        if is_zero == 0 or is_zero == len(shards):
            return shards
        return self._reconstruct(shards, data_only=True)

    def decode_data_and_parity_blocks(self, shards: list) -> list:
        """Reconstruct all missing shards (data and parity)."""
        if len(shards) != self.total_shards:
            raise ErrTooFewShards(
                f"got {len(shards)} shards, want {self.total_shards}"
            )
        if all(b is not None and len(b) for b in shards):
            return shards
        return self._reconstruct(shards, data_only=False)

    def _present(self, shards: list) -> list[int]:
        if len(shards) != self.total_shards:
            raise ErrTooFewShards(
                f"got {len(shards)} shards, want {self.total_shards}"
            )
        present = [i for i, b in enumerate(shards)
                   if b is not None and len(b) > 0]
        if len(present) < self.data_blocks:
            raise ErrTooFewShards(
                f"{len(present)} shards present, need {self.data_blocks}"
            )
        shard_len = len(shards[present[0]])
        if any(len(shards[i]) != shard_len for i in present):
            raise ErrShardSize("present shards differ in size")
        return present

    def _rebuild(self, shards: list, present: list[int],
                 targets: list[int]) -> np.ndarray:
        rows = [np.frombuffer(memoryview(shards[i]), dtype=np.uint8)
                for i in present[: self.data_blocks]]
        # Gathered straight into a pinned buffer on the card, so the
        # survivors' copy to the device is asynchronous.
        src = host_buffer((len(rows), len(rows[0])), self.device)
        np.stack(rows, out=src)
        try:
            out, _ = self.engine.reconstruct_async(src[None], present,
                                                   targets)
        except ValueError as exc:
            # A singular survivor submatrix: not enough independent shards.
            raise ErrTooFewShards(str(exc)) from exc
        return np.asarray(out)[0]

    def _reconstruct(self, shards: list, data_only: bool) -> list:
        present = self._present(shards)
        present_set = set(present)
        missing = [i for i in range(self.total_shards)
                   if i not in present_set
                   and (not data_only or i < self.data_blocks)]
        if not missing:
            return shards
        out = self._rebuild(shards, present, missing)
        for t_i, t in enumerate(missing):
            shards[t] = out[t_i]
        return shards

    def reconstruct_targets(self, shards: list,
                            targets: list[int]) -> list[np.ndarray]:
        """Regenerate exactly `targets` from >= k present shards without
        mutating the input list (the heal path)."""
        present = self._present(shards)
        out = self._rebuild(shards, present, list(targets))
        return [out[i] for i in range(len(targets))]

    def join(self, shards: list, out_size: int) -> bytes:
        """Concatenate data shards and trim padding (reedsolomon.Join)."""
        if len(shards) < self.data_blocks:
            raise ErrTooFewShards("not enough shards to join")
        for i in range(self.data_blocks):
            if shards[i] is None or len(shards[i]) == 0:
                raise ErrReconstructRequired(f"data shard {i} missing")
        data = np.concatenate(
            [np.frombuffer(memoryview(shards[i]), dtype=np.uint8)
             for i in range(self.data_blocks)]
        )
        if data.size < out_size:
            raise ErrShortData("shards hold less data than requested")
        return data[:out_size].tobytes()
