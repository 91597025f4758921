"""Device codec for the erasure hot path, the counterpart of
minio_tpu/erasure/device_engine.py.

Each [B, k, S] batch is staged onto the device once and runs kernel A
(the GF apply) then kernel B (HighwayHash-256 of every shard chunk) back
to back on the calling thread's current stream. A batch the pipelined
PUT staged on its copy stream (ops.host_feed.HostFeed) arrives as a
`Staged` item: the compute stream waits on its event on the device, and
the tensor is recorded on that stream for the caching allocator. The
parity matrix and each (present, targets) reconstruction matrix stay
cached on the device. A sub-packetized codec (msr-pm) addresses
alpha sub-shards a shard: the contiguous [B, K, S] batch is viewed as
[B, K*alpha, S/alpha] for kernel A, whose [B, R*alpha, S/alpha] output
is viewed back as [B, R, S] (both views cost nothing); kernel B hashes
whole shards either way. The outputs
come back by a non_blocking copy into pinned host tensors behind a
recorded CUDA event: the returned handles wait on that event before they
hand out numpy, so the host can fan out the writes of batch N-1 while
batch N computes.

STATS counts, per process:
  dispatches     batches sent to the device
  async_d2h      outputs whose host copy was queued asynchronously
  launches_gf    GF applications issued (kernel A on the card)
  launches_hash  digest computations issued (kernel B on the card), the
                 bitrot writers' and readers' included
  launches_verify       grouped verifies of a reader fetch's full-size
                        chunks (one a fetch; part of launches_hash)
  launches_verify_tail  grouped verifies of a fetch's short last chunk
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from ..ops import gf
from ..ops.highwayhash_torch import hash256_batch
from ..ops.host_feed import Staged, count_h2d
from ..ops.rs import apply_gf_matrix
from ..utils.device import resolve_device
from ..utils.errors import ErrShardSize
from . import registry

STATS = {"dispatches": 0, "async_d2h": 0, "launches_gf": 0,
         "launches_hash": 0, "launches_verify": 0, "launches_verify_tail": 0}
_stats_lock = threading.Lock()


def count(name: str, n: int = 1) -> None:
    with _stats_lock:
        STATS[name] += n


def stats_snapshot() -> dict:
    with _stats_lock:
        return dict(STATS)


def reset_stats() -> None:
    with _stats_lock:
        for k in STATS:
            STATS[k] = 0


class HostResult:
    """A device output on its way to host memory. `np.asarray(handle)`
    (or `.numpy()`) waits for the copy's event, then returns the bytes."""

    __slots__ = ("_host", "_event")

    def __init__(self, host: torch.Tensor, event):
        self._host = host
        self._event = event

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return self._host.numpy()

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr if dtype is None else arr.astype(dtype, copy=False)


def _to_host(outs: list[torch.Tensor]) -> list[HostResult]:
    """Queue the device->host copy of every output (pinned, non_blocking)
    and record one event after them."""
    if outs[0].device.type == "cpu":
        return [HostResult(t, None) for t in outs]
    hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
             for t in outs]
    for h, t in zip(hosts, outs):
        h.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    # The stream of the outputs' device on this thread (a stage thread's
    # current device need not be theirs).
    event.record(torch.cuda.current_stream(outs[0].device))
    count("async_d2h", len(outs))
    return [HostResult(h, event) for h in hosts]


class DeviceCodec:
    """Encode/reconstruct dispatcher for one (k, m, codec, device).
    Obtain through `for_geometry`, whose cache keeps the matrices on the
    device across calls."""

    def __init__(self, data_blocks: int, parity_blocks: int,
                 codec: str = registry.DEFAULT_CODEC, device="cuda"):
        self.k = data_blocks
        self.m = parity_blocks
        self.device = resolve_device(device)
        self.codec_id = codec
        self._entry = registry.get(codec)
        self.alpha = self._entry.alpha(self.k, self.m)
        self._lock = threading.Lock()
        self._mats: dict = {}  # key -> device bit-matrix
        self._parity = self._bitmat(
            "parity", lambda: self._entry.parity_matrix(self.k, self.m))

    def _bitmat(self, key, make_bytes) -> torch.Tensor:
        with self._lock:
            mat = self._mats.get(key)
        if mat is not None:
            return mat
        mat = gf.to_device_bitmat(gf.bit_matrix_for(make_bytes()),
                                  self.device)
        with self._lock:
            return self._mats.setdefault(key, mat)

    def _stage(self, blocks) -> torch.Tensor:
        """[B, k, S] uint8 -> contiguous on the device, ready for work
        on the current stream. A `Staged` item (the pipeline's HostFeed)
        is consumed: the stream waits on its copy's event. A host array
        or tensor is copied here, asynchronously when it is pinned. The
        kernels only read it, so the caller's buffer stays intact."""
        if isinstance(blocks, Staged):
            t = blocks.consume()
        elif isinstance(blocks, torch.Tensor):
            t = blocks
        else:
            t = torch.from_numpy(np.ascontiguousarray(blocks, dtype=np.uint8))
        if t.dtype != torch.uint8 or t.dim() != 3:
            raise ValueError(f"want uint8 [B, k, S], got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.device.type == "cpu" and self.device.type == "cuda":
            pinned = t.is_pinned()
            count_h2d(pinned, t.numel())
            return t.to(self.device, non_blocking=pinned).contiguous()
        return t.to(self.device).contiguous()

    def _apply(self, bitmat, dev: torch.Tensor) -> torch.Tensor:
        """Kernel A on [B, K, S] shards on the device -> [B, R, S], in the
        sub-shard view when alpha > 1."""
        a = self.alpha
        if a > 1:
            b, k, s = dev.shape
            if s % a:
                raise ErrShardSize(
                    f"shard length {s} not a multiple of sub-packetization "
                    f"{a} for codec {self.codec_id!r}")
            dev = dev.view(b, k * a, s // a)
        out = apply_gf_matrix(bitmat, dev)
        count("launches_gf")
        if a > 1:
            out = out.view(out.shape[0], out.shape[1] // a, -1)
        return out

    @staticmethod
    def _finish(out, hash_input_of):
        """Digest the output if asked (kernel B), then queue the copies
        of both to the host."""
        if hash_input_of is None:
            return _to_host([out])[0], None
        digests = hash256_batch(hash_input_of(out))
        count("launches_hash")
        out_h, dig_h = _to_host([out, digests])
        return out_h, dig_h

    def encode_async(self, blocks, with_hashes: bool):
        """blocks [B, k, S] (a host array, a tensor, or a `Staged` item
        from the HostFeed) -> (parity [B, m, S], digests [B, k+m, 32] or
        None) as HostResult handles with their copies in flight."""
        dev = self._stage(blocks)
        if dev.shape[1] != self.k:
            raise ValueError(f"want {self.k} data shards, got {dev.shape[1]}")
        hash_in = (lambda parity: torch.cat([dev, parity], dim=1)) \
            if with_hashes else None
        count("dispatches")
        registry.note_dispatch(self.codec_id, "device")
        return self._finish(self._apply(self._parity, dev), hash_in)

    def reconstruct_async(self, src, present, targets,
                          with_hashes: bool = False):
        """Rebuild `targets` from the first k `present` shards: src
        [B, k, S] (rows in present[:k] order; a host array, a tensor or a
        `Staged` item) -> (rebuilt [B, T, S], digests [B, T, 32] or None)
        as HostResult handles."""
        present = tuple(present[: self.k])
        targets = tuple(targets)
        bitmat = self._bitmat(
            ("rec", present, targets),
            lambda: self._entry.reconstruct_matrix(
                self.k, self.m, list(present), list(targets)))
        dev = self._stage(src)
        count("dispatches")
        registry.note_dispatch(self.codec_id, "device")
        return self._finish(self._apply(bitmat, dev),
                            (lambda out: out) if with_hashes else None)

    def repair_async(self, target: int, matrix, symbols,
                     with_hashes: bool = False):
        """Rebuild shard `target` of nb blocks from its repair symbols
        (erasure/repair.py): symbols [nb, T, S/alpha] in the plan's order
        (a host array, a tensor or a `Staged` item), `matrix` the plan's
        [alpha, T] byte matrix -> (chunks [nb, 1, S], digests [nb, 1, 32]
        or None) as HostResult handles. The symbols are sub-shards
        already, so kernel A takes them as they are."""
        bitmat = self._bitmat(("repair", target), lambda: matrix)
        dev = self._stage(symbols)
        count("dispatches")
        registry.note_dispatch(self.codec_id, "device")
        out = apply_gf_matrix(bitmat, dev)
        count("launches_gf")
        return self._finish(out.view(out.shape[0], 1, -1),
                            (lambda o: o) if with_hashes else None)


@functools.lru_cache(maxsize=64)
def _for_geometry(data_blocks: int, parity_blocks: int, codec: str,
                  device: torch.device) -> DeviceCodec:
    return DeviceCodec(data_blocks, parity_blocks, codec, device)


def for_geometry(data_blocks: int, parity_blocks: int,
                 codec: str = registry.DEFAULT_CODEC,
                 device="cuda") -> DeviceCodec:
    """The (geometry, codec, device)-keyed codec cache: every PUT, GET and
    heal of one erasure set shares its device matrices."""
    return _for_geometry(data_blocks, parity_blocks, codec,
                         resolve_device(device))
