"""The repair plane: a heal of ONE stale shard under a regenerating codec
(ops/regen.py through the codec registry) that reads only beta-slices of
the survivors, the port's copy of minio_tpu/erasure/repair.py.

The dense heal (streaming.heal_stream) reads k whole surviving shards to
rebuild one: k bytes read per byte healed. A regenerating codec's repair
plan reads only beta = alpha/m sub-shards from each of the n-1
survivors, (n-1)/m bytes per byte healed (1.75 at 4+4 against dense's
4).

A survivor's shard file is a sequence of bitrot frames [digest || chunk],
the chunk being the alpha-rounded shard of one block
(codec.Erasure.shard_size(); the last block's may be shorter), so
sub-shard j of block b lies at b*(digest + shard) + digest +
j*(chunk/alpha). The healer fans the plan's (helper -> sub-shards) reads
over the survivors (`read_repair_symbol`), stacks the slices in the
plan's symbol order and applies the plan's [alpha, sum(beta)] repair
matrix with kernel A on the erasure's device (device_engine
.repair_async, its plain version on the CPU), which also takes the
rebuilt chunks' digests with kernel B.

Repair reads check no digest: a slice cannot be checked without reading
its whole chunk, which would cancel the saving. The rebuilt shard gets
fresh digests, and a corrupt survivor shows on its next verified read.

What this plane cannot serve raises RepairUnavailable, with a reason,
and the heal falls back to the dense path (the same bytes either way);
so does a drive error. A CUDA error is not a reason to fall back: the
dense path would run the same kernel, so it propagates.

STATS counts, per process:
  parts_repaired      parts rebuilt by the repair plane
  fallbacks           repairs that fell back to the dense heal, and by
  fallback_<reason>   reason (disabled, no_plan, helper_missing,
                      short_read, drive_error)
  bytes_read          repair symbol bytes read from the survivors
  bytes_written       shard bytes rebuilt (without digests)
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from ..pipeline.buffers import host_buffer
from . import registry

# Concurrent survivor reads a repair; the plan has n-1 helpers, so this
# binds only wide geometries.
_MAX_FANOUT = 8

# Gathered repair symbols a window (bytes): bounds memory, not
# correctness.
_WINDOW_BYTES = 4 << 20

FALLBACK_REASONS = ("disabled", "no_plan", "helper_missing", "short_read",
                    "drive_error")

_stats_lock = threading.Lock()
STATS = {"parts_repaired": 0, "fallbacks": 0,
         **{f"fallback_{r}": 0 for r in FALLBACK_REASONS},
         "bytes_read": 0, "bytes_written": 0}


def record_stat(name: str, n: int = 1) -> None:
    with _stats_lock:
        STATS[name] += n


def stats_snapshot() -> dict:
    with _stats_lock:
        return dict(STATS)


def reset_stats() -> None:
    with _stats_lock:
        for k in STATS:
            STATS[k] = 0


def note_fallback(reason: str) -> None:
    """Count one repair that fell back to the dense heal."""
    with _stats_lock:
        STATS["fallbacks"] += 1
        STATS[f"fallback_{reason}"] += 1


class RepairUnavailable(Exception):
    """The repair plane cannot serve this heal; use the dense path.
    `reason` is one of FALLBACK_REASONS."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


def enabled() -> bool:
    """MTPU_REPAIR=0 sends every heal down the dense path (default "1");
    read at each heal."""
    return os.environ.get("MTPU_REPAIR", "1") == "1"


@dataclass(frozen=True)
class SymbolSource:
    """Where one survivor's repair symbols live: a StorageAPI drive, the
    shard file, and the bitrot frame's digest size."""

    disk: object
    volume: str
    path: str
    digest_size: int


def plan_for(erasure, target: int):
    """The codec's repair plan for shard `target`, or None when it has
    none (dense codecs; piggyback parity shards)."""
    entry = registry.get(erasure.codec_id)
    if entry.repair_plan is None:
        return None
    return entry.repair_plan(erasure.data_blocks, erasure.parity_blocks,
                             target)


def repair_part(erasure, target: int, sources: list, writer,
                part_size: int) -> int:
    """Rebuild shard `target` of one part onto `writer` (a
    StreamingBitrotWriter) from the plan's beta-slices. `sources` maps
    shard index -> SymbolSource (None at `target`; every helper the plan
    names must be there). Returns the shard bytes written. Raises
    RepairUnavailable when the plan cannot serve this part."""
    if not enabled():
        raise RepairUnavailable("disabled",
                                "repair plane disabled (MTPU_REPAIR=0)")
    plan = plan_for(erasure, target)
    if plan is None:
        raise RepairUnavailable(
            "no_plan", f"codec {erasure.codec_id!r} has no repair plan for "
            f"shard {target}")
    for helper, _subs in plan.reads:
        if sources[helper] is None:
            raise RepairUnavailable(
                "helper_missing", f"survivor shard {helper} unavailable "
                f"(the plan needs all {len(plan.reads)} helpers)")
    if part_size <= 0:
        return 0

    shard = erasure.shard_size()
    full_blocks = part_size // erasure.block_size
    tail_chunk = erasure.shard_file_size(part_size) - full_blocks * shard
    # Windows of one chunk length (one kernel launch takes one sub-shard
    # length): full blocks in runs bounded by _WINDOW_BYTES, then the
    # shorter last block alone.
    windows: list[list[tuple[int, int]]] = []
    if full_blocks:
        per_block = plan.total_symbols * (shard // plan.alpha)
        step = max(1, _WINDOW_BYTES // per_block)
        for lo in range(0, full_blocks, step):
            windows.append([(b, shard)
                            for b in range(lo, min(full_blocks, lo + step))])
    if tail_chunk:
        windows.append([(full_blocks, tail_chunk)])

    hashed = getattr(writer, "device_hashable", False)
    written = 0
    with ThreadPoolExecutor(max_workers=min(len(plan.reads), _MAX_FANOUT),
                            thread_name_prefix="mtpu-repair") as pool:
        for window in windows:
            x = _gather(plan, sources, shard, window, pool, erasure.device)
            chunks_h, digests_h = _apply(erasure, plan, x, hashed)
            chunks = np.asarray(chunks_h)
            digests = np.asarray(digests_h) if hashed else None
            for i in range(len(window)):
                if hashed:
                    written += writer.write_with_digest(chunks[i, 0],
                                                        digests[i, 0])
                else:
                    written += writer.write(chunks[i, 0])
    record_stat("bytes_written", written)
    record_stat("parts_repaired")
    return written


def _gather(plan, sources: list, shard: int, window: list[tuple[int, int]],
            pool, device) -> np.ndarray:
    """Fan the window's beta-slice reads over the plan's helpers, one
    read_repair_symbol call a helper, into [nb, total_symbols, sub_len]
    in the plan's symbol order (a pinned buffer on the card)."""
    nb = len(window)
    sub_len = window[0][1] // plan.alpha
    x = host_buffer((nb, plan.total_symbols, sub_len), device)
    futs = []
    col = 0
    for helper, subs in plan.reads:
        src = sources[helper]
        futs.append((pool.submit(
            src.disk.read_repair_symbol, src.volume, src.path,
            stride=src.digest_size + shard, digest_size=src.digest_size,
            alpha=plan.alpha, subs=list(subs), blocks=window),
            col, len(subs)))
        col += len(subs)
    for fut, c0, nsub in futs:
        data = fut.result()
        if len(data) != nb * nsub * sub_len:
            raise RepairUnavailable(
                "short_read", f"repair symbol read returned {len(data)} "
                f"bytes, expected {nb * nsub * sub_len}")
        x[:, c0:c0 + nsub, :] = np.frombuffer(
            data, dtype=np.uint8).reshape(nb, nsub, sub_len)
        record_stat("bytes_read", len(data))
    return x


def _apply(erasure, plan, x: np.ndarray, with_hashes: bool):
    """[alpha, total_symbols] repair matrix x [nb, total_symbols, sub_len]
    symbols -> (the target's chunks [nb, 1, chunk], their digests or
    None), kernel A (and kernel B) on the erasure's device."""
    return erasure.engine.repair_async(plan.target, plan.matrix, x,
                                       with_hashes)
