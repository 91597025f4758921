"""Streaming erasure drivers, the counterpart of minio_tpu/erasure/
streaming.py (the reference's cmd/erasure-encode.go, erasure-decode.go
and erasure-lowlevel-heal.go).

Each path has a pipelined driver and a serial one; as in minio_tpu, only
the host decides between them (`utils.fanout.SINGLE_CORE`, read at each
call), never an error:

- PUT: `encode_stream` gathers `batch_blocks` blocks into one [B, k, S]
  batch a dispatch (kernel A for the parity, kernel B for the digests of
  all k+m shard chunks). On a multi-core host the stages md5 -> pack
  (into a pinned pooled buffer) -> h2d (HostFeed, a copy stream) ->
  dispatch -> flush-write run overlapped (`queue_depth=1`); a stream
  that fits in one gather runs the same stages inline. On one core the
  serial driver double-buffers: batch N computes while N-1 is written.
  The ragged tail block is a batch of its own on the card in both.
- GET: `decode_stream` reads k-of-n chunks through `ParallelReader`,
  reconstructs missing data shards and writes the range. More than 2
  blocks on a multi-core host run a shard-read stage and a decode stage
  (`queue_depth=2`) with the client write on the caller's thread;
  otherwise the block loop is serial and recycles its fetch buffers.
- heal: `heal_stream` batches survivor blocks per failure pattern into
  fused reconstruct + digest dispatches (minio_tpu's _heal_stream_fused)
  and writes only the stale shards; dispatch N overlaps the writes of
  batch N-1.

Fan-out: `ParallelWriter` writes a block's shards at once on `_io_pool`
and returns at write quorum plus a grace period, detaching stragglers;
`ParallelReader` fires k reads at once, escalates to spare readers on
failure, hedges a stalled fetch and parks stragglers. Its threads only
read files: the fetch's frames land in one pinned buffer, and every
reader of the fetch is verified in one grouped kernel B launch.

minio_tpu's worker pool, admission slots, host-native strip drivers and
mesh drivers are not ported yet.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..observability import carry as obs_carry
from ..observability import ioflow, spans
from ..ops.host_feed import HostFeed
from ..pipeline import (
    SKIP,
    Pipeline,
    Stage,
    copy_add,
    host_buffer,
    pinned_factory,
    shared_pool,
)
from ..storage.diskcheck import ROBUST
from ..utils import fanout
from ..utils.errors import (
    OBJECT_OP_IGNORED_ERRS,
    ErrDiskNotFound,
    ErrDiskOpTimeout,
    ErrErasureReadQuorum,
    ErrFileCorrupt,
    ErrFileNotFound,
    ErrInvalidArgument,
    ErrLessData,
    ErrShardSize,
    ErrTooFewShards,
    reduce_read_quorum_errs,
    reduce_write_quorum_errs,
)
from .bitrot import DIGEST_SIZE, verify_fetch
from .codec import Erasure

# Shared pool of the shard fan-outs (the reference spawns goroutines; a
# pool keeps thread churn bounded). Its threads do file I/O only.
_io_pool = ThreadPoolExecutor(max_workers=64, thread_name_prefix="mtpu-io")
# Detached stragglers keep their worker, possibly for ever; the
# compensator raises the pool's ceiling meanwhile.
_io_compensator = fanout.StragglerCompensator(_io_pool)


def start_io_pool() -> None:
    """Start every worker of the shard fan-out pool now (a server on the
    card does it when it starts)."""
    fanout.prestart(_io_pool, _io_pool._max_workers)

# Fan-out and reader counters, per process: hedged reads, hedge windows
# restarted after an oversleeping wait, writers detached past quorum, reader fetches, and those with full-size chunks
# (each verified by one grouped kernel B launch when no reader is bad).
_stats_lock = threading.Lock()
STATS = {"hedged_reads_total": 0, "hedge_windows_restarted": 0,
         "fanout_stragglers_total": 0, "reader_fetches": 0,
         "reader_fetches_full": 0}


# A registry installed at server start mirrors minio_tpu's two series
# (hedged reads, detached stragglers) onto the metrics endpoint; the
# other counters are the port's own and stay here.
_metrics = None
_MIRRORED = frozenset({"hedged_reads_total", "fanout_stragglers_total"})


def set_metrics(registry) -> None:
    global _metrics
    _metrics = registry


def record_stat(name: str, n: int = 1) -> None:
    with _stats_lock:
        STATS[name] += n
    if _metrics is not None and name in _MIRRORED:
        _metrics.inc(name, n)


def stats_snapshot() -> dict:
    with _stats_lock:
        return dict(STATS)


def reset_stats() -> None:
    with _stats_lock:
        for k in STATS:
            STATS[k] = 0


class ParallelWriter:
    """Write one block's shards to k+m writers at once, tolerating
    failures down to write_quorum (cmd/erasure-encode.go parallelWriter).

    Each write returns once write quorum has landed plus a straggler
    grace; a writer still in flight then is detached: its slot is nil'd
    in the caller's list (so later blocks and the commit skip it and the
    shard heals) and `errs` holds ErrDiskOpTimeout for it. A writer that
    fails is nil'd with its error. On a one-core host, local sinks are
    written inline."""

    def __init__(self, writers: list, write_quorum: int):
        # The caller's list is mutated on purpose: the object layer reads
        # which writers failed mid-stream.
        self.writers = writers
        self.write_quorum = write_quorum
        self.errs: list = [None] * len(writers)
        # Detach state persists: a writer detached on one block stays
        # detached for the rest of the stream.
        self._fan = fanout.QuorumFanout(_io_pool, _io_compensator)

    def write(self, blocks: list, digests: list | None = None) -> None:
        def attempt(i):
            w = self.writers[i]
            if digests is not None:
                w.write_with_digest(blocks[i], digests[i])
            else:
                w.write(blocks[i])

        pending: set[int] = set()
        inline: list[int] = []
        single_core = fanout.SINGLE_CORE
        for i, w in enumerate(self.writers):
            if i in self._fan.detached:
                continue  # straggler of an earlier block; errs latched
            if w is None:
                if self.errs[i] is None:
                    self.errs[i] = ErrDiskNotFound(f"writer {i}")
                continue
            if single_core and fanout.is_local_sink(getattr(w, "_sink", w)):
                inline.append(i)
            else:
                pending.add(i)

        def record(i, err):
            self.errs[i] = err
            if err is not None:
                self.writers[i] = None

        def on_detach(i):
            self.errs[i] = ErrDiskOpTimeout(
                f"writer {i} straggling past write quorum")
            self.writers[i] = None

        self._fan.dispatch(
            attempt, pending, inline, self.write_quorum,
            ROBUST.op_deadline_s, ROBUST.straggler_grace_s,
            count_ok=lambda: sum(1 for j in range(len(self.errs))
                                 if self.errs[j] is None
                                 and j not in pending),
            record=record, on_detach=on_detach,
            skip=lambda i: self.writers[i] is None,
            on_stragglers=lambda n: record_stat("fanout_stragglers_total",
                                                n))
        if sum(1 for e in self.errs if e is None) >= self.write_quorum:
            return
        err = reduce_write_quorum_errs(self.errs, OBJECT_OP_IGNORED_ERRS,
                                       self.write_quorum)
        if err is not None:
            raise err


def _read_full(src, n: int) -> bytes:
    out = src.read(n)
    if len(out) == n or not out:
        return out
    buf = bytearray(out)
    while len(buf) < n:
        chunk = src.read(n - len(buf))
        if not chunk:
            break
        buf += chunk
    return bytes(buf)


def _gather_batches(src, block_size: int, batch_blocks: int):
    """Yield (full_blocks, tail): up to batch_blocks full blocks, and the
    stream's short last block as `tail` (b"" once for an empty stream;
    None when the stream ended on a block boundary)."""
    eof = False
    produced = False
    while not eof:
        bufs: list[bytes] = []
        while len(bufs) < batch_blocks:
            b = _read_full(src, block_size)
            if len(b) < block_size:
                eof = True
                if b or (not produced and not bufs):
                    bufs.append(b)  # short tail / empty-object sentinel
                break
            bufs.append(b)
        if not bufs:
            break
        produced = True
        full = [b for b in bufs if len(b) == block_size]
        tail = next((b for b in bufs if len(b) < block_size), None)
        yield full, tail


def _pack(group: list[bytes], erasure: Erasure) -> np.ndarray:
    """Equal-length blocks -> [B, k, S] data shards, zero-padded as
    Erasure.split pads (to the codec's sub-packetization too)."""
    k = erasure.data_blocks
    s = erasure.chunk_size(len(group[0]))
    data = np.zeros((len(group), k * s), dtype=np.uint8)
    for bi, b in enumerate(group):
        data[bi, : len(b)] = np.frombuffer(b, dtype=np.uint8)
    return data.reshape(len(group), k, s)


def encode_stream(erasure: Erasure, src, writers: list, quorum: int,
                  batch_blocks: int = 8, telemetry: str = "put") -> int:
    """Read `src` to its end, erasure-encode it and write every shard's
    framed chunks. Returns the bytes consumed (Erasure.Encode).
    `telemetry` labels the pipeline's counters."""
    writer = ParallelWriter(writers, quorum)
    want_digests = all(getattr(w, "device_hashable", False)
                       for w in writers if w is not None)
    if fanout.SINGLE_CORE:
        return _encode_stream_batched(erasure, src, writer, batch_blocks,
                                      want_digests)
    return _encode_stream_batched_pipelined(erasure, src, writer,
                                            batch_blocks, want_digests,
                                            telemetry)


def _write_batch(writer: ParallelWriter, data: np.ndarray, parity_h,
                 digests_h) -> None:
    """Fan out the shards of a dispatched [B, k, S] batch, block by
    block; the parity and digests handles wait for their copies."""
    k = data.shape[1]
    parity = np.asarray(parity_h)
    digests = np.asarray(digests_h) if digests_h is not None else None
    for bi in range(data.shape[0]):
        blocks = [data[bi, j] for j in range(k)] + \
                 [parity[bi, j] for j in range(parity.shape[1])]
        writer.write(blocks, None if digests is None
                     else [digests[bi, j] for j in range(digests.shape[1])])


def _encode_stream_batched(erasure: Erasure, src, writer: ParallelWriter,
                           batch_blocks: int, want_digests: bool) -> int:
    """Serial driver: each gather's full blocks are one batch dispatched
    asynchronously (staged from pageable memory), and the tail block a
    batch of its own; while batch N computes, the host writes batch N-1."""
    total = 0
    pending = None  # (data [B, k, S], parity handle, digests handle, bytes)

    for full, tail in _gather_batches(src, erasure.block_size, batch_blocks):
        for group in (full, [tail] if tail else []):
            if not group:
                continue
            data = _pack(group, erasure)
            parity_h, digests_h = erasure.encode_batch_async(
                data, with_hashes=want_digests)
            if pending is not None:
                _write_batch(writer, *pending[:3])  # N computes, N-1 writes
                total += pending[3]
            pending = (data, parity_h, digests_h, sum(map(len, group)))
    if pending is not None:
        _write_batch(writer, *pending[:3])
        total += pending[3]
    return total


_HOST_FEEDS: dict = {}
_host_feeds_lock = threading.Lock()


def _host_feed(device) -> HostFeed:
    """The process-wide HostFeed of a device (one copy stream): every
    pipelined PUT shares it."""
    with _host_feeds_lock:
        feed = _HOST_FEEDS.get(device)
        if feed is None:
            feed = _HOST_FEEDS[device] = HostFeed(device)
        return feed


def blocks_pool(erasure: Erasure, batch_blocks: int = 8):
    """The process-wide pool of pinned [batch_blocks, k*S] buffers the
    pipelined PUT packs its batches into, one a geometry and device.
    Capacity covers the in-flight window at queue_depth=1 (one buffer a
    stage and a queue), so steady state allocates nothing."""
    k = erasure.data_blocks
    shard = erasure.shard_size()
    device = erasure.device
    return shared_pool(("blocks", batch_blocks, k, shard, str(device)),
                       pinned_factory((batch_blocks, k * shard), device),
                       capacity=8, name="blocks")


def prefill_blocks_pool(erasure: Erasure, batch_blocks: int = 8) -> None:
    """Allocate the blocks pool's buffers up to its capacity now (the
    server does it when it starts), so a PUT pins no memory of its own."""
    pool = blocks_pool(erasure, batch_blocks)
    bufs = [pool.acquire()
            for _ in range(pool.capacity - pool.stats()["free"])]
    for b in bufs:
        pool.release(b)


def _encode_stream_batched_pipelined(erasure: Erasure, src,
                                     writer: ParallelWriter,
                                     batch_blocks: int, want_digests: bool,
                                     telemetry: str) -> int:
    """Pipelined driver: md5 -> pack -> h2d -> dispatch -> flush-write as
    overlapped stages. `pack` fills a pinned [B, k*S] buffer from a
    shared pool; `h2d` copies it to the card on the HostFeed's copy
    stream and records an event; `dispatch` queues kernel A and kernel B
    behind that event; `flush-write` waits for the parity and digests,
    fans out the shards (data shards straight from the pinned buffer)
    and only then returns the buffer to the pool."""
    block_size = erasure.block_size
    k = erasure.data_blocks
    shard = erasure.shard_size()
    device = erasure.device
    md5_update = None
    if hasattr(src, "delegate_hashing"):
        src, md5_update = src.delegate_hashing()
    pool = blocks_pool(erasure, batch_blocks)
    feed = _host_feed(device)
    totals = {"bytes": 0}

    # Packed items are lists [pooled buf, batches]; each batch is a list
    # [host [n, k, S], bytes, staged, parity handle, digests handle]. The
    # item keeps its identity, so drop() returns an abandoned item's
    # buffer exactly once (gather tuples carry none).
    def drop(item):
        if isinstance(item, list) and item and item[0] is not None:
            pool.release(item[0])
            item[0] = None

    def md5_stage(item):
        full, tail = item
        for b in full:
            md5_update(b)
        if tail:
            md5_update(tail)
        return item

    def pack(item):
        full, tail = item
        buf, batches = None, []
        if full:
            buf = pool.acquire()
            try:
                for bi, b in enumerate(full):
                    row = buf[bi]
                    row[:block_size] = np.frombuffer(b, dtype=np.uint8)
                    row[block_size:] = 0  # split's zero pad (buffers recycle)
            except BaseException:
                pool.release(buf)  # not in an item yet: drop() cannot see it
                raise
            copy_add("put.pack_copy", len(full) * block_size)
            batches.append([buf[: len(full)].reshape(len(full), k, shard),
                            len(full) * block_size, None, None, None])
        if tail:
            # The ragged tail splits to its own shard size: a batch of its
            # own, in a pinned buffer of its own.
            s_t = erasure.chunk_size(len(tail))
            tbuf = host_buffer((1, k * s_t), device)
            tbuf[0, : len(tail)] = np.frombuffer(tail, dtype=np.uint8)
            tbuf[0, len(tail):] = 0
            batches.append([tbuf.reshape(1, k, s_t), len(tail), None, None,
                            None])
        return [buf, batches] if batches else SKIP

    def h2d(item):
        for b in item[1]:
            b[2] = feed(b[0])
        return item

    def dispatch(item):
        for b in item[1]:
            b[3], b[4] = erasure.encode_batch_async(
                b[2], with_hashes=want_digests)
        return item

    def flush(item):
        buf, batches = item
        out = 0
        for host, nbytes, staged, parity_h, digests_h in batches:
            _write_batch(writer, host, parity_h, digests_h)
            if staged.event is not None:
                staged.event.synchronize()  # no DMA still reads the buffer
            out += nbytes
        if buf is not None:
            pool.release(buf)
            item[0] = None
        totals["bytes"] += out
        return out or SKIP

    def run_inline(item):
        out = None
        try:
            if md5_update is not None:
                md5_stage(item)
            # Bound after each stage, so a raise in h2d or dispatch still
            # leaves `out` holding the pooled buffer for drop().
            out = pack(item)
            if out is SKIP:
                return
            out = h2d(out)
            out = dispatch(out)
            flush(out)
        finally:
            drop(out)  # a no-op once flush released it

    # A stream that fits in its first gather gains nothing from a linear
    # pipeline: run its stages inline, with no thread spin-up. A short
    # first gather (partial batch, or a tail) means the stream ended.
    src_iter = _gather_batches(src, block_size, batch_blocks)
    first = next(src_iter, None)
    if first is None:
        return 0
    if len(first[0]) < batch_blocks or first[1] is not None:
        run_inline(first)
        return totals["bytes"]

    def source_from_peeked():
        yield first
        yield from src_iter

    stages = []
    if md5_update is not None:
        stages.append(Stage("md5", md5_stage,
                            bytes_of=lambda it: sum(len(b) for b in it[0])))
    stages += [
        Stage("pack", pack),
        Stage(feed.name, h2d,
              bytes_of=lambda it: sum(b[2].nbytes for b in it[1])),
        Stage("dispatch", dispatch),
        Stage("flush-write", flush, bytes_of=int),
    ]
    Pipeline(telemetry, stages, queue_depth=1, pools=[pool],
             drop=drop).run(source_from_peeked())
    return totals["bytes"]


class _FetchBuffer:
    """One fetch's frames: row i of `buf` ([n readers, phys], pinned on
    the card) is reader i's [digest || chunk]*. `inflight` counts reads
    still landing in it, a parked reader's included."""

    __slots__ = ("buf", "inflight")

    def __init__(self, shape, device):
        self.buf = host_buffer(shape, device)
        self.inflight = 0


class ParallelReader:
    """Read >= k shard chunks per block from n readers, escalating to
    spare readers on failure (cmd/erasure-decode.go parallelReader).

    A fetch covers BATCH_BLOCKS blocks: k reads fire at once on
    `_io_pool`, each landing one reader's frames in its row of the
    fetch's pinned buffer (StreamingBitrotReader.read_frames). A read
    that fails moves its thread to the next untried reader. When no
    result has arrived for ROBUST.hedge_delay_s, the next untried reader
    is fired as well (a hedged read). Unlike minio_tpu, a fetch's first
    wait that oversleeps by half that delay (the process itself was held,
    by a collector pass or the host) restarts the window instead; a
    second one does not. The landed readers are then verified together,
    one grouped kernel B launch for the fetch's full-size chunks (and
    one for a short last chunk) with one sync; a
    reader with a bad chunk fails as ErrFileCorrupt and the next untried
    one is read and verified in turn. When the fetch closes, readers
    still mid-read are abandoned (parked, ErrDiskOpTimeout); a parked
    reader rejoins if its late read lines up with the next offset.
    Missing and corrupt shards set saw_missing and saw_corrupt, so the
    caller can queue a heal."""

    BATCH_BLOCKS = 8

    def __init__(self, readers: list, erasure: Erasure, offset: int,
                 total_length: int):
        self.readers = list(readers)
        self.org_readers = readers
        self.data_blocks = erasure.data_blocks
        self.device = erasure.device
        self.shard_size = erasure.shard_size()
        self.offset = (offset // erasure.block_size) * self.shard_size
        self.shard_file_size = erasure.shard_file_size(total_length)
        self.errs: list = [None] * len(readers)
        self.reader_to_buf = list(range(len(readers)))
        self.saw_missing = False
        self.saw_corrupt = False
        self._queue: list = []
        self._blocks_wanted: int | None = None
        self._ring: list | None = None  # reuse_buffers(): fetch buffers
        self._ring_i = 0
        self._ring_mu = threading.Lock()

    def prefer_readers(self, prefer: list[bool]) -> None:
        """Move preferred (typically local) readers to the front
        (cmd/erasure-decode.go)."""
        if len(prefer) != len(self.org_readers):
            return
        readers = list(self.org_readers)
        r2b = list(range(len(readers)))
        nxt = 0
        for i, ok in enumerate(prefer):
            if not ok or readers[i] is None:
                continue
            if i == nxt:
                nxt += 1
                continue
            readers[nxt], readers[i] = readers[i], readers[nxt]
            r2b[nxt], r2b[i] = r2b[i], r2b[nxt]
            nxt += 1
        self.readers = readers
        self.reader_to_buf = r2b

    def set_blocks_wanted(self, n: int) -> None:
        """Bound prefetching to the caller's remaining block count."""
        self._blocks_wanted = n

    def reuse_buffers(self, depth: int = 2) -> None:
        """Recycle fetch buffers round-robin instead of taking a fresh one
        a fetch. Only valid while the consumer drains each fetch's views
        before `depth` more fetches (the serial drivers). A buffer that a
        parked reader may still be reading into is never recycled: that
        slot gets a fresh buffer and the parked read keeps the old one."""
        with self._ring_mu:
            if self._ring is None:
                self._ring = [None] * max(2, depth)

    def release_buffers(self) -> None:
        """Stop recycling and drop the ring (the drivers call this when
        the stream ends). Buffers go back to the caching host allocator
        once their last view is gone, so a parked read's buffer outlives
        the stream as long as that read."""
        with self._ring_mu:
            self._ring = None
            self._ring_i = 0

    def _fetch_buffer(self, phys: int) -> _FetchBuffer:
        shape = (len(self.readers), phys)
        with self._ring_mu:
            if self._ring is None:
                return _FetchBuffer(shape, self.device)
            fb = self._ring[self._ring_i]
            if fb is None or fb.inflight or fb.buf.shape != shape:
                fb = self._ring[self._ring_i] = _FetchBuffer(shape,
                                                             self.device)
            self._ring_i = (self._ring_i + 1) % len(self._ring)
            return fb

    def read(self) -> list:
        """One block: a list of n chunks with >= k filled entries."""
        if not self._queue:
            self._fetch_batch()
        return self._queue.pop(0)

    def _fail(self, i: int, exc: Exception) -> None:
        # The error is kept without its traceback: the traceback's frames
        # hold this reader and the fetch's pinned buffer, in a reference
        # cycle that only a collector pass would break.
        exc.with_traceback(None)
        if isinstance(exc, ErrFileNotFound):
            self.saw_missing = True
        elif isinstance(exc, ErrFileCorrupt):
            self.saw_corrupt = True
        if self.saw_missing or self.saw_corrupt:
            # The stream is degraded from here on: the shared op tag
            # turns get-degraded for every later byte, in every thread.
            ioflow.retag_degraded()
        self.org_readers[self.reader_to_buf[i]] = None
        self.readers[i] = None
        self.errs[i] = exc

    def _fetch_batch(self) -> None:
        n_max = self.BATCH_BLOCKS
        if self._blocks_wanted is not None:
            n_max = max(1, min(n_max, self._blocks_wanted))
        lengths: list[int] = []
        off = self.offset
        for _ in range(n_max):
            shard = min(self.shard_size, self.shard_file_size - off)
            if shard <= 0:
                break
            lengths.append(shard)
            off += shard
        if not lengths:
            self._queue.append([None] * len(self.org_readers))
            return
        record_stat("reader_fetches")
        if lengths[0] == self.shard_size:  # it has full-size chunks
            record_stat("reader_fetches_full")
        n = len(self.readers)
        k = self.data_blocks
        fetch = self._fetch_buffer(sum(lengths) + DIGEST_SIZE * len(lengths))
        buf = fetch.buf
        offset = self.offset

        cv = threading.Condition()
        landed: set[int] = set()  # read, not verified yet
        good: set[int] = set()    # read and verified
        state = {"next": 0, "active": 0, "closed": False,
                 "progress": time.monotonic()}
        inflight: set[int] = set()   # positions mid-read
        abandoned: set[int] = set()  # parked past the fetch; late reads dropped
        parked: dict[int, object] = {}

        def try_next() -> int | None:
            with cv:
                i = state["next"]
                if i >= n:
                    return None
                state["next"] += 1
                return i

        def run(i: int | None) -> None:
            while i is not None:
                rr = self.readers[i]
                if rr is None:
                    i = try_next()
                    continue
                with cv:
                    # Closed-check and inflight entry are one step: once
                    # the fetch is closed, a reader not yet started stays
                    # untouched in the rotation.
                    if state["closed"]:
                        return
                    inflight.add(i)
                with self._ring_mu:
                    fetch.inflight += 1
                err = None
                try:
                    rr.read_frames(offset, lengths, buf[i])
                except Exception as exc:  # noqa: BLE001 - classified below
                    err = exc
                finally:
                    with self._ring_mu:
                        fetch.inflight -= 1
                with cv:
                    inflight.discard(i)
                    if i in abandoned:
                        abandoned.discard(i)
                        _io_compensator.released()
                        rr2 = parked.pop(i, None)
                        # A late read that completed this fetch's schedule
                        # left the reader at the next fetch's offset: if no
                        # later fetch has moved past it, it rejoins.
                        if (err is None and rr2 is not None
                                and self.readers[i] is None
                                and getattr(rr2, "_curr", None)
                                == self.offset):
                            self.readers[i] = rr2
                            self.errs[i] = None
                        cv.notify_all()
                        return
                    if err is None:
                        landed.add(i)
                        state["progress"] = time.monotonic()
                        # The waiter only acts once k have landed; before
                        # that a wake-up would send it back to sleep.
                        if len(good) + len(landed) >= k:
                            cv.notify_all()
                        return
                self._fail(i, err)
                i = try_next()

        def worker(i: int) -> None:
            try:
                run(i)
            finally:
                with cv:
                    state["active"] -= 1
                    if state["active"] == 0:
                        cv.notify_all()

        def verify_landed() -> int:
            """Verify every landed reader in one grouped launch; returns
            how many failed (each is ErrFileCorrupt from then on)."""
            with cv:
                todo = sorted(landed)
                landed.clear()
            if not todo:
                return 0
            lo, hi = todo[0], todo[-1] + 1
            # Rows lo..hi-1 in one copy and one launch; a row in between
            # whose read failed or is still running is checked too, and
            # its answer ignored.
            bad = verify_fetch(buf[lo:hi], lengths, self.shard_size,
                               self.device)
            failed = 0
            for i in todo:
                if bad[i - lo] >= 0:
                    self._fail(i, ErrFileCorrupt(
                        f"streaming bitrot mismatch chunk {bad[i - lo]}"))
                    failed += 1
                else:
                    good.add(i)
            return failed

        first = [i for i in (try_next() for _ in range(k)) if i is not None]
        if fanout.SINGLE_CORE and all(
                getattr(self.readers[i], "local", False) for i in first):
            # One core: read inline, then verify; escalate serially (no
            # hedging: no thread to overlap the wait with).
            for i in first:
                run(i)
            while True:
                verify_landed()
                if len(good) >= k:
                    break
                while len(good) + len(landed) < k and state["next"] < n:
                    run(try_next())
                if not landed:
                    break
        else:
            # Reader threads carry the request's trace and op tag, so
            # their disk ops and bytes count under it.
            worker = obs_carry(worker)
            with cv:
                state["active"] = len(first)
            for i in first:
                _io_pool.submit(worker, i)
            hedge_s = ROBUST.hedge_delay_s
            deadline = time.monotonic() + ROBUST.long_op_deadline_s
            last_hedge = 0.0
            restarted = False  # the one window restart a fetch allows
            with cv:
                state["progress"] = time.monotonic()
            t_span0 = time.monotonic()
            while True:
                wake_due = None  # when the last timed wait was due to end
                with cv:
                    while len(good) + len(landed) < k:
                        if state["active"] == 0 and state["next"] >= n:
                            break  # everyone finished or failed
                        now = time.monotonic()
                        if now >= deadline:
                            break
                        if not restarted and wake_due is not None and \
                                now - wake_due > hedge_s / 2:
                            # The wait overslept: the whole process was
                            # held (a collector pass, the host descheduling
                            # it) and every reader with it, so the window
                            # starts again. Once a fetch: a drive that
                            # stalls while every wait oversleeps is still
                            # hedged, one window later than minio_tpu's.
                            restarted = True
                            record_stat("hedge_windows_restarted")
                            state["progress"] = now
                            wake_due = None
                            continue
                        # Hedge only on a stall: no result for a whole
                        # hedge window (a fetch making steady progress
                        # pays no read amplification).
                        fire_at = max(state["progress"], last_hedge) + hedge_s
                        if now >= fire_at:
                            last_hedge = now
                            j = try_next()
                            if j is not None:
                                state["active"] += 1
                                record_stat("hedged_reads_total")
                                # The hedge on the request's timeline.
                                spans.record("fanout", f"hedge #{j}", 0)
                                _io_pool.submit(worker, j)
                            continue
                        wake_due = min(fire_at, deadline)
                        cv.wait(wake_due - now)
                if not landed:
                    break
                failed = verify_landed()
                if len(good) >= k:
                    break
                # Each reader that failed its check is replaced by the
                # next untried one, as a failed read is.
                with cv:
                    for _ in range(failed):
                        j = try_next()
                        if j is None:
                            break
                        state["active"] += 1
                        _io_pool.submit(worker, j)
                    state["progress"] = time.monotonic()
            with cv:
                # Close the fetch: readers not yet started exit at the
                # closed-check, untouched. Readers still mid-read are
                # abandoned: their stream is parked on this fetch's
                # offsets, so they leave the rotation (slow is not
                # missing: no heal hint) and their late result is
                # dropped. Each still holds a pool thread; compensate.
                state["closed"] = True
                for j in list(inflight):
                    abandoned.add(j)
                    inflight.discard(j)
                    _io_compensator.parked()
                    if self.errs[j] is None:
                        self.errs[j] = ErrDiskOpTimeout(
                            f"shard reader {j} abandoned past hedge")
                    parked[j] = self.readers[j]
                    self.readers[j] = None
                    spans.record("fanout", f"straggler-detach #{j}", 0)
            # One span a fan-out: the wait for results, the verifies and
            # the hedge and abandon bookkeeping above.
            spans.record("fanout", "shard-read-wait",
                         int((time.monotonic() - t_span0) * 1e9))

        if len(good) < k:
            err = reduce_read_quorum_errs(self.errs, OBJECT_OP_IGNORED_ERRS,
                                          k)
            raise err if err else ErrErasureReadQuorum()
        rows = {self.reader_to_buf[i]: memoryview(buf[i]) for i in good}
        o = DIGEST_SIZE
        for ln in lengths:
            bufs: list = [None] * len(self.org_readers)
            for b, row in rows.items():
                bufs[b] = row[o: o + ln]
            self._queue.append(bufs)
            o += ln + DIGEST_SIZE
        self.offset += sum(lengths)
        if self._blocks_wanted is not None:
            self._blocks_wanted -= len(lengths)


def _write_data_blocks(dst, blocks: list, data_blocks: int, offset: int,
                       length: int) -> int:
    """Write [offset, offset+length) of the concatenated data shards
    (writeDataBlocks, cmd/erasure-utils.go)."""
    if length == 0:
        return 0
    total = sum(len(blocks[i]) for i in range(data_blocks))
    if total < length:
        raise ErrLessData(f"block holds {total}, need {length}")
    write = length
    written = 0
    for i in range(data_blocks):
        b = blocks[i]
        if offset >= len(b):
            offset -= len(b)
            continue
        chunk = memoryview(np.ascontiguousarray(b)).cast("B")[offset:]
        offset = 0
        chunk = chunk[:write]
        dst.write(chunk)
        written += len(chunk)
        write -= len(chunk)
        if write <= 0:
            break
    # Payload bytes served: the read-amplification denominator.
    ioflow.logical(written)
    return written


def decode_stream(erasure: Erasure, writer, readers: list, offset: int,
                  length: int, total_length: int,
                  prefer: list[bool] | None = None):
    """Read k-of-n shards, reconstruct missing data shards and write the
    byte range [offset, offset+length) to `writer`.

    Returns (bytes_written, heal_hint): heal_hint is ErrFileNotFound or
    ErrFileCorrupt when a source failed but the read succeeded, so the
    caller can queue a heal (Erasure.Decode, cmd/erasure-decode.go).

    More than 2 blocks on a multi-core host run pipelined: the shard
    reads and verify of block N+1 and the decode of block N overlap the
    client write of block N-1, which stays on the caller's thread."""
    if offset < 0 or length < 0 or offset + length > total_length:
        raise ErrInvalidArgument("bad range")
    if length == 0:
        return 0, None
    reader = ParallelReader(readers, erasure, offset, total_length)
    if prefer is not None and len(prefer) == len(readers):
        reader.prefer_readers(prefer)
    block_size = erasure.block_size
    start_block = offset // block_size
    end_block = (offset + length) // block_size
    geoms: list[tuple[int, int]] = []
    for block in range(start_block, end_block + 1):
        if start_block == end_block:
            block_offset, block_length = offset % block_size, length
        elif block == start_block:
            block_offset = offset % block_size
            block_length = block_size - block_offset
        elif block == end_block:
            block_offset, block_length = 0, (offset + length) % block_size
        else:
            block_offset, block_length = 0, block_size
        if block_length == 0:
            break
        geoms.append((block_offset, block_length))
    reader.set_blocks_wanted(len(geoms))

    bytes_written = 0
    heal_hint: Exception | None = None

    def note_heal() -> None:
        nonlocal heal_hint
        if reader.saw_missing and heal_hint is None:
            heal_hint = ErrFileNotFound("shard missing during read")
        if reader.saw_corrupt and heal_hint is None:
            heal_hint = ErrFileCorrupt("bitrot during read")

    try:
        if fanout.SINGLE_CORE or len(geoms) <= 2:
            # Serial consumption drains every fetch's views before the
            # next fetch, so the fetch buffers may be recycled.
            reader.reuse_buffers()
            for block_offset, block_length in geoms:
                bufs = reader.read()
                note_heal()
                erasure.decode_data_blocks(bufs)
                bytes_written += _write_data_blocks(
                    writer, bufs, erasure.data_blocks, block_offset,
                    block_length)
        else:
            def decode(gb):
                erasure.decode_data_blocks(gb[1])
                return gb

            pipe = Pipeline("get", [
                Stage("shard-read", lambda geom: (geom, reader.read())),
                Stage("decode", decode, bytes_of=lambda gb: gb[0][1]),
            ], queue_depth=2)
            # The client write stays on the caller's thread.
            for (block_offset, block_length), bufs in pipe.results(geoms):
                note_heal()
                bytes_written += _write_data_blocks(
                    writer, bufs, erasure.data_blocks, block_offset,
                    block_length)
    finally:
        reader.release_buffers()
    if bytes_written != length:
        raise ErrLessData(f"wrote {bytes_written}, want {length}")
    return bytes_written, heal_hint


# Blocks per heal dispatch: one reader fetch feeds exactly one batch.
HEAL_BATCH = ParallelReader.BATCH_BLOCKS


def heal_stream(erasure: Erasure, writers: list, readers: list,
                part_size: int) -> None:
    """Rebuild a part onto the stale shards: `writers` has one entry per
    shard position and the non-None ones are written (quorum 1,
    Erasure.Heal in cmd/erasure-lowlevel-heal.go).

    Survivor blocks batch per failure pattern and shard length into one
    fused reconstruct + digest dispatch each (minio_tpu's
    _heal_stream_fused), gathered at read time straight into a pinned
    batch buffer; the dispatch of batch N overlaps the writes of batch
    N-1. The survivors come through the threaded ParallelReader."""
    targets = [i for i, w in enumerate(writers) if w is not None]
    if not targets or part_size <= 0:
        return
    k = erasure.data_blocks
    total_blocks = -(-part_size // erasure.block_size)
    reader = ParallelReader(readers, erasure, 0, part_size)
    reader.set_blocks_wanted(total_blocks)
    # Each block is copied out of the fetch at gather time, so the fetch
    # buffers may be recycled with dispatches in flight.
    reader.reuse_buffers()
    want_digests = all(getattr(writers[t], "device_hashable", False)
                       for t in targets)
    pending = None  # (rebuilt handle, digests handle, pinned source)
    batch = None    # pinned [HEAL_BATCH, k, S] being filled
    batch_n = 0
    batch_key: tuple = ()

    def flush(p) -> None:
        rebuilt = np.asarray(p[0])
        digests = np.asarray(p[1]) if p[1] is not None else None
        for bi in range(rebuilt.shape[0]):
            for t_i, t in enumerate(targets):
                if digests is not None:
                    writers[t].write_with_digest(rebuilt[bi, t_i],
                                                 digests[bi, t_i])
                else:
                    writers[t].write(rebuilt[bi, t_i])

    def dispatch() -> None:
        nonlocal pending, batch, batch_n
        if not batch_n:
            return
        src = batch[:batch_n]
        out = erasure.engine.reconstruct_async(src, batch_key[0], targets,
                                               with_hashes=want_digests)
        batch, batch_n = None, 0
        if pending is not None:
            flush(pending)
        pending = (*out, src)  # src stays alive until its copy is done

    try:
        for _ in range(total_blocks):
            bufs = reader.read()
            present = tuple(i for i, b in enumerate(bufs)
                            if b is not None and len(b))
            if len(present) < k:
                raise ErrTooFewShards(
                    f"{len(present)} shards present, need {k}")
            blen = len(bufs[present[0]])
            if any(len(bufs[i]) != blen for i in present):
                raise ErrShardSize("present shards differ in size")
            key = (present[:k], blen)
            if batch_n and key != batch_key:
                dispatch()  # survivor set or shard length changed
            batch_key = key
            if batch is None:
                batch = host_buffer((HEAL_BATCH, k, blen), erasure.device)
            for row, i in enumerate(present[:k]):
                batch[batch_n, row] = np.frombuffer(bufs[i], dtype=np.uint8)
            batch_n += 1
            if batch_n >= HEAL_BATCH:
                dispatch()
        dispatch()
        if pending is not None:
            flush(pending)
    finally:
        reader.release_buffers()
