"""The port's quorum fan-outs against minio_tpu's, on the CPU, with
robust_overrides giving small delays:

- ParallelWriter nils and records the same writer indices (and error
  kinds) as minio_tpu's for a writer that fails and for one that
  straggles past write quorum plus grace;
- ParallelReader escalates to the same spare reader and gives the same
  heal hint as minio_tpu's for a missing reader, a corrupt one (found by
  the port's grouped verify) and a stalled one (one hedged read, then a
  rejoin or an abandon), also while every wait of the hedge timer
  oversleeps.

Both packages read the same 6+2 shard files, written by the port."""

import io
import time

import numpy as np
import pytest
import torch

import minio_tpu.erasure.streaming as jax_streaming
from minio_tpu.erasure.bitrot import StreamingBitrotReader as JaxReader
from minio_tpu.erasure.codec import Erasure as JaxErasure
from minio_tpu.storage.diskcheck import robust_overrides as jax_overrides
from minio_tpu.utils.errors import ErrFileNotFound as JaxErrFileNotFound
from minio_tpu_torch.erasure import streaming
from minio_tpu_torch.erasure.bitrot import (
    StreamingBitrotReader,
    StreamingBitrotWriter,
)
from minio_tpu_torch.erasure.codec import Erasure
from minio_tpu_torch.storage.diskcheck import robust_overrides
from minio_tpu_torch.utils import fanout
from minio_tpu_torch.utils.errors import ErrFileNotFound

torch.set_num_threads(1)

K, M = 6, 2
BLOCK = K * 4096
SIZE = 17 * BLOCK + 777  # 3 fetches: 8, 8 and 2 blocks


@pytest.fixture(autouse=True)
def threaded(monkeypatch):
    """Both packages take their threaded fan-outs, whatever this host's
    core count."""
    monkeypatch.setattr(fanout, "SINGLE_CORE", False)
    monkeypatch.setattr(jax_streaming, "_SINGLE_CORE", False)


@pytest.fixture(scope="module")
def files():
    e = Erasure(K, M, BLOCK, device="cpu")
    data = np.random.default_rng(7).bytes(SIZE)
    sinks = [io.BytesIO() for _ in range(K + M)]
    assert streaming.encode_stream(
        e, io.BytesIO(data),
        [StreamingBitrotWriter(s, device="cpu") for s in sinks],
        K + 1) == SIZE
    return data, [s.getvalue() for s in sinks]


# --- writers ------------------------------------------------------------

class _Sink:
    """A writer both ParallelWriters take: it fails, or stalls, on its
    `bad_block`-th write."""

    def __init__(self, mode=None, bad_block=1, stall_s=0.4):
        self.mode, self.bad_block, self.stall_s = mode, bad_block, stall_s
        self.n = 0
        self.got = []
        self._sink = self  # not a local sink: always the pool

    def write(self, b):
        self.n += 1
        if self.mode and self.n == self.bad_block:
            if self.mode == "fail":
                raise OSError("disk gone")
            time.sleep(self.stall_s)
        self.got.append(bytes(b))
        return len(b)

    def write_with_digest(self, b, digest):
        return self.write(b)


def _run_writer(cls, overrides, faults: dict) -> tuple:
    writers = [_Sink(*faults.get(i, (None,))) for i in range(K + M)]
    with overrides(straggler_grace_s=0.05, op_deadline_s=5.0):
        pw = cls(writers, K + 1)
        for b in range(3):
            pw.write([bytes([b, i]) * 8 for i in range(K + M)])
    return ([w is None for w in pw.writers],
            [type(e).__name__ if e is not None else None for e in pw.errs])


@pytest.mark.parametrize("faults,nilled,timed_out", [
    ({3: ("fail", 2)}, {3}, set()),
    ({5: ("stall", 2)}, {5}, {5}),
    # Quorum 7 of 8 with writer 0 gone needs writer 7: its stall is
    # waited out, not detached.
    ({0: ("fail", 1), 7: ("stall", 3)}, {0}, set()),
], ids=["failing", "straggling", "stall-needed-for-quorum"])
def test_parallel_writer_nils_the_same_writers(faults, nilled, timed_out):
    port = _run_writer(streaming.ParallelWriter, robust_overrides, faults)
    ref = _run_writer(jax_streaming.ParallelWriter, jax_overrides, faults)
    assert port == ref
    assert {i for i, gone in enumerate(port[0]) if gone} == nilled
    assert {i for i, e in enumerate(port[1])
            if e == "ErrDiskOpTimeout"} == timed_out


def test_parallel_writer_counts_the_straggler():
    before = streaming.stats_snapshot()["fanout_stragglers_total"]
    _run_writer(streaming.ParallelWriter, robust_overrides,
                {2: ("stall", 1)})
    assert streaming.stats_snapshot()["fanout_stragglers_total"] == \
        before + 1


# --- readers ------------------------------------------------------------

class _Stream(io.BytesIO):
    """A shard stream whose first read stalls for `stall_s`."""

    def __init__(self, data, stall_s=0.0):
        super().__init__(data)
        self.stall_s = stall_s

    def _stall(self):
        if self.stall_s:
            time.sleep(self.stall_s)
            self.stall_s = 0.0

    def read(self, n=-1):
        self._stall()
        return super().read(n)

    def readinto(self, b):
        self._stall()
        return super().readinto(b)


def _opener(buf, missing=False, stall_s=0.0, not_found=ErrFileNotFound):
    def open_stream(off, ln):
        if missing:
            raise not_found("shard removed")
        return _Stream(buf[off: off + ln], stall_s)
    return open_stream


def _readers(files, make, missing=(), corrupt=(), stall=None):
    """Each package's readers over the shard files; a missing one raises
    that package's own ErrFileNotFound."""
    not_found = ErrFileNotFound if make is _port_make else JaxErrFileNotFound
    out = []
    for i, f in enumerate(files):
        if i in corrupt:
            f = bytearray(f)
            f[32 + 4096 + 32 + 100] ^= 0x40  # the second chunk
            f = bytes(f)
        out.append(make(_opener(f, i in missing,
                                stall[1] if stall and stall[0] == i
                                else 0.0, not_found)))
    return out


def _port_make(open_stream):
    return StreamingBitrotReader(open_stream, SIZE, BLOCK // K,
                                 device="cpu")


def _jax_make(open_stream):
    return JaxReader(open_stream, SIZE, BLOCK // K)


def _present(bufs):
    return tuple(i for i, b in enumerate(bufs) if b is not None)


def _fetches(reader, n_fetches, pause_s=0.0):
    """The shard positions of each fetch's blocks, with a pause after
    each fetch."""
    got = []
    for f in range(n_fetches):
        blocks = [reader.read() for _ in range(8 if f < 2 else 2)]
        assert len({_present(b) for b in blocks}) == 1
        got.append(_present(blocks[0]))
        time.sleep(pause_s)
    return got


@pytest.mark.parametrize("case", ["missing", "corrupt"])
def test_parallel_reader_escalates_like_minio_tpu(files, case):
    data, shard_files = files
    kw = {"missing": (2,)} if case == "missing" else {"corrupt": (2,)}
    port = streaming.ParallelReader(
        _readers(shard_files, _port_make, **kw),
        Erasure(K, M, BLOCK, device="cpu"), 0, SIZE)
    ref = jax_streaming.ParallelReader(
        _readers(shard_files, _jax_make, **kw), JaxErasure(K, M, BLOCK), 0,
        SIZE)
    got = _fetches(port, 3)
    assert got == _fetches(ref, 3)
    assert got[0] == (0, 1, 3, 4, 5, 6)  # spare 6 read in place of 2
    assert (port.saw_missing, port.saw_corrupt) == \
        (ref.saw_missing, ref.saw_corrupt) == \
        (case == "missing", case == "corrupt")
    assert [type(e).__name__ if e else None for e in port.errs] == \
        [type(e).__name__ if e else None for e in ref.errs]


@pytest.mark.parametrize("case", ["missing", "corrupt"])
def test_decode_heal_hint_like_minio_tpu(files, case):
    data, shard_files = files
    kw = {"missing": (2, 7)} if case == "missing" else {"corrupt": (2, 7)}
    sink, jsink = io.BytesIO(), io.BytesIO()
    n, hint = streaming.decode_stream(
        Erasure(K, M, BLOCK, device="cpu"), sink,
        _readers(shard_files, _port_make, **kw), 0, SIZE, SIZE)
    jn, jhint = jax_streaming.decode_stream(
        JaxErasure(K, M, BLOCK), jsink,
        _readers(shard_files, _jax_make, **kw), 0, SIZE, SIZE)
    assert n == jn == SIZE and sink.getvalue() == jsink.getvalue() == data
    assert hint is not None and \
        type(hint).__name__ == type(jhint).__name__


@pytest.mark.parametrize("stall_s,pause_s,rejoins", [(0.3, 0.6, True),
                                                     (1.5, 0.0, False)],
                         ids=["rejoin", "abandon"])
def test_stalled_reader_hedges_then_rejoins_or_is_abandoned(
        files, stall_s, pause_s, rejoins):
    """Reader 1 stalls on its first read: after the hedge delay the spare
    (6) is read instead, the fetch closes and reader 1 is parked. If its
    late read lands before the next fetch, it rejoins the rotation;
    otherwise that fetch reads the spare again. No heal hint either way:
    slow is not missing."""
    data, shard_files = files
    results = []
    for mod, make, er, overrides in (
            (streaming, _port_make, Erasure(K, M, BLOCK, device="cpu"),
             robust_overrides),
            (jax_streaming, _jax_make, JaxErasure(K, M, BLOCK),
             jax_overrides)):
        before = mod.STATS["hedged_reads_total"]
        with overrides(hedge_delay_s=0.05):
            reader = mod.ParallelReader(
                _readers(shard_files, make, stall=(1, stall_s)), er, 0,
                SIZE)
            got = _fetches(reader, 3, pause_s)
        results.append((got, mod.STATS["hedged_reads_total"] - before,
                        reader.saw_missing or reader.saw_corrupt))
    assert results[0] == results[1]
    got, hedges, hinted = results[0]
    assert hedges == 1 and not hinted
    assert got[0] == (0, 2, 3, 4, 5, 6)
    assert got[1] == ((0, 1, 2, 3, 4, 5) if rejoins else (0, 2, 3, 4, 5, 6))


def test_failed_readers_leave_no_reference_cycle(files, monkeypatch):
    """A reader that fails keeps its error without the traceback, whose
    frames would hold the ParallelReader and its pinned fetch buffer in a
    cycle until a collector pass: after a degraded decode the reader is
    freed by reference counting alone."""
    import gc
    import weakref

    data, shard_files = files
    made = []
    init = streaming.ParallelReader.__init__

    def tracked_init(self, *args, **kw):
        init(self, *args, **kw)
        made.append(weakref.ref(self))

    monkeypatch.setattr(streaming.ParallelReader, "__init__", tracked_init)
    readers = _readers(shard_files, _port_make, missing=(1,), corrupt=(4,))
    gc.disable()
    try:
        sink = io.BytesIO()
        streaming.decode_stream(Erasure(K, M, BLOCK, device="cpu"), sink,
                                readers, 0, SIZE, SIZE)
        assert sink.getvalue() == data
        del readers
        assert made and made[0]() is None
    finally:
        gc.enable()


def test_a_held_process_is_not_a_stalled_drive(files, monkeypatch):
    """Reader 1 takes 0.45 s, past the 0.3 s hedge delay, and the hedge
    timer's clock jumps 2 s meanwhile, as if a collector pass had held
    the whole process: the waiter wakes from its timed wait 2 s late,
    sees that it overslept and restarts the window instead of hedging,
    and reader 1 lands inside the new window."""
    import types

    data, shard_files = files
    jump = {"at": None, "by": 0.0}

    def monotonic():
        t = time.monotonic()
        if jump["at"] is not None and t >= jump["at"]:
            t += jump["by"]
        return t

    monkeypatch.setattr(streaming, "time",
                        types.SimpleNamespace(monotonic=monotonic))
    before = streaming.stats_snapshot()["hedged_reads_total"]
    restarts = streaming.stats_snapshot()["hedge_windows_restarted"]
    with robust_overrides(hedge_delay_s=0.3):
        reader = streaming.ParallelReader(
            _readers(shard_files, _port_make, stall=(1, 0.45)),
            Erasure(K, M, BLOCK, device="cpu"), 0, SIZE)
        jump.update(at=time.monotonic() + 0.05, by=2.0)
        got = _fetches(reader, 1)
    assert got == [(0, 1, 2, 3, 4, 5)]
    assert streaming.stats_snapshot()["hedged_reads_total"] == before
    assert streaming.stats_snapshot()["hedge_windows_restarted"] == \
        restarts + 1


def test_a_stalled_drive_is_hedged_while_every_wait_oversleeps(
        files, monkeypatch):
    """The hedge timer's clock runs three times fast, so every timed wait
    oversleeps its due time by twice its length, as under a process held
    again and again. Reader 1 stalls for 1.5 s: the first oversleeping
    wait restarts the window, the second hedges, and the fetch reads
    minio_tpu's spare (6) with one hedged read, as minio_tpu's reader
    does on a true clock."""
    import types

    data, shard_files = files
    results = []
    with jax_overrides(hedge_delay_s=0.3):
        before = jax_streaming.STATS["hedged_reads_total"]
        reader = jax_streaming.ParallelReader(
            _readers(shard_files, _jax_make, stall=(1, 1.5)),
            JaxErasure(K, M, BLOCK), 0, SIZE)
        results.append((_fetches(reader, 1),
                        jax_streaming.STATS["hedged_reads_total"] - before))
    t0 = time.monotonic()
    monkeypatch.setattr(streaming, "time", types.SimpleNamespace(
        monotonic=lambda: t0 + 3 * (time.monotonic() - t0)))
    before = streaming.stats_snapshot()
    with robust_overrides(hedge_delay_s=0.3):
        reader = streaming.ParallelReader(
            _readers(shard_files, _port_make, stall=(1, 1.5)),
            Erasure(K, M, BLOCK, device="cpu"), 0, SIZE)
        got = _fetches(reader, 1)
    after = streaming.stats_snapshot()
    results.append((got, after["hedged_reads_total"]
                    - before["hedged_reads_total"]))
    assert results[0] == results[1] == ([(0, 2, 3, 4, 5, 6)], 1)
    assert after["hedge_windows_restarted"] == \
        before["hedge_windows_restarted"] + 1


def test_prefer_readers_reads_the_preferred_shards_first(files):
    """prefer_readers moves the preferred (local) readers to the front of
    the rotation: the port reads minio_tpu's shards, 2 and 7 among them."""
    data, shard_files = files
    prefer = [i in (2, 7) for i in range(K + M)]
    got = []
    for mod, make, er in (
            (streaming, _port_make, Erasure(K, M, BLOCK, device="cpu")),
            (jax_streaming, _jax_make, JaxErasure(K, M, BLOCK))):
        reader = mod.ParallelReader(_readers(shard_files, make), er, 0, SIZE)
        reader.prefer_readers(prefer)
        got.append(_fetches(reader, 3))
    assert got[0] == got[1]
    assert 2 in got[0][0] and 7 in got[0][0]
    sink = io.BytesIO()
    streaming.decode_stream(Erasure(K, M, BLOCK, device="cpu"), sink,
                            _readers(shard_files, _port_make), 0, SIZE, SIZE,
                            prefer=prefer)
    assert sink.getvalue() == data
