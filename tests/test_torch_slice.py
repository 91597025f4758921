"""The port's erasure slice (encode_stream -> degraded decode_stream ->
heal_stream, on the CPU) against minio_tpu's, byte for byte, on in-memory
bitrot-framed shard files: 3 full blocks of k*4096 bytes plus a ragged
tail, at 8+4 and 12+4, with 2 data and 2 parity shards lost. Shard files
written by either package are read by the other. The pipelined and the
serial drivers (utils.fanout.SINGLE_CORE forced each way) are each held
to minio_tpu's files, bytes and heal hints, at 6+2 and 12+4 and sizes
from empty to 17 blocks."""

import io

import numpy as np
import pytest
import torch

from minio_tpu.erasure.bitrot import (
    StreamingBitrotReader as JaxReader,
    StreamingBitrotWriter as JaxWriter,
)
from minio_tpu.erasure.codec import Erasure as JaxErasure
from minio_tpu.utils.errors import ErrFileNotFound as JaxErrFileNotFound
import minio_tpu.erasure.streaming as jax_streaming
from minio_tpu.erasure.streaming import (
    decode_stream as jax_decode_stream,
    encode_stream as jax_encode_stream,
)
from minio_tpu_torch.erasure import device_engine
from minio_tpu_torch.erasure.bitrot import (
    StreamingBitrotReader,
    StreamingBitrotWriter,
)
from minio_tpu_torch.erasure.codec import Erasure
from minio_tpu_torch.erasure.streaming import (
    ParallelReader,
    decode_stream,
    encode_stream,
    heal_stream,
)
from minio_tpu_torch.utils import fanout
from minio_tpu_torch.utils.errors import (
    ErrFileCorrupt,
    ErrFileNotFound,
    ErrTooFewShards,
)

# The suite runs in parallel worker processes: keep torch's intra-op
# thread pool from spinning on every core beside them.
torch.set_num_threads(1)

# (k, m) -> 2 data + 2 parity shards lost
LOST = {(8, 4): (1, 6, 8, 11), (12, 4): (0, 5, 12, 15)}
GEOMETRIES = sorted(LOST)


def _payload(k: int) -> bytes:
    rng = np.random.default_rng(k)
    return rng.integers(0, 256, size=3 * k * 4096 + 1234,
                        dtype=np.uint8).tobytes()


def _port_readers(files, size, erasure, lost=()):
    def reader(buf):
        if buf is None:
            def missing(off, ln):
                raise ErrFileNotFound("shard removed")
            return StreamingBitrotReader(missing, size, erasure.shard_size(),
                                         device="cpu")
        return StreamingBitrotReader(
            lambda off, ln: io.BytesIO(buf[off: off + ln]), size,
            erasure.shard_size(), device="cpu")

    return [reader(None if i in lost else f) for i, f in enumerate(files)]


def _jax_readers(files, size, shard_size, lost=()):
    return [None if i in lost else JaxReader(
        lambda off, ln, buf=f: io.BytesIO(buf[off: off + ln]), size,
        shard_size) for i, f in enumerate(files)]


def _jax_missing_readers(files, size, shard_size, lost):
    """minio_tpu's readers with the `lost` shard files gone: opening one
    raises minio_tpu's ErrFileNotFound, as the port's readers do."""
    def missing(off, ln):
        raise JaxErrFileNotFound("shard removed")

    readers = _jax_readers(files, size, shard_size)
    for i in lost:
        readers[i] = JaxReader(missing, size, shard_size)
    return readers


@pytest.fixture(scope="module")
def jax_files():
    """minio_tpu's shard files per geometry, encoded by its device engine."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MTPU_ENCODE_ENGINE", "device")
        mp.setenv("MTPU_WORKER_POOL", "0")
        for k, m in GEOMETRIES:
            e = JaxErasure(k, m, k * 4096)
            data = _payload(k)
            sinks = [io.BytesIO() for _ in range(k + m)]
            n = jax_encode_stream(e, io.BytesIO(data),
                                  [JaxWriter(s) for s in sinks],
                                  quorum=k + 1, batch_blocks=2)
            assert n == len(data)
            out[(k, m)] = [s.getvalue() for s in sinks]
    return out


def _port_encode(k, m):
    e = Erasure(k, m, k * 4096, device="cpu")
    data = _payload(k)
    sinks = [io.BytesIO() for _ in range(k + m)]
    n = encode_stream(e, io.BytesIO(data),
                      [StreamingBitrotWriter(s, device="cpu") for s in sinks],
                      quorum=k + 1, batch_blocks=2)
    assert n == len(data)
    return e, data, [s.getvalue() for s in sinks]


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_encode_stream_writes_jax_identical_files(jax_files, k, m):
    device_engine.reset_stats()
    _, _, files = _port_encode(k, m)
    for i, (a, b) in enumerate(zip(files, jax_files[(k, m)])):
        assert a == b, f"shard {i} differs from minio_tpu's"
    # 3 full blocks at batch 2 -> 2 batches, then the tail's own batch.
    assert device_engine.stats_snapshot()["dispatches"] == 3


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_port_decodes_jax_files_degraded(jax_files, k, m):
    e = Erasure(k, m, k * 4096, device="cpu")
    data = _payload(k)
    lost = LOST[(k, m)]
    files = jax_files[(k, m)]
    sink = io.BytesIO()
    n, hint = decode_stream(e, sink, _port_readers(files, len(data), e, lost),
                            0, len(data), len(data))
    assert n == len(data) and sink.getvalue() == data
    assert isinstance(hint, ErrFileNotFound)
    off, ln = k * 4096 + 777, k * 4096 + 4321  # unaligned, spans blocks
    sink = io.BytesIO()
    decode_stream(e, sink, _port_readers(files, len(data), e, lost), off, ln,
                  len(data))
    assert sink.getvalue() == data[off: off + ln]


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_jax_decodes_port_files_degraded(monkeypatch, k, m):
    monkeypatch.setenv("MTPU_ENCODE_ENGINE", "device")
    monkeypatch.setenv("MTPU_WORKER_POOL", "0")
    _, data, files = _port_encode(k, m)
    je = JaxErasure(k, m, k * 4096)
    sink = io.BytesIO()
    n, _ = jax_decode_stream(
        je, sink, _jax_readers(files, len(data), je.shard_size(), LOST[(k, m)]),
        0, len(data), len(data))
    assert n == len(data) and sink.getvalue() == data


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_heal_rebuilds_identical_files(jax_files, k, m):
    e = Erasure(k, m, k * 4096, device="cpu")
    size = len(_payload(k))
    lost = LOST[(k, m)]
    files = jax_files[(k, m)]
    healed = {i: io.BytesIO() for i in lost}
    writers = [StreamingBitrotWriter(healed[i], device="cpu")
               if i in healed else None for i in range(k + m)]
    readers = [None if i in lost else r
               for i, r in enumerate(_port_readers(files, size, e))]
    device_engine.reset_stats()
    heal_stream(e, writers, readers, size)
    for i in lost:
        assert healed[i].getvalue() == files[i], f"healed shard {i} differs"
    # 3 full blocks in one batch, the tail block in a batch of its own.
    assert device_engine.stats_snapshot()["dispatches"] == 2


def test_flipped_byte_raises_and_escalates_to_spare(jax_files):
    k, m = 8, 4
    e = Erasure(k, m, k * 4096, device="cpu")
    data = _payload(k)
    files = list(jax_files[(k, m)])
    bad = bytearray(files[2])
    bad[32 + 4096 + 32 + 100] ^= 0x40  # inside shard 2's second chunk
    files[2] = bytes(bad)
    with pytest.raises(ErrFileCorrupt):
        _port_readers(files, len(data), e)[2].read_chunks(0, [4096, 4096])

    reader = ParallelReader(_port_readers(files, len(data), e), e, 0,
                            len(data))
    bufs = reader.read()
    assert reader.saw_corrupt and not reader.saw_missing
    assert bufs[2] is None and bufs[k] is not None  # spare parity read
    sink = io.BytesIO()
    n, hint = decode_stream(e, sink, _port_readers(files, len(data), e), 0,
                            len(data), len(data))
    assert sink.getvalue() == data and isinstance(hint, ErrFileCorrupt)


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_codec_matches_jax_codec(k, m):
    """Erasure's geometry, one-block encode, decode, reconstruct and join
    against minio_tpu's Erasure."""
    e = Erasure(k, m, k * 4096, device="cpu")
    je = JaxErasure(k, m, k * 4096)
    assert e.shard_size() == je.shard_size()
    for total in (0, 1, k * 4096, 3 * k * 4096 + 1234):
        assert e.shard_file_size(total) == je.shard_file_size(total)
        assert e.shard_file_offset(5, 7000, total) == \
            je.shard_file_offset(5, 7000, total)
    block = np.random.default_rng(k + 1).integers(
        0, 256, size=k * 4096 - 77, dtype=np.uint8).tobytes()
    shards = e.encode_data(block)
    want = je.encode_data(block)
    assert all(np.array_equal(a, b) for a, b in zip(shards, want))
    lost = LOST[(k, m)]

    degraded = [None if i in lost else s for i, s in enumerate(shards)]
    e.decode_data_blocks(degraded)
    assert e.join(degraded, len(block)) == block
    assert all(degraded[i] is None for i in lost if i >= k)

    degraded = [None if i in lost else s for i, s in enumerate(shards)]
    e.decode_data_and_parity_blocks(degraded)
    assert all(np.array_equal(a, b) for a, b in zip(degraded, want))

    rebuilt = e.reconstruct_targets(
        [None if i in lost else s for i, s in enumerate(shards)], list(lost))
    assert all(np.array_equal(r, want[t]) for r, t in zip(rebuilt, lost))

    too_few = [None if i <= m else s for i, s in enumerate(shards)]
    with pytest.raises(ErrTooFewShards):
        e.decode_data_blocks(too_few)


# --- the pipelined and serial drivers, each against minio_tpu ----------

DRIVER_GEOMETRIES = [(6, 2), (12, 4)]
DRIVERS = [False, True]  # fanout.SINGLE_CORE: pipelined, serial


def _driver_sizes(block: int) -> tuple:
    return (0, 1, block - 1, block, 9 * block + 13, 17 * block)


@pytest.fixture(scope="module")
def jax_sized_files():
    """minio_tpu's shard files at every driver test size, 8 blocks a
    batch: (k, m, size) -> files."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MTPU_WORKER_POOL", "0")
        for k, m in DRIVER_GEOMETRIES:
            e = JaxErasure(k, m, k * 4096)
            for size in _driver_sizes(k * 4096):
                data = np.random.default_rng(size).bytes(size)
                sinks = [io.BytesIO() for _ in range(k + m)]
                assert jax_encode_stream(e, io.BytesIO(data),
                                         [JaxWriter(s) for s in sinks],
                                         quorum=k + 1) == size
                out[(k, m, size)] = [s.getvalue() for s in sinks]
    return out


@pytest.mark.parametrize("single_core", DRIVERS,
                         ids=["pipelined", "serial"])
@pytest.mark.parametrize("k,m", DRIVER_GEOMETRIES)
def test_encode_drivers_write_jax_identical_files(jax_sized_files,
                                                  monkeypatch, k, m,
                                                  single_core):
    """Both encode drivers (fanout.SINGLE_CORE forced each way) write
    minio_tpu's shard files, so also each other's: empty, one byte, a
    block less one, one block (inline stages), 9 blocks + 13 and 17
    blocks (the staged pipeline, tail and all)."""
    monkeypatch.setattr(fanout, "SINGLE_CORE", single_core)
    e = Erasure(k, m, k * 4096, device="cpu")
    for size in _driver_sizes(k * 4096):
        data = np.random.default_rng(size).bytes(size)
        sinks = [io.BytesIO() for _ in range(k + m)]
        n = encode_stream(e, io.BytesIO(data),
                          [StreamingBitrotWriter(s, device="cpu")
                           for s in sinks], quorum=k + 1)
        assert n == size
        for i, s in enumerate(sinks):
            assert s.getvalue() == jax_sized_files[(k, m, size)][i], \
                f"size {size}: shard {i} differs from minio_tpu's"


@pytest.mark.parametrize("single_core", DRIVERS,
                         ids=["pipelined", "serial"])
@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_decode_and_heal_drivers_match_jax(jax_files, monkeypatch, k, m,
                                           single_core):
    """Degraded GET (whole, and 3 blocks from an unaligned offset) and
    heal on each driver: minio_tpu's bytes, its heal hint, and the lost
    shard files rebuilt exactly."""
    monkeypatch.setattr(fanout, "SINGLE_CORE", single_core)
    monkeypatch.setattr(jax_streaming, "_SINGLE_CORE", single_core)
    monkeypatch.setenv("MTPU_WORKER_POOL", "0")
    e = Erasure(k, m, k * 4096, device="cpu")
    je = JaxErasure(k, m, k * 4096)
    data = _payload(k)
    lost = LOST[(k, m)]
    files = jax_files[(k, m)]
    for off, ln in ((0, len(data)), (777, 2 * k * 4096 + 5)):
        sink, jsink = io.BytesIO(), io.BytesIO()
        n, hint = decode_stream(e, sink, _port_readers(files, len(data), e,
                                                       lost),
                                off, ln, len(data))
        _, jhint = jax_decode_stream(
            je, jsink, _jax_missing_readers(files, len(data),
                                            je.shard_size(), lost),
            off, ln, len(data))
        assert n == ln and sink.getvalue() == jsink.getvalue() == \
            data[off: off + ln]
        assert type(hint).__name__ == type(jhint).__name__ == \
            "ErrFileNotFound"
    healed = {i: io.BytesIO() for i in lost}
    writers = [StreamingBitrotWriter(healed[i], device="cpu")
               if i in healed else None for i in range(k + m)]
    readers = [None if i in lost else r
               for i, r in enumerate(_port_readers(files, len(data), e))]
    heal_stream(e, writers, readers, len(data))
    for i in lost:
        assert healed[i].getvalue() == files[i], f"healed shard {i} differs"
