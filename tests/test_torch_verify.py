"""The pitched hash and the framed verify of minio_tpu_torch (the plain
versions of kernel B's two entries, on the CPU), and kernel A's plain
version at the wide geometries minio_tpu accepts, byte-exact against the
JAX package: minio_tpu.ops.highwayhash.hash256 per chunk, the frames
minio_tpu.erasure.bitrot writes and the verdicts its reader gives, and
minio_tpu.ops.rs._apply_bits. Inputs stay small (chunks of at most
4,118 bytes, few of them): the plain hash is a Python loop over
packets."""

import io
import re

import numpy as np
import pytest
import torch

from minio_tpu.erasure.bitrot import StreamingBitrotReader as JaxReader
from minio_tpu.erasure.bitrot import StreamingBitrotWriter as JaxWriter
from minio_tpu.ops import gf as jgf
from minio_tpu.ops import rs as jrs
from minio_tpu.ops.highwayhash import hash256
from minio_tpu.utils.errors import ErrFileCorrupt as JaxErrFileCorrupt
from minio_tpu_torch.erasure.bitrot import StreamingBitrotReader
from minio_tpu_torch.ops import gf, rs
from minio_tpu_torch.ops.highwayhash_torch import (
    _verify_cuda,
    hash256_pitched,
    verify_frames,
)
from minio_tpu_torch.utils.errors import ErrFileCorrupt

# The suite runs in parallel worker processes: keep torch's intra-op
# thread pool from spinning on every core beside them.
torch.set_num_threads(1)

SHARD = 100  # bitrot chunk length of the framed streams below
N_FULL = 5


@pytest.mark.parametrize("length,offset,pitch", [(0, 3, 32), (49, 1, 81),
                                                 (4096 + 22, 5, 4096 + 54)])
def test_pitched_hash_matches_oracle(length, offset, pitch):
    rng = np.random.default_rng(length + offset)
    n = 3
    buf = rng.integers(0, 256, size=offset + n * pitch, dtype=np.uint8)
    got = hash256_pitched(torch.from_numpy(buf), offset, pitch, n,
                          length).numpy()
    assert got.shape == (n, 32)
    for i in range(n):
        start = offset + i * pitch
        assert got[i].tobytes() == hash256(buf[start: start + length]
                                           .tobytes())


def test_pitched_hash_refuses_overrun():
    buf = torch.zeros(100, dtype=torch.uint8)
    with pytest.raises(ValueError):
        hash256_pitched(buf, 10, 40, 3, 20)  # last row ends at 110
    with pytest.raises(ValueError):  # the kernel entry takes CUDA only
        _verify_cuda(buf[32:].view(2, 34), buf[:64].view(2, 32), bytes(32))


def _framed(tail: int):
    """N_FULL chunks of SHARD bytes and a `tail`-byte one, framed by
    minio_tpu's writer."""
    rng = np.random.default_rng(tail)
    data = rng.integers(0, 256, size=N_FULL * SHARD + tail,
                        dtype=np.uint8).tobytes()
    sink = io.BytesIO()
    w = JaxWriter(sink)
    for off in range(0, len(data), SHARD):
        w.write(data[off: off + SHARD])
    return len(data), bytearray(sink.getvalue())


def _first_bad_by_oracle(framed: bytes, lengths: list[int]) -> int:
    off = 0
    for i, ln in enumerate(lengths):
        if framed[off: off + 32] != hash256(framed[off + 32: off + 32 + ln]):
            return i
        off += 32 + ln
    return -1


def _read(reader_cls, framed: bytes, size: int, lengths: list[int]):
    def open_stream(offset, length):
        return io.BytesIO(bytes(framed[offset: offset + length]))

    if reader_cls is StreamingBitrotReader:
        reader = reader_cls(open_stream, size, SHARD, device="cpu")
    else:
        reader = reader_cls(open_stream, size, SHARD)
    return reader.read_chunks(0, lengths)


@pytest.mark.parametrize("flips", [(), (0,), (2,), (N_FULL - 1,),
                                   (1, N_FULL - 1)])
def test_verify_frames_matches_reference(flips):
    size, framed = _framed(0)
    pitch = 32 + SHARD
    for i in flips:
        framed[i * pitch + 32 + 7 * i + 3] ^= 0x10
    want = _first_bad_by_oracle(framed, [SHARD] * N_FULL)
    assert want == (flips[0] if flips else -1)
    buf = torch.from_numpy(np.frombuffer(framed, dtype=np.uint8).copy())
    assert verify_frames(buf, N_FULL, SHARD) == want
    # The port's reader and minio_tpu's over the same bytes.
    lengths = [SHARD] * N_FULL
    if want < 0:
        got = _read(StreamingBitrotReader, framed, size, lengths)
        ref = _read(JaxReader, framed, size, lengths)
        assert [bytes(g) for g in got] == [bytes(r) for r in ref]
        return
    with pytest.raises(ErrFileCorrupt, match=f"chunk {want}$"):
        _read(StreamingBitrotReader, framed, size, lengths)
    with pytest.raises(JaxErrFileCorrupt) as exc:
        _read(JaxReader, framed, size, lengths)
    m = re.search(r"chunk (\d+)", str(exc.value))
    if m:  # minio_tpu names the chunk when its native verify ran
        assert int(m.group(1)) == want


@pytest.mark.parametrize("flip_tail", [False, True])
def test_short_last_chunk(flip_tail):
    tail = 37
    size, framed = _framed(tail)
    lengths = [SHARD] * N_FULL + [tail]
    if flip_tail:
        framed[-1] ^= 0x01
    want = _first_bad_by_oracle(framed, lengths)
    assert want == (N_FULL if flip_tail else -1)
    at = N_FULL * (32 + SHARD)
    buf = torch.from_numpy(np.frombuffer(framed, dtype=np.uint8).copy())
    assert verify_frames(buf[at:], 1, tail) == (0 if flip_tail else -1)
    if flip_tail:
        with pytest.raises(ErrFileCorrupt, match=f"chunk {N_FULL}$"):
            _read(StreamingBitrotReader, framed, size, lengths)
        with pytest.raises(JaxErrFileCorrupt):
            _read(JaxReader, framed, size, lengths)
    else:
        got = _read(StreamingBitrotReader, framed, size, lengths)
        assert [len(g) for g in got] == lengths
        assert b"".join(got) == b"".join(
            bytes(r) for r in _read(JaxReader, framed, size, lengths))


@pytest.mark.parametrize("k,m,s", [(40, 40, 64), (128, 128, 33),
                                   (200, 56, 17)])
def test_wide_geometry_parity_matches_jax(k, m, s):
    rng = np.random.default_rng(k + m + s)
    bits = jgf.bit_matrix(jgf.parity_matrix(k, m))
    assert np.array_equal(bits, gf.bit_matrix(gf.parity_matrix(k, m)))
    shards = rng.integers(0, 256, size=(1, k, s), dtype=np.uint8)
    got = rs.apply_gf_matrix(gf.to_device_bitmat(bits, "cpu"),
                             torch.from_numpy(shards)).numpy()
    assert got.shape == (1, m, s)
    assert np.array_equal(got, np.asarray(jrs._apply_bits(bits, shards)))


def test_wide_geometry_reconstructs():
    k, m, s = 40, 40, 64
    rng = np.random.default_rng(4040)
    data = rng.integers(0, 256, size=(k, s), dtype=np.uint8)
    allshards = jgf.gf_matmul_shards_ref(jgf.rs_matrix(k, m), data)
    lost = list(range(0, k + m, 2))  # half the data and half the parity
    present = [i for i in range(k + m) if i not in lost]
    bits = jgf.bit_matrix(jgf.reconstruct_matrix(k, m, present, lost))
    assert np.array_equal(
        bits, gf.bit_matrix(gf.reconstruct_matrix(k, m, present, lost)))
    src = allshards[present[:k]][None]
    got = rs.apply_gf_matrix(gf.to_device_bitmat(bits, "cpu"),
                             torch.from_numpy(src)).numpy()
    assert np.array_equal(got, np.asarray(jrs._apply_bits(bits, src)))
    for t_i, t in enumerate(lost):
        assert np.array_equal(got[0, t_i], allshards[t])


def _groups_of_frames(n_groups: int, tail: int, slack: int):
    """n_groups fetches of minio_tpu-framed chunks (N_FULL of SHARD bytes
    and a `tail`-byte one), one a group, `slack` bytes apart."""
    frames = []
    for g in range(n_groups):
        data = np.random.default_rng(100 + g).integers(
            0, 256, size=N_FULL * SHARD + tail, dtype=np.uint8).tobytes()
        sink = io.BytesIO()
        w = JaxWriter(sink)
        for off in range(0, len(data), SHARD):
            w.write(data[off: off + SHARD])
        frames.append(sink.getvalue())
    group = len(frames[0]) + slack
    buf = bytearray(n_groups * group)
    for g, f in enumerate(frames):
        buf[g * group: g * group + len(f)] = f
    return buf, group


@pytest.mark.parametrize("bad", [(), ((0, 0),), ((1, 2), (3, 4)),
                                 ((0, 4), (2, 1), (2, 3), (3, 0))])
def test_grouped_verify_matches_per_group_verify(bad):
    """verify_frames_grouped (the plain version of kernel B's grouped
    entry) against a loop of verify_frames over each group, with bad
    chunks in several groups, for the full-size chunks and for the short
    last chunk at its true length."""
    from minio_tpu_torch.ops.highwayhash_torch import verify_frames_grouped

    n_groups, tail = 4, 37
    buf, group = _groups_of_frames(n_groups, tail, slack=5)
    for g, i in bad:
        buf[g * group + i * (32 + SHARD) + 32 + 11] ^= 0x20
    t = torch.from_numpy(np.frombuffer(buf, dtype=np.uint8).copy())
    got = verify_frames_grouped(t, n_groups, group, N_FULL, SHARD)
    loop = [verify_frames(t[g * group:], N_FULL, SHARD)
            for g in range(n_groups)]
    assert [N_FULL if x < 0 else x for x in loop] == got.tolist()
    assert got.tolist() == [min([i for gg, i in bad if gg == g],
                                default=N_FULL) for g in range(n_groups)]
    at = N_FULL * (32 + SHARD)
    buf[2 * group + at + 32] ^= 0x01  # group 2's short chunk
    t = torch.from_numpy(np.frombuffer(buf, dtype=np.uint8).copy())
    tails = verify_frames_grouped(t, n_groups, group, 1, tail, offset=at)
    loop = [verify_frames(t[g * group + at:], 1, tail)
            for g in range(n_groups)]
    assert tails.tolist() == [1 if x < 0 else x for x in loop] == \
        [1, 1, 0, 1]


def test_verify_fetch_names_the_first_bad_chunk_of_each_reader():
    """bitrot.verify_fetch, as the ParallelReader calls it: one answer a
    reader row, the full-size chunks and the short last one together."""
    from minio_tpu_torch.erasure.bitrot import verify_fetch

    n_groups, tail = 3, 37
    buf, group = _groups_of_frames(n_groups, tail, slack=0)
    buf[1 * group + 3 * (32 + SHARD) + 40] ^= 0x08       # reader 1, chunk 3
    buf[2 * group + N_FULL * (32 + SHARD) + 40] ^= 0x08  # reader 2's tail
    rows = np.frombuffer(buf, dtype=np.uint8).reshape(n_groups, group)
    bad = verify_fetch(rows, [SHARD] * N_FULL + [tail], SHARD,
                       torch.device("cpu"))
    assert bad.tolist() == [-1, 3, N_FULL]


def test_read_frames_lands_unverified_bytes():
    """read_frames copies the framed bytes into the caller's slot with no
    check; read_chunks reads each fetch into a buffer of its own and
    checks it."""
    size, framed = _framed(0)
    framed[40] ^= 0x01  # chunk 0 is bad: read_frames does not look

    def reader():
        return StreamingBitrotReader(
            lambda off, ln: io.BytesIO(bytes(framed[off: off + ln])), size,
            SHARD, device="cpu")

    r = reader()
    out = np.zeros(2 * (32 + SHARD), dtype=np.uint8)
    r.read_frames(0, [SHARD, SHARD], out)
    assert out.tobytes() == bytes(framed[: 2 * (32 + SHARD)])
    with pytest.raises(ValueError):
        r.read_frames(2 * SHARD, [SHARD], out)  # slot of the wrong size
    with pytest.raises(ErrFileCorrupt):
        reader().read_chunks(0, [SHARD])
    framed[40] ^= 0x01
    r = reader()
    views = [r.read_chunks(i * SHARD, [SHARD]) for i in range(3)]
    for i, v in enumerate(views):
        o = i * (32 + SHARD) + 32
        assert bytes(v[0]) == bytes(framed[o: o + SHARD])
    assert not np.shares_memory(np.asarray(views[0][0]),
                                np.asarray(views[2][0]))
