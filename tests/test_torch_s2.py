"""The port's S2-framed snappy (minio_tpu_torch/ops/s2.py) against
minio_tpu's (minio_tpu/ops/s2.py), on the CPU.

- tests/test_s2.py case for case: block round trips, the CRC32C vectors,
  framed streams, corruption, incompressible chunks stored raw, the
  incremental decoder, the copy-remainder regression, the legacy zlib
  object, the transforms' reader and writer, a block fuzz.
- Byte for byte: the port's plain codec (kernels E and F's plain
  versions) writes minio_tpu's native engine's blocks and frames, and
  each package decodes the other's (its Python engine's too, which
  writes other bytes); a hypothesis fuzz over small inputs.
- The plain versions on tensors (compress_plain, decompress_plain): the
  statuses of F, no write outside a frame's slot.
- The segmented CRC model of kernels E and F against the byte-at-a-time
  CRC, at the kernels' 64 and 128 lanes too.
- The models of the kernels' warp designs: E's 32-position window
  (s2.window_parse) against the serial loop, match for match and table
  for table, and its blocks against snappy.c's; F's warp decode with its
  `k mod off` copy (s2.warp_decode_block) against the serial decode, on
  phase 3's chunk pool, periodic chunks of periods 1 to 33, chunks of 9
  to 40 bytes, corrupted blocks and a fuzz over small alphabets.
Kernels E and F are held to these plain versions on the card
(tests/test_torch_cuda.py, phase 3 of chip_smoke.py).
"""

import io
import random
import struct
import zlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from minio_tpu.api import transforms as jax_tfm
from minio_tpu.ops import s2 as jax_s2
from minio_tpu_torch.api import transforms as tfm
from minio_tpu_torch.ops import s2, s2_cuda

CPU = "cpu"


def _patterns():
    rng = random.Random(7)
    return [
        b"",
        b"a",
        b"abcd" * 5000,
        bytes(rng.randrange(256) for _ in range(1000)),  # incompressible
        b"the quick brown fox jumps over the lazy dog " * 1000,
        bytes(200_000),  # a zero run: overlapping copies
        rng.randbytes(70_000),
        b"x" * 65536 + b"y" * 65536,  # runs across the chunk boundary
    ]


@pytest.fixture(scope="module")
def native():
    """minio_tpu's native C engine: the bytes the port is held to."""
    if jax_s2._native() is None:
        pytest.fail("minio_tpu's native snappy engine did not build")
    return jax_s2


# --- tests/test_s2.py, case for case ------------------------------------

def test_block_roundtrip_plain():
    for data in _patterns():
        comp = s2.compress_block(data)
        assert s2.decompress_block(comp) == data


def test_block_roundtrip_cross_engine(native):
    """One wire format: each package decodes the other's blocks, from
    minio_tpu's native and Python engines."""
    for data in _patterns():
        assert s2._decompress_block_py(native.compress_block(data)) == data
        assert s2._decompress_block_py(
            native._compress_block_py(data)) == data
        assert native.decompress_block(s2._compress_block_py(data)) == data
        assert native._decompress_block_py(
            s2._compress_block_py(data)) == data


def test_blocks_equal_native(native):
    """The plain version of kernel E writes snappy.c's bytes."""
    for data in _patterns():
        assert s2._compress_block_py(data) == native.compress_block(data)


def test_compression_actually_compresses():
    data = b"compressible-payload " * 10_000
    assert len(s2.compress_block(data)) < len(data) // 3


def test_crc32c_known_vectors():
    # RFC 3720 test vectors
    assert s2.crc32c(b"") == 0
    assert s2.crc32c(b"\x00" * 32) == 0x8A9136AA
    assert s2.crc32c(b"\xff" * 32) == 0x62A8AB43
    assert s2.crc32c(bytes(range(32))) == 0x46DD794E


@pytest.mark.parametrize("n", [0, 1, 31, 32, 33, 63, 1000, 12_345, 65_536])
def test_segmented_crc_model(n):
    """Kernels E and F's CRC split over 32 lanes, in plain integers,
    equals the byte-at-a-time CRC."""
    data = random.Random(n).randbytes(n)
    assert s2.segmented_crc32c(data) == s2._crc32c_py(data) \
        == jax_s2._crc32c_py(data)


@pytest.mark.parametrize("lanes", [64, 128])
@pytest.mark.parametrize("n", [0, 1, 63, 65, 127, 129, 12_345, 65_536])
def test_segmented_crc_model_kernel_lanes(lanes, n):
    """The CRC split of kernel E (warps 2 and 3: 64 lanes) and of kernel F
    (the block: 128 lanes) equals the byte-at-a-time CRC."""
    data = random.Random(n + lanes).randbytes(n)
    assert s2.segmented_crc32c(data, lanes=lanes) == s2._crc32c_py(data)


def test_framed_stream_roundtrip(native):
    for data in _patterns():
        framed = s2.compress_stream(data, device=CPU)
        assert framed.startswith(s2.STREAM_ID)
        assert framed == native.compress_stream(data)
        assert s2.decompress_stream(framed, device=CPU) == data
        assert native.decompress_stream(framed) == data


def test_frame_crc_detects_corruption():
    framed = bytearray(s2.compress_stream(b"protect me " * 5000,
                                          device=CPU))
    framed[len(framed) // 2] ^= 0xFF
    with pytest.raises(ValueError):
        s2.decompress_stream(bytes(framed), device=CPU)


def test_crc_mismatch_and_corrupt_block_messages():
    """A flipped CRC byte and a truncated block raise minio_tpu's
    messages."""
    raw = b"crc checked " * 600
    frame = bytearray(s2.frame_chunk(raw, device=CPU))
    assert frame[0] == 0x00
    bad_crc = bytearray(frame)
    bad_crc[4] ^= 0x01
    with pytest.raises(ValueError, match="snappy frame CRC mismatch"):
        s2.decompress_stream(s2.STREAM_ID + bytes(bad_crc), device=CPU)
    body = bytes(frame[4:-5])  # the block cut short
    short = bytes([0x00]) + struct.pack("<I", len(body))[:3] + body
    with pytest.raises(ValueError, match="corrupt snappy block"):
        s2.decompress_stream(s2.STREAM_ID + short, device=CPU)
    with pytest.raises(ValueError):
        jax_s2.decompress_stream(s2.STREAM_ID + short)


def test_incompressible_chunks_stored_raw(native):
    data = random.Random(3).randbytes(s2.CHUNK)
    frame = s2.frame_chunk(data, device=CPU)
    assert frame[0] == 0x01  # uncompressed chunk type
    assert len(frame) == 4 + 4 + len(data)
    assert frame == native.frame_chunk(data)


def test_incremental_decoder():
    data = b"incremental feeding " * 20_000
    framed = s2.compress_stream(data, device=CPU)
    for batch_bytes in (8 << 20, 5_000):
        dec = s2.FrameDecoder(CPU, batch_bytes=batch_bytes)
        out = b""
        for i in range(0, len(framed), 777):
            dec.feed(framed[i:i + 777])
            out += dec.decoded()
        out += dec.finish()
        assert out == data


def test_decoder_random_splits_and_skippable(native):
    """Frames split at random points, the stream identifier alone,
    skippable chunks and padding between frames: minio_tpu's stream
    decodes alike on both packages."""
    rng = random.Random(5)
    data = (b"split " * 30_000) + rng.randbytes(70_000)
    framed = native.compress_stream(data)
    body = framed[len(jax_s2.STREAM_ID):]
    skippable = bytes([0x80]) + struct.pack("<I", 3)[:3] + b"abc"
    padding = bytes([0xFE]) + struct.pack("<I", 0)[:3]
    stream = jax_s2.STREAM_ID + skippable + body[:9] + body[9:] + padding
    for _ in range(5):
        cuts = sorted(rng.sample(range(1, len(stream)), 12))
        pieces = [stream[a:b] for a, b in zip([0] + cuts,
                                              cuts + [len(stream)])]
        outs = []
        for dec in (s2.FrameDecoder(CPU, batch_bytes=40_000),
                    jax_s2.FrameDecoder()):
            out = b""
            for p in pieces:
                dec.feed(p)
                out += dec.decoded()
            outs.append(out + dec.finish())
        assert outs[0] == outs[1] == data
    dec = s2.FrameDecoder(CPU)
    dec.feed(jax_s2.STREAM_ID)
    assert dec.decoded() == b"" and dec.finish() == b""


def test_truncated_stream_and_unknown_type():
    framed = s2.compress_stream(b"truncate me " * 3000, device=CPU)
    dec = s2.FrameDecoder(CPU)
    dec.feed(framed[:-3])
    with pytest.raises(ValueError, match="truncated snappy stream"):
        dec.finish()
    with pytest.raises(ValueError, match="unknown snappy frame type"):
        s2.decompress_stream(b"\x02\x01\x00\x00x", device=CPU)


def test_transforms_use_s2(native):
    """The compression reader and the decompression writer round trip,
    and the reader's frames are minio_tpu's."""
    payload = b"transform me please " * 50_000
    stored = {}
    for pkg, reader in (
            ("port", lambda m: tfm.CompressReader(io.BytesIO(payload), m,
                                                  device=CPU)),
            ("jax", lambda m: jax_tfm.CompressReader(io.BytesIO(payload),
                                                     m))):
        meta: dict = {}
        r = reader(meta)
        out = b""
        while chunk := r.read(100_000):
            out += chunk
        assert meta[tfm.META_COMPRESSION] == "s2"
        assert int(meta[tfm.META_COMPRESSED_SIZE]) == len(out)
        assert int(meta[tfm.META_UNCOMPRESSED_SIZE]) == len(payload)
        assert len(out) < len(payload) // 2
        stored[pkg] = out
    assert stored["port"] == stored["jax"]
    out = io.BytesIO()
    w = tfm.DecompressWriter(out, "s2", device=CPU)
    for i in range(0, len(stored["port"]), 1000):
        w.write(stored["port"][i:i + 1000])
    w.close()
    assert out.getvalue() == payload


def test_incompressible_stream_passes_through_unmarked():
    payload = random.Random(9).randbytes(300_000)
    meta: dict = {}
    r = tfm.CompressReader(io.BytesIO(payload), meta, device=CPU)
    assert r.read() == payload
    assert tfm.META_COMPRESSION not in meta


def test_legacy_zlib_objects_still_readable():
    payload = b"old object " * 1000
    stored = zlib.compress(payload, 1)
    out = io.BytesIO()
    w = tfm.DecompressWriter(out, "zlib", device=CPU)
    w.write(stored)
    w.close()
    assert out.getvalue() == payload


def test_copy_remainder_regression(native):
    """A 66-byte run once produced a copy whose 1-3 byte remainder was
    dropped (a corrupt block on every GET)."""
    for n in (65, 66, 67, 68, 129, 130, 131):
        data = b"a" * n
        assert s2.decompress_block(s2.compress_block(data)) == data
        assert s2.compress_block(data) == native.compress_block(data)


def test_block_fuzz(native):
    rng = random.Random(99)
    for _ in range(12):
        n = rng.randrange(0, 150_000)
        data = (bytes(rng.randrange(4) for _ in range(n))
                if rng.random() < 0.5 else rng.randbytes(n))
        comp = s2.compress_block(data)
        assert comp == native.compress_block(data)
        assert s2.decompress_block(comp) == data
        assert native._decompress_block_py(comp) == data


@settings(max_examples=150, deadline=None)
@given(st.binary(max_size=600), st.integers(1, 8))
def test_hypothesis_small_inputs(data, rep):
    data = data * rep
    comp = s2.compress_block(data)
    assert comp == jax_s2.compress_block(data)
    assert s2.decompress_block(comp) == data
    assert s2.decompress_block(jax_s2._compress_block_py(data)) == data
    assert s2.segmented_crc32c(data) == jax_s2.crc32c(data)


# --- the plain versions of E and F on tensors ---------------------------

def _desc_e(sizes):
    rows, in_off, out_off = [], 0, 0
    for n in sizes:
        rows.append((in_off, n, out_off))
        in_off += n
        out_off += s2.max_compressed(n)
    return torch.tensor(rows, dtype=torch.int64).reshape(-1, 3), out_off


def test_compress_plain_batch(native):
    rng = np.random.default_rng(1)
    chunks = [b"batched text " * 5000, rng.bytes(9000), bytes(100), b"",
              b"abc"]
    chunks[0] = chunks[0][:s2.CHUNK]
    raw = b"".join(chunks)
    desc, out_size = _desc_e([len(c) for c in chunks])
    out, crcs, lens = s2_cuda.compress(
        torch.frombuffer(bytearray(raw), dtype=torch.uint8), desc, out_size)
    outb = out.numpy().tobytes()
    for c, (_, _, o), crc, ln in zip(chunks, desc.tolist(), crcs.tolist(),
                                     lens.tolist()):
        assert outb[o:o + ln] == native.compress_block(c)
        assert crc == native._masked_crc(c)


def test_decompress_plain_status_and_slots():
    raw = b"slot bound " * 3000
    good = s2.frame_chunk(raw, device=CPU)[4:]
    bad_crc = bytearray(good)
    bad_crc[0] ^= 1
    short = good[:-7]
    raw_frame = s2.frame_chunk(random.Random(2).randbytes(500),
                               device=CPU)[4:]
    bodies = [good, bytes(bad_crc), short, raw_frame]
    types = [0, 0, 0, 1]
    lens = [len(raw), len(raw), len(raw), 500]
    rows, off, out_off = [], 0, 0
    for t, b, n in zip(types, bodies, lens):
        rows.append((t, off, len(b), out_off, n))
        off += len(b)
        out_off += n
    data = torch.frombuffer(bytearray(b"".join(bodies)), dtype=torch.uint8)
    out, status = s2_cuda.decompress(
        data, torch.tensor(rows, dtype=torch.int64), out_off + 16)
    assert status.tolist() == [s2.STATUS_OK, s2.STATUS_CRC,
                               s2.STATUS_CORRUPT, s2.STATUS_OK]
    outb = out.numpy().tobytes()
    assert outb[:len(raw)] == raw
    # The corrupt frame's slot is untouched and nothing lies past the
    # last slot.
    assert outb[2 * len(raw):3 * len(raw)] == bytes(len(raw))
    assert outb[out_off:] == bytes(16)


def test_wrappers_refuse_cpu_launch_and_bad_desc():
    data = torch.zeros(8, dtype=torch.uint8)
    with pytest.raises(ValueError):
        s2_cuda.compress_cuda(data, torch.zeros((1, 3), dtype=torch.int64),
                              64)
    with pytest.raises(ValueError):
        s2_cuda.decompress_cuda(data, torch.zeros((1, 5), dtype=torch.int64),
                                64)
    with pytest.raises(RuntimeError):
        s2.S2Batch()  # the card by default; none here


# --- the models of the kernels' warp designs -----------------------------

def _serial_parse(chunk):
    """_compress_block_py's loop over one chunk of 8 B or more, keeping
    its matches and its table writes: (matches, writes up to and with each
    match's seeds, then the writes after the last match)."""
    b = bytes(chunk)
    arr = np.frombuffer(b + b"\0\0\0", dtype=np.uint8).astype(np.uint32)
    load = ((arr[:-3] | (arr[1:-2] << 8) | (arr[2:-1] << 16)
             | (arr[3:] << 24))[:len(b)])
    hashes = ((load * np.uint32(0x1E35A7BD)) >> np.uint32(18)).tolist()
    load = load.tolist()
    table = [0] * s2.HASH_SIZE
    limit = len(b) - s2.MIN_MATCH
    matches, writes, seg = [], [], []
    pos = 0
    while pos <= limit:
        h = hashes[pos]
        cand = table[h]
        table[h] = pos
        seg.append((h, pos))
        if cand < pos and pos - cand <= 0xFFFF and load[cand] == load[pos]:
            mlen = s2._match_length(b, cand, pos, len(b))
            s = pos + 1
            while s + 4 <= pos + mlen and s <= limit and s < pos + 4:
                table[hashes[s]] = s
                seg.append((hashes[s], s))
                s += 1
            matches.append((pos, cand, mlen))
            writes.append(seg)
            seg = []
            pos += mlen
        else:
            pos += 1
    writes.append(seg)
    return matches, writes


def _hold_window(native, chunk):
    """E's window against the serial loop (the same matches, the same
    table at every match) and snappy.c; F's warp decode against the
    serial decode."""
    chunk = bytes(chunk)
    block = s2.window_block(chunk)
    assert block == s2._compress_block_py(chunk) \
        == native.compress_block(chunk)
    assert s2.warp_decode_block(block, len(chunk)) \
        == s2._decompress_block_py(block, len(chunk)) == chunk
    if len(chunk) < 8:
        return None
    wp = s2.window_parse(chunk)
    matches, writes = _serial_parse(chunk)
    assert wp.matches == matches
    assert len(wp.writes) == len(writes)
    t_win, t_ser = [0] * s2.HASH_SIZE, [0] * s2.HASH_SIZE
    for w_win, w_ser in zip(wp.writes, writes):
        for h, p in w_win:
            t_win[h] = p
        for h, p in w_ser:
            t_ser[h] = p
        assert all(t_win[h] == t_ser[h] for h, _ in w_win + w_ser)
        # A window's lanes write distinct entries; every write is one the
        # serial loop makes.
        assert set(w_win) <= set(w_ser)
    return wp


@pytest.fixture(scope="module")
def phase3_pool():
    """Phase 3's chunk pool (chip_smoke.s2_pool), as the card tests
    take it."""
    return chip_smoke.s2_pool(np.random.default_rng(1234))


@pytest.mark.parametrize("group", [f"text{i}" for i in range(8)] + [
    "random", "zeros", "tail", "len", "run", "period", "lane31", "short",
    "mixed"])
def test_window_model_phase3_pool(native, phase3_pool, group):
    names = [n for n in phase3_pool if n.startswith(group)]
    assert names
    for name in names:
        wp = _hold_window(native, phase3_pool[name])
        if name == "lane31":
            assert wp.matches[0][0] == 31  # lane 31 of the first window
    if group == "random":
        # 64 KiB of random bytes: 2,048 windows and one a chance match,
        # no extension step.
        for name in names:
            wp = s2.window_parse(phase3_pool[name])
            assert 2048 <= wp.windows <= 2048 + len(wp.matches)
            assert wp.steps == 0
    if group == "zeros":
        # One window, one match to the chunk's end: 512 steps of 128 B.
        wp = s2.window_parse(phase3_pool["zeros"])
        assert (wp.windows, wp.steps, wp.matches) == (1, 512,
                                                      [(1, 0, 65_535)])


@pytest.mark.parametrize("period", range(1, 34))
def test_window_model_periodic(native, period):
    """Periods 1-33: equal hashes on several lanes of one window, and
    matches that restart after each changed byte."""
    rng = np.random.default_rng(period)
    for size in (4096, 997 + period):
        _hold_window(native, chip_smoke.periodic_chunk(rng, period, size,
                                                       every=251))


@pytest.mark.parametrize("n", range(9, 41))
def test_window_model_short_chunks(native, n):
    """Chunks of 9 to 40 bytes: a partial window at the limit."""
    rng = np.random.default_rng(n)
    for alphabet in (b"a", b"ab", b"abc", bytes(range(256))):
        pick = np.frombuffer(alphabet, dtype=np.uint8)
        for _ in range(6):
            _hold_window(native, bytes(rng.choice(pick, n)))


@settings(max_examples=150, deadline=None)
@given(st.integers(1, 5), st.binary(min_size=0, max_size=400),
       st.integers(1, 6))
def test_window_model_fuzz_small_alphabets(k, raw, rep):
    data = bytes(b % k + 97 for b in raw) * rep
    _hold_window(jax_s2, data)


def test_warp_decode_corrupt_blocks():
    """F's warp decode fails on exactly the truncated, cut and flipped
    blocks that the serial decode fails on, and agrees where both
    decode."""
    rng = random.Random(11)
    chunks = [b"the quick brown fox jumps " * 40, bytes(300),
              chip_smoke.periodic_chunk(np.random.default_rng(3), 7, 900)]
    for chunk in chunks:
        block = s2._compress_block_py(chunk)
        cases = [block[:i] for i in range(len(block))]
        for _ in range(60):
            bad = bytearray(block)
            bad[rng.randrange(len(bad))] ^= 1 << rng.randrange(8)
            cases.append(bytes(bad))
        for case in cases:
            for cap in (len(chunk), len(chunk) - 1):
                _same_decode(case, cap)
    # Random valid tags of every kind and header form, cut, flipped or
    # extended, a last copy at the output's edge and past it, and copies at
    # offsets no block takes: the cases the card tests send through F.
    for case, cap in chip_smoke.s2_hostile_blocks(np.random.default_rng(11),
                                                  1500):
        _same_decode(case, cap)


@pytest.mark.parametrize("off", chip_smoke.S2_FAR_OFFSETS)
def test_warp_decode_far_offsets(off):
    """A 4-byte copy offset of 64 KiB or more (negative as a 32-bit int
    from 0x80000000 on) is malformed in both decodes, as the first tag and
    after a literal."""
    far = bytes([(7 << 2) | 3]) + off.to_bytes(4, "little")
    for block, cap in ((s2._varint(8) + far, 8),
                       (s2._varint(24) + bytes([15 << 2]) + bytes(16) + far,
                        24)):
        for decode in (s2._decompress_block_py, s2.warp_decode_block):
            with pytest.raises(ValueError):
                decode(block, cap)


def _same_decode(case, cap):
    outs = []
    for decode in (s2._decompress_block_py, s2.warp_decode_block):
        try:
            outs.append(decode(case, cap))
        except ValueError:
            outs.append(None)
    assert outs[0] == outs[1], (case, cap)


def test_longest_valid_block():
    """A block that decodes to 64 KiB is at most 10 + 6 x 65,536 bytes
    long (kernel F's kMaxBlock): a 10-byte varint, then each byte a
    literal behind a 5-byte tag. That block decodes; one byte more does
    not, in either decode."""
    block = (b"\x80\x80\x84" + b"\x80" * 6 + b"\x00"
             + b"\xfc\x00\x00\x00\x00b" * s2.CHUNK)
    assert len(block) == 10 + 6 * s2.CHUNK
    assert s2._decompress_block_py(block, s2.CHUNK) == b"b" * s2.CHUNK
    assert s2.warp_decode_block(block, s2.CHUNK) == b"b" * s2.CHUNK
    for decode in (s2._decompress_block_py, s2.warp_decode_block):
        with pytest.raises(ValueError):
            decode(block + b"b", s2.CHUNK)
