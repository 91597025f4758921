"""minio_tpu_torch's CUDA kernels against their plain PyTorch versions, on
the card. Marked `cuda`: each test asks the `cuda` fixture for the device,
and the fixture skips where there is no card (decided when the test runs,
never at import, so every worker collects the same tests).

Run on a machine with a CUDA card, without tests/conftest.py (it arms
JAX, which such a machine need not have):

    python -m pytest -q --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import struct

import chip_smoke
from minio_tpu_torch.crypto.aead import AESGCM
from minio_tpu_torch import entry
from minio_tpu_torch.entry import (admission_drive_health,
                                   config_compression,
                                   object_codec_put_get_heal,
                                   object_put_get_heal, object_self_heal,
                                   observability, put_get_heal, s3_core,
                                   s3_put_get_heal, s3_sse)
from minio_tpu_torch.erasure import device_engine, registry
from minio_tpu_torch.ops import aes_gcm, aes_gcm_cuda, s2, s2_cuda
from minio_tpu_torch.ops import gf, highwayhash_torch as hh, rs, rs_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this host")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain GF matmul exact
    return torch.device("cuda")


def _rand(shape, seed, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, 256, size=shape, dtype=np.uint8)).to(device)


@pytest.mark.parametrize("k,m,s,b", [(12, 4, 87382, 8), (16, 16, 333, 2),
                                     (2, 2, 333, 3), (8, 4, 1, 1),
                                     (5, 7, 4099, 2), (12, 4, 4097, 3),
                                     (12, 4, 4098, 3), (12, 4, 4099, 3),
                                     (40, 40, 1000, 2), (128, 128, 257, 2),
                                     (200, 56, 515, 1)])
def test_gf_kernel_matches_plain(cuda, k, m, s, b):
    bm = gf.to_device_bitmat(gf.bit_matrix(gf.parity_matrix(k, m)), cuda)
    x = _rand((b, k, s), k * m + s, cuda)
    before = rs_cuda.LAUNCHES.value
    got = rs.apply_gf_matrix(bm, x)  # CUDA tensors -> kernel A
    assert rs_cuda.LAUNCHES.value == before + 1
    assert torch.equal(got, rs._apply_bits_plain(bm, x))


@pytest.mark.parametrize("k,m,lost", [(12, 4, (0, 5, 12, 15)), (12, 4, (3,)),
                                      (40, 40, tuple(range(0, 80, 2)))])
def test_gf_kernel_reconstructs(cuda, k, m, lost):
    present = [i for i in range(k + m) if i not in lost]
    rec = gf.reconstruct_matrix(k, m, present, list(lost))
    bm = gf.to_device_bitmat(gf.bit_matrix(rec), cuda)
    x = _rand((4, k, 1000), 1, cuda)
    assert torch.equal(rs_cuda.apply_gf_matrix_cuda(bm, x),
                       rs._apply_bits_plain(bm, x))


@pytest.mark.parametrize("k,m,sub", [
    (254, 2, 515),      # piggyback, K = 508: the widest K
    (128, 128, 257),    # piggyback, R = 256: the widest R
    (200, 56, 515),     # piggyback, K = 400, R = 112
    (8, 2, 333),        # coupled-layer, alpha 32: K = 256, R = 64
    (6, 3, 1000),       # coupled-layer, alpha 27
    (5, 5, 1000),       # coupled-layer, alpha 25
    (12, 4, 43691),     # 12+4 at a 1 MiB block: 87,382 / 2
    (12, 4, 515),       # its 12,345 B tail: 1,030 / 2
    (4, 4, 193),        # 4+4's 12,345 B tail: 3,088 / 16
])
def test_gf_kernel_at_msr_pm_shapes(cuda, k, m, sub):
    """Kernel A in the msr-pm sub-shard view [B, k*alpha, S/alpha]: the
    encode, and a reconstruction of shards 0..m-1 from the rest."""
    entry = registry.get(registry.MSR_PM)
    a = entry.alpha(k, m)
    x = _rand((2, k * a, sub), k + m + sub, cuda)
    for mat in (entry.parity_matrix(k, m),
                entry.reconstruct_matrix(k, m, list(range(m, k + m)),
                                         list(range(m)))):
        bm = gf.to_device_bitmat(gf.bit_matrix(mat), cuda)
        assert torch.equal(rs_cuda.apply_gf_matrix_cuda(bm, x),
                           rs._apply_bits_plain(bm, x))


@pytest.mark.parametrize("k,m,target,sub", [(4, 4, 6, 16384), (4, 4, 0, 193),
                                            (12, 4, 3, 43691),
                                            (12, 4, 3, 515)])
def test_gf_kernel_at_repair_shapes(cuda, k, m, target, sub):
    """Kernel A with a repair plan's [alpha, T] matrix on [nb, T, S/alpha]
    symbols."""
    plan = registry.get(registry.MSR_PM).repair_plan(k, m, target)
    bm = gf.to_device_bitmat(gf.bit_matrix(plan.matrix), cuda)
    x = _rand((9, plan.total_symbols, sub), target + sub, cuda)
    assert torch.equal(rs_cuda.apply_gf_matrix_cuda(bm, x),
                       rs._apply_bits_plain(bm, x))


@pytest.mark.parametrize("codec,drives,lost,target", [
    ("cauchy-xor", 16, (0, 5, 12, 15), None),
    ("msr-pm", 16, (0, 5, 12, 15), 3),
    ("msr-pm", 8, (0, 3, 4, 7), 6)])
def test_object_codec_put_get_heal_on_card(cuda, tmp_path, codec, drives,
                                           lost, target):
    """Phase 4h of chip_smoke.py at 3 MiB + 777 B: every check holds,
    and the repair heal reads plan.total_symbols / alpha bytes a byte
    healed."""
    res = object_codec_put_get_heal(tmp_path, 3 * (1 << 20) + 777, codec,
                                    drives=drives, parity=4, lost=lost,
                                    repair_target=target, device=cuda)
    assert all(res["checks"].values()), res["checks"]
    for phase, c in res["counters"].items():
        assert c["kernel_hash_launches"] > 0, phase
        assert (c["kernel_gf_launches"] > 0) == (phase != "get"), phase


def test_gf_kernel_unaligned_view_and_large_batch(cuda):
    # A contiguous view at an odd address, and more batches than one grid
    # column holds (the kernel loops over the batch).
    bm = gf.to_device_bitmat(gf.bit_matrix(gf.parity_matrix(4, 2)), cuda)
    flat = _rand((3 + 70000 * 4 * 3,), 5, cuda)
    x = flat[3:].view(70000, 4, 3)
    assert torch.equal(rs_cuda.apply_gf_matrix_cuda(bm, x),
                       rs._apply_bits_plain(bm, x))


def test_gf_kernel_refuses_what_it_cannot_take(cuda):
    bm = gf.to_device_bitmat(gf.bit_matrix(gf.parity_matrix(4, 2)), cuda)
    with pytest.raises(ValueError):
        rs_cuda.apply_gf_matrix_cuda(bm, _rand((1, 3, 8), 0, cuda))
    with pytest.raises(ValueError):  # not contiguous
        rs_cuda.apply_gf_matrix_cuda(bm, _rand((1, 8, 4), 0, cuda)
                                     .transpose(1, 2))


@pytest.mark.parametrize("length", [0, 1, 17, 31, 32, 33, 49, 63,
                                    4096 + 22, 87382])
def test_hash_kernel_matches_plain(cuda, length):
    x = _rand((8, length), length, cuda)
    before = hh.LAUNCHES.value
    got = hh.hash256_batch(x)  # CUDA tensor -> kernel B
    assert hh.LAUNCHES.value == before + 1
    assert torch.equal(got, hh._hash256_plain(x, hh.MAGIC_KEY))


@pytest.mark.parametrize("offset", range(16))
def test_hash_kernel_at_every_start_offset(cuda, offset):
    length, n = 4096 + 22, 20  # two blocks of chunks, the second partial
    buf = _rand((offset + n * length,), offset, cuda)
    got = hh.hash256_pitched(buf, offset, length, n, length)
    want = hh._hash256_plain(hh._rows(buf, offset, length, n, length),
                             hh.MAGIC_KEY)
    assert torch.equal(got, want)


@pytest.mark.parametrize("length", [0, 1, 17, 31, 32, 33, 63, 4096 + 22,
                                    87382])
def test_hash_kernel_framed_and_verify(cuda, length):
    # n frames [digest || chunk] at pitch 32 + length, from an odd address.
    n, pitch = 20, 32 + length
    buf = _rand((3 + n * pitch,), length + 1, cuda)
    framed = buf[3:]
    rows = hh._rows(framed, 32, pitch, n, length)
    want = hh._hash256_plain(rows, hh.MAGIC_KEY)
    before = hh.LAUNCHES.value
    assert torch.equal(hh.hash256_pitched(framed, 32, pitch, n, length), want)
    assert hh.LAUNCHES.value == before + 1
    hh._rows(framed, 0, pitch, n, 32).copy_(want)
    assert hh.verify_frames(framed, n, length) == -1
    for bad in ((0,), (17, 19), (n - 1,)):
        f = framed.clone()
        for i in bad:
            at = i * pitch + (32 + length // 2 if length else 5)
            f[at] ^= 0x41
        assert hh.verify_frames(f, n, length) == bad[0]
        if length <= 4096 + 22:  # the plain version, on the same bytes
            assert hh.verify_frames(f.cpu(), n, length) == bad[0]


def test_device_engine_on_card_matches_cpu(cuda):
    blocks = _rand((2, 12, 4099), 9, "cpu").numpy()
    got = device_engine.for_geometry(12, 4, device=cuda).encode_async(
        blocks, with_hashes=True)
    want = device_engine.for_geometry(12, 4, device="cpu").encode_async(
        blocks, with_hashes=True)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))


def test_put_get_heal_small_on_card(cuda, tmp_path):
    res = put_get_heal(tmp_path, 3 * (1 << 20) + 777, device=cuda)
    assert res["get_ok"] and res["range_ok"]
    assert res["healed_identical"] and res["reverified"]
    for phase in ("put", "get", "heal"):
        c = res["counters"][phase]
        assert c["kernel_gf_launches"] > 0 and c["kernel_hash_launches"] > 0
    assert len(res["bytes"]) == 3 * (1 << 20) + 777


def test_object_put_get_heal_on_card(cuda, tmp_path):
    """The object layer at 12+4 and 1 MiB blocks on the card: PutObject,
    healthy and degraded GetObject, HealObject, bitrot, with the losses
    of chip_smoke.py; exact bytes, and both kernels launched wherever a
    stream decodes, rebuilds or writes."""
    res = object_put_get_heal(tmp_path, 3 * (1 << 20) + 777, device=cuda,
                              inline_size=100 << 10)
    assert all(res["checks"].values()), res["checks"]
    for phase, c in res["counters"].items():
        assert c["kernel_hash_launches"] > 0, phase
        if phase in ("get", "get_inline", "verify", "bitrot_verify"):
            assert c["kernel_gf_launches"] == 0, phase
        else:
            assert c["kernel_gf_launches"] > 0, phase


def test_s3_put_get_heal_on_card(cuda, tmp_path):
    """The S3 plane over HTTP at 12+4 and 1 MiB blocks on the card: the
    server's boot self-tests, aws-chunked and multipart PUTs, small
    objects, listing, GETs, lost drives, degraded GETs and an admin heal;
    exact bytes, and the kernels launched wherever a phase writes,
    rebuilds or decodes degraded data."""
    res = s3_put_get_heal(tmp_path, 3 * (1 << 20) + 777, device=cuda,
                          part_size=2 << 20, parts=2, last_part=12_345,
                          small_count=8, page=3, concurrent=2)
    assert all(res["checks"].values()), res["checks"]
    for phase in ("put", "multipart", "put_small", "degraded_get",
                  "degraded_get_multipart", "heal"):
        c = res["counters"][phase]
        assert c["kernel_gf_launches"] > 0, phase
        assert c["kernel_hash_launches"] > 0, phase
    for phase in ("get", "range_get"):
        c = res["counters"][phase]
        assert c["kernel_gf_launches"] == 0, phase
        assert c["kernel_hash_launches"] > 0, phase


def test_s3_core_on_card(cuda, tmp_path):
    """The S3 object core over HTTP at 12+4 and 1 MiB blocks on the card:
    versioned PUTs, a delete marker, versioned and degraded GETs, a
    CopyObject from the degraded source, UploadPartCopy, a metadata-only
    self-copy, tagging, DeleteObjects, a bucket policy and the heal of
    every version; exact bytes, kernel A launched by the degraded copy and
    the heals, and no kernel by the self-copy."""
    res = s3_core(tmp_path, 4 * (1 << 20) + 12_345, device=cuda,
                  small_count=8, page=3)
    assert all(res["checks"].values()), res["checks"]
    for phase in ("copy", "heal_bucket", "heal_versions", "degraded_get_v1"):
        assert res["counters"][phase]["kernel_gf_launches"] > 0, phase
    c = res["counters"]["self_copy"]
    assert c["kernel_gf_launches"] == c["kernel_hash_launches"] == 0
    assert res["copy_bytes"]["copy"]["pulls"] == 5


@pytest.mark.parametrize("length", [1, 33, 4096 + 22, 87382])
def test_grouped_verify_kernel_matches_plain(cuda, length):
    """Kernel B's grouped verify entry against its plain version: 12
    groups of n frames at a group pitch with slack, bad chunks in several
    groups, one first-bad index a group."""
    g_n, n = 12, (1 if length > 4096 + 22 else 5)
    group = n * (32 + length) + 7
    buf = _rand((1 + g_n * group,), length, cuda)[1:]
    for g in range(g_n):
        hh._rows(buf, g * group, 32 + length, n, 32).copy_(
            hh.hash256_pitched(buf, g * group + 32, 32 + length, n, length))
    assert hh.verify_frames_grouped(buf, g_n, group, n, length).tolist() \
        == [n] * g_n
    for g, i in dict.fromkeys(((0, 0), (4, n - 1), (11, 0), (11, n - 1))):
        buf[g * group + i * (32 + length) + 32 + length // 2] ^= 0x41
    before = hh.LAUNCHES.value
    got = hh.verify_frames_grouped(buf, g_n, group, n, length)
    assert hh.LAUNCHES.value == before + 1
    want = hh.verify_frames_grouped(buf.cpu(), g_n, group, n, length)
    assert got.cpu().tolist() == want.tolist()
    assert want[0] == 0 and want[4] == n - 1 and want[11] == 0
    assert want[1] == n


def test_pipelined_put_recycles_two_pinned_buffers(cuda, monkeypatch):
    """64 pipelined PUT batches through a pool that keeps 2 pinned
    buffers, so every batch packs into a buffer just recycled: every
    shard file must equal the serial driver's (pageable, no pool), every
    data chunk the payload's own bytes, and the pipelined PUT must copy
    nothing pageable to the card."""
    import io

    from minio_tpu_torch.erasure import streaming
    from minio_tpu_torch.erasure.bitrot import StreamingBitrotWriter
    from minio_tpu_torch.erasure.codec import Erasure
    from minio_tpu_torch.ops import host_feed
    from minio_tpu_torch.pipeline import BufferPool
    from minio_tpu_torch.utils import fanout

    k, m, block = 12, 4, 12 * 16384
    shard = block // k
    e = Erasure(k, m, block, device=cuda)
    payload = np.random.default_rng(64).bytes(64 * 8 * block)
    pools = []

    def two_buffer_pool(key, factory, capacity=6, name=""):
        pools.append(BufferPool(factory, capacity=2, name="two"))
        return pools[-1]

    monkeypatch.setattr(streaming, "shared_pool", two_buffer_pool)

    def put(single_core: bool) -> list:
        monkeypatch.setattr(fanout, "SINGLE_CORE", single_core)
        sinks = [io.BytesIO() for _ in range(k + m)]
        n = streaming.encode_stream(
            e, io.BytesIO(payload),
            [StreamingBitrotWriter(s, device=cuda) for s in sinks], k + 1)
        assert n == len(payload)
        return [s.getvalue() for s in sinks]

    host_feed.reset_h2d()
    piped = put(False)
    assert host_feed.h2d_snapshot()["pageable"] == 0
    assert host_feed.h2d_snapshot()["pinned"] == 64
    assert pools and pools[0].stats()["reused"] > 0
    for j in range(k):
        f = piped[j]
        for b in range(64 * 8):
            at = b * (32 + shard) + 32
            assert f[at: at + shard] == \
                payload[b * block + j * shard: b * block + (j + 1) * shard]
    serial = put(True)
    for i in range(k + m):
        assert piped[i] == serial[i], f"shard {i} differs"


def test_self_heal_on_card_equals_cpu(cuda, tmp_path, monkeypatch):
    """An MRF drain after a drive outage and a fresh-drive sweep (msr-pm
    objects through the repair plane) on the card at 12+4 and small
    blocks: every check holds, both kernels launch in the drain and the
    sweep, and every file of the 16 drives equals the same run on the
    CPU (ids and the clock made alike for both runs)."""
    import random
    import time as time_mod
    import types
    import uuid as uuid_mod

    from minio_tpu_torch.object import erasure_objects
    from minio_tpu_torch.storage import fileinfo

    monkeypatch.setenv("MTPU_INLINE_THRESHOLD", "4096")
    monkeypatch.setattr(erasure_objects, "BLOCK_SIZE_V2", 12 * 4096)
    clock = types.SimpleNamespace(
        time_ns=lambda: 1_700_000_000_000_000_000,
        monotonic=time_mod.monotonic)
    monkeypatch.setattr(erasure_objects, "time", clock)
    runs = {}
    for dev in (cuda, "cpu"):
        rng = random.Random(5)
        monkeypatch.setattr(fileinfo, "uuid", types.SimpleNamespace(
            uuid4=lambda: uuid_mod.UUID(int=rng.getrandbits(128),
                                        version=4)))
        res = object_self_heal(tmp_path / str(dev), 300_001, device=dev)
        assert all(res["checks"].values()), (dev, res["checks"])
        runs[str(dev)] = res
    for phase in ("mrf_drain", "sweep"):
        c = runs["cuda"]["counters"][phase]
        assert c["kernel_gf_launches"] > 0 and c["kernel_hash_launches"] > 0
    assert runs["cuda"]["files"] == runs["cpu"]["files"]


def _aes_batch(lengths, aads, seed, device):
    """Seal descriptor, plaintext, nonces and AADs of back-to-back
    packages on `device`."""
    rng = np.random.default_rng(seed)
    desc = aes_gcm.seal_desc(lengths, [len(a) for a in aads])
    p, n = len(desc), int(desc[:, 1].sum())
    aad = torch.from_numpy(np.frombuffer(b"".join(aads), dtype=np.uint8)
                           .copy()).to(device)
    return (rng.bytes(32), torch.from_numpy(desc).to(device),
            _rand((n,), seed, device), _rand((p, 12), seed + 1, device), aad,
            n + aes_gcm.OVERHEAD * p)


@pytest.mark.parametrize("packages", [1, 16, 33, 127, 256, 4097])
def test_aes_kernels_match_plain(cuda, packages):
    """Kernels C and D against the plain version: full 64 KiB packages
    (the last 12,345 B), <Q sequence AADs; each one launch. 127 is the
    card's batch, all full; 33 the closing one of 256 MiB + 12,345 B."""
    last = 65_536 if packages == 127 else 12_345
    lengths = [65_536] * (packages - 1) + [last]
    aads = [struct.pack("<Q", i) for i in range(packages)]
    key, desc, data, nonces, aad, n = _aes_batch(lengths, aads, packages,
                                                 cuda)
    before = aes_gcm_cuda.SEAL_LAUNCHES.value, aes_gcm_cuda.OPEN_LAUNCHES.value
    wire = aes_gcm_cuda.seal(key, data, desc, nonces, aad, n)
    assert torch.equal(wire, aes_gcm.seal_plain(key, data, desc, nonces,
                                                aad, n))
    odesc = aes_gcm.open_desc(desc)
    plain, ok = aes_gcm_cuda.open_(key, wire, odesc, aad, data.numel())
    assert bool(ok.all()) and torch.equal(plain, data)
    assert (aes_gcm_cuda.SEAL_LAUNCHES.value,
            aes_gcm_cuda.OPEN_LAUNCHES.value) == (before[0] + 1,
                                                  before[1] + 1)


@pytest.mark.parametrize("aad", [b"OEK", struct.pack("<Q", 9),
                                 b'{"bucket": "smoke"}'])
def test_aes_kernels_every_length(cuda, aad):
    lengths = [0, 1, 15, 16, 17, 32, 12_345, 65_536]
    key, desc, data, nonces, aad_t, n = _aes_batch(
        lengths, [aad] * len(lengths), len(aad), cuda)
    wire = aes_gcm_cuda.seal_cuda(key, data, desc, nonces, aad_t, n)
    assert torch.equal(wire, aes_gcm.seal_plain(key, data, desc, nonces,
                                                aad_t, n))


def test_aes_open_flags_exactly_the_tampered(cuda):
    lengths = [65_536] * 7 + [12_345]
    aads = [struct.pack("<Q", i) for i in range(8)]
    key, desc, data, nonces, aad, n = _aes_batch(lengths, aads, 8, cuda)
    wire = aes_gcm_cuda.seal_cuda(key, data, desc, nonces, aad, n)
    rows = desc.cpu().tolist()
    wire[rows[1][4] + 2] ^= 1                            # nonce
    wire[rows[3][4] + 12 + 100] ^= 1                     # ciphertext
    wire[rows[5][4] + 12 + rows[5][1] + 3] ^= 1          # tag
    aad[rows[7][2]] ^= 1                                 # AAD
    odesc = aes_gcm.open_desc(desc)
    got, ok = aes_gcm_cuda.open_cuda(key, wire, odesc, aad, data.numel())
    want, want_ok = aes_gcm.open_plain(key, wire, odesc, aad, data.numel())
    assert ok.bool().tolist() == want_ok.tolist() == [
        True, False, True, False, True, False, True, False]
    assert torch.equal(got, want)


def _aes_exact(key, batch, flips=()):
    """Kernel C and D against the plain version on one batch (chip_smoke's
    aes_case: ok flags false exactly at the flipped packages)."""
    errs = {"aes_gcm_seal": 0, "aes_gcm_open": 0}
    chip_smoke.aes_case(key, batch, "test", errs, flips=flips)
    assert errs == {"aes_gcm_seal": 0, "aes_gcm_open": 0}


@pytest.mark.parametrize("packages", [1, 64, 127])
def test_aes_kernels_at_cluster_edges(cuda, packages):
    """GHASH sequences that end exactly on a multiple of a cluster's
    threads and one block either side, at the cluster size each launch
    takes; beside them (64 and 127 packages) a zero-length package with no
    AAD, one with an AAD of 300 blocks and no message, and every other
    package of a different length."""
    rng = np.random.default_rng(packages)
    key = rng.bytes(32)
    if packages == 1:
        edges = chip_smoke.aes_edge_lengths(aes_gcm_cuda.cluster_size(1))
        for ln in edges + [0]:
            _aes_exact(key, chip_smoke.aes_batch(
                rng, [ln], [b"OEK" if ln else b""]))
        return
    lengths, aads = chip_smoke.aes_edge_batch(packages)
    assert len(set(lengths)) == packages - 1  # two zero-length packages
    _aes_exact(key, chip_smoke.aes_batch(rng, lengths, aads))


def test_aes_tampered_packages_zeroed_by_every_block(cuda):
    """127 full packages (a cluster of blocks each): the flipped ones fail
    and every byte of their plaintext is zero, the others come back."""
    rng = np.random.default_rng(127)
    key = rng.bytes(32)
    aads = [struct.pack("<Q", i) for i in range(127)]
    batch = chip_smoke.aes_batch(rng, [65_536] * 127, aads)
    _aes_exact(key, batch, flips=((0, "ct"), (5, "nonce"), (63, "tag"),
                                  (126, "aad")))
    desc, data, nonces, aad, n = batch
    wire = aes_gcm_cuda.seal_cuda(key, data, desc, nonces, aad, n)
    wire[int(desc[63, 4]) + 12 + 65_536] ^= 1  # package 63's tag
    got, ok = aes_gcm_cuda.open_cuda(key, wire, aes_gcm.open_desc(desc),
                                     aad, data.numel())
    assert ok.bool().tolist() == [p != 63 for p in range(127)]
    assert not bool(got[63 * 65_536:64 * 65_536].any())
    assert torch.equal(got[:63 * 65_536], data[:63 * 65_536])
    assert torch.equal(got[64 * 65_536:], data[64 * 65_536:])


def test_aes_seal_and_open_in_a_cuda_graph(cuda):
    rng = np.random.default_rng(16)
    errs = {"aes_gcm_seal": 0, "aes_gcm_open": 0}
    chip_smoke.aes_graph_case(rng.bytes(32), chip_smoke.aes_batch(
        rng, [65_536] * 15 + [12_345],
        [struct.pack("<Q", i) for i in range(16)]), errs)
    assert errs == {"aes_gcm_seal": 0, "aes_gcm_open": 0}


def test_aes_launches_counted_by_package_count(cuda):
    key, desc, data, nonces, aad, n = _aes_batch([100, 200, 300],
                                                 [b"OEK"] * 3, 3, cuda)
    before = aes_gcm_cuda.SEAL_LAUNCHES_BY_SHAPE.snapshot().get("3", 0)
    aes_gcm_cuda.seal_cuda(key, data, desc, nonces, aad, n)
    assert aes_gcm_cuda.SEAL_LAUNCHES_BY_SHAPE.snapshot()["3"] == before + 1


@pytest.mark.parametrize("i", range(len(chip_smoke.AES_GCM_KAT)))
def test_aead_known_answers_on_card(cuda, i):
    key, nonce, pt, aad, want = (bytes.fromhex(x)
                                 for x in chip_smoke.AES_GCM_KAT[i])
    aead = AESGCM(key, cuda)
    before = aes_gcm_cuda.SEAL_LAUNCHES.value
    assert aead.encrypt(nonce, pt, aad) == want
    assert aes_gcm_cuda.SEAL_LAUNCHES.value == before + 1
    assert aead.decrypt(nonce, want, aad) == pt


def test_s3_sse_on_card(cuda, tmp_path):
    """SSE-S3, SSE-C and SSE-KMS over HTTP at 12+4 and 1 MiB blocks on the
    card: exact bytes for every GET, ranged and degraded GET, heals that
    rebuild the originals without kernel C or D, a re-encrypting copy,
    and AccessDenied for a wrong SSE-C key; kernel C in every PUT and
    kernel D in every GET."""
    res = s3_sse(tmp_path, 4 * (1 << 20) + 12_345, device=cuda)
    assert all(res["checks"].values()), res["checks"]
    for mode in res["modes"]:
        c = res["counters"]
        assert c[f"{mode}:put"]["kernel_seal_launches"] > 0
        for step in ("get", "range_get", "degraded_get", "get_after_heal"):
            assert c[f"{mode}:{step}"]["kernel_open_launches"] > 0, step
        heal = c[f"{mode}:heal"]
        assert heal["kernel_gf_launches"] > 0
        assert heal["kernel_seal_launches"] == heal[
            "kernel_open_launches"] == 0


def test_sse_bounded_rss_on_card(cuda, tmp_path):
    """tests/test_streaming_transforms.py's bounded-RSS case on the port:
    every encrypted 192 MiB PUT and GET grows the resident set by less
    than minio_tpu's 96 MiB, the first PUT of the process (which also
    fills the pipelined drivers' pinned pools) included."""
    size = 192 << 20
    res = s3_sse(tmp_path, size, device=cuda, modes=("sse-s3", "sse-c"))
    assert all(res["checks"].values()), res["checks"]
    peak = res["rss_peak_bytes"]
    for step in ("sse-s3:put", "sse-s3:get", "sse-c:put", "sse-c:get"):
        assert peak[step] < 96 << 20, (step, peak)


def test_admission_drive_health_on_card(cuda, tmp_path):
    """Phase 4l at 4 MiB + 12,345 B objects on the card: fair grants
    across two keys, 503 SlowDown past a full queue and for a GET while
    the read governor is saturated, bucket tenants, a hung drive through
    degraded GETs and PUTs before and after the breaker latches, the heal
    paced by a foreground backlog; kernel A in the degraded GETs and the
    heal, and neither C nor D anywhere."""
    size = 4 * (1 << 20) + 12_345
    res = admission_drive_health(tmp_path, size, size, device=cuda)
    assert all(res["checks"].values()), res["checks"]
    for step in ("get_before_latch", "get_after_latch",
                 "heal_under_backlog"):
        assert res["counters"][step]["kernel_gf_launches"] > 0, step
    for step, c in res["counters"].items():
        assert c["kernel_seal_launches"] == c["kernel_open_launches"] == 0


def test_observability_on_card(cuda, tmp_path):
    """Phase 4m at 4 MiB + 12,345 B on the card: the health probes in
    every drive state, a PUT, GET, degraded GET and heal, an SSE-S3 PUT
    and GET, the scrapes and admin answers; every request tree whole,
    the ledger equal to the drives' bytes; kernels A and B in the PUT,
    degraded GET and heal, C in the SSE PUT and D in the SSE GET."""
    size = 4 * (1 << 20) + 12_345
    res = observability(tmp_path, size, device=cuda)
    assert all(res["checks"].values()), res["checks"]
    c = res["counters"]
    for step in ("put", "degraded_get", "heal"):
        assert c[step]["kernel_gf_launches"] > 0, step
        assert c[step]["kernel_hash_launches"] > 0, step
    assert c["sse_put"]["kernel_seal_launches"] > 0
    assert c["sse_get"]["kernel_open_launches"] > 0
    for step in ("put", "get", "degraded_get", "heal"):
        assert c[step]["kernel_seal_launches"] == 0, step
        assert c[step]["kernel_open_launches"] == 0, step


# --- kernels E and F (csrc/s2.cu) ----------------------------------------

@pytest.fixture(scope="module")
def s2_answers():
    """chip_smoke's phase-3 chunk pool and the plain codec's answer for
    each distinct chunk (the plain codec is a Python loop)."""
    pool = chip_smoke.s2_pool(np.random.default_rng(1234))
    return pool, chip_smoke.s2_plain(pool)


@pytest.mark.parametrize("chunks", chip_smoke.S2_BATCHES)
def test_s2_kernels_match_plain(cuda, s2_answers, chunks):
    """Kernel E's blocks, CRCs and lengths and kernel F's raw bytes and
    statuses equal the plain versions' over a batch cycling through 64 KiB
    of text, random bytes and zeros, the 12,345 B tail, lengths 0 to 8,
    the copy-remainder runs and the hard cases of E's window: periodic
    chunks, a first match at lane 31, chunks of 9, 31 and 40 B."""
    pool, plain = s2_answers
    names = chip_smoke.s2_batch_names(pool, chunks)
    before = s2_cuda.COMPRESS_LAUNCHES.value
    rows, out, crcs, lens = chip_smoke.s2_run_e(pool, names)
    assert s2_cuda.COMPRESS_LAUNCHES.value == before + 1
    for (_, _, o), name, crc, ln in zip(rows, names, crcs, lens):
        assert out[o:o + ln].tobytes() == plain[name][0], name
        assert crc == plain[name][1], name
    frames = [plain[n] for n in names]
    _, fout, status = chip_smoke.s2_run_f([f[3] for f in frames],
                                          [f[2] for f in frames],
                                          [len(pool[n]) for n in names])
    assert status == [f[5] for f in frames] == [s2.STATUS_OK] * chunks
    assert fout.tobytes() == b"".join(pool[n] for n in names)


def test_s2_decompress_status_flags(cuda, s2_answers):
    """F flags a flipped CRC byte (1) and a truncated block (2), as the
    plain version does, and decodes the good frame between them."""
    pool, plain = s2_answers
    bad = bytearray(plain["text0"][3])
    bad[2] ^= 0x01
    bodies = [bytes(bad), plain["text2"][3], plain["text3"][3][:-9]]
    _, fout, status = chip_smoke.s2_run_f(bodies, [0, 0, 0],
                                          [chip_smoke.PACKAGE] * 3)
    assert status == [s2.STATUS_CRC, s2.STATUS_OK, s2.STATUS_CORRUPT]
    p = chip_smoke.PACKAGE
    assert fout[p:2 * p].tobytes() == pool["text2"]


def test_s2_decompress_long_block(cuda):
    """F decodes a valid block longer than its staged window (1-byte
    copies, three bytes a tag), reading the rest of the body from global
    memory, as the plain version does."""
    p = chip_smoke.PACKAGE
    body = chip_smoke.long_block_body(p)
    plain, p_status = s2.decompress_plain(
        torch.frombuffer(bytearray(body), dtype=torch.uint8),
        torch.tensor([[0, 0, len(body), 0, p]], dtype=torch.int64), p)
    _, fout, status = chip_smoke.s2_run_f([body, body[:-1]], [0, 0],
                                          [p, p])
    assert p_status.tolist() == [s2.STATUS_OK]
    assert status == [s2.STATUS_OK, s2.STATUS_CORRUPT]
    assert fout[:p].tobytes() == plain.numpy().tobytes() == b"a" * p
    # The longest valid block of 64 KiB (a 10-byte varint, then a byte a
    # literal behind a 5-byte tag) decodes; one byte more is malformed.
    block = (b"\x80\x80\x84" + b"\x80" * 6 + b"\x00"
             + (b"\xfc\x00\x00\x00\x00b") * p)
    body = struct.pack("<I", s2._masked_crc(b"b" * p)) + block
    _, fout, status = chip_smoke.s2_run_f([body, body + b"b"], [0, 0],
                                          [p, p])
    assert status == [s2.STATUS_OK, s2.STATUS_CORRUPT]
    assert fout[:p].tobytes() == b"b" * p


@pytest.mark.parametrize("off", chip_smoke.S2_FAR_OFFSETS)
def test_s2_decompress_far_offset(cuda, s2_answers, off):
    """A 4-byte copy offset that no block takes (negative as a 32-bit int
    from 0x80000000 on) is malformed (status 2) as the first tag and after
    a literal, and the good frame beside them in the batch decodes: the
    launch faults nowhere."""
    pool, plain = s2_answers
    far = bytes([(7 << 2) | 3]) + off.to_bytes(4, "little")
    bodies = [bytes(4) + s2._varint(8) + far,
              bytes(4) + s2._varint(24) + bytes([15 << 2]) + bytes(16) + far,
              plain["text0"][3]]
    p = chip_smoke.PACKAGE
    _, fout, status = chip_smoke.s2_run_f(bodies, [0, 0, 0], [8, 24, p])
    assert status == [s2.STATUS_CORRUPT, s2.STATUS_CORRUPT, s2.STATUS_OK]
    assert fout[32:].tobytes() == pool["text0"]


def test_s2_decompress_hostile_blocks_match_plain(cuda, s2_answers):
    """F's statuses and raw bytes equal decompress_plain's over the blocks
    that hold F's warp model to the serial decode on the CPU
    (chip_smoke.s2_hostile_blocks: random tags of every kind cut, flipped
    and extended, copies at far offsets) and over two blocks longer than
    F's staged window (the 1-byte-copy block and the "mixed" chunk's),
    cut and flipped past it, as frames of one batch."""
    pool, plain = s2_answers
    p = chip_smoke.PACKAGE
    longs = [(chip_smoke.long_block_body(p)[4:], p), (plain["mixed"][0], p)]
    assert plain["mixed"][2] == 0
    assert min(len(b) for b, _ in longs) > chip_smoke.S2_BODY_STAGE
    status, p_status, fout, p_out, rows = chip_smoke.s2_run_hostile(
        np.random.default_rng(11), 1500, longs)
    assert status == p_status
    assert {s2.STATUS_OK, s2.STATUS_CRC, s2.STATUS_CORRUPT} <= set(status)
    for (_, _, _, o, n), st in zip(rows, p_status):
        if st != s2.STATUS_CORRUPT:
            assert fout[o:o + n].tobytes() == p_out[o:o + n].tobytes(), o


def test_s2_stream_through_the_transforms_on_card(cuda):
    """CompressReader and DecompressWriter on the card give minio_tpu's
    frames (the plain codec's bytes) and the text back; E launches once a
    batch of 128 chunks plus the probe."""
    import io

    from minio_tpu_torch.api import transforms as tfm

    text = entry.seeded_text((16 << 20) + 12_345, 3)
    before = s2_cuda.COMPRESS_LAUNCHES.value
    meta: dict = {}
    r = tfm.CompressReader(io.BytesIO(text), meta, device=cuda)
    stored = r.read()
    assert s2_cuda.COMPRESS_LAUNCHES.value - before == 1 + 3
    # The first four chunks' frames are the plain codec's.
    assert stored.startswith(s2.compress_stream(
        text[:4 * chip_smoke.PACKAGE], device="cpu"))
    out = io.BytesIO()
    w = tfm.DecompressWriter(out, device=cuda)
    for i in range(0, len(stored), 1 << 20):
        w.write(stored[i:i + (1 << 20)])
    w.close()
    assert out.getvalue() == text
    assert meta[tfm.META_COMPRESSED_SIZE] == str(len(stored))


def test_compressed_sse_bounded_rss_on_card(cuda, tmp_path):
    """A compressed SSE-S3 192 MiB PUT and its GET grow the resident set
    by less than minio_tpu's 96 MiB bound: the codec batches and never
    buffers the object."""
    from minio_tpu_torch.server import Server

    size = 192 << 20
    text = entry.seeded_text(size, 9)
    peak: dict = {}
    server = Server([str(tmp_path / "d{1...16}")], port=0,
                    root_user=entry.S3_ACCESS, root_password=entry.S3_SECRET,
                    default_parity=4, device=cuda)
    server.config_sys.config.set_kv("compression", enable="on",
                                    extensions=".log")
    server.s3.start()
    try:
        c = entry.S3Client(server.endpoint, entry.S3_ACCESS,
                           entry.S3_SECRET)
        assert c.request("PUT", "/rss")[0] == 200
        with entry._rss_peak(peak, "put"):
            st, _, _ = c.put_stream("/rss/big.log",
                                    entry._PayloadReader(text), size,
                                    entry.sse_put_headers("sse-s3"))
        assert st == 200
        with entry._rss_peak(peak, "get"):
            st, _, ok = entry._get_exact(c, "/rss/big.log", text)
        assert st == 200 and ok
    finally:
        server.stop()
    assert peak["put"] < 96 << 20 and peak["get"] < 96 << 20, peak


def test_config_compression_on_card(cuda, tmp_path):
    """Phase 4n at 4 MiB + 12,345 B on the card: E in the compressed
    PUTs and the probe, F in the compressed GETs, neither in the heal, C
    in the settings' saves, D in the SSE GET and the config's load at the
    restart, kernel A at 14+2 for the RRS object."""
    res = config_compression(tmp_path, 4 * (1 << 20) + 12_345, device=cuda,
                             range_size=1 << 20)
    assert all(res["checks"].values()), res["checks"]
    c = res["counters"]
    for step in ("put", "sse_put"):
        assert c[step]["kernel_compress_launches"] > 0, step
    assert c["random_put"]["kernel_compress_launches"] == 1
    for step in ("get", "range_get", "degraded_get", "sse_get",
                 "get_after_restart"):
        assert c[step]["kernel_decompress_launches"] > 0, step
    assert c["heal"]["kernel_compress_launches"] == 0
    assert c["heal"]["kernel_decompress_launches"] == 0
    assert c["heal"]["kernel_gf_launches"] > 0
    assert c["settings"]["kernel_seal_launches"] >= 2
    assert c["restart"]["kernel_open_launches"] >= 1
    assert res["gf_by_shape"]["rrs_put"].get("2x14", 0) > 0


def test_lock_quota_lifecycle_on_card(cuda, tmp_path):
    """Phase 4o on a 12+4 set at 16 MiB: the WORM refusal (no file of the
    key changed), the degraded GET and heal of a retained version (A and
    B), the quota's 409 on a PUT and an UploadPart (no kernel launch), and
    the aged noncurrent sweep."""
    size = 16 << 20
    res = entry.s3_lock_quota_lifecycle(tmp_path, size, device=cuda,
                                        small_size=4 << 20,
                                        refused_size=8 << 20,
                                        quota=20 << 20)
    assert all(res["checks"].values()), res["checks"]
    c = res["counters"]
    for step in ("worm_put_v1", "worm_degraded_get", "worm_heal",
                 "quota_put", "ilm_setup"):
        assert c[step]["kernel_gf_launches"] > 0, step
        assert c[step]["kernel_hash_launches"] > 0, step
    for step in ("worm_delete_v1", "quota_refused_put", "quota_refused_part",
                 "ilm_sweep"):
        assert c[step]["kernel_gf_launches"] == 0, step
        assert c[step]["kernel_hash_launches"] == 0, step
    assert res["ilm_expired_total"] == 3


def test_tiering_on_card(cuda, tmp_path):
    """Phase 4p on a 4+4 hot and cold pair at 8 MiB: transitioned, read
    back whole and ranged through the tier (B on the cold server, D and
    F on the hot), degraded on the cold server (A), restored (A and B)
    and dropped back to the tier; the heal keeps the tiered versions."""
    res = entry.s3_tiering(tmp_path, 8 << 20, device=cuda,
                           text_size=2 << 20, drives=8, parity=4,
                           lost=(0, 3, 4, 7), range_size=1 << 20)
    assert all(res["checks"].values()), res["checks"]
    c = res["counters"]
    for step in ("tier_transition", "tier_degraded_get", "tier_restore"):
        assert c[step]["kernel_gf_launches"] > 0, step
        assert c[step]["kernel_hash_launches"] > 0, step
    for step in ("tier_get", "tier_range_get"):
        assert c[step]["kernel_gf_launches"] == 0, step
        assert c[step]["kernel_hash_launches"] > 0, step
        assert c[step]["kernel_open_launches"] > 0, step
        assert c[step]["kernel_decompress_launches"] > 0, step
    for step in ("tier_restore_expiry", "tier_heal", "tier_remove_refused"):
        assert not any(c[step][f"kernel_{k}_launches"] for k in (
            "gf", "hash", "seal", "open", "compress", "decompress")), step
    assert res["ilm_transitioned_total"] == 3
    assert res["ilm_restored_total"] == 1


def test_identity_on_card(cuda, tmp_path):
    """Phase 4q on a 12+4 set at 16 MiB: IAM writes as .minio.sys PUTs (A
    and B), a user's, a temporary credential's, a web identity's SSE-S3
    and an LDAP identity's requests, form uploads, refusals with no
    launch, and a restart that loads the IAM from degraded blobs (A)."""
    res = entry.s3_identity(tmp_path, 16 << 20, device=cuda,
                            post_size=4 << 20, range_size=1 << 20)
    assert all(res["checks"].values()), res["checks"]
    c = res["counters"]
    for step in ("idp_add_user", "alice_put", "ldap_degraded_get",
                 "post_201", "iam_reload", "heal_iam"):
        assert c[step]["kernel_gf_launches"] > 0, step
        assert c[step]["kernel_hash_launches"] > 0, step
    assert c["web_sse_put"]["kernel_seal_launches"] > 0
    assert c["web_sse_get"]["kernel_open_launches"] > 0
    for step in ("alice_put_denied", "assume_role", "sts_get_no_token",
                 "web_identity_rs256", "post_refused", "after_restart"):
        assert not any(c[step][f"kernel_{k}_launches"] for k in (
            "gf", "hash", "seal", "open", "compress", "decompress")), step
