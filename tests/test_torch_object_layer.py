"""The port's object layer (ErasureSets -> ErasureObjects -> LocalStorage
with xl.meta) against minio_tpu's, on the CPU, byte for byte.

Each package builds one 12+4 set on 16 drive directories from the same
seeded inputs. Ids are made alike, not normalised: `uuid.uuid4` is
replaced by one seeded sequence, restarted for each package, and both
take the same calls in the same order, so the deployment id, the data
dirs and every other uuid agree; mod times come from
`ObjectOptions(mod_time_ns=...)`. So every file either package writes
(format.json, xl.meta, part.1) is compared whole. Both run with
MTPU_CODEC=dense-gf8, so that no measured auto-selection picks the codec,
and minio_tpu with MTPU_WORKER_POOL=0; the codec cases name their codec
on each PUT (ObjectOptions.codec), at 12+4 on 16 drives and at 4+4 on 8.

The port hashes on the CPU with its plain HighwayHash, a Python loop over
32-byte packets (~0.15 s a call at 4 KiB chunks, ~2 s at 87 KiB), so
every case but one runs at BLOCK_SIZE_V2 = 12 * 4096 in both packages,
with MTPU_INLINE_THRESHOLD = 4096 so that a few blocks still make part
files; one case runs at MinIO's 1 MiB block and 128 KiB threshold.
"""

import io
import os
import random
import shutil
import uuid

import numpy as np
import pytest
import torch

from minio_tpu.object import erasure_objects as jax_eo
from minio_tpu.object.metadata import hash_order as jax_hash_order
from minio_tpu.object.sets import ErasureSets as JaxErasureSets
from minio_tpu.object.types import ObjectOptions as JaxObjectOptions
from minio_tpu.storage.local import LocalStorage as JaxLocalStorage
from minio_tpu.utils.siphash import crc_hash_mod as jax_crc_hash_mod
from minio_tpu.utils.siphash import siphash_mod as jax_siphash_mod
from minio_tpu_torch.entry import object_put_get_heal
from minio_tpu_torch.object import erasure_objects
from minio_tpu_torch.object.metadata import hash_order
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.object.types import ObjectOptions
from minio_tpu_torch.storage.local import LocalStorage
from minio_tpu_torch.utils.siphash import crc_hash_mod, siphash_mod

torch.set_num_threads(1)

BUCKET, BIG, SMALL, EMPTY = "bucket", "dir/big.bin", "small.txt", "empty"
SMALL_BLOCK = 12 * 4096
BIG_SIZE = 3 * SMALL_BLOCK + 1234  # 3 full blocks and a ragged tail
SMALL_SIZE = 1000  # inline at the 4 KiB threshold
MOD_TIME = 1_700_000_000_123_456_789
LOST = (0, 5, 12, 15)  # data 0, 5 and parity 12, 15, by shard index
PORT, JAX = "port", "jax"


def _payload(seed: int, size: int) -> bytes:
    return np.random.default_rng(seed).bytes(size)


def _seed_uuids(mp, seed: int) -> None:
    rng = random.Random(seed)
    mp.setattr(uuid, "uuid4",
               lambda: uuid.UUID(int=rng.getrandbits(128), version=4))


def _set(pkg: str, root, fresh: bool, drives: int = 16):
    """A set of `drives` drives (default parity 4) of `pkg` over
    root/d{i}: formatted anew, or loaded from the format.json already
    there."""
    disks = [LocalStorage(str(root / f"d{i}"), endpoint=f"d{i}",
                          device="cpu") if pkg == PORT else
             JaxLocalStorage(str(root / f"d{i}"), endpoint=f"d{i}")
             for i in range(drives)]
    sets = (ErasureSets(disks, drives, default_parity=4, device="cpu")
            if pkg == PORT else
            JaxErasureSets(disks, drives, default_parity=4))
    if fresh:
        sets.init_format()
        sets.make_bucket(BUCKET)
    else:
        sets.load_format()
    return sets


def _opts(pkg: str, **kw):
    kw.setdefault("mod_time_ns", MOD_TIME)
    return (ObjectOptions if pkg == PORT else JaxObjectOptions)(**kw)


def _tree(root) -> dict:
    """Every file under root by relative path."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _get(sets, name, offset=0, length=-1) -> bytes:
    sink = io.BytesIO()
    sets.get_object(BUCKET, name, sink, offset, length)
    return sink.getvalue()


def _error(fn) -> str | None:
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 - compared by class name
        return type(exc).__name__
    return None


@pytest.fixture
def small_blocks(monkeypatch):
    monkeypatch.setenv("MTPU_CODEC", "dense-gf8")
    monkeypatch.setenv("MTPU_WORKER_POOL", "0")
    monkeypatch.setenv("MTPU_INLINE_THRESHOLD", "4096")
    monkeypatch.setattr(jax_eo, "BLOCK_SIZE_V2", SMALL_BLOCK)
    monkeypatch.setattr(erasure_objects, "BLOCK_SIZE_V2", SMALL_BLOCK)


@pytest.fixture
def written(small_blocks, tmp_path):
    """Both packages' sets after the same PUTs: root per package."""
    roots = {}
    for pkg in (PORT, JAX):
        roots[pkg] = tmp_path / pkg
        with pytest.MonkeyPatch.context() as mp:
            _seed_uuids(mp, 11)
            sets = _set(pkg, roots[pkg], fresh=True)
            sets.put_object(BUCKET, BIG, io.BytesIO(_payload(1, BIG_SIZE)),
                            BIG_SIZE, _opts(pkg))
            sets.put_object(BUCKET, SMALL,
                            io.BytesIO(_payload(2, SMALL_SIZE)), SMALL_SIZE,
                            _opts(pkg, user_defined={"x-k": "v"}))
            sets.put_object(BUCKET, EMPTY, io.BytesIO(b""), 0, _opts(pkg))
    return roots


def test_put_writes_the_same_drives(written):
    port, jax = _tree(written[PORT]), _tree(written[JAX])
    assert sorted(port) == sorted(jax)
    for path in port:
        assert port[path] == jax[path], f"{path} differs from minio_tpu's"
    names = {p.split(os.sep, 1)[1] for p in port}
    assert ".mtpu.sys/format.json" in names
    assert f"{BUCKET}/small.txt/xl.meta" in names  # inline: no part file
    assert sum(p.endswith("part.1") for p in port) == 16


def _shard_dirs(root, name):
    """(object dir, data dir) of every shard index, mapped to drives
    through the object's distribution."""
    fi = JaxLocalStorage(str(root / "d0")).read_version(BUCKET, name)
    drive = {d - 1: i for i, d in enumerate(fi.erasure.distribution)}
    return {s: (root / f"d{drive[s]}" / BUCKET / name, fi.data_dir)
            for s in drive}, drive


def _lose(root, name, lost=LOST):
    """Of the shards `lost` (data 0 and 5 and parity 12 and 15 at 12+4),
    the first two lose part.1, the third its object directory, and the
    fourth's part.1 is cut in half."""
    dirs, drive = _shard_dirs(root, name)
    for s in lost[:2]:
        (dirs[s][0] / dirs[s][1] / "part.1").unlink()
    shutil.rmtree(dirs[lost[2]][0])
    part = dirs[lost[3]][0] / dirs[lost[3]][1] / "part.1"
    with open(part, "r+b") as f:
        f.truncate(part.stat().st_size // 2)
    return drive


@pytest.mark.parametrize("reader,writer", [(PORT, PORT), (PORT, JAX),
                                           (JAX, PORT)])
def test_get_degraded_get_range_and_heal(written, tmp_path, reader, writer):
    """`reader`'s package serves and heals the set `writer`'s wrote."""
    root = tmp_path / f"{reader}-reads-{writer}"
    shutil.copytree(written[writer], root)
    before = _tree(root)
    sets = _set(reader, root, fresh=False)
    payload = _payload(1, BIG_SIZE)
    assert _get(sets, BIG) == payload
    assert _get(sets, SMALL) == _payload(2, SMALL_SIZE)

    drive = _lose(root, BIG)
    assert _get(sets, BIG) == payload
    off, ln = SMALL_BLOCK + 777, SMALL_BLOCK + 4321  # unaligned, 2 blocks
    assert _get(sets, BIG, off, ln) == payload[off:off + ln]
    assert sets.heal_object(BUCKET, BIG) == {
        "healed": [f"d{drive[s]}" for s in LOST], "dangling": False}
    after = _tree(root)
    for path, blob in before.items():
        if ".mtpu.sys" not in path:
            assert after.get(path) == blob, f"{path} not rebuilt exactly"
    assert sets.heal_object(BUCKET, BIG) == {"healed": [],
                                             "dangling": False}
    for disk in sets.sets[0].disks:
        disk.verify_file(BUCKET, BIG, disk.read_version(BUCKET, BIG))


@pytest.mark.parametrize("reader", [PORT, JAX])
def test_inline_object_degraded_and_healed(written, tmp_path, reader):
    root = tmp_path / f"copy-{reader}"
    shutil.copytree(written[PORT], root)
    before = _tree(root)
    sets = _set(reader, root, fresh=False)
    dirs, drive = _shard_dirs(root, SMALL)
    for s in LOST:
        shutil.rmtree(dirs[s][0])
    assert _get(sets, SMALL) == _payload(2, SMALL_SIZE)
    assert _get(sets, EMPTY) == b""
    info = sets.get_object_info(BUCKET, SMALL)
    assert (info.size, info.user_defined["x-k"]) == (SMALL_SIZE, "v")
    assert sets.heal_object(BUCKET, SMALL) == {
        "healed": [f"d{drive[s]}" for s in LOST], "dangling": False}
    assert _tree(root) == before


def test_delete_and_errors_match(written, tmp_path):
    outcomes = {}
    for pkg in (PORT, JAX):
        root = tmp_path / f"copy-{pkg}"
        shutil.copytree(written[pkg], root)
        sets = _set(pkg, root, fresh=False)
        got = [
            _error(lambda: _get(sets, "missing")),
            _error(lambda: sets.get_object("nobucket", BIG, io.BytesIO())),
            _error(lambda: _get(sets, BIG, BIG_SIZE - 5, 10)),
            _error(lambda: sets.delete_object(BUCKET, BIG)),
            _error(lambda: _get(sets, BIG)),
            _error(lambda: sets.get_object_info(BUCKET, BIG)),
            _error(lambda: sets.delete_object(BUCKET, BIG)),
            _error(lambda: sets.heal_object(BUCKET, BIG)),
        ]
        # Five of 16 shards of the inline object gone: below read quorum.
        dirs, _ = _shard_dirs(root, SMALL)
        for s in range(5):
            shutil.rmtree(dirs[s][0])
        got.append(_error(lambda: _get(sets, SMALL)))
        got.append(_error(lambda: sets.heal_object(BUCKET, SMALL)))
        outcomes[pkg] = got
        assert not (root / "d0" / BUCKET / "dir").exists()
    assert outcomes[PORT] == outcomes[JAX]
    assert outcomes[PORT][:8] == [
        "ErrObjectNotFound", "ErrBucketNotFound", "ErrInvalidArgument",
        None, "ErrObjectNotFound", "ErrObjectNotFound", "ErrObjectNotFound",
        "ErrObjectNotFound"]
    assert outcomes[PORT][8] is not None


def test_versioned_delete_marker_matches(small_blocks, tmp_path,
                                         monkeypatch):
    trees, outcomes = {}, {}
    for pkg in (PORT, JAX):
        _seed_uuids(monkeypatch, 3)
        sets = _set(pkg, tmp_path / pkg, fresh=True)
        data = _payload(4, 2 * SMALL_BLOCK)
        oi = sets.put_object(BUCKET, "v", io.BytesIO(data), len(data),
                             _opts(pkg, versioned=True))
        marker = sets.delete_object(BUCKET, "v", _opts(
            pkg, versioned=True, mod_time_ns=MOD_TIME + 1))
        vid_get = io.BytesIO()
        sets.get_object(BUCKET, "v", vid_get,
                        opts=_opts(pkg, version_id=oi.version_id))
        outcomes[pkg] = (
            marker.delete_marker, vid_get.getvalue() == data,
            _error(lambda: _get(sets, "v")),
            _error(lambda: sets.get_object(
                BUCKET, "v", io.BytesIO(),
                opts=_opts(pkg, version_id=marker.version_id))))
        trees[pkg] = _tree(tmp_path / pkg)
    assert outcomes[PORT] == outcomes[JAX] == (
        True, True, "ErrObjectNotFound", "ErrMethodNotAllowed")
    assert trees[PORT] == trees[JAX]


def test_one_mib_block(tmp_path, monkeypatch):
    """MinIO's 1 MiB block and 128 KiB inline threshold: the port's PUT
    writes minio_tpu's drives, and minio_tpu serves the port's object
    degraded; the port serves an inline object of 100 KiB."""
    monkeypatch.setenv("MTPU_CODEC", "dense-gf8")
    monkeypatch.setenv("MTPU_WORKER_POOL", "0")
    monkeypatch.delenv("MTPU_INLINE_THRESHOLD", raising=False)
    size = (1 << 20) + (600 << 10)  # 87,382 + 51,200 B shards: a part file
    payload, small = _payload(7, size), _payload(8, 100 << 10)
    trees, port_sets = {}, None
    for pkg in (PORT, JAX):
        _seed_uuids(monkeypatch, 5)
        sets = _set(pkg, tmp_path / pkg, fresh=True)
        sets.put_object(BUCKET, "big", io.BytesIO(payload), size, _opts(pkg))
        sets.put_object(BUCKET, "inline", io.BytesIO(small), len(small),
                        _opts(pkg))
        trees[pkg] = _tree(tmp_path / pkg)
        port_sets = port_sets or sets
    assert trees[PORT] == trees[JAX]
    assert sum(p.endswith("part.1") for p in trees[PORT]) == 16
    _lose(tmp_path / PORT, "big")
    jax_sets = _set(JAX, tmp_path / PORT, fresh=False)
    assert _get(jax_sets, "big") == payload
    assert _get(port_sets, "inline") == small


def test_object_put_get_heal_entry(small_blocks, tmp_path):
    """The entry point chip_smoke.py drives, on the CPU: every check
    holds, and the healthy GETs rebuild nothing (no GF application)."""
    res = object_put_get_heal(tmp_path, 5 * SMALL_BLOCK + 333, device="cpu",
                              inline_size=SMALL_SIZE)
    assert all(res["checks"].values()), res["checks"]
    c = res["counters"]
    assert c["get"]["launches_gf"] == c["get_inline"]["launches_gf"] == 0
    for phase in ("put", "degraded_get", "range_get", "heal", "bitrot_get"):
        assert c[phase]["launches_gf"] > 0 and c[phase]["launches_hash"] > 0
    # Heal rebuilds the whole part: one GF launch a batch, as the PUT.
    assert c["heal"]["launches_gf"] == c["put"]["launches_gf"]


@pytest.mark.parametrize("set_count", [2, 4, 16])
def test_placement_matches(set_count):
    rng = random.Random(set_count)
    dep = uuid.UUID(int=rng.getrandbits(128), version=4)
    names = [f"obj/{rng.getrandbits(64):x}/{i}" for i in range(1000)]
    for name in names:
        assert siphash_mod(name, set_count, dep.bytes) == \
            jax_siphash_mod(name, set_count, dep.bytes)
        assert hash_order(name, set_count) == jax_hash_order(name, set_count)
        assert crc_hash_mod(name, set_count) == \
            jax_crc_hash_mod(name, set_count)
    port = ErasureSets([None] * (set_count * 4), 4, deployment_id=str(dep),
                       device="cpu")
    jax = JaxErasureSets([None] * (set_count * 4), 4,
                         deployment_id=str(dep))
    assert [port.get_hashed_set_index(n) for n in names] == \
        [jax.get_hashed_set_index(n) for n in names]


def test_buckets_format_and_etag_match(tmp_path):
    from minio_tpu.object.types import compute_etag as jax_compute_etag
    from minio_tpu_torch.object.types import compute_etag

    seen = {}
    for pkg in (PORT, JAX):
        with pytest.MonkeyPatch.context() as mp:
            _seed_uuids(mp, 9)
            first = _set(pkg, tmp_path / pkg, fresh=True)
        first.make_bucket("b2")
        first.make_bucket("b2")  # already there on every disk: no error
        names = [b.name for b in first.list_buckets()]
        exists = (first.bucket_exists("b2"), first.bucket_exists("b3"))
        first.delete_bucket("b2")
        again = _set(pkg, tmp_path / pkg, fresh=False)
        seen[pkg] = (names, exists, first.bucket_exists("b2"),
                     again.deployment_id == first.deployment_id,
                     [d.get_disk_id() for d in again.sets[0].disks],
                     _error(lambda: again.delete_bucket("b2")))
    assert seen[PORT] == seen[JAX]
    assert seen[PORT][:4] == (["b2", BUCKET], (True, False), False, True)
    assert seen[PORT][4] == [f"disk-0-{i}" for i in range(16)]
    digest = bytes(range(16))
    for parts in (0, 1, 7):
        assert compute_etag(digest, parts) == jax_compute_etag(digest, parts)
    assert compute_etag(None) == jax_compute_etag(None) == ""


@pytest.mark.parametrize("single_core", [False, True],
                         ids=["pipelined", "serial"])
def test_delegated_md5_etag_matches(small_blocks, tmp_path, monkeypatch,
                                    single_core):
    """A PUT of 9 blocks + 13 B: on the pipelined encode the MD5 is a
    stage of its own (TeeMD5Reader.delegate_hashing), on the serial one
    the reader hashes as it goes. Either way the ETag is minio_tpu's and
    the 16 drives hold minio_tpu's files."""
    import hashlib

    from minio_tpu_torch.utils import fanout

    monkeypatch.setattr(fanout, "SINGLE_CORE", single_core)
    size = 9 * SMALL_BLOCK + 13
    payload = _payload(3, size)
    etags = {}
    for pkg in (PORT, JAX):
        with pytest.MonkeyPatch.context() as mp:
            _seed_uuids(mp, 12)
            sets = _set(pkg, tmp_path / pkg, fresh=True)
            etags[pkg] = sets.put_object(BUCKET, "nine", io.BytesIO(payload),
                                         size, _opts(pkg)).etag
    assert etags[PORT] == etags[JAX] == hashlib.md5(payload).hexdigest()
    port, jax = _tree(tmp_path / PORT), _tree(tmp_path / JAX)
    assert sorted(port) == sorted(jax)
    assert all(port[p] == jax[p] for p in port)


@pytest.mark.parametrize("pipelined", [True, False])
def test_tee_md5_reader_matches_minio_tpu(pipelined):
    """TeeMD5Reader with its hashing thread or inline, through read() and
    readinto() and a delegate_hashing() hand-off midway: minio_tpu's MD5
    and byte count."""
    import hashlib

    from minio_tpu.object.types import TeeMD5Reader as JaxTee
    from minio_tpu_torch.object.types import TeeMD5Reader

    data = _payload(4, (5 << 20) + 3)
    digests = []
    for cls in (TeeMD5Reader, JaxTee):
        tee = cls(io.BytesIO(data), pipelined=pipelined, size=len(data))
        buf = bytearray(70_001)
        got = [tee.read(100_000)]
        n = tee.readinto(buf)
        got.append(bytes(buf[:n]))  # the tee hashes a snapshot
        buf[:] = b"\0" * len(buf)   # so reusing the buffer changes nothing
        got.append(tee.read(1 << 20))
        assert tee.bytes_read == sum(map(len, got))
        src, update = tee.delegate_hashing()
        rest = src.read()
        update(rest)
        assert b"".join(got) + rest == data
        digests.append(tee.md5_hex())
    assert digests[0] == digests[1] == hashlib.md5(data).hexdigest()


def test_tee_md5_reader_pipelines_only_large_streams_on_many_cores(
        monkeypatch):
    import hashlib

    from minio_tpu_torch.object.types import TeeMD5Reader
    from minio_tpu_torch.utils import fanout

    monkeypatch.setattr(fanout, "SINGLE_CORE", False)
    big = TeeMD5Reader(io.BytesIO(b"x" * 10), size=8 << 20)
    small = TeeMD5Reader(io.BytesIO(b"x" * 10), size=1000)
    assert big._want_pipeline and not small._want_pipeline
    assert big._queue is None  # the hashing thread starts lazily
    assert big.read(10) == small.read(10) == b"x" * 10
    assert big._queue is not None and small._queue is None
    assert big.md5_hex() == small.md5_hex() == \
        hashlib.md5(b"x" * 10).hexdigest()
    assert big._queue is None  # drained, its thread joined
    monkeypatch.setattr(fanout, "SINGLE_CORE", True)
    assert not TeeMD5Reader(io.BytesIO(b""), size=8 << 20)._want_pipeline


# Codec cases: (codec, drives); the lost shards are 0, 5, 12, 15 at 12+4
# and 0, 3, 4, 7 at 4+4.
CODEC_LOST = {16: LOST, 8: (0, 3, 4, 7)}


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)])
@pytest.mark.parametrize("codec,drives", [
    ("dense-gf8", 16), ("cauchy-xor", 16), ("msr-pm", 16),
    ("dense-gf8", 8), ("cauchy-xor", 8), ("msr-pm", 8)])
def test_codec_objects_cross_packages(small_blocks, tmp_path, codec, drives,
                                      writer, reader):
    """Both packages write one object under `codec` (ObjectOptions.codec)
    to the same drives byte for byte; `reader`'s package then reads the
    set `writer`'s wrote, degraded and ranged, heals the lost shards,
    and heals one more lost drive alone (through the repair plane where
    the codec has a plan): every file as it was."""
    payload = _payload(1, BIG_SIZE)
    for pkg in (PORT, JAX):
        with pytest.MonkeyPatch.context() as mp:
            _seed_uuids(mp, 13)
            sets = _set(pkg, tmp_path / pkg, fresh=True, drives=drives)
            sets.put_object(BUCKET, BIG, io.BytesIO(payload), BIG_SIZE,
                            _opts(pkg, codec=codec))
    written = _tree(tmp_path / writer)
    assert written == _tree(tmp_path / (JAX if writer == PORT else PORT))
    fi = JaxLocalStorage(str(tmp_path / writer / "d0")).read_version(
        BUCKET, BIG)
    assert fi.erasure.codec == codec

    root = tmp_path / f"{reader}-reads-{writer}"
    shutil.copytree(tmp_path / writer, root)
    sets = _set(reader, root, fresh=False, drives=drives)
    assert _get(sets, BIG) == payload
    lost = CODEC_LOST[drives]
    drive = _lose(root, BIG, lost)
    assert _get(sets, BIG) == payload
    off, ln = SMALL_BLOCK + 777, SMALL_BLOCK + 4321
    assert _get(sets, BIG, off, ln) == payload[off:off + ln]
    assert sets.heal_object(BUCKET, BIG) == {
        "healed": [f"d{drive[s]}" for s in lost], "dangling": False}
    assert _tree(root) == written
    shutil.rmtree(root / f"d{drive[1]}" / BUCKET / BIG)
    assert sets.heal_object(BUCKET, BIG) == {
        "healed": [f"d{drive[1]}"], "dangling": False}
    assert _tree(root) == written
    assert _get(sets, BIG) == payload
