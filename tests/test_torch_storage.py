"""The port's LocalStorage against minio_tpu's, on the CPU: the same
calls on two fresh drive directories leave the same files (xl.meta and
part files byte for byte) and raise the same error classes by name.
Covers make_vol, write_metadata, read_version, rename_data,
delete_version, check_parts and verify_file on good, corrupted,
truncated and missing part files."""

import os

import numpy as np
import pytest
import torch

from minio_tpu.erasure.bitrot import StreamingBitrotWriter as JaxWriter
from minio_tpu.storage.fileinfo import (
    ChecksumInfo as JaxChecksumInfo,
    ErasureInfo as JaxErasureInfo,
    FileInfo as JaxFileInfo,
)
from minio_tpu.storage.local import LocalStorage as JaxLocalStorage
from minio_tpu_torch.erasure.bitrot import StreamingBitrotWriter
from minio_tpu_torch.storage.fileinfo import (
    ChecksumInfo,
    ErasureInfo,
    FileInfo,
)
from minio_tpu_torch.storage.local import SYSTEM_META_BUCKET, LocalStorage

torch.set_num_threads(1)

K, M, BLOCK = 12, 4, 12 * 4096
SIZE = 3 * BLOCK + 1234  # three full chunks of 4,096 B and one of 103 B
DATA_DIR, TMP = "0b9c1d57-7a9e-4f3c-9a7e-5f1b2c3d4e5f", "tmp/stage-1"


class Side:
    """One package's LocalStorage and constructors."""

    def __init__(self, root, port: bool, fsync: bool = False):
        self.port = port
        self.disk = (LocalStorage(str(root), endpoint="d0", fsync=fsync,
                                  device="cpu") if port else
                     JaxLocalStorage(str(root), endpoint="d0", fsync=fsync))
        self.root = root

    def file_info(self, version_id="", mod_time_ns=1000, data=None,
                  data_dir=DATA_DIR):
        fi_cls, ei_cls, ci_cls = ((FileInfo, ErasureInfo, ChecksumInfo)
                                  if self.port else (JaxFileInfo,
                                                     JaxErasureInfo,
                                                     JaxChecksumInfo))
        fi = fi_cls(volume="bucket", name="dir/obj", version_id=version_id,
                    data_dir=data_dir, mod_time_ns=mod_time_ns, size=SIZE,
                    metadata={"etag": "0" * 32},
                    erasure=ei_cls(data_blocks=K, parity_blocks=M,
                                   block_size=BLOCK, index=3,
                                   distribution=list(range(1, 17)),
                                   checksums=[ci_cls(1, "highwayhash256S")],
                                   codec="dense-gf8"),
                    data=data or {})
        fi.add_part(1, SIZE, SIZE)
        return fi

    def stage_part(self, shard: bytes) -> None:
        sink = self.disk.create_file_writer(SYSTEM_META_BUCKET,
                                            f"{TMP}/part.1")
        w = (StreamingBitrotWriter(sink, device="cpu") if self.port
             else JaxWriter(sink))
        for off in range(0, len(shard), BLOCK // K):
            w.write(shard[off: off + BLOCK // K])
        sink.close()

    def tree(self) -> dict:
        """Every file under the drive, by its path relative to the root."""
        out = {}
        for dirpath, _, files in os.walk(self.root):
            for f in files:
                p = os.path.join(dirpath, f)
                out[os.path.relpath(p, self.root)] = open(p, "rb").read()
        return out


@pytest.fixture(params=[False, True], ids=["buffered", "fsync"])
def sides(tmp_path, request):
    return (Side(tmp_path / "port", True, request.param),
            Side(tmp_path / "jax", False, request.param))


def outcome(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 - compared by class name
        return type(exc).__name__
    return None


def both(sides, call):
    """Run call(side) on both packages; return the port's outcome after
    checking that minio_tpu's is the same."""
    got = [outcome(lambda s=s: call(s)) for s in sides]
    assert got[0] == got[1], got
    return got[0]


SHARD = np.random.default_rng(5).bytes(3 * (BLOCK // K) + 103)


def test_volumes_and_error_names(sides):
    assert both(sides, lambda s: s.disk.make_vol("bucket")) is None
    assert both(sides, lambda s: s.disk.make_vol("bucket")) == \
        "ErrVolumeExists"
    assert both(sides, lambda s: s.disk.stat_vol("nope")) == \
        "ErrVolumeNotFound"
    assert both(sides, lambda s: s.disk.read_version("nope", "o")) == \
        "ErrVolumeNotFound"
    assert both(sides, lambda s: s.disk.read_version("bucket", "o")) == \
        "ErrFileNotFound"
    assert both(sides, lambda s: s.disk.read_all("bucket", "x")) == \
        "ErrFileNotFound"
    assert both(sides, lambda s: s.disk.read_version("bucket", "../x")) == \
        "ErrInvalidArgument"
    assert both(sides, lambda s: s.disk.write_all("bucket", "a/f", b"1")) \
        is None
    assert both(sides, lambda s: s.disk.delete_vol("bucket")) == \
        "ErrVolumeNotEmpty"
    assert both(sides, lambda s: s.disk.delete("bucket", "a")) == \
        "ErrVolumeNotEmpty"
    assert both(sides, lambda s: s.disk.delete("bucket", "a",
                                               recursive=True)) is None
    assert both(sides, lambda s: s.disk.delete_vol("bucket")) is None
    assert [v.name for v in sides[0].disk.list_vols()] == \
        [v.name for v in sides[1].disk.list_vols()] == [".mtpu.sys"]
    for s in sides:
        s.disk.set_online(False)
    assert both(sides, lambda s: s.disk.make_vol("b2")) == "ErrDiskNotFound"


def test_metadata_journal_matches(sides):
    both(sides, lambda s: s.disk.make_vol("bucket"))
    inline = {1: b"\x07" * 300}
    assert both(sides, lambda s: s.disk.write_metadata(
        "bucket", "dir/obj", s.file_info("", 1000, inline, ""))) is None
    assert both(sides, lambda s: s.disk.write_metadata(
        "bucket", "dir/obj", s.file_info("v1", 2000, inline, ""))) is None
    assert sides[0].tree() == sides[1].tree()
    port, jax = (s.disk for s in sides)
    for vid, read_data in (("", False), ("v1", True), ("null", True)):
        a = port.read_version("bucket", "dir/obj", vid, read_data)
        b = jax.read_version("bucket", "dir/obj", vid, read_data)
        assert a.to_dict() == b.to_dict()
        assert (a.is_latest, a.num_versions) == (b.is_latest, b.num_versions)
    assert both(sides, lambda s: s.disk.read_version(
        "bucket", "dir/obj", "v9")) == "ErrFileVersionNotFound"
    assert both(sides, lambda s: s.disk.delete_version(
        "bucket", "dir/obj", s.file_info("v1"))) is None
    assert sides[0].tree() == sides[1].tree()
    assert both(sides, lambda s: s.disk.delete_version(
        "bucket", "dir/obj", s.file_info("v1"))) == "ErrFileVersionNotFound"
    assert both(sides, lambda s: s.disk.delete_version(
        "bucket", "dir/obj", s.file_info(""))) is None
    # The journal emptied: the object directory and its parent are gone.
    assert os.listdir(sides[0].root / "bucket") == \
        os.listdir(sides[1].root / "bucket") == []


def test_rename_data_check_parts_and_verify_file(sides):
    both(sides, lambda s: s.disk.make_vol("bucket"))
    for s in sides:
        s.stage_part(SHARD)
    assert both(sides, lambda s: s.disk.rename_data(
        SYSTEM_META_BUCKET, TMP, s.file_info(), "bucket", "dir/obj")) is None
    assert sides[0].tree() == sides[1].tree()
    assert both(sides, lambda s: s.disk.rename_data(
        SYSTEM_META_BUCKET, TMP, s.file_info(), "bucket", "dir/obj")) == \
        "ErrFileNotFound"  # nothing staged any more

    def read(s):
        return s.disk.read_version("bucket", "dir/obj", read_data=True)

    assert both(sides, lambda s: s.disk.check_parts(
        "bucket", "dir/obj", read(s))) is None
    assert both(sides, lambda s: s.disk.verify_file(
        "bucket", "dir/obj", read(s))) is None
    part = f"bucket/dir/obj/{DATA_DIR}/part.1"
    with open(sides[0].root / part, "rb") as f:
        good = f.read()

    def damage(mutate):
        for s in sides:
            with open(s.root / part, "wb") as f:
                f.write(mutate(good))

    flipped = bytearray(good)
    flipped[32 + 4096 + 32 + 17] ^= 0x20  # in the second chunk
    damage(lambda b: bytes(flipped))
    assert both(sides, lambda s: s.disk.check_parts(
        "bucket", "dir/obj", read(s))) is None  # sizes only
    assert both(sides, lambda s: s.disk.verify_file(
        "bucket", "dir/obj", read(s))) == "ErrFileCorrupt"
    flipped = bytearray(good)
    flipped[5] ^= 1  # in the first frame's digest
    damage(lambda b: bytes(flipped))
    assert both(sides, lambda s: s.disk.verify_file(
        "bucket", "dir/obj", read(s))) == "ErrFileCorrupt"
    damage(lambda b: b[:-1])
    assert both(sides, lambda s: s.disk.check_parts(
        "bucket", "dir/obj", read(s))) == "ErrFileCorrupt"
    assert both(sides, lambda s: s.disk.verify_file(
        "bucket", "dir/obj", read(s))) == "ErrFileCorrupt"
    for s in sides:
        os.remove(s.root / part)
    assert both(sides, lambda s: s.disk.check_parts(
        "bucket", "dir/obj", read(s))) == "ErrFileNotFound"
    assert both(sides, lambda s: s.disk.verify_file(
        "bucket", "dir/obj", read(s))) == "ErrFileNotFound"


def test_verify_file_reads_inline_parts(sides):
    both(sides, lambda s: s.disk.make_vol("bucket"))
    framed = {}
    for s in sides:
        s.stage_part(SHARD)
        with open(s.root / SYSTEM_META_BUCKET / TMP / "part.1", "rb") as f:
            framed[s.port] = f.read()
    assert framed[True] == framed[False]
    both(sides, lambda s: s.disk.write_metadata(
        "bucket", "o", s.file_info(data={1: framed[True]}, data_dir="")))
    assert sides[0].tree() == sides[1].tree()
    assert both(sides, lambda s: s.disk.verify_file(
        "bucket", "o", s.disk.read_version("bucket", "o",
                                           read_data=True))) is None
    bad = bytearray(framed[True])
    bad[-1] ^= 1
    assert both(sides, lambda s: s.disk.verify_file(
        "bucket", "o", s.file_info(data={1: bytes(bad)},
                                   data_dir=""))) == "ErrFileCorrupt"


def test_purge_stale_tmp_and_offline(sides):
    port = sides[0].disk
    port.make_vol("bucket")
    sides[0].stage_part(b"x" * 10)
    assert port.purge_stale_tmp() == sides[1].disk.purge_stale_tmp() + 1
    assert port.purge_stale_tmp() == 0
    port.set_online(False)
    with pytest.raises(Exception) as info:
        port.verify_file("bucket", "o", sides[0].file_info())
    assert type(info.value).__name__ == "ErrDiskNotFound"
