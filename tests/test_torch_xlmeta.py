"""The port's msgpack subset and xl.meta against what minio_tpu writes:
`_msgpack.packb` / `unpackb` against the real `msgpack` package (which
the card machine does not have) over the types xl.meta holds, and
`XLMeta.to_bytes` against minio_tpu's XLMeta for the same journal."""

import msgpack
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from minio_tpu.storage.fileinfo import FileInfo as JaxFileInfo
from minio_tpu.storage.xlmeta import XLMeta as JaxXLMeta
from minio_tpu_torch.storage import _msgpack
from minio_tpu_torch.storage.fileinfo import (
    ChecksumInfo,
    ErasureInfo,
    FileInfo,
)
from minio_tpu_torch.storage.xlmeta import XLMeta, read_xl_meta
from minio_tpu_torch.utils.errors import (
    ErrCorruptedFormat,
    ErrFileVersionNotFound,
)


def _theirs(obj) -> bytes:
    return msgpack.packb(obj, use_bin_type=True)


def _their_unpack(buf):
    return msgpack.unpackb(buf, raw=False, strict_map_key=False)


# Every width boundary of msgpack's int forms, both sides of each.
_EDGES = [0, 31, 32, 127, 128, 255, 256, (1 << 16) - 1, 1 << 16,
          (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63, (1 << 64) - 1]
INT_EDGES = sorted({s * e + d for e in _EDGES for s in (1, -1)
                    for d in (-1, 0, 1)
                    if -(1 << 63) <= s * e + d < (1 << 64)})

scalars = (st.none() | st.booleans() | st.sampled_from(INT_EDGES)
           | st.integers(-(1 << 63), (1 << 64) - 1)
           | st.floats(allow_nan=False) | st.text(max_size=300)
           | st.binary(max_size=300))
keys = st.text(max_size=40) | st.integers(-(1 << 63), (1 << 64) - 1)
docs = st.recursive(
    scalars,
    lambda children: (st.lists(children, max_size=20)
                      | st.dictionaries(keys, children, max_size=20)),
    max_leaves=60)


@settings(max_examples=300, deadline=None)
@given(docs)
def test_packb_matches_msgpack(doc):
    ours = _msgpack.packb(doc)
    assert ours == _theirs(doc)
    assert _msgpack.unpackb(ours) == _their_unpack(ours)


@pytest.mark.parametrize("value", INT_EDGES)
def test_int_width_boundaries(value):
    assert _msgpack.packb(value) == _theirs(value)
    assert _msgpack.unpackb(_theirs(value)) == value


@pytest.mark.parametrize("n", [0, 15, 16, 31, 32, 255, 256, 65535, 65536])
def test_container_length_boundaries(n):
    for doc in ("x" * n, b"x" * n, [1] * n,
                {str(i): None for i in range(min(n, 70000))}):
        assert _msgpack.packb(doc) == _theirs(doc)
        assert _msgpack.unpackb(_theirs(doc)) == _their_unpack(_theirs(doc))


def test_unpackb_reads_float32_and_refuses_the_rest():
    assert _msgpack.unpackb(b"\xca\x3f\xc0\x00\x00") == 1.5
    for bad in (b"\xc1", b"\xd4\x01\x02", b"\x92\x01", b"\x01\x02"):
        with pytest.raises(_msgpack.PackError):
            _msgpack.unpackb(bad)
    with pytest.raises(_msgpack.PackError):
        _msgpack.packb({1, 2})
    with pytest.raises(_msgpack.PackError):
        _msgpack.packb(1 << 64)


def _journal(cls_fi, cls_ei, cls_ci):
    """Three versions (one inline, one delete marker) as either
    package's FileInfo, built field for field alike."""
    out = []
    for i, (vid, deleted, data) in enumerate(
            [("", False, {}), ("v-1", False, {1: b"\x00\xff" * 700}),
             ("v-2", True, {})]):
        fi = cls_fi(volume="bucket", name="a/b.bin", version_id=vid,
                    deleted=deleted, data_dir="" if deleted else f"dd-{i}",
                    mod_time_ns=1_700_000_000_000_000_000 + i, size=1000 * i,
                    metadata={} if deleted else {"etag": "e" * 32,
                                                 "content-type": "x/y"},
                    erasure=cls_ei() if deleted else cls_ei(
                        algorithm="rs-vandermonde", data_blocks=12,
                        parity_blocks=4, block_size=1 << 20, index=i + 3,
                        distribution=list(range(16, 0, -1)),
                        checksums=[cls_ci(1, "highwayhash256S")],
                        codec="dense-gf8"),
                    data=data)
        if not deleted:
            fi.add_part(1, fi.size, fi.size)
        out.append(fi)
    return out


def test_xlmeta_bytes_match_minio_tpu():
    from minio_tpu.storage.fileinfo import (
        ChecksumInfo as JaxChecksumInfo,
        ErasureInfo as JaxErasureInfo,
    )

    ours, theirs = XLMeta(), JaxXLMeta()
    for fi in _journal(FileInfo, ErasureInfo, ChecksumInfo):
        ours.add_version(fi)
    for fi in _journal(JaxFileInfo, JaxErasureInfo, JaxChecksumInfo):
        theirs.add_version(fi)
    blob = ours.to_bytes()
    assert blob == theirs.to_bytes()
    back = XLMeta.from_bytes(JaxXLMeta.from_bytes(blob).to_bytes())
    assert back.versions == ours.versions
    assert [v["vid"] for v in back.versions] == ["v-2", "v-1", ""]
    latest = read_xl_meta(blob, "bucket", "a/b.bin", "")
    assert latest.deleted and latest.is_latest and latest.num_versions == 3
    fi = read_xl_meta(blob, "bucket", "a/b.bin", "v-1")
    assert fi.data == {1: b"\x00\xff" * 700} and not fi.is_latest
    assert fi.erasure.shard_file_size(fi.size) == \
        JaxFileInfo.from_dict(fi.to_dict()).erasure.shard_file_size(fi.size)
    null = read_xl_meta(blob, "bucket", "a/b.bin", "null")
    assert null.version_id == "" and null.data_dir == "dd-0"
    with pytest.raises(ErrFileVersionNotFound):
        read_xl_meta(blob, "bucket", "a/b.bin", "v-9")


def test_xlmeta_refuses_corrupt_and_unknown_codecs():
    for bad in (b"", b"XL2 \x80", b"XLT1\x82\xa3ver\x02", b"XLT1\xc1"):
        with pytest.raises(ErrCorruptedFormat):
            XLMeta.from_bytes(bad)
    fi = _journal(FileInfo, ErasureInfo, ChecksumInfo)[0]
    d = fi.to_dict()
    d["er"]["cid"] = "bogus-codec"
    with pytest.raises(ValueError, match="does not have"):
        FileInfo.from_dict(d)
    d["er"]["cid"] = "msr-pm"  # a known codec under another's algorithm
    with pytest.raises(ValueError, match="mismatch"):
        FileInfo.from_dict(d)
    del d["er"]["cid"]  # metadata from before codec ids reads as dense
    assert FileInfo.from_dict(d).erasure.codec == "dense-gf8"
