"""Compression and the storage classes on the port against minio_tpu,
over HTTP on localhost, on the CPU (kernels E and F take their plain
versions here; they are held to them on the card).

- The compression cases of tests/test_streaming_transforms.py and the
  storage-class cases of tests/test_tagging_acl_storageclass.py, case
  for case on both packages' S3Servers, with the `compression` and
  `storage_class` subsystems of a ConfigSys.
- With os.urandom seeded and ids and clocks made alike, both packages
  write byte-identical drive files at 12+4 for a compressed PUT, a
  compressed + SSE-S3 PUT, a CopyObject, an RRS PUT (14+2) and a
  compressed object a ranged GET reads (MTPU_WORKER_POOL=0,
  MTPU_CODEC=dense-gf8 on minio_tpu's side).
- Each package reads the other's compressed, compressed + SSE-S3 and
  RRS objects.
- Where the port differs from minio_tpu on purpose: an UploadPartCopy
  from a compressed source copies the decoded range (minio_tpu copies
  the compressed bytes into the part, ROADMAP.md Queue 3), and a ranged
  GET of a compressed object decodes its whole stored stream.
"""

import base64
import hashlib
import os
import random
import re
import shutil

import numpy as np
import pytest
import torch

from minio_tpu.api import S3Server as JaxS3Server
from minio_tpu.bucket import BucketMetadataSys as JaxBucketMetadataSys
from minio_tpu.config.config import ConfigSys as JaxConfigSys
from minio_tpu.crypto import SSEConfig as JaxSSEConfig
from minio_tpu.iam import IAMSys as JaxIAMSys
from minio_tpu.object import erasure_objects as jax_eo
from minio_tpu.object.pools import ErasureServerPools as JaxPools
from minio_tpu.object.sets import ErasureSets as JaxErasureSets
from minio_tpu.storage.local import LocalStorage as JaxLocalStorage
from minio_tpu_torch.api import transforms as tfm
from minio_tpu_torch.api.client import S3Client
from minio_tpu_torch.api.server import S3Server
from minio_tpu_torch.bucket.metadata import BucketMetadataSys
from minio_tpu_torch.config.config import ConfigSys
from minio_tpu_torch.crypto import SSEConfig
from minio_tpu_torch.iam.store import IAMSys
from minio_tpu_torch.object import erasure_objects
from minio_tpu_torch.object.pools import ErasureServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.ops import s2
from minio_tpu_torch.storage.local import LocalStorage
from tests.test_torch_s3_core import _alike, _tree

torch.set_num_threads(1)

PORT, JAX = "port", "jax"
PKGS = (JAX, PORT)
ACCESS, SECRET = "tpuadmin", "tpuadmin-secret-key"
DEPLOYMENT = "5ba52d31-4f2e-4d69-92f5-926a51824ee0"
SMALL_BLOCK = 12 * 1024
LOST = (0, 5, 12, 15)
TEXT = b"compressible line of text\n"


def _text(size: int, seed: int = 0) -> bytes:
    """Seeded text: lines of words, compressible but not a single run."""
    rng = random.Random(seed)
    words = [bytes(rng.choice(b"abcdefghij") for _ in range(rng.randrange(
        2, 9))) for _ in range(200)]
    out = bytearray()
    while len(out) < size:
        out += b" ".join(rng.choice(words) for _ in range(12)) + b"\n"
    return bytes(out[:size])


@pytest.fixture
def env(monkeypatch):
    """Both packages at 12 KiB erasure blocks and a 1 KiB inline
    threshold, minio_tpu with dense-gf8 and no worker pool."""
    monkeypatch.setenv("MTPU_CODEC", "dense-gf8")
    monkeypatch.setenv("MTPU_WORKER_POOL", "0")
    monkeypatch.setenv("MTPU_INLINE_THRESHOLD", "1024")
    monkeypatch.setattr(jax_eo, "BLOCK_SIZE_V2", SMALL_BLOCK)
    monkeypatch.setattr(erasure_objects, "BLOCK_SIZE_V2", SMALL_BLOCK)
    return monkeypatch


def _s3server(pkg: str, root, drives: int = 4, parity=None, kv=None,
              fresh: bool = True):
    """An S3Server of `pkg` over `drives` drive directories, one set, a
    ConfigSys set from `kv` (kept in memory) and SSEConfig("root-secret")."""
    if pkg == PORT:
        disks = [LocalStorage(str(root / f"d{i}"), endpoint=f"d{i}",
                              device="cpu") for i in range(drives)]
        sets = ErasureSets(disks, drives, deployment_id=DEPLOYMENT,
                           default_parity=parity, device="cpu")
    else:
        disks = [JaxLocalStorage(str(root / f"d{i}"), endpoint=f"d{i}")
                 for i in range(drives)]
        sets = JaxErasureSets(disks, drives, deployment_id=DEPLOYMENT,
                              default_parity=parity)
    if fresh:
        sets.init_format()
    else:
        sets.load_format()
    if pkg == PORT:
        ol = ErasureServerPools([sets], device="cpu")
        cs = ConfigSys(ol, secret=SECRET)
    else:
        ol = JaxPools([sets])
        cs = JaxConfigSys(ol, secret=SECRET)
    for target, values in (kv or {}).items():
        cs.config.set_kv(target, **values)
    if pkg == PORT:
        srv = S3Server(ol, IAMSys(ACCESS, SECRET), BucketMetadataSys(ol),
                       device="cpu", config_sys=cs,
                       sse_config=SSEConfig("root-secret", device="cpu"))
    else:
        srv = JaxS3Server(ol, JaxIAMSys(ACCESS, SECRET),
                          JaxBucketMetadataSys(ol), config_sys=cs,
                          sse_config=JaxSSEConfig("root-secret"))
    return srv.start()


COMPRESS_KV = {"compression": {"enable": "on", "extensions": ".txt,.log"}}


@pytest.fixture(params=PKGS)
def cl(env, tmp_path, request):
    """tests/test_streaming_transforms.py's `cl`: a 4-drive server with
    compression on for .txt and .log, bucket /tfm."""
    srv = _s3server(request.param, tmp_path, kv=COMPRESS_KV)
    c = S3Client(srv.endpoint, ACCESS, SECRET)
    assert c.request("PUT", "/tfm")[0] == 200
    c.server = srv
    yield c
    srv.stop()


def _stored(c, name: str):
    """The object's FileInfo on drive 0 (size and metadata)."""
    disk = c.server.handlers.ol.pools[0].sets[0].disks[0]
    return disk.read_version("tfm", name)


# --- tests/test_streaming_transforms.py's compression cases ------------

def test_compression_roundtrip(cl):
    body = TEXT * 12_000  # 312,000 B
    st, _, _ = cl.request("PUT", "/tfm/log.txt", body=body,
                          headers={"Content-Type": "text/plain"})
    assert st == 200
    st, h, got = cl.request("GET", "/tfm/log.txt")
    assert st == 200 and got == body
    st, h, _ = cl.request("HEAD", "/tfm/log.txt")
    assert h["Content-Length"] == str(len(body))
    st, _, got = cl.request("GET", "/tfm/log.txt",
                            headers={"Range": "bytes=100-200000"})
    assert st == 206 and got == body[100:200001]
    fi = _stored(cl, "log.txt")
    assert fi.metadata[tfm.META_COMPRESSION] == "s2"
    assert fi.metadata[tfm.META_UNCOMPRESSED_SIZE] == str(len(body))
    assert fi.size == int(fi.metadata[tfm.META_COMPRESSED_SIZE])
    assert fi.size < len(body) // 4


def test_compressed_and_encrypted_combo(cl):
    body = b"both transforms! " * 20_000
    st, _, _ = cl.request(
        "PUT", "/tfm/both.txt", body=body,
        headers={"Content-Type": "text/plain",
                 "x-amz-server-side-encryption": "AES256"})
    assert st == 200
    st, h, got = cl.request("GET", "/tfm/both.txt")
    assert st == 200 and got == body
    assert h.get("x-amz-server-side-encryption") == "AES256"
    st, h, _ = cl.request("HEAD", "/tfm/both.txt")
    assert h["Content-Length"] == str(len(body))
    fi = _stored(cl, "both.txt")
    # Compress, then encrypt: the SSE actual size is the compressed
    # length, and the compression marker gives the logical size.
    comp = int(fi.metadata[tfm.META_COMPRESSED_SIZE])
    assert fi.metadata["x-mtpu-internal-actual-size"] == str(comp)
    assert fi.metadata[tfm.META_UNCOMPRESSED_SIZE] == str(len(body))
    st, _, got = cl.request("GET", "/tfm/both.txt",
                            headers={"Range": "bytes=70000-140000"})
    assert st == 206 and got == body[70000:140001]


def test_bad_digest_on_transformed_put_leaves_nothing(cl):
    body = b"digested" * 1000
    wrong = base64.b64encode(hashlib.md5(b"other").digest()).decode()
    st, _, resp = cl.request(
        "PUT", "/tfm/dig.txt", body=body,
        headers={"Content-Type": "text/plain", "Content-MD5": wrong})
    assert st == 400 and b"BadDigest" in resp
    assert cl.request("GET", "/tfm/dig.txt")[0] == 404


def test_incompressible_data_not_stored_compressed(cl):
    body = np.random.default_rng(4).bytes(300_000)
    st, _, _ = cl.request("PUT", "/tfm/rand.txt", body=body,
                          headers={"Content-Type": "text/plain"})
    assert st == 200
    st, h, got = cl.request("GET", "/tfm/rand.txt")
    assert st == 200 and got == body
    assert h["Content-Length"] == str(len(body))
    fi = _stored(cl, "rand.txt")
    assert tfm.META_COMPRESSION not in fi.metadata
    assert fi.size == len(body)


def test_filters_choose_what_compresses(cl):
    """Extensions and MIME types from the config; an excluded extension
    never compresses."""
    body = TEXT * 4000
    for name, ctype, want in (("a.log", "", True), ("a.bin", "", False),
                              ("a.json", "application/json", True),
                              ("a.zip", "text/plain", False)):
        st, _, _ = cl.request("PUT", f"/tfm/{name}", body=body,
                              headers={"Content-Type": ctype} if ctype
                              else {})
        assert st == 200
        assert (tfm.META_COMPRESSION in _stored(cl, name).metadata) == want
        assert cl.request("GET", f"/tfm/{name}")[2] == body


def test_copy_compressed_object(cl):
    body = _text(150_000, 1)
    assert cl.request("PUT", "/tfm/src.log", body=body)[0] == 200
    for dst, headers in (("dst.log", {}), ("dst.bin", {}),
                         ("enc.log", {"x-amz-server-side-encryption":
                                      "AES256"})):
        st, _, resp = cl.request("PUT", f"/tfm/{dst}", headers={
            "x-amz-copy-source": "/tfm/src.log", **headers})
        assert st == 200, resp
        st, h, got = cl.request("GET", f"/tfm/{dst}")
        assert st == 200 and got == body
        assert (tfm.META_COMPRESSION in _stored(cl, dst).metadata) == \
            dst.endswith(".log")


def test_should_compress_matches_minio_tpus():
    from minio_tpu.api import transforms as jax_tfm
    from minio_tpu.config.config import Config as JaxConfig
    from minio_tpu_torch.config.config import Config

    cases = [("x.txt", ""), ("x.LOG", ""), ("x.bin", "text/csv"),
             ("x.gz", "text/plain"), ("x", "application/xml"), ("x", "")]
    for kv in ({"enable": "off"}, {"enable": "on"},
               {"enable": "on", "extensions": "", "mime_types": ""},
               {"enable": "on", "extensions": ".bin", "mime_types": ""}):
        port, jax = Config(), JaxConfig()
        port.set_kv("compression", **kv)
        jax.set_kv("compression", **kv)
        for name, ctype in cases:
            assert tfm.should_compress(port, name, ctype) == \
                jax_tfm.should_compress(jax, name, ctype), (kv, name)
    assert not tfm.should_compress(None, "x.txt", "text/plain")


# --- tests/test_tagging_acl_storageclass.py's storage-class cases ------

@pytest.fixture(params=PKGS)
def sc_server(env, tmp_path, request):
    srv = _s3server(request.param, tmp_path)
    c = S3Client(srv.endpoint, ACCESS, SECRET)
    assert c.request("PUT", "/tagbkt")[0] == 200
    c.server = srv
    yield c
    srv.stop()


def _config(c):
    return c.server.handlers.config


def test_storage_class_parity(sc_server):
    c = sc_server
    _config(c).set_kv("storage_class", rrs="EC:1")
    body = b"rrs data" * 100
    st, _, _ = c.request("PUT", "/tagbkt/rrs.bin", body=body,
                         headers={"x-amz-storage-class":
                                  "REDUCED_REDUNDANCY"})
    assert st == 200
    st, h, _ = c.request("HEAD", "/tagbkt/rrs.bin")
    assert h.get("x-amz-storage-class") == "REDUCED_REDUNDANCY"
    assert c.request("GET", "/tagbkt/rrs.bin")[2] == body
    st, _, _ = c.request("PUT", "/tagbkt/std.bin", body=body)
    assert st == 200
    st, h, _ = c.request("HEAD", "/tagbkt/std.bin")
    assert "x-amz-storage-class" not in {k.lower() for k in h}
    disk = c.server.handlers.ol.pools[0].sets[0].disks[0]
    assert disk.read_version("tagbkt", "rrs.bin").erasure.parity_blocks == 1
    assert disk.read_version("tagbkt", "std.bin").erasure.parity_blocks == 2
    st, _, raw = c.request("PUT", "/tagbkt/bad.bin", body=b"x",
                           headers={"x-amz-storage-class": "GLACIER"})
    assert st == 400 and b"InvalidStorageClass" in raw
    _config(c).set_kv("storage_class", standard="EC:1")
    assert c.request("PUT", "/tagbkt/std1.bin", body=body, headers={
        "x-amz-storage-class": "STANDARD"})[0] == 200
    assert disk.read_version("tagbkt",
                             "std1.bin").erasure.parity_blocks == 1
    _config(c).set_kv("storage_class", standard="EC:x")
    st, _, raw = c.request("PUT", "/tagbkt/std2.bin", body=body, headers={
        "x-amz-storage-class": "STANDARD"})
    assert st == 400 and b"InvalidArgument" in raw


def test_lowercase_standard_not_echoed(sc_server):
    c = sc_server
    st, _, _ = c.request("PUT", "/tagbkt/lowstd.bin", body=b"x",
                         headers={"x-amz-storage-class": "standard"})
    assert st == 200
    st, h, _ = c.request("HEAD", "/tagbkt/lowstd.bin")
    assert "x-amz-storage-class" not in {k.lower() for k in h}


def test_multipart_storage_class(sc_server):
    c = sc_server
    _config(c).set_kv("storage_class", rrs="EC:1")
    st, _, raw = c.request("POST", "/tagbkt/mp-rrs", [("uploads", "")],
                           headers={"x-amz-storage-class": "GLACIER"})
    assert st == 400 and b"InvalidStorageClass" in raw
    st, _, raw = c.request("POST", "/tagbkt/mp-rrs", [("uploads", "")],
                           headers={"x-amz-storage-class":
                                    "REDUCED_REDUNDANCY"})
    assert st == 200
    upload_id = re.search(rb"<UploadId>([^<]+)</UploadId>", raw).group(1)
    part = b"p" * 40_000
    st, h, _ = c.request("PUT", "/tagbkt/mp-rrs",
                         [("partNumber", "1"),
                          ("uploadId", upload_id.decode())], body=part)
    assert st == 200
    etag = h["ETag"].strip('"')
    done = (f'<CompleteMultipartUpload><Part><PartNumber>1</PartNumber>'
            f'<ETag>"{etag}"</ETag></Part></CompleteMultipartUpload>')
    st, _, raw = c.request("POST", "/tagbkt/mp-rrs",
                           [("uploadId", upload_id.decode())],
                           body=done.encode())
    assert st == 200, raw
    assert c.request("GET", "/tagbkt/mp-rrs")[2] == part
    st, h, _ = c.request("HEAD", "/tagbkt/mp-rrs")
    assert h.get("x-amz-storage-class") == "REDUCED_REDUNDANCY"
    disk = c.server.handlers.ol.pools[0].sets[0].disks[0]
    assert disk.read_version("tagbkt", "mp-rrs").erasure.parity_blocks == 1


# --- byte-identical drive files under a seeded os.urandom -------------

SEEDED_KV = {"compression": {"enable": "on", "extensions": ".log"},
             "storage_class": {"rrs": "EC:2"}}
SSE_S3 = {"x-amz-server-side-encryption": "AES256"}
RRS = {"x-amz-storage-class": "REDUCED_REDUNDANCY"}


def _seeded_run(pkg: str, root, mp) -> dict:
    """The 16-drive 12+4 server of `pkg` with compression on for .log and
    rrs EC:2, under a seeded os.urandom: a compressed PUT, a compressed +
    SSE-S3 PUT, a CopyObject of the first, an RRS PUT, a random .log PUT,
    GETs whole and ranged; the files written; then the objects lost on
    drives 0, 5, 12 and 15 (the RRS object on 0 and 5), degraded GETs,
    heals and the files after."""
    clock = _alike(mp)
    rng = random.Random(2024)
    mp.setattr(os, "urandom", rng.randbytes)
    srv = _s3server(pkg, root, drives=16, parity=4, kv=SEEDED_KV)
    text = _text(200_001, 3)
    noise = random.Random(8).randbytes(70_000)
    objs = {"c.log": (text, {}), "cs.log": (text, SSE_S3),
            "rrs.log": (text[:90_000], RRS), "rand.log": (noise, {})}
    out = {"responses": []}
    try:
        c = S3Client(srv.endpoint, ACCESS, SECRET)

        def rec(*args, **kw):
            clock.now += 10 ** 9
            st, h, body = c.request(*args, **kw)
            lower = {k.lower(): v for k, v in h.items()}
            out["responses"].append((st, body, {
                k: v for k, v in lower.items()
                if k.startswith(("x-amz-server-side", "x-amz-storage"))
                or k in ("etag", "content-length", "content-range")}))
            return st, body

        rec("PUT", "/cmp")
        for name, (body, headers) in objs.items():
            rec("PUT", f"/cmp/{name}", headers=headers, body=body)
        rec("PUT", "/cmp/copy.log", headers={"x-amz-copy-source":
                                             "/cmp/c.log"})
        for name in (*objs, "copy.log"):
            rec("GET", f"/cmp/{name}")
            rec("HEAD", f"/cmp/{name}")
        rec("GET", "/cmp/c.log", headers={"Range": "bytes=70000-140000"})
        rec("GET", "/cmp/cs.log", headers={"Range": "bytes=65530-65600"})
        out["written"] = _tree(root)
        names = (*objs, "copy.log")
        for i in LOST:
            for name in names:
                if name != "rrs.log" or i in LOST[:2]:  # 14+2: lose two
                    shutil.rmtree(root / f"d{i}" / "cmp" / name,
                                  ignore_errors=True)
        want = {n: objs[n][0] if n in objs else text for n in names}
        out["degraded"] = [c.request("GET", f"/cmp/{n}")[2] == want[n]
                           for n in names]
        ol = srv.handlers.ol
        out["heals"] = [len(ol.heal_object("cmp", n)["healed"])
                        for n in names]
        out["after"] = _tree(root)
    finally:
        srv.stop()
    return out


def test_seeded_urandom_gives_identical_drive_files(env, tmp_path):
    runs = {}
    for pkg in PKGS:
        with pytest.MonkeyPatch.context() as mp:
            runs[pkg] = _seeded_run(pkg, tmp_path / pkg, mp)
    jax, port = runs[JAX], runs[PORT]
    assert port["responses"] == jax["responses"]
    assert all(st in (200, 206) for st, _, _ in port["responses"])
    assert port["written"].keys() == jax["written"].keys()
    differ = [k for k in jax["written"]
              if port["written"][k] != jax["written"][k]]
    assert not differ
    assert port["degraded"] == jax["degraded"] == [True] * 5
    assert port["heals"] == jax["heals"]
    for run in runs.values():
        assert run["after"] == run["written"]
    # The RRS object is 14+2 and the compressed ones are marked.
    meta = [v for k, v in port["written"].items()
            if k.startswith("d0/cmp/rrs.log/") and k.endswith("xl.meta")]
    assert meta and b"x-mtpu-internal-compression" in meta[0]


# --- each package reads the other's objects -----------------------------

CROSS = {"c.log": ({}, 150_001), "cs.log": (SSE_S3, 100_000),
         "rrs.bin": (RRS, 30_000), "rrs.log": (RRS, 70_000)}


@pytest.mark.parametrize("writer,reader", ((JAX, PORT), (PORT, JAX)))
def test_each_package_reads_the_others_objects(env, tmp_path, writer,
                                               reader):
    srv = _s3server(writer, tmp_path, drives=16, parity=4, kv=SEEDED_KV)
    try:
        c = S3Client(srv.endpoint, ACCESS, SECRET)
        assert c.request("PUT", "/cross")[0] == 200
        for i, (name, (headers, size)) in enumerate(CROSS.items()):
            st, _, _ = c.request("PUT", f"/cross/{name}", headers=headers,
                                 body=_text(size, i))
            assert st == 200
    finally:
        srv.stop()
    srv = _s3server(reader, tmp_path, drives=16, parity=4, fresh=False)
    try:
        c = S3Client(srv.endpoint, ACCESS, SECRET)
        for i, (name, (headers, size)) in enumerate(CROSS.items()):
            st, h, got = c.request("GET", f"/cross/{name}")
            assert st == 200 and got == _text(size, i), name
            st, h, _ = c.request("HEAD", f"/cross/{name}")
            assert h["Content-Length"] == str(size)
        st, _, got = c.request("GET", "/cross/c.log",
                               headers={"Range": "bytes=65530-131100"})
        assert st == 206 and got == _text(150_001, 0)[65530:131101]
        disk = srv.handlers.ol.pools[0].sets[0].disks[0]
        assert disk.read_version("cross",
                                 "rrs.log").erasure.parity_blocks == 2
    finally:
        srv.stop()


# --- where the port differs from minio_tpu ------------------------------

def test_upload_part_copy_of_a_compressed_source_copies_logical_bytes(
        env, tmp_path):
    srv = _s3server(PORT, tmp_path, kv=COMPRESS_KV)
    try:
        c = S3Client(srv.endpoint, ACCESS, SECRET)
        body = _text(100_000, 5)
        assert c.request("PUT", "/upc")[0] == 200
        assert c.request("PUT", "/upc/src.txt", body=body)[0] == 200
        st, _, raw = c.request("POST", "/upc/dst", [("uploads", "")])
        upload_id = re.search(rb"<UploadId>([^<]+)</UploadId>",
                              raw).group(1).decode()
        st, _, raw = c.request("PUT", "/upc/dst", [
            ("partNumber", "1"), ("uploadId", upload_id)], headers={
            "x-amz-copy-source": "/upc/src.txt",
            "x-amz-copy-source-range": "bytes=1000-90999"})
        assert st == 200, raw
        etag = re.search(rb"<ETag>([^<]+)</ETag>", raw).group(1).decode()
        done = (f"<CompleteMultipartUpload><Part><PartNumber>1</PartNumber>"
                f"<ETag>{etag}</ETag></Part></CompleteMultipartUpload>")
        assert c.request("POST", "/upc/dst", [("uploadId", upload_id)],
                         body=done.encode())[0] == 200
        assert c.request("GET", "/upc/dst")[2] == body[1000:91000]
        st, _, raw = c.request("PUT", "/upc/dst", [
            ("partNumber", "2"), ("uploadId", upload_id)], headers={
            "x-amz-copy-source": "/upc/src.txt",
            "x-amz-copy-source-range": "bytes=0-100000"})
        assert st == 400  # past the logical end
    finally:
        srv.stop()


def test_ranged_get_decodes_whole_compressed_stream(env, tmp_path):
    """stored_prefix: every stored byte of a compressed object, SSE or
    not; a prefix through the window's package for SSE alone."""
    meta_sse = {"x-mtpu-internal-server-side-encryption": "AES256"}
    comp = {tfm.META_COMPRESSION: "s2"}
    psize = 65_536 + 28
    assert tfm.stored_prefix(comp, 5000, 10, 10) == 5000
    assert tfm.stored_prefix({**meta_sse, **comp}, 5 * psize, 10, 10) == \
        5 * psize
    if tfm.ssemod.is_encrypted(meta_sse):
        assert tfm.stored_prefix(meta_sse, 5 * psize, 10, 10) == psize
    assert tfm.actual_object_size(
        {**comp, tfm.META_UNCOMPRESSED_SIZE: "123",
         "x-mtpu-internal-actual-size": "77"}, 50) == 123


def test_decompress_writer_refuses_unknown_codec_and_bad_frames():
    with pytest.raises(tfm.S3Error):
        tfm.build_get_chain({tfm.META_COMPRESSION: "lz4"}, {}, None, "b",
                            "o", None, device="cpu")
    w = tfm.DecompressWriter(open(os.devnull, "wb"), device="cpu")
    with pytest.raises(tfm.S3Error):
        w.write(s2.STREAM_ID + b"\x00\x05\x00\x00\x00\x00\x00\x00\xff")
        w.close()
