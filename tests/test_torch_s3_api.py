"""The port's S3 server (SigV4 S3Server -> ErasureServerPools -> one 12+4
set on 16 drive directories) against minio_tpu's, over HTTP on
localhost, on the CPU.

Both servers get the same signed request sequence: MakeBucket; PutObject
plain, aws-chunked, small (inline), with a good and a bad Content-MD5,
and with a signed x-amz-content-sha256 of another body; GetObject whole, ranged, past the end (416) and
conditional; HeadObject; ListObjects v1 and v2 with prefix, delimiter,
max-keys and continuation; multipart with three parts (the last one
ragged), ListParts, ListMultipartUploads, Complete, Abort and a Complete
naming a wrong ETag; DeleteObject; and the errors NoSuchKey,
NoSuchBucket, SignatureDoesNotMatch, InvalidAccessKeyId and anonymous
AccessDenied. Statuses, bodies, the content headers (ETag,
Content-Length, Content-Range, Content-Type, x-amz-meta-*) and the error
Code, Message and Resource must be equal; every comparison is exact.

Then shards 0, 5, 12 and 15 of every object are destroyed on both
sides, degraded GETs must give the payloads, and an admin heal of the
bucket, polled to its end, must rebuild both sides so that every file
under the 32 drive directories compares whole. Each package then serves
the drives the other's server wrote.

Files compare whole because ids and clocks are made alike, not
normalised: the `uuid` that each package's storage/fileinfo.py mints
ids with is replaced by one seeded sequence, restarted for each side,
and the object layers' and bucket metadata's clocks read one fixed time.
minio_tpu runs with MTPU_CODEC=dense-gf8 and MTPU_WORKER_POOL=0, and
both at BLOCK_SIZE_V2 = 12 * 1024 with MTPU_INLINE_THRESHOLD = 1024:
the port's plain HighwayHash is a Python loop over 32-byte packets, so
chunks are kept at 1 KiB and objects at a few blocks (the larger ones
still make part files, the small ones stay inline).
"""

import base64
import hashlib
import http.client
import json
import random
import re
import time
import types
import uuid
from pathlib import Path

import numpy as np
import pytest
import torch

from minio_tpu.api import S3Server as JaxS3Server
from minio_tpu.bucket import BucketMetadataSys as JaxBucketMetadataSys
from minio_tpu.bucket import metadata as jax_bucket_meta
from minio_tpu.iam import IAMSys as JaxIAMSys
from minio_tpu.object import erasure_objects as jax_eo
from minio_tpu.object import multipart as jax_mp
from minio_tpu.object.pools import ErasureServerPools as JaxPools
from minio_tpu.object.sets import ErasureSets as JaxErasureSets
from minio_tpu.storage import fileinfo as jax_fileinfo
from minio_tpu.storage.local import LocalStorage as JaxLocalStorage
from minio_tpu_torch.api import sign
from minio_tpu_torch.api.client import S3Client
from minio_tpu_torch.api.server import S3Server
from minio_tpu_torch.bucket import metadata as bucket_meta
from minio_tpu_torch.bucket.metadata import BucketMetadataSys
from minio_tpu_torch.iam.store import IAMSys
from minio_tpu_torch.object import erasure_objects, multipart
from minio_tpu_torch.object.pools import ErasureServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.storage import fileinfo
from minio_tpu_torch.storage.local import LocalStorage

torch.set_num_threads(1)

PORT, JAX = "port", "jax"
ACCESS, SECRET = "tpuadmin", "tpuadmin-secret-key"
DEPLOYMENT = "5ba52d31-4f2e-4d69-92f5-926a51824ed9"
MOD_TIME = 1_700_000_000_123_456_789
SMALL_BLOCK = 12 * 1024
BUCKET = "bkt"
LOST = (0, 5, 12, 15)
CONTENT_HEADERS = ("etag", "content-length", "content-range",
                   "content-type")

PLAIN, CHUNKED, SMALL, GOOD_MD5, MP = (
    "plain/obj.bin", "chunked/obj.bin", "small/s.txt", "md5/good",
    "mp/big.bin")
SIZES = {PLAIN: 30_001, CHUNKED: 90_001, SMALL: 1000, GOOD_MD5: 5000}
LIST_KEYS = [f"list/{d}/k{i}" for d in ("a", "b", "c") for i in range(3)]
PART_SIZES = (25_000, 25_000, 12_345)


def _payload(name: str, size: int) -> bytes:
    seed = int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "big")
    return np.random.default_rng(seed).bytes(size)


class _Shim(types.SimpleNamespace):
    """A module stand-in: its own attributes, the rest from `base`."""

    def __init__(self, base, **attrs):
        super().__init__(**attrs)
        self._base = base

    def __getattr__(self, name):
        return getattr(self._base, name)


def _alike(mp) -> None:
    """One seeded uuid sequence for each package's ids, and one fixed
    clock for both object layers and bucket metadata."""
    rng = random.Random(7)
    seeded = _Shim(uuid, uuid4=lambda: uuid.UUID(int=rng.getrandbits(128),
                                                 version=4))
    for mod in (fileinfo, jax_fileinfo):
        mp.setattr(mod, "uuid", seeded)
    clock = _Shim(time, time_ns=lambda: MOD_TIME)
    for mod in (erasure_objects, multipart, bucket_meta, jax_eo, jax_mp,
                jax_bucket_meta):
        mp.setattr(mod, "time", clock)


def _server(pkg: str, root: Path, fresh: bool):
    if pkg == PORT:
        disks = [LocalStorage(str(root / f"d{i}"), endpoint=f"d{i}",
                              device="cpu") for i in range(16)]
        sets = ErasureSets(disks, 16, deployment_id=DEPLOYMENT,
                           default_parity=4, device="cpu")
    else:
        disks = [JaxLocalStorage(str(root / f"d{i}"), endpoint=f"d{i}")
                 for i in range(16)]
        sets = JaxErasureSets(disks, 16, deployment_id=DEPLOYMENT,
                              default_parity=4)
    if fresh:
        sets.init_format()
    else:
        sets.load_format()
    if pkg == PORT:
        ol = ErasureServerPools([sets], device="cpu")
        return S3Server(ol, IAMSys(ACCESS, SECRET), BucketMetadataSys(ol),
                        device="cpu").start()
    ol = JaxPools([sets])
    return JaxS3Server(ol, JaxIAMSys(ACCESS, SECRET),
                       JaxBucketMetadataSys(ol)).start()


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def _record(resp) -> dict:
    """What is compared of a response: status, content headers, and the
    body, or an error's Code, Message and Resource (its RequestId is
    random)."""
    status, headers, body = resp
    lower = {k.lower(): v for k, v in headers.items()}
    out = {"status": status,
           "headers": {k: v for k, v in lower.items()
                       if k in CONTENT_HEADERS
                       or k.startswith("x-amz-meta-")}}
    if status >= 400 and body.startswith(b"<?xml"):
        out["error"] = {t: re.search(rf"<{t}>(.*?)</{t}>".encode(),
                                     body).group(1)
                        for t in ("Code", "Message", "Resource")}
    else:
        out["body"] = body
    return out


def _complete_xml(etags) -> bytes:
    return ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{i + 1}</PartNumber><ETag>{e}</ETag></Part>"
        for i, e in enumerate(etags)) + "</CompleteMultipartUpload>").encode()


def _upload_id(body: bytes) -> str:
    return re.search(rb"<UploadId>(.*?)</UploadId>", body).group(1).decode()


def _put_signed_for_other_body(c: S3Client, path: str, body: bytes):
    """A PUT whose signed x-amz-content-sha256 is another body's."""
    headers = sign.sign_v4_request(
        SECRET, ACCESS, "PUT", c.endpoint, path,
        payload_hash=hashlib.sha256(body + b"!").hexdigest())
    conn = http.client.HTTPConnection(c.endpoint, timeout=60)
    try:
        conn.request("PUT", path, body=body, headers=headers)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _sequence(c: S3Client) -> list:
    """The request sequence; returns (label, record) pairs."""
    out = []

    def rec(label, resp):
        out.append((label, _record(resp)))
        return resp

    b = f"/{BUCKET}"
    rec("make_bucket", c.request("PUT", b))
    rec("head_bucket", c.request("HEAD", b))
    rec("location", c.request("GET", b, [("location", "")]))
    rec("put_plain", c.request(
        "PUT", f"{b}/{PLAIN}", body=_payload(PLAIN, SIZES[PLAIN]),
        headers={"Content-Type": "text/plain", "x-amz-meta-color": "blue"}))
    rec("put_chunked", c.put_chunked(f"{b}/{CHUNKED}",
                                     _payload(CHUNKED, SIZES[CHUNKED])))
    rec("put_small", c.request("PUT", f"{b}/{SMALL}",
                               body=_payload(SMALL, SIZES[SMALL])))
    good = _payload(GOOD_MD5, SIZES[GOOD_MD5])
    md5 = base64.b64encode(hashlib.md5(good).digest()).decode()
    rec("put_good_md5", c.request("PUT", f"{b}/{GOOD_MD5}", body=good,
                                  headers={"Content-MD5": md5}))
    bad_md5 = base64.b64encode(hashlib.md5(b"other").digest()).decode()
    rec("put_bad_md5", c.request("PUT", f"{b}/md5/bad", body=good,
                                 headers={"Content-MD5": bad_md5}))
    rec("get_bad_md5", c.request("GET", f"{b}/md5/bad"))
    rec("put_bad_sha256", _put_signed_for_other_body(c, f"{b}/sha/bad",
                                                     good))
    rec("get_bad_sha256", c.request("GET", f"{b}/sha/bad"))
    for key in LIST_KEYS:
        rec(f"put_{key}", c.request("PUT", f"{b}/{key}", body=key.encode()))

    for key in (PLAIN, CHUNKED, SMALL, GOOD_MD5):
        rec(f"get_{key}", c.request("GET", f"{b}/{key}"))
    for rng in ("bytes=1000-50000", "bytes=-777", "bytes=89000-",
                "bytes=200000-", "bytes=90001-90002"):
        rec(f"range {rng}", c.request("GET", f"{b}/{CHUNKED}",
                                      headers={"Range": rng}))
    rec("head", c.request("HEAD", f"{b}/{PLAIN}"))
    rec("head_missing", c.request("HEAD", f"{b}/nokey"))
    status, headers, _ = c.request("HEAD", f"{b}/{PLAIN}")
    rec("if_none_match", c.request("GET", f"{b}/{PLAIN}", headers={
        "If-None-Match": headers["ETag"]}))
    rec("if_match_fails", c.request("GET", f"{b}/{PLAIN}", headers={
        "If-Match": '"0123"'}))

    for q in ([], [("prefix", "list/")], [("delimiter", "/")],
              [("prefix", "list/"), ("delimiter", "/")],
              [("prefix", "list/a/"), ("max-keys", "2")],
              [("marker", "list/b/k1"), ("max-keys", "3")],
              [("max-keys", "0")]):
        rec(f"list_v1 {q}", c.request("GET", b, q))
    for q in ([("list-type", "2")],
              [("list-type", "2"), ("prefix", "list/"), ("delimiter", "/")],
              [("list-type", "2"), ("start-after", "list/a/k2")]):
        rec(f"list_v2 {q}", c.request("GET", b, q))
    # Page through v2 with continuation tokens, with and without a
    # delimiter.
    for extra in ([], [("delimiter", "/"), ("prefix", "list/")]):
        token = ""
        for page in range(10):
            q = [("list-type", "2"), ("max-keys", "4")] + extra
            if token:
                q.append(("continuation-token", token))
            _, _, body = rec(f"list_v2 page {page} {extra}",
                             c.request("GET", b, q))
            m = re.search(rb"<NextContinuationToken>(.*?)<", body)
            if not m:
                break
            token = m.group(1).decode()
    # ... and v1 with NextMarker.
    marker = ""
    for page in range(10):
        q = [("max-keys", "3"), ("prefix", "list/")]
        if marker:
            q.append(("marker", marker))
        _, _, body = rec(f"list_v1 page {page}", c.request("GET", b, q))
        m = re.search(rb"<NextMarker>(.*?)<", body)
        if not m:
            break
        marker = m.group(1).decode()

    # Multipart: three parts, the last ragged; list, complete, read.
    _, _, body = rec("mp_new", c.request(
        "POST", f"{b}/{MP}", [("uploads", "")],
        headers={"Content-Type": "application/x-test",
                 "x-amz-meta-kind": "multipart"}))
    upload = _upload_id(body)
    payload = _payload(MP, sum(PART_SIZES))
    etags, off = [], 0
    for i, size in enumerate(PART_SIZES):
        _, h, _ = rec(f"mp_part {i + 1}", c.request(
            "PUT", f"{b}/{MP}", [("partNumber", str(i + 1)),
                                 ("uploadId", upload)],
            body=payload[off:off + size]))
        etags.append(h["ETag"])
        off += size
    rec("mp_list_parts", c.request("GET", f"{b}/{MP}",
                                   [("uploadId", upload)]))
    rec("mp_list_uploads", c.request("GET", b, [("uploads", "")]))
    rec("mp_complete_wrong_etag", c.request(
        "POST", f"{b}/{MP}", [("uploadId", upload)],
        body=_complete_xml(etags[:2] + ['"0123456789abcdef"'])))
    rec("mp_complete", c.request("POST", f"{b}/{MP}",
                                 [("uploadId", upload)],
                                 body=_complete_xml(etags)))
    rec("mp_get", c.request("GET", f"{b}/{MP}"))
    rec("mp_range", c.request("GET", f"{b}/{MP}",
                              headers={"Range": "bytes=24000-26000"}))
    _, _, body = rec("mp_new_abort", c.request("POST", f"{b}/mp/aborted",
                                               [("uploads", "")]))
    aborted = _upload_id(body)
    rec("mp_abort_part", c.request(
        "PUT", f"{b}/mp/aborted", [("partNumber", "1"),
                                   ("uploadId", aborted)], body=b"x" * 999))
    rec("mp_abort", c.request("DELETE", f"{b}/mp/aborted",
                              [("uploadId", aborted)]))
    rec("mp_aborted_parts", c.request("GET", f"{b}/mp/aborted",
                                      [("uploadId", aborted)]))
    rec("mp_list_uploads_after", c.request("GET", b, [("uploads", "")]))

    rec("delete", c.request("DELETE", f"{b}/{GOOD_MD5}"))
    rec("get_deleted", c.request("GET", f"{b}/{GOOD_MD5}"))
    rec("delete_missing", c.request("DELETE", f"{b}/{GOOD_MD5}"))
    rec("no_such_bucket", c.request("GET", "/nobucket/x"))
    rec("bad_signature", S3Client(c.endpoint, ACCESS, "not-the-secret")
        .request("GET", f"{b}/{PLAIN}"))
    rec("unknown_access_key", S3Client(c.endpoint, "NOSUCHKEY", SECRET)
        .request("GET", f"{b}/{PLAIN}"))
    rec("anonymous", c.request("GET", f"{b}/{PLAIN}", anonymous=True))
    rec("sigv2_head", c.request("HEAD", b, v2=True))
    rec("list_final", c.request("GET", b, [("list-type", "2")]))
    return out


def _objects() -> dict:
    """The objects the sequence leaves, with their payloads."""
    out = {k: _payload(k, SIZES[k]) for k in (PLAIN, CHUNKED, SMALL)}
    out.update({k: k.encode() for k in LIST_KEYS})
    out[MP] = _payload(MP, sum(PART_SIZES))
    return out


def _destroy(root: Path) -> None:
    """Every object loses its shards 0, 5, 12 and 15: their drives'
    object directories go, mapped through each object's distribution."""
    disk = JaxLocalStorage(str(root / "d0"))
    for name in _objects():
        fi = disk.read_version(BUCKET, name)
        drive = {d - 1: i for i, d in enumerate(fi.erasure.distribution)}
        for s in LOST:
            obj = root / f"d{drive[s]}" / BUCKET / name
            for p in sorted(obj.rglob("*"), reverse=True):
                p.unlink() if p.is_file() else p.rmdir()
            obj.rmdir()


def _heal(c: S3Client) -> dict:
    """Admin heal of the bucket, polled to its end."""
    path = f"/minio/admin/v3/heal/{BUCKET}"
    status, _, body = c.request("POST", path)
    assert status == 200, body
    token = json.loads(body)["clientToken"]
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        status, _, body = c.request("POST", path, [("clientToken", token)])
        assert status == 200, body
        state = json.loads(body)
        if state["Summary"] != "running":
            return state
        time.sleep(0.02)
    raise AssertionError("heal sequence did not end")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both servers through the sequence, the losses, the degraded GETs
    and the heal. Per package: the records, the drive trees after the
    sequence and after the heal, the degraded GETs and the heal state."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MTPU_CODEC", "dense-gf8")
        mp.setenv("MTPU_WORKER_POOL", "0")
        mp.setenv("MTPU_INLINE_THRESHOLD", "1024")
        mp.setattr(jax_eo, "BLOCK_SIZE_V2", SMALL_BLOCK)
        mp.setattr(erasure_objects, "BLOCK_SIZE_V2", SMALL_BLOCK)
        root = tmp_path_factory.mktemp("s3")
        for pkg in (JAX, PORT):
            with pytest.MonkeyPatch.context() as alike:
                _alike(alike)
                srv = _server(pkg, root / pkg, fresh=True)
                try:
                    c = S3Client(srv.endpoint, ACCESS, SECRET)
                    records = _sequence(c)
                    meta_sys = srv.handlers.bm
                    meta = meta_sys.get(BUCKET)
                    meta.created_ns = MOD_TIME
                    meta.tagging_xml = "<Tagging><TagSet/></Tagging>"
                    meta_sys.save(meta)
                    written = _tree(root / pkg)
                    _destroy(root / pkg)
                    degraded = {name: c.request("GET", f"/{BUCKET}/{name}")
                                for name in (CHUNKED, MP, PLAIN)}
                    healed = _heal(c)
                    after = _tree(root / pkg)
                finally:
                    srv.stop()
            out[pkg] = {"records": records, "written": written,
                        "degraded": degraded, "heal": healed,
                        "after": after, "root": root / pkg}
        yield out


def test_same_responses(runs):
    port, jax = runs[PORT]["records"], runs[JAX]["records"]
    assert [label for label, _ in port] == [label for label, _ in jax]
    for (label, p), (_, j) in zip(port, jax):
        assert p == j, f"{label}: port {p} != minio_tpu {j}"


def test_sequence_did_what_it_says(runs):
    """The sequence's key answers, held to S3 (so that equal answers are
    also the right ones)."""
    recs = dict(runs[PORT]["records"])
    objects = _objects()
    assert recs["make_bucket"]["status"] == 200
    assert recs["put_bad_md5"]["error"]["Code"] == b"BadDigest"
    assert recs["get_bad_md5"]["error"]["Code"] == b"NoSuchKey"
    assert recs["put_bad_sha256"]["error"]["Code"] == \
        b"XAmzContentSHA256Mismatch"
    assert recs["get_bad_sha256"]["error"]["Code"] == b"NoSuchKey"
    for key in (PLAIN, CHUNKED, SMALL):
        assert recs[f"get_{key}"]["body"] == objects[key]
    assert recs["get_plain/obj.bin"]["headers"]["content-type"] == \
        "text/plain"
    assert recs["get_plain/obj.bin"]["headers"]["x-amz-meta-color"] == \
        "blue"
    assert recs["range bytes=1000-50000"]["status"] == 206
    assert recs["range bytes=1000-50000"]["body"] == \
        objects[CHUNKED][1000:50001]
    assert recs["range bytes=200000-"]["status"] == 416
    assert recs["if_none_match"]["status"] == 304
    assert recs["if_match_fails"]["error"]["Code"] == b"PreconditionFailed"
    assert recs["mp_complete_wrong_etag"]["error"]["Code"] == b"InvalidPart"
    assert recs["mp_get"]["body"] == objects[MP]
    assert re.fullmatch(rb'.*<ETag>"[0-9a-f]{32}-3"</ETag>.*',
                        recs["mp_complete"]["body"], re.S)
    assert recs["mp_aborted_parts"]["error"]["Code"] == b"NoSuchUpload"
    assert recs["get_deleted"]["error"]["Code"] == b"NoSuchKey"
    assert recs["no_such_bucket"]["error"]["Code"] == b"NoSuchBucket"
    assert recs["bad_signature"]["error"]["Code"] == \
        b"SignatureDoesNotMatch"
    assert recs["unknown_access_key"]["error"]["Code"] == \
        b"InvalidAccessKeyId"
    assert recs["anonymous"]["error"]["Code"] == b"AccessDenied"
    assert recs["sigv2_head"]["status"] == 200
    listed = re.findall(rb"<Key>(.*?)</Key>", recs["list_final"]["body"])
    assert sorted(k.decode() for k in listed) == sorted(objects)


def test_same_drives_after_the_sequence(runs):
    port, jax = runs[PORT]["written"], runs[JAX]["written"]
    assert sorted(port) == sorted(jax)
    for path in port:
        assert port[path] == jax[path], f"{path} differs from minio_tpu's"
    names = {p.split("/", 1)[1] for p in port}
    assert ".minio.sys/buckets/bkt/metadata.json/xl.meta" in names
    # part files: plain, chunked and multipart; three parts of the latter
    assert sum(p.endswith("/part.1") for p in port) == 16 * 3
    assert sum(p.endswith("/part.3") for p in port) == 16
    assert not any(n.startswith(("bkt/md5/bad", "bkt/sha/bad"))
                   for n in names)


def test_degraded_gets(runs):
    objects = _objects()
    for pkg in (PORT, JAX):
        for name, (status, _, body) in runs[pkg]["degraded"].items():
            assert status == 200 and body == objects[name], (pkg, name)


def test_heal_rebuilds_every_file(runs):
    for pkg in (PORT, JAX):
        state = runs[pkg]["heal"]
        assert state["Summary"] == "finished", state
        assert state["NumFailed"] == 0 and \
            state["NumHealed"] == len(_objects()), state
        written, after = runs[pkg]["written"], runs[pkg]["after"]
        for path, blob in written.items():
            if "/.mtpu.sys/" not in f"/{path}":
                assert after.get(path) == blob, f"{pkg}: {path} not rebuilt"
    port, jax = runs[PORT]["after"], runs[JAX]["after"]
    assert sorted(port) == sorted(jax)
    for path in port:
        assert port[path] == jax[path], f"{path} differs after heal"


@pytest.mark.parametrize("reader,writer", [(PORT, JAX), (JAX, PORT)])
def test_serves_the_other_packages_drives(runs, reader, writer,
                                          monkeypatch):
    monkeypatch.setenv("MTPU_CODEC", "dense-gf8")
    monkeypatch.setenv("MTPU_WORKER_POOL", "0")
    monkeypatch.setenv("MTPU_INLINE_THRESHOLD", "1024")
    srv = _server(reader, runs[writer]["root"], fresh=False)
    try:
        c = S3Client(srv.endpoint, ACCESS, SECRET)
        for name, payload in _objects().items():
            status, headers, body = c.request("GET", f"/{BUCKET}/{name}")
            assert status == 200 and body == payload, name
        status, _, body = c.request("GET", f"/{BUCKET}", [("list-type",
                                                           "2")])
        assert body == dict(runs[writer]["records"])["list_final"]["body"]
    finally:
        srv.stop()


def test_s3_put_get_heal_entry(tmp_path, monkeypatch):
    """The slice's entry point end to end on the CPU at small sizes:
    every check holds, and each serial phase that writes, rebuilds or
    decodes degraded data counted GF applications and digests."""
    from minio_tpu_torch.entry import s3_put_get_heal

    monkeypatch.setenv("MTPU_INLINE_THRESHOLD", "1024")
    monkeypatch.setattr(erasure_objects, "BLOCK_SIZE_V2", SMALL_BLOCK)
    res = s3_put_get_heal(tmp_path, 30_001, device="cpu", part_size=13_000,
                          parts=2, last_part=2_000, small_count=4,
                          small_sizes=(100, 1025, 3000), page=2,
                          concurrent=2)
    assert all(res["checks"].values()), res["checks"]
    assert res["list_pages"] == 3 and res["heal"]["NumHealed"] == 6
    for ph in ("put", "multipart", "degraded_get", "degraded_get_multipart",
               "heal"):
        c = res["counters"][ph]
        assert c["launches_gf"] > 0 and c["launches_hash"] > 0, (ph, c)
    assert res["counters"]["get"]["launches_gf"] == 0


def test_http_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the calls would run on it")
    from minio_tpu_torch.entry import s3_put_get_heal
    from minio_tpu_torch.server import Server

    cpu = ErasureServerPools([ErasureSets([LocalStorage(
        str(tmp_path / f"c{i}"), device="cpu") for i in range(4)], 4,
        device="cpu")], device="cpu")
    try:
        calls = [
            lambda: Server([str(tmp_path / "d{1...4}")], port=0),
            lambda: s3_put_get_heal(tmp_path / "s3", 1000),
            lambda: ErasureServerPools(cpu.pools),
            lambda: S3Server(cpu, IAMSys(ACCESS, SECRET),
                             BucketMetadataSys(cpu), port=0),
        ]
        for call in calls:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
    finally:
        cpu.close()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"c{i}" for i in range(4)]  # nothing ran on the CPU instead


# Codes the port answers where minio_tpu answers otherwise (ROADMAP.md
# Queue 3, PR 19): MinIO's own entries (cmd/api-errors.go). minio_tpu has
# none of them: it reads no session token (ErrInvalidToken), and it
# raises MalformedPOSTRequest without a table entry, which answers 500.
MINIO_ONLY_ERRORS = {
    "InvalidTokenId": ("The security token included in the request is "
                       "invalid", 403),
    "MalformedPOSTRequest": ("The body of your POST request is not "
                             "well-formed multipart/form-data.", 400),
}


def test_error_table_is_minio_tpus():
    """Every error code the port's server can answer has minio_tpu's
    status and description (MinIO's, for the codes minio_tpu lacks and
    the port answers on purpose), and every code it raises is in its
    table."""
    import re as _re

    from minio_tpu.api.errors import API_ERRORS as JAX_API_ERRORS
    from minio_tpu_torch.api.errors import API_ERRORS

    assert not set(MINIO_ONLY_ERRORS) & set(JAX_API_ERRORS)
    for code, err in API_ERRORS.items():
        if code in MINIO_ONLY_ERRORS:
            assert (err.description, err.status) == MINIO_ONLY_ERRORS[code]
            continue
        want = JAX_API_ERRORS[code]
        assert (err.code, err.description, err.status) == \
            (want.code, want.description, want.status)
    api = Path(__file__).resolve().parent.parent / "minio_tpu_torch" / "api"
    raised = {m for f in api.glob("*.py") for m in _re.findall(
        r'(?:S3Error|SignError)\("([A-Za-z0-9]+)"', f.read_text())}
    assert raised and raised <= set(API_ERRORS), raised - set(API_ERRORS)


def test_heal_bucket_remakes_missing_volumes(tmp_path, monkeypatch):
    """heal_bucket on both packages' pools over drives that lost the
    bucket's volume: the same drives healed, the same volumes after."""
    monkeypatch.setenv("MTPU_CODEC", "dense-gf8")
    monkeypatch.setenv("MTPU_WORKER_POOL", "0")
    out = {}
    for pkg in (PORT, JAX):
        srv = _server(pkg, tmp_path / pkg, fresh=True)
        try:
            ol = srv.handlers.ol
            ol.make_bucket(BUCKET)
            for i in (3, 9):
                (tmp_path / pkg / f"d{i}" / BUCKET).rmdir()
            out[pkg] = (ol.heal_bucket(BUCKET), ol.heal_bucket(BUCKET))
        finally:
            srv.stop()
    assert out[PORT] == out[JAX]
    assert out[PORT][0] == [[{"healed": ["d3", "d9"]}]]
    assert out[PORT][1] == [[{"healed": []}]]
    assert sorted(p.name for p in (tmp_path / PORT).glob(f"d*/{BUCKET}")) \
        == sorted(p.name for p in (tmp_path / JAX).glob(f"d*/{BUCKET}"))


@pytest.mark.parametrize("header,want", [
    ("msr-pm", "msr-pm"), ("dense-gf8", "dense-gf8"), ("auto", "msr-pm"),
    ("bogus", None)])
def test_codec_header(tmp_path, monkeypatch, header, want):
    """x-mtpu-codec on PutObject and on a multipart initiate, both
    servers alike: a known id is stamped in xl.meta; "auto" turns
    auto-selection (here the heal-heavy profile, msr-pm at 12+4) back on
    over the server-wide MTPU_CODEC; an unknown id is InvalidArgument
    before a byte streams. Every answer, and every file of the bucket,
    equal."""
    monkeypatch.setenv("MTPU_CODEC", "cauchy-xor")
    monkeypatch.setenv("MTPU_CODEC_PROFILE", "heal-heavy")
    monkeypatch.setenv("MTPU_WORKER_POOL", "0")
    monkeypatch.setenv("MTPU_INLINE_THRESHOLD", "1024")
    monkeypatch.setattr(jax_eo, "BLOCK_SIZE_V2", SMALL_BLOCK)
    monkeypatch.setattr(erasure_objects, "BLOCK_SIZE_V2", SMALL_BLOCK)
    payload = _payload("codec", 30_001)
    codec_header = {"x-mtpu-codec": header}
    out = {}
    for pkg in (JAX, PORT):
        with pytest.MonkeyPatch.context() as alike:
            _alike(alike)
            srv = _server(pkg, tmp_path / pkg, fresh=True)
            try:
                c = S3Client(srv.endpoint, ACCESS, SECRET)
                recs = [c.request("PUT", f"/{BUCKET}"),
                        c.request("PUT", f"/{BUCKET}/obj",
                                  headers=codec_header, body=payload)]
                init = c.request("POST", f"/{BUCKET}/mp", [("uploads", "")],
                                 headers=codec_header)
                recs.append(init)
                if init[0] == 200:
                    upload, etags = _upload_id(init[2]), []
                    for n, part in enumerate((payload[:25_000],
                                              payload[25_000:]), 1):
                        resp = c.request("PUT", f"/{BUCKET}/mp", [
                            ("partNumber", str(n)), ("uploadId", upload)],
                            body=part)
                        etags.append(resp[1]["ETag"])
                        recs.append(resp)
                    recs.append(c.request("POST", f"/{BUCKET}/mp",
                                          [("uploadId", upload)],
                                          body=_complete_xml(etags)))
                recs += [c.request("GET", f"/{BUCKET}/{name}")
                         for name in ("obj", "mp")]
            finally:
                srv.stop()
        out[pkg] = ([_record(r) for r in recs],
                    {p: b for p, b in _tree(tmp_path / pkg).items()
                     if Path(p).parts[1] == BUCKET})
    assert out[PORT][0] == out[JAX][0]
    assert out[PORT][1] == out[JAX][1]
    records = out[PORT][0]
    if want is None:
        assert [r["error"]["Code"] for r in records[1:]] == [
            b"InvalidArgument", b"InvalidArgument", b"NoSuchKey",
            b"NoSuchKey"]
        return
    assert records[-2]["body"] == records[-1]["body"] == payload
    for name in ("obj", "mp"):
        fi = LocalStorage(str(tmp_path / PORT / "d0"), device="cpu") \
            .read_version(BUCKET, name)
        assert fi.erasure.codec == want
