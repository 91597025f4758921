"""The port's S3 object core against minio_tpu's, over HTTP on localhost,
on the CPU: versioning with delete markers and ListObjectVersions,
CopyObject and UploadPartCopy, DeleteObjects, object and bucket
tagging, the canned ACLs and bucket answers, and bucket policies with
anonymous access.

Both servers (SigV4 S3Server -> ErasureServerPools -> one 12+4 set on 16
drive directories) get the same signed request sequence. Statuses,
bodies, the content headers, x-amz-version-id, x-amz-delete-marker and
x-amz-tagging-count, and the error Code, Message and Resource must be
equal, and every file of the 32 drive directories must compare whole
after it. Then shards 0, 5, 12 and 15 of every object are lost on both
sides: versioned GETs by id and a CopyObject from a lost source must
give the payloads, and a heal of every version of every object (the
admin heal walks latest versions only) must rebuild both sides alike,
every part file equal to its pre-loss copy. Each package then serves
the versioned drives the other wrote.

Files compare whole because ids and clocks are made alike: each
package's `uuid` in storage/fileinfo.py is one seeded sequence,
restarted for each side, and the object layers' and bucket metadata's
clock reads a time the sequence sets before each request (one second
apart, so versions order as they were written). minio_tpu runs with
MTPU_CODEC=dense-gf8 and MTPU_WORKER_POOL=0, both at BLOCK_SIZE_V2 =
12 * 1024 with MTPU_INLINE_THRESHOLD = 1024: the port's plain
HighwayHash is a Python loop over 32-byte packets.
"""

import hashlib
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
from minio_tpu.object.metadata import hash_order
from minio_tpu.object.pools import ErasureServerPools as JaxPools
from minio_tpu.object.sets import ErasureSets as JaxErasureSets
from minio_tpu.storage import fileinfo as jax_fileinfo
from minio_tpu.storage.fileinfo import FileInfo as JaxFileInfo
from minio_tpu.storage.local import LocalStorage as JaxLocalStorage
from minio_tpu.storage.xlmeta import XLMeta as JaxXLMeta
from minio_tpu_torch.api.client import S3Client
from minio_tpu_torch.api.server import S3Server
from minio_tpu_torch.bucket import metadata as bucket_meta
from minio_tpu_torch.bucket.metadata import BucketMetadataSys
from minio_tpu_torch.iam.store import IAMSys
from minio_tpu_torch.object import erasure_objects, multipart
from minio_tpu_torch.object.pools import ErasureServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.storage import fileinfo
from minio_tpu_torch.storage.fileinfo import FileInfo
from minio_tpu_torch.storage.local import LocalStorage
from minio_tpu_torch.storage.xlmeta import XLMeta

torch.set_num_threads(1)

PORT, JAX = "port", "jax"
ACCESS, SECRET = "tpuadmin", "tpuadmin-secret-key"
DEPLOYMENT = "5ba52d31-4f2e-4d69-92f5-926a51824ed9"
T0 = 1_700_000_000_123_456_789
SMALL_BLOCK = 12 * 1024
LOST = (0, 5, 12, 15)
COMPARED_HEADERS = ("etag", "content-length", "content-range",
                    "content-type", "last-modified", "x-amz-version-id",
                    "x-amz-delete-marker", "x-amz-tagging-count")
ENABLED = (b'<VersioningConfiguration xmlns="http://s3.amazonaws.com/doc/'
           b'2006-03-01/"><Status>Enabled</Status>'
           b'</VersioningConfiguration>')
SUSPENDED = (b"<VersioningConfiguration><Status> Suspended </Status>"
             b"</VersioningConfiguration>")
TAGGING = (b"<Tagging><TagSet><Tag><Key>team</Key><Value>storage</Value>"
           b"</Tag><Tag><Key>empty</Key><Value></Value></Tag></TagSet>"
           b"</Tagging>")
BIG = 30_001


def _payload(name: str, size: int) -> bytes:
    seed = int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "big")
    return np.random.default_rng(seed).bytes(size)


A, B = _payload("A", BIG), _payload("B", BIG)
MP_SOURCE = _payload("mp-source", 40_000)


def _policy(bucket: str, action: str, resource: str) -> bytes:
    return json.dumps({"Version": "2012-10-17", "Statement": [{
        "Effect": "Allow", "Principal": {"AWS": ["*"]},
        "Action": [action], "Resource": [f"arn:aws:s3:::{bucket}/{resource}"],
    }]}).encode()


class _Shim(types.SimpleNamespace):
    """A module stand-in: its own attributes, the rest from `base`."""

    def __init__(self, base, **attrs):
        super().__init__(**attrs)
        self._base = base

    def __getattr__(self, name):
        return getattr(self._base, name)


class _Clock:
    """The time the sequence sets: one value for a whole request."""

    def __init__(self):
        self.now = T0

    def time_ns(self) -> int:
        return self.now


def _alike(mp) -> _Clock:
    rng = random.Random(11)
    seeded = _Shim(uuid, uuid4=lambda: uuid.UUID(int=rng.getrandbits(128),
                                                 version=4))
    for mod in (fileinfo, jax_fileinfo):
        mp.setattr(mod, "uuid", seeded)
    clock = _Clock()
    shim = _Shim(time, time_ns=clock.time_ns)
    for mod in (erasure_objects, multipart, bucket_meta, jax_eo, jax_mp,
                jax_bucket_meta):
        mp.setattr(mod, "time", shim)
    return clock


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
    status, headers, body = resp
    lower = {k.lower(): v for k, v in headers.items()}
    out = {"status": status,
           "headers": {k: v for k, v in lower.items()
                       if k in COMPARED_HEADERS
                       or k.startswith("x-amz-meta-")}}
    if status >= 400 and body.startswith(b"<?xml"):
        out["error"] = {t: re.search(rf"<{t}>(.*?)</{t}>".encode(),
                                     body).group(1)
                        for t in ("Code", "Message", "Resource")}
    else:
        out["body"] = body
    return out


def _tag(body: bytes, tag: str) -> list[str]:
    return [m.decode() for m in re.findall(rf"<{tag}>(.*?)</{tag}>".encode(),
                                           body)]


def _complete_xml(etags) -> bytes:
    return ("<CompleteMultipartUpload>" + "".join(
        f"<Part><PartNumber>{i + 1}</PartNumber><ETag>{e}</ETag></Part>"
        for i, e in enumerate(etags)) + "</CompleteMultipartUpload>").encode()


def _delete_xml(objects, quiet=False) -> bytes:
    return ("<Delete>" + ("<Quiet>true</Quiet>" if quiet else "") + "".join(
        f"<Object><Key>{k}</Key>"
        + (f"<VersionId>{v}</VersionId>" if v else "") + "</Object>"
        for k, v in objects) + "</Delete>").encode()


def _sequence(c: S3Client, clock: _Clock) -> tuple[list, dict]:
    """The request sequence: (label, record) pairs, and the version ids
    it made by name."""
    out, vids = [], {}
    def rec(label, method, path, query=None, headers=None, body=b"",
            anonymous=False):
        clock.now += 10 ** 9
        resp = c.request(method, path, query, headers, body,
                         anonymous=anonymous)
        out.append((label, _record(resp)))
        return resp

    def vid(label, resp):
        vids[label] = resp[1].get("x-amz-version-id", "")
        return vids[label]

    # Versioning Enabled: three versions, a marker, targeted reads and
    # deletes.
    rec("make ver", "PUT", "/ver")
    rec("get versioning unset", "GET", "/ver", [("versioning", "")])
    rec("put versioning bad xml", "PUT", "/ver", [("versioning", "")],
        body=b"<Versioning")
    rec("put versioning", "PUT", "/ver", [("versioning", "")], body=ENABLED)
    rec("get versioning", "GET", "/ver", [("versioning", "")])
    for i, body in enumerate((b"one", b"two", b"three")):
        vid(f"doc{i}", rec(f"put doc {i}", "PUT", "/ver/doc", body=body))
    rec("get doc", "GET", "/ver/doc")
    rec("get doc v0", "GET", "/ver/doc", [("versionId", vids["doc0"])])
    rec("head doc v1", "HEAD", "/ver/doc", [("versionId", vids["doc1"])])
    rec("get doc no such version", "GET", "/ver/doc",
        [("versionId", "00000000-0000-4000-8000-000000000000")])
    rec("versions doc", "GET", "/ver", [("versions", ""), ("prefix", "doc")])
    vid("doc marker", rec("delete doc", "DELETE", "/ver/doc"))
    rec("get doc deleted", "GET", "/ver/doc")
    rec("head doc deleted", "HEAD", "/ver/doc")
    rec("get doc marker by id", "GET", "/ver/doc",
        [("versionId", vids["doc marker"])])
    rec("versions doc with marker", "GET", "/ver",
        [("versions", ""), ("prefix", "doc")])
    rec("list v2 hides marked", "GET", "/ver", [("list-type", "2")])
    rec("delete doc marker", "DELETE", "/ver/doc",
        [("versionId", vids["doc marker"])])
    rec("get doc restored", "GET", "/ver/doc")
    rec("delete doc v1", "DELETE", "/ver/doc", [("versionId", vids["doc1"])])
    rec("get doc v1 gone", "GET", "/ver/doc", [("versionId", vids["doc1"])])
    rec("delete doc v1 again", "DELETE", "/ver/doc",
        [("versionId", vids["doc1"])])

    # The big object: part files, two versions, tags on the second.
    vid("bigA", rec("put big A", "PUT", "/ver/big", body=A))
    vid("bigB", rec("put big B tagged", "PUT", "/ver/big", body=B,
                    headers={"x-amz-tagging": "team=storage&tier="}))
    rec("head big", "HEAD", "/ver/big")
    rec("versions big", "GET", "/ver", [("versions", ""), ("prefix", "big")])

    # The null version (tests/test_versioning.py) and suspension.
    rec("make nullb", "PUT", "/nullb")
    rec("put pre unversioned", "PUT", "/nullb/pre", body=b"prever")
    rec("enable nullb", "PUT", "/nullb", [("versioning", "")], body=ENABLED)
    vid("pre v2", rec("put pre v2", "PUT", "/nullb/pre", body=b"v2"))
    rec("get pre null", "GET", "/nullb/pre", [("versionId", "null")])
    rec("versions nullb", "GET", "/nullb", [("versions", "")])
    rec("delete pre null", "DELETE", "/nullb/pre", [("versionId", "null")])
    rec("get pre null gone", "GET", "/nullb/pre", [("versionId", "null")])
    rec("get pre latest", "GET", "/nullb/pre")
    rec("put null-targeted", "PUT", "/nullb/nw", [("versionId", "null")],
        body=b"nullwrite")
    rec("get null-targeted", "GET", "/nullb/nw", [("versionId", "null")])
    rec("suspend nullb", "PUT", "/nullb", [("versioning", "")],
        body=SUSPENDED)
    rec("get versioning suspended", "GET", "/nullb", [("versioning", "")])
    rec("put pre suspended", "PUT", "/nullb/pre", body=b"suspended-1")
    rec("put pre suspended again", "PUT", "/nullb/pre",
        body=b"suspended-2")
    rec("versions nullb suspended", "GET", "/nullb", [("versions", "")])
    rec("get pre suspended", "GET", "/nullb/pre")
    rec("delete pre suspended", "DELETE", "/nullb/pre")
    rec("versions nullb after delete", "GET", "/nullb", [("versions", "")])
    rec("get pre after suspended delete", "GET", "/nullb/pre")
    rec("delete pre suspended again", "DELETE", "/nullb/pre")
    rec("get pre v2 kept", "GET", "/nullb/pre",
        [("versionId", vids["pre v2"])])

    # ListObjectVersions: pages with key and version-id markers, a
    # delimiter, max-keys 0, a version-id marker alone.
    rec("make pgb", "PUT", "/pgb")
    rec("enable pgb", "PUT", "/pgb", [("versioning", "")], body=ENABLED)
    for k in range(4):
        for v in range(3):
            rec(f"put pgb k{k} v{v}", "PUT", f"/pgb/k{k}",
                body=f"{k}-{v}".encode())
    rec("put pgb dir", "PUT", "/pgb/dir/a", body=b"in a dir")
    rec("delete pgb k2", "DELETE", "/pgb/k2")
    key_marker = vid_marker = ""
    for page in range(10):
        q = [("versions", ""), ("max-keys", "5")]
        if key_marker:
            q.append(("key-marker", key_marker))
        if vid_marker:
            q.append(("version-id-marker", vid_marker))
        _, _, body = rec(f"versions pgb page {page}", "GET", "/pgb", q)
        if b"<IsTruncated>true</IsTruncated>" not in body:
            break
        key_marker = _tag(body, "NextKeyMarker")[0]
        vid_marker = _tag(body, "NextVersionIdMarker")[0]
    rec("versions pgb delimiter", "GET", "/pgb",
        [("versions", ""), ("delimiter", "/")])
    rec("versions pgb key marker only", "GET", "/pgb",
        [("versions", ""), ("key-marker", "k1")])
    rec("versions pgb max-keys 0", "GET", "/pgb",
        [("versions", ""), ("max-keys", "0")])
    rec("versions pgb vid marker alone", "GET", "/pgb",
        [("versions", ""), ("version-id-marker", "x")])
    rec("versions pgb url", "GET", "/pgb",
        [("versions", ""), ("encoding-type", "url"), ("prefix", "dir/")])

    # DeleteObjects: verbose and quiet, version ids, keys already gone.
    for i in range(6):
        rec(f"put del {i}", "PUT", f"/pgb/del/{i}", body=b"x" * i)
    _, _, vers = rec("versions del", "GET", "/pgb",
                     [("versions", ""), ("prefix", "del/")])
    del_vids = _tag(vers, "VersionId")
    rec("delete objects verbose", "POST", "/pgb", [("delete", "")],
        body=_delete_xml([("del/0", ""), ("del/1", del_vids[4]),
                          ("del/none", ""), ("del/2", "")]))
    rec("delete objects quiet", "POST", "/pgb", [("delete", "")],
        body=_delete_xml([("del/3", ""), ("del/4", del_vids[1])],
                         quiet=True))
    rec("delete objects malformed", "POST", "/pgb", [("delete", "")],
        body=b"<Delete><Object>")
    rec("delete objects no such version", "POST", "/pgb", [("delete", "")],
        body=_delete_xml([("del/5", "00000000-0000-4000-8000-000000000000")]))
    rec("versions del after", "GET", "/pgb",
        [("versions", ""), ("prefix", "del/")])

    # CopyObject.
    rec("make dst", "PUT", "/dst")
    src_a = f"/ver/big?versionId={vids['bigA']}"
    rec("copy big A", "PUT", "/dst/copy",
        headers={"x-amz-copy-source": src_a})
    rec("get copy", "GET", "/dst/copy")
    rec("copy latest replace", "PUT", "/dst/replaced", headers={
        "x-amz-copy-source": "/ver/big", "x-amz-metadata-directive":
        "REPLACE", "Content-Type": "text/x-replaced",
        "x-amz-meta-origin": "replace"})
    rec("head replaced", "HEAD", "/dst/replaced")
    _, h, _ = rec("head big A", "HEAD", "/ver/big",
                  [("versionId", vids["bigA"])])
    etag_a = h["ETag"]
    for label, hdr, val in (
            ("if-match ok", "x-amz-copy-source-if-match", etag_a),
            ("if-match fails", "x-amz-copy-source-if-match", '"0123"'),
            ("if-none-match fails", "x-amz-copy-source-if-none-match",
             etag_a),
            ("if-modified-since fails",
             "x-amz-copy-source-if-modified-since",
             "Sun, 01 Jan 2040 00:00:00 GMT"),
            ("if-unmodified-since fails",
             "x-amz-copy-source-if-unmodified-since",
             "Mon, 01 Jan 2001 00:00:00 GMT"),
            ("if-unmodified-since ok",
             "x-amz-copy-source-if-unmodified-since",
             "Sun, 01 Jan 2040 00:00:00 GMT")):
        rec(f"copy {label}", "PUT", "/dst/cond",
            headers={"x-amz-copy-source": src_a, hdr: val})
    rec("copy missing source", "PUT", "/dst/x",
        headers={"x-amz-copy-source": "/ver/nokey"})
    rec("copy marked source", "PUT", "/dst/x",
        headers={"x-amz-copy-source": "/pgb/k2"})
    rec("copy bad source", "PUT", "/dst/x",
        headers={"x-amz-copy-source": "nobucketslash"})
    rec("copy no such bucket", "PUT", "/dst/x",
        headers={"x-amz-copy-source": "/nobucket/key"})
    rec("self-copy untargeted", "PUT", "/dst/copy",
        headers={"x-amz-copy-source": "/dst/copy"})
    rec("self-copy replace unversioned", "PUT", "/dst/copy", headers={
        "x-amz-copy-source": "/dst/copy",
        "x-amz-metadata-directive": "REPLACE", "x-amz-meta-note": "self"})
    rec("head self-copied", "HEAD", "/dst/copy")
    vid("big self", rec("self-copy replace versioned", "PUT", "/ver/big",
                        headers={"x-amz-copy-source": "/ver/big",
                                 "x-amz-metadata-directive": "REPLACE",
                                 "x-amz-meta-note": "versioned self"}))
    vid("big restored", rec("self-copy targeted", "PUT", "/ver/big",
                            headers={"x-amz-copy-source": src_a}))
    rec("get big restored", "GET", "/ver/big")
    rec("versions big after copies", "GET", "/ver",
        [("versions", ""), ("prefix", "big")])

    # A multipart source, copied whole and by UploadPartCopy.
    _, _, body = rec("mp source new", "POST", "/dst/mpsrc", [("uploads", "")])
    upload = _tag(body, "UploadId")[0]
    etags = []
    for n, (lo, hi) in enumerate(((0, 25_000), (25_000, 40_000)), 1):
        _, h, _ = rec(f"mp source part {n}", "PUT", "/dst/mpsrc",
                      [("partNumber", str(n)), ("uploadId", upload)],
                      body=MP_SOURCE[lo:hi])
        etags.append(h["ETag"])
    rec("mp source complete", "POST", "/dst/mpsrc", [("uploadId", upload)],
        body=_complete_xml(etags))
    rec("copy multipart source", "PUT", "/dst/mpcopy",
        headers={"x-amz-copy-source": "/dst/mpsrc"})
    rec("get multipart copy", "GET", "/dst/mpcopy")

    _, _, body = rec("upc new", "POST", "/dst/parts", [("uploads", "")],
                     headers={"x-amz-tagging": "origin=copy"})
    upload = _tag(body, "UploadId")[0]
    src_b = f"/ver/big?versionId={vids['bigB']}"
    for bad in ("bytes=-5", "bytes=5-", "bytes=10-5", f"bytes=0-{BIG}",
                "octets=0-5"):
        rec(f"upc range {bad}", "PUT", "/dst/parts",
            [("partNumber", "1"), ("uploadId", upload)],
            headers={"x-amz-copy-source": src_b,
                     "x-amz-copy-source-range": bad})
    etags = []
    for n, rng in enumerate(("bytes=0-12287", f"bytes=12288-{BIG - 1}"), 1):
        _, _, body = rec(f"upc part {n}", "PUT", "/dst/parts",
                         [("partNumber", str(n)), ("uploadId", upload)],
                         headers={"x-amz-copy-source": src_b,
                                  "x-amz-copy-source-range": rng})
        etags += _tag(body, "ETag")
    _, _, body = rec("upc part 3 whole", "PUT", "/dst/parts",
                     [("partNumber", "3"), ("uploadId", upload)],
                     headers={"x-amz-copy-source": "/ver/doc"})
    etags += _tag(body, "ETag")
    rec("upc part missing upload", "PUT", "/dst/parts",
        [("partNumber", "1"), ("uploadId", "nosuchupload")],
        headers={"x-amz-copy-source": src_b})
    rec("upc list parts", "GET", "/dst/parts", [("uploadId", upload)])
    rec("upc complete", "POST", "/dst/parts", [("uploadId", upload)],
        body=_complete_xml([e.replace("&quot;", '"') for e in etags]))
    rec("get parts", "GET", "/dst/parts")
    rec("head parts", "HEAD", "/dst/parts")

    # Object tagging (tests/test_tagging_acl_storageclass.py).
    q_a = [("tagging", ""), ("versionId", vids["bigA"])]
    rec("get tags A none", "GET", "/ver/big", q_a)
    rec("put tags A", "PUT", "/ver/big", q_a, body=TAGGING)
    rec("get tags A", "GET", "/ver/big", q_a)
    rec("get tags B", "GET", "/ver/big",
        [("tagging", ""), ("versionId", vids["bigB"])])
    rec("head B tag count", "HEAD", "/ver/big",
        [("versionId", vids["bigB"])])
    rec("head A tag count", "HEAD", "/ver/big",
        [("versionId", vids["bigA"])])
    rec("delete tags A", "DELETE", "/ver/big", q_a)
    rec("get tags A deleted", "GET", "/ver/big", q_a)
    eleven = "".join(f"<Tag><Key>k{i}</Key><Value>v</Value></Tag>"
                     for i in range(11))
    for label, body in (
            ("eleven", f"<Tagging><TagSet>{eleven}</TagSet></Tagging>"),
            ("duplicate", "<Tagging><TagSet><Tag><Key>a</Key><Value>1"
             "</Value></Tag><Tag><Key>a</Key><Value>2</Value></Tag>"
             "</TagSet></Tagging>"),
            ("no value", "<Tagging><TagSet><Tag><Key>a</Key></Tag>"
             "</TagSet></Tagging>"),
            ("long key", f"<Tagging><TagSet><Tag><Key>{'k' * 129}</Key>"
             "<Value>v</Value></Tag></TagSet></Tagging>"),
            ("malformed", "<Tagging><TagSet>")):
        rec(f"put tags {label}", "PUT", "/dst/copy", [("tagging", "")],
            body=body.encode())
    rec("put tagging header eleven", "PUT", "/dst/toomany", body=b"x",
        headers={"x-amz-tagging": "&".join(f"k{i}=" for i in range(11))})
    rec("tags on marked key", "GET", "/pgb/k2", [("tagging", "")])
    rec("put tags on marked key", "PUT", "/pgb/k2", [("tagging", "")],
        body=TAGGING)
    rec("tags missing key", "GET", "/dst/nokey", [("tagging", "")])

    # Bucket tagging.
    rec("get bucket tags none", "GET", "/dst", [("tagging", "")])
    rec("put bucket tags", "PUT", "/dst", [("tagging", "")], body=TAGGING)
    rec("put bucket tags malformed", "PUT", "/dst", [("tagging", "")],
        body=b"<Tagging")
    rec("get bucket tags", "GET", "/dst", [("tagging", "")])
    rec("delete bucket tags", "DELETE", "/dst", [("tagging", "")])
    rec("get bucket tags deleted", "GET", "/dst", [("tagging", "")])

    # The canned ACLs and bucket answers.
    rec("get bucket acl", "GET", "/dst", [("acl", "")])
    rec("get object acl", "GET", "/dst/copy", [("acl", "")])
    rec("put bucket acl private", "PUT", "/dst", [("acl", "")],
        headers={"x-amz-acl": "private"})
    rec("put bucket acl public", "PUT", "/dst", [("acl", "")],
        headers={"x-amz-acl": "public-read"})
    rec("put object acl missing", "PUT", "/dst/nokey", [("acl", "")],
        headers={"x-amz-acl": "private"})
    rec("put object acl grants", "PUT", "/dst/copy", [("acl", "")], body=(
        b"<AccessControlPolicy><AccessControlList><Grant><Grantee><ID>x"
        b"</ID></Grantee><Permission>FULL_CONTROL</Permission></Grant>"
        b"<Grant><Grantee><ID>y</ID></Grantee><Permission>READ"
        b"</Permission></Grant></AccessControlList></AccessControlPolicy>"))
    rec("acl on marked key", "GET", "/pgb/k2", [("acl", "")])
    for sub in ("cors", "website", "accelerate", "requestPayment",
                "logging", "policyStatus"):
        rec(f"get bucket {sub}", "GET", "/dst", [(sub, "")])
    rec("delete bucket website", "DELETE", "/dst", [("website", "")])
    rec("put bucket cors rejected", "PUT", "/dst", [("cors", "")],
        body=b"<CORSConfiguration/>")
    rec("get bucket metrics rejected", "GET", "/dst", [("metrics", "")])
    rec("head bucket acl rejected", "HEAD", "/dst", [("acl", "")])
    rec("get lifecycle none", "GET", "/dst", [("lifecycle", "")])
    rec("get retention none", "GET", "/dst/copy", [("retention", "")])
    rec("get replication not ported", "GET", "/dst", [("replication", "")])

    # Bucket policy and anonymous access (tests/test_s3_api.py:331, 648).
    rec("put public x", "PUT", "/dst/public/x", body=b"public bytes")
    rec("get policy none", "GET", "/dst", [("policy", "")])
    rec("put policy malformed", "PUT", "/dst", [("policy", "")],
        body=b"{not json")
    rec("put policy bad effect", "PUT", "/dst", [("policy", "")],
        body=b'{"Statement": [{"Effect": "Maybe", "Action": "s3:*"}]}')
    rec("put policy", "PUT", "/dst", [("policy", "")],
        body=_policy("dst", "s3:GetObject", "public/*"))
    rec("get policy", "GET", "/dst", [("policy", "")])
    rec("policy status public", "GET", "/dst", [("policyStatus", "")])
    rec("anonymous get public", "GET", "/dst/public/x", anonymous=True)
    rec("anonymous get private", "GET", "/dst/copy", anonymous=True)
    rec("anonymous put", "PUT", "/dst/public/y", body=b"no",
        anonymous=True)
    rec("anonymous list", "GET", "/dst", anonymous=True)
    rec("make drop", "PUT", "/drop")
    rec("put drop policy", "PUT", "/drop", [("policy", "")],
        body=_policy("drop", "s3:PutObject", "*"))
    rec("anonymous copy unreadable source", "PUT", "/drop/stolen",
        headers={"x-amz-copy-source": "/dst/copy"}, anonymous=True)
    rec("anonymous copy readable source", "PUT", "/drop/copied",
        headers={"x-amz-copy-source": "/dst/public/x"}, anonymous=True)
    rec("anonymous put allowed", "PUT", "/drop/put", body=b"dropped",
        anonymous=True)
    rec("delete policy", "DELETE", "/dst", [("policy", "")])
    rec("anonymous get public after", "GET", "/dst/public/x",
        anonymous=True)
    rec("get policy deleted", "GET", "/dst", [("policy", "")])

    rec("versions ver final", "GET", "/ver", [("versions", "")])
    rec("list dst final", "GET", "/dst", [("list-type", "2")])
    return out, vids


# The objects whose every version is read back degraded and healed, by
# bucket.
OBJECTS = {"ver": ("doc", "big"), "dst": ("copy", "replaced", "parts",
                                          "mpsrc", "mpcopy")}


def _versions_on(root: Path, drive: int, bucket: str, name: str):
    """A drive's version journal of the object (id, mod time, deleted),
    None when the drive has no xl.meta of it."""
    p = root / f"d{drive}" / bucket / name / "xl.meta"
    if not p.is_file():
        return None
    return [{"vid": v["vid"], "mt": v["mt"], "del": v["del"]}
            for v in XLMeta.from_bytes(p.read_bytes()).versions]


def _versions(root: Path, bucket: str, name: str) -> list[dict]:
    """The version journal of the first drive that has one."""
    return next(v for i in range(16)
                if (v := _versions_on(root, i, bucket, name)) is not None)


def _destroy(root: Path) -> None:
    """Every object of OBJECTS loses shards 0, 5, 12 and 15: the object
    directories of the drives that hold them, by its distribution."""
    for bucket, names in OBJECTS.items():
        for name in names:
            dist = hash_order(f"{bucket}/{name}", 16)
            drive = {d - 1: i for i, d in enumerate(dist)}
            for s in LOST:
                obj = root / f"d{drive[s]}" / bucket / name
                for p in sorted(obj.rglob("*"), reverse=True):
                    p.unlink() if p.is_file() else p.rmdir()
                obj.rmdir()


def _heal_bucket(c: S3Client, bucket: str) -> dict:
    path = f"/minio/admin/v3/heal/{bucket}"
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
    """Both servers through the sequence, the losses, the degraded
    reads and copy, and the heals."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MTPU_CODEC", "dense-gf8")
        mp.setenv("MTPU_WORKER_POOL", "0")
        mp.setenv("MTPU_INLINE_THRESHOLD", "1024")
        mp.setattr(jax_eo, "BLOCK_SIZE_V2", SMALL_BLOCK)
        mp.setattr(erasure_objects, "BLOCK_SIZE_V2", SMALL_BLOCK)
        root = tmp_path_factory.mktemp("s3core")
        for pkg in (JAX, PORT):
            with pytest.MonkeyPatch.context() as alike:
                clock = _alike(alike)
                srv = _server(pkg, root / pkg, fresh=True)
                try:
                    c = S3Client(srv.endpoint, ACCESS, SECRET)
                    records, vids = _sequence(c, clock)
                    written = _tree(root / pkg)
                    journals = {(b, n): _versions(root / pkg, b, n)
                                for b, names in OBJECTS.items()
                                for n in names}
                    _destroy(root / pkg)
                    degraded = {key: c.request("GET", "/ver/big", [
                        ("versionId", vids[key])])
                        for key in ("bigA", "bigB", "big self")}
                    clock.now += 10 ** 9
                    degraded["copy"] = c.request(
                        "PUT", "/dst/degraded-copy", headers={
                            "x-amz-copy-source":
                                f"/ver/big?versionId={vids['bigA']}"})
                    degraded["copy get"] = c.request(
                        "GET", "/dst/degraded-copy")
                    admin = _heal_bucket(c, "dst")
                    ol = srv.handlers.ol
                    heals = {}
                    for (b, n), versions in journals.items():
                        for v in versions:
                            heals[(b, n, v["vid"])] = ol.heal_object(
                                b, n, v["vid"] or "null")
                    after = _tree(root / pkg)
                    healed_journals = {
                        key: [_versions_on(root / pkg, i, *key)
                              for i in range(16)] for key in journals}
                finally:
                    srv.stop()
            out[pkg] = {"records": records, "vids": vids,
                        "written": written, "journals": journals,
                        "degraded": degraded, "admin": admin,
                        "heals": heals, "after": after,
                        "healed_journals": healed_journals,
                        "root": root / pkg}
        yield out


# Requests of configurations outside the slice: minio_tpu serves them,
# the port answers NotImplemented.
NOT_PORTED = ("get replication not ported",)


def test_same_responses(runs):
    port, jax = runs[PORT]["records"], runs[JAX]["records"]
    assert [label for label, _ in port] == [label for label, _ in jax]
    for (label, p), (_, j) in zip(port, jax):
        if label in NOT_PORTED:
            assert p["error"]["Code"] == b"NotImplemented", (label, p)
            continue
        assert p == j, f"{label}: port {p} != minio_tpu {j}"


def test_sequence_did_what_it_says(runs):
    """Key answers held to S3, so that equal answers are right ones."""
    recs = dict(runs[PORT]["records"])
    vids = runs[PORT]["vids"]

    def code(label):
        return recs[label]["error"]["Code"].decode()

    assert b"<Status>Enabled</Status>" in recs["get versioning"]["body"]
    assert len({vids[f"doc{i}"] for i in range(3)}) == 3
    assert recs["get doc"]["body"] == b"three"
    assert recs["get doc v0"]["body"] == b"one"
    assert recs["delete doc"]["headers"]["x-amz-delete-marker"] == "true"
    assert code("get doc deleted") == "NoSuchKey"
    assert code("get doc marker by id") == "MethodNotAllowed"
    body = recs["versions doc with marker"]["body"]
    assert body.count(b"<DeleteMarker>") == 1 and \
        body.count(b"<Version>") == 3
    assert recs["get doc restored"]["body"] == b"three"
    assert code("get doc v1 gone") == "NoSuchVersion"
    assert recs["head B tag count"]["headers"]["x-amz-tagging-count"] == "2"
    assert recs["get pre null"]["body"] == b"prever"
    assert _tag(recs["versions nullb"]["body"], "VersionId")[:2] == \
        [vids["pre v2"], "null"]
    assert recs["get null-targeted"]["body"] == b"nullwrite"
    assert recs["get pre suspended"]["body"] == b"suspended-2"
    assert recs["get pre v2 kept"]["body"] == b"v2"
    pages = [label for label in recs if label.startswith("versions pgb page")]
    assert len(pages) >= 3
    assert code("versions pgb vid marker alone") == "InvalidArgument"
    verbose = recs["delete objects verbose"]["body"]
    assert verbose.count(b"<Deleted>") == 4 and b"<Error>" not in verbose
    assert b"<Deleted>" not in recs["delete objects quiet"]["body"]
    assert code("delete objects malformed") == "MalformedXML"
    assert recs["get copy"]["body"] == A
    assert recs["head replaced"]["headers"]["content-type"] == \
        "text/x-replaced"
    assert recs["copy if-match ok"]["status"] == 200
    for label in ("if-match fails", "if-none-match fails",
                  "if-modified-since fails", "if-unmodified-since fails"):
        assert code(f"copy {label}") == "PreconditionFailed"
    assert code("copy missing source") == "NoSuchKey"
    assert code("copy bad source") == "InvalidArgument"
    assert code("self-copy untargeted") == "InvalidRequest"
    assert recs["head self-copied"]["headers"]["x-amz-meta-note"] == "self"
    assert recs["get big restored"]["body"] == A
    assert recs["get multipart copy"]["body"] == MP_SOURCE
    for bad in ("bytes=-5", "bytes=5-", "bytes=10-5", f"bytes=0-{BIG}",
                "octets=0-5"):
        assert code(f"upc range {bad}") == "InvalidArgument"
    assert recs["get parts"]["body"] == B + b"three"
    # minio_tpu keeps no x-mtpu-internal-* key of the upload at Complete,
    # so the tags of NewMultipartUpload are lost; the port does the same.
    assert "x-amz-tagging-count" not in recs["head parts"]["headers"]
    assert b"<Key>empty</Key>" in recs["get tags A"]["body"]
    for label in ("eleven", "duplicate", "no value", "long key"):
        assert code(f"put tags {label}") == "InvalidTag"
    assert code("put tagging header eleven") == "InvalidTag"
    assert code("tags on marked key") == "NoSuchKey"
    assert code("get bucket tags none") == "NoSuchTagSet"
    assert code("put bucket acl public") == "NotImplemented"
    assert code("put object acl missing") == "NoSuchKey"
    assert code("get bucket cors") == "NoSuchCORSConfiguration"
    assert code("put bucket cors rejected") == "NotImplemented"
    assert code("get lifecycle none") == "NoSuchLifecycleConfiguration"
    assert code("get retention none") == "NoSuchObjectLockConfiguration"
    assert code("get replication not ported") == "NotImplemented"
    assert code("get policy none") == "NoSuchBucketPolicy"
    assert code("put policy malformed") == "MalformedXML"
    assert b"TRUE" in recs["policy status public"]["body"]
    assert recs["anonymous get public"]["body"] == b"public bytes"
    assert code("anonymous get private") == "AccessDenied"
    assert code("anonymous put") == "AccessDenied"
    assert code("anonymous copy unreadable source") == "AccessDenied"
    assert recs["anonymous copy readable source"]["status"] == 200
    assert recs["anonymous put allowed"]["status"] == 200
    assert code("anonymous get public after") == "AccessDenied"


def test_same_drives_after_the_sequence(runs):
    port, jax = runs[PORT]["written"], runs[JAX]["written"]
    assert sorted(port) == sorted(jax)
    for path in port:
        assert port[path] == jax[path], f"{path} differs from minio_tpu's"
    assert sum(p.endswith("/part.1") for p in port) > 16 * 4


def test_degraded_versioned_reads_and_copy(runs):
    for pkg in (PORT, JAX):
        deg = runs[pkg]["degraded"]
        assert deg["bigA"][0] == 200 and deg["bigA"][2] == A, pkg
        assert deg["bigB"][0] == 200 and deg["bigB"][2] == B, pkg
        assert deg["big self"][2] == B, pkg
        assert deg["copy"][0] == 200, (pkg, deg["copy"])
        assert f'"{hashlib.md5(A).hexdigest()}"'.encode() in deg["copy"][2]
        assert deg["copy get"][2] == A, pkg
    for key in ("bigA", "bigB", "big self", "copy", "copy get"):
        assert _record(runs[PORT]["degraded"][key]) == \
            _record(runs[JAX]["degraded"][key]), key


def test_per_version_heals_rebuild_both_sides(runs):
    for pkg in (PORT, JAX):
        run = runs[pkg]
        assert run["admin"]["Summary"] == "finished", run["admin"]
        assert run["admin"]["NumFailed"] == 0, run["admin"]
        # The admin heal rebuilt dst's (unversioned) objects; every
        # version of ver's is rebuilt by its own heal.
        for (bucket, name, vid), res in run["heals"].items():
            assert bool(res["healed"]) == (bucket == "ver"), (
                pkg, bucket, name, vid, res)
        for path, blob in run["written"].items():
            if "/part." in path:
                assert run["after"].get(path) == blob, f"{pkg}: {path}"
        for key, journal in run["journals"].items():
            for i, healed in enumerate(run["healed_journals"][key]):
                assert healed == journal, (pkg, key, i)
    assert runs[PORT]["heals"] == runs[JAX]["heals"]
    port, jax = runs[PORT]["after"], runs[JAX]["after"]
    assert sorted(port) == sorted(jax)
    for path in port:
        assert port[path] == jax[path], f"{path} differs after heal"


@pytest.mark.parametrize("reader,writer", [(PORT, JAX), (JAX, PORT)])
def test_serves_the_other_packages_versioned_drives(runs, reader, writer,
                                                    monkeypatch):
    monkeypatch.setenv("MTPU_CODEC", "dense-gf8")
    monkeypatch.setenv("MTPU_WORKER_POOL", "0")
    monkeypatch.setenv("MTPU_INLINE_THRESHOLD", "1024")
    vids = runs[writer]["vids"]
    srv = _server(reader, runs[writer]["root"], fresh=False)
    try:
        c = S3Client(srv.endpoint, ACCESS, SECRET)
        for key, want in (("bigA", A), ("bigB", B), ("doc0", b"one")):
            name = "big" if key.startswith("big") else "doc"
            status, _, body = c.request("GET", f"/ver/{name}",
                                        [("versionId", vids[key])])
            assert status == 200 and body == want, key
        status, h, _ = c.request("HEAD", "/ver/big",
                                 [("versionId", vids["bigB"])])
        assert h.get("x-amz-tagging-count") == "2"
        status, _, body = c.request("GET", "/ver", [("versions", "")])
        assert body == dict(runs[writer]["records"])[
            "versions ver final"]["body"]
        assert c.request("GET", "/dst/parts")[2] == B + b"three"
    finally:
        srv.stop()


def test_list_versions_lists_the_null_version_as_the_latest(tmp_path):
    """ROADMAP Queue 3's fault of the reference, copied as it is: a
    journal entry with the null version id resolves through
    to_file_info's "" = latest, so list_versions gives the latest
    version twice and never the null version's own data."""
    out = {}
    for pkg, disk, fi_cls in (
            (PORT, LocalStorage(str(tmp_path / PORT), device="cpu"),
             FileInfo),
            (JAX, JaxLocalStorage(str(tmp_path / JAX)), JaxFileInfo)):
        disk.make_vol("b")
        for vid, mt, size in (("", 1, 10), ("v-new", 2, 20)):
            disk.write_metadata("b", "o", fi_cls(
                volume="b", name="o", version_id=vid, mod_time_ns=mt,
                size=size))
        listed = disk.list_versions("b", "o").versions
        out[pkg] = [(v.version_id, v.mod_time_ns, v.size, v.is_latest)
                    for v in listed]
    assert out[PORT] == out[JAX]
    # Both entries are the latest (v-new, size 20): the fault.
    assert out[PORT] == [("v-new", 2, 20, True), ("v-new", 2, 20, True)]
    raw = JaxXLMeta.from_bytes((tmp_path / PORT / "b" / "o" / "xl.meta")
                               .read_bytes())
    assert [v["vid"] for v in raw.versions] == ["v-new", ""]


def test_delete_versions_and_update_metadata(tmp_path):
    """The drive calls the object core adds, both packages alike:
    update_metadata rewrites an existing version only, delete_versions
    answers per version."""
    out = {}
    for pkg, disk, fi_cls in (
            (PORT, LocalStorage(str(tmp_path / PORT), device="cpu"),
             FileInfo),
            (JAX, JaxLocalStorage(str(tmp_path / JAX)), JaxFileInfo)):
        disk.make_vol("b")
        for vid, mt in (("v1", 1), ("v2", 2)):
            disk.write_metadata("b", "o", fi_cls(volume="b", name="o",
                                                 version_id=vid,
                                                 mod_time_ns=mt))
        upd = fi_cls(volume="b", name="o", version_id="v1", mod_time_ns=1,
                     metadata={"k": "v"})
        disk.update_metadata("b", "o", upd)
        missing = fi_cls(volume="b", name="o", version_id="v9")
        try:
            disk.update_metadata("b", "o", missing)
            refused = None
        except Exception as exc:  # noqa: BLE001 - its class is compared
            refused = type(exc).__name__
        meta = disk.read_version("b", "o", "v1").metadata
        errs = disk.delete_versions("b", [
            fi_cls(volume="b", name="o", version_id="v1"),
            fi_cls(volume="b", name="o", version_id="v9"),
            fi_cls(volume="b", name="o", version_id="v2")])
        out[pkg] = (meta, refused, [type(e).__name__ if e else None
                                    for e in errs],
                    (tmp_path / pkg / "b" / "o").exists())
    assert out[PORT] == out[JAX]
    assert out[PORT] == ({"k": "v"}, "ErrFileVersionNotFound",
                         [None, "ErrFileVersionNotFound", None], False)
