"""Server-side encryption on the port against minio_tpu's, over HTTP on
localhost, on the CPU (the port's AEAD takes its plain version here;
kernels C and D are held to it on the card).

- The SSE cases of tests/test_streaming_transforms.py and the cases of
  tests/test_kms.py, case for case on both packages' servers (the
  compression cases are in tests/test_torch_compression.py; the 192 MiB
  bounded-RSS case runs on the card, in tests/test_torch_cuda.py and
  phase 4k of chip_smoke.py). Objects are a few 64 KiB packages
  over 12 KiB erasure blocks.
- Each package reads the SSE-S3, SSE-C and SSE-KMS objects the other
  wrote (one root password), a named KMS key's registry included.
- With os.urandom seeded, and ids and clocks made alike, both packages
  write byte-identical drive files for encrypted PUTs; with four drives
  lost both read the objects degraded and their heals rebuild the
  originals.
- The SSE-C-over-plain-HTTP guard and MTPU_ALLOW_INSECURE_SSEC; the
  bucket's ?encryption document.
- Two faults of minio_tpu that the port refuses instead (ROADMAP Queue
  3): an encrypted multipart upload is stored in plaintext, and an
  UploadPartCopy from an encrypted source copies its ciphertext.
"""

import base64
import hashlib
import json
import os
import random
import shutil

import numpy as np
import pytest
import torch

from minio_tpu.api import S3Server as JaxS3Server
from minio_tpu.bucket import BucketMetadataSys as JaxBucketMetadataSys
from minio_tpu.crypto import SSEConfig as JaxSSEConfig
from minio_tpu.crypto.kms import KMSError as JaxKMSError
from minio_tpu.crypto.kms import LocalKMS as JaxLocalKMS
from minio_tpu.iam import IAMSys as JaxIAMSys
from minio_tpu.object import erasure_objects as jax_eo
from minio_tpu.object.pools import ErasureServerPools as JaxPools
from minio_tpu.object.sets import ErasureSets as JaxErasureSets
from minio_tpu.server import Server as JaxServer
from minio_tpu.storage.local import LocalStorage as JaxLocalStorage
from minio_tpu_torch.api.client import S3Client
from minio_tpu_torch.api.server import S3Server
from minio_tpu_torch.bucket.metadata import BucketMetadataSys
from minio_tpu_torch.crypto import SSEConfig
from minio_tpu_torch.crypto.kms import KMSError, LocalKMS
from minio_tpu_torch.iam.store import IAMSys
from minio_tpu_torch.object import erasure_objects
from minio_tpu_torch.object.pools import ErasureServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.server import Server
from minio_tpu_torch.storage.local import LocalStorage
from tests.test_torch_s3_core import _alike, _tree

torch.set_num_threads(1)

PORT, JAX = "port", "jax"
PKGS = (JAX, PORT)
ACCESS, SECRET = "tpuadmin", "tpuadmin-secret-key"
DEPLOYMENT = "5ba52d31-4f2e-4d69-92f5-926a51824ee0"
SMALL_BLOCK = 12 * 1024
LOST = (0, 5, 12, 15)
SSEC_KEY = bytes(range(32))
SSEC_B64 = base64.b64encode(SSEC_KEY).decode()
SSEC_MD5 = base64.b64encode(hashlib.md5(SSEC_KEY).digest()).decode()
SSEC_HEADERS = {
    "x-amz-server-side-encryption-customer-algorithm": "AES256",
    "x-amz-server-side-encryption-customer-key": SSEC_B64,
    "x-amz-server-side-encryption-customer-key-md5": SSEC_MD5,
}
WRONG_KEY = bytes(range(1, 33))
WRONG_HEADERS = {
    "x-amz-server-side-encryption-customer-algorithm": "AES256",
    "x-amz-server-side-encryption-customer-key":
        base64.b64encode(WRONG_KEY).decode(),
    "x-amz-server-side-encryption-customer-key-md5":
        base64.b64encode(hashlib.md5(WRONG_KEY).digest()).decode(),
}
KMS_CONTEXT = base64.b64encode(json.dumps({"app": "tests"}).encode()).decode()


def _payload(name: str, size: int) -> bytes:
    seed = int.from_bytes(hashlib.sha256(name.encode()).digest()[:4], "big")
    return np.random.default_rng(seed).bytes(size)


@pytest.fixture
def env(monkeypatch):
    """Both packages at 12 KiB erasure blocks and a 1 KiB inline
    threshold (the port's plain HighwayHash is a Python loop), minio_tpu
    with dense-gf8 and no worker pool; SSE-C allowed over plain HTTP."""
    monkeypatch.setenv("MTPU_CODEC", "dense-gf8")
    monkeypatch.setenv("MTPU_WORKER_POOL", "0")
    monkeypatch.setenv("MTPU_INLINE_THRESHOLD", "1024")
    monkeypatch.setenv("MTPU_ALLOW_INSECURE_SSEC", "1")
    monkeypatch.setattr(jax_eo, "BLOCK_SIZE_V2", SMALL_BLOCK)
    monkeypatch.setattr(erasure_objects, "BLOCK_SIZE_V2", SMALL_BLOCK)
    return monkeypatch


def _s3server(pkg: str, root, drives: int = 4, parity=None):
    """An S3Server over `drives` fresh drive directories, one set, with
    SSEConfig("root-secret")."""
    if pkg == PORT:
        disks = [LocalStorage(str(root / f"d{i}"), endpoint=f"d{i}",
                              device="cpu") for i in range(drives)]
        sets = ErasureSets(disks, drives, deployment_id=DEPLOYMENT,
                           default_parity=parity, device="cpu")
        sets.init_format()
        ol = ErasureServerPools([sets], device="cpu")
        return S3Server(ol, IAMSys(ACCESS, SECRET), BucketMetadataSys(ol),
                        device="cpu",
                        sse_config=SSEConfig("root-secret",
                                             device="cpu")).start()
    disks = [JaxLocalStorage(str(root / f"d{i}"), endpoint=f"d{i}")
             for i in range(drives)]
    sets = JaxErasureSets(disks, drives, deployment_id=DEPLOYMENT,
                          default_parity=parity)
    sets.init_format()
    ol = JaxPools([sets])
    return JaxS3Server(ol, JaxIAMSys(ACCESS, SECRET),
                       JaxBucketMetadataSys(ol),
                       sse_config=JaxSSEConfig("root-secret")).start()


@pytest.fixture(params=PKGS)
def cl(env, tmp_path, request):
    """tests/test_streaming_transforms.py's `cl`: a 4-drive server of one
    package with bucket /tfm."""
    srv = _s3server(request.param, tmp_path)
    c = S3Client(srv.endpoint, ACCESS, SECRET)
    assert c.request("PUT", "/tfm")[0] == 200
    yield c
    srv.stop()


# --- tests/test_streaming_transforms.py, case for case -----------------

def test_sse_s3_roundtrip_and_range(cl):
    body = bytes(range(256)) * 800  # 204,800 B: four packages
    st, h, _ = cl.request("PUT", "/tfm/enc.bin", body=body,
                          headers={"x-amz-server-side-encryption": "AES256"})
    assert st == 200
    assert h.get("x-amz-server-side-encryption") == "AES256"
    st, h, got = cl.request("GET", "/tfm/enc.bin")
    assert st == 200 and got == body
    assert h["Content-Length"] == str(len(body))
    st, h, got = cl.request("GET", "/tfm/enc.bin",
                            headers={"Range": "bytes=65530-131100"})
    assert st == 206 and got == body[65530:131101]
    st, h, _ = cl.request("HEAD", "/tfm/enc.bin")
    assert h["Content-Length"] == str(len(body))


def test_sse_c_requires_matching_key(cl):
    body = b"customer keyed" * 9999
    st, _, _ = cl.request("PUT", "/tfm/ssec.bin", body=body,
                          headers=SSEC_HEADERS)
    assert st == 200
    st, _, _ = cl.request("GET", "/tfm/ssec.bin")
    assert st == 400
    st, _, _ = cl.request("GET", "/tfm/ssec.bin", headers=WRONG_HEADERS)
    assert st == 403
    st, _, got = cl.request("GET", "/tfm/ssec.bin", headers=SSEC_HEADERS)
    assert st == 200 and got == body


def test_bad_digest_on_sse_put_leaves_nothing(cl):
    body = b"digested" * 1000
    wrong = base64.b64encode(hashlib.md5(b"other").digest()).decode()
    st, _, resp = cl.request(
        "PUT", "/tfm/dig.bin", body=body,
        headers={"x-amz-server-side-encryption": "AES256",
                 "Content-MD5": wrong})
    assert st == 400 and b"BadDigest" in resp
    assert cl.request("GET", "/tfm/dig.bin")[0] == 404


def test_exact_package_multiple_sse_put(cl):
    body = b"\xab" * (2 * 65536)
    right = base64.b64encode(hashlib.md5(body).digest()).decode()
    st, _, _ = cl.request(
        "PUT", "/tfm/exact.bin", body=body,
        headers={"x-amz-server-side-encryption": "AES256",
                 "Content-MD5": right})
    assert st == 200
    st, h, got = cl.request("GET", "/tfm/exact.bin")
    assert st == 200 and got == body
    assert h["Content-Length"] == str(len(body))
    wrong = base64.b64encode(hashlib.md5(b"nope").digest()).decode()
    st, _, resp = cl.request(
        "PUT", "/tfm/exact2.bin", body=body,
        headers={"x-amz-server-side-encryption": "AES256",
                 "Content-MD5": wrong})
    assert st == 400 and b"BadDigest" in resp
    assert cl.request("GET", "/tfm/exact2.bin")[0] == 404


def test_empty_object_is_one_package(cl):
    st, _, _ = cl.request("PUT", "/tfm/empty", body=b"",
                          headers={"x-amz-server-side-encryption": "AES256"})
    assert st == 200
    st, h, got = cl.request("GET", "/tfm/empty")
    assert st == 200 and got == b"" and h["Content-Length"] == "0"


def test_copy_encrypted_object_reencrypts(cl):
    body = b"copy me encrypted" * 5000
    st, _, _ = cl.request("PUT", "/tfm/src.bin", body=body,
                          headers={"x-amz-server-side-encryption": "AES256"})
    assert st == 200
    st, _, resp = cl.request(
        "PUT", "/tfm/dst.bin",
        headers={"x-amz-copy-source": "/tfm/src.bin",
                 "x-amz-server-side-encryption": "AES256"})
    assert st == 200, resp
    st, _, got = cl.request("GET", "/tfm/dst.bin")
    assert st == 200 and got == body


def test_copy_plain_to_encrypted_dest(cl):
    body = b"plain source" * 5000
    assert cl.request("PUT", "/tfm/plainsrc", body=body)[0] == 200
    st, _, _ = cl.request(
        "PUT", "/tfm/encdst",
        headers={"x-amz-copy-source": "/tfm/plainsrc",
                 "x-amz-server-side-encryption": "AES256"})
    assert st == 200
    st, h, got = cl.request("GET", "/tfm/encdst")
    assert st == 200 and got == body
    assert h.get("x-amz-server-side-encryption") == "AES256"


def test_copy_ssec_source_with_copy_headers(cl):
    body = b"ssec copy source" * 3000
    assert cl.request("PUT", "/tfm/csrc", body=body,
                      headers=SSEC_HEADERS)[0] == 200
    copy_headers = {
        "x-amz-copy-source": "/tfm/csrc",
        "x-amz-copy-source-server-side-encryption-customer-algorithm":
            "AES256",
        "x-amz-copy-source-server-side-encryption-customer-key": SSEC_B64,
        "x-amz-copy-source-server-side-encryption-customer-key-md5":
            SSEC_MD5,
    }
    st, _, resp = cl.request("PUT", "/tfm/cdst", headers=copy_headers)
    assert st == 200, resp
    st, _, got = cl.request("GET", "/tfm/cdst")
    assert st == 200 and got == body


# --- tests/test_kms.py, case for case ----------------------------------

def _kms(pkg):
    return (JaxLocalKMS("master-secret") if pkg == JAX
            else LocalKMS("master-secret", device="cpu"))


KMS_ERRORS = {JAX: JaxKMSError, PORT: KMSError}


@pytest.mark.parametrize("pkg", PKGS)
def test_data_key_roundtrip(pkg):
    kms = _kms(pkg)
    pk, sealed = kms.generate_data_key(context={"bucket": "b"})
    assert len(pk) == 32
    assert kms.decrypt_data_key("", sealed, {"bucket": "b"}) == pk


@pytest.mark.parametrize("pkg", PKGS)
def test_context_binding(pkg):
    kms = _kms(pkg)
    pk, sealed = kms.generate_data_key(context={"bucket": "b"})
    with pytest.raises(KMS_ERRORS[pkg]):
        kms.decrypt_data_key("", sealed, {"bucket": "EVIL"})
    with pytest.raises(KMS_ERRORS[pkg]):
        kms.decrypt_data_key("", sealed, None)


@pytest.mark.parametrize("pkg", PKGS)
def test_named_keys_isolated(pkg):
    kms = _kms(pkg)
    kms.create_key("tenant-a")
    pk, sealed = kms.generate_data_key("tenant-a")
    with pytest.raises(KMS_ERRORS[pkg]):
        kms.decrypt_data_key(kms.default_key_id, sealed)
    assert kms.decrypt_data_key("tenant-a", sealed) == pk
    with pytest.raises(KMS_ERRORS[pkg]):
        kms.generate_data_key("never-created")
    with pytest.raises(KMS_ERRORS[pkg]):
        kms.create_key("tenant-a")


@pytest.mark.parametrize("pkg", PKGS)
def test_status_probe(pkg):
    kms = _kms(pkg)
    kms.create_key("extra")
    st = kms.status()
    assert st["backend"] == "local"
    assert {k["keyName"] for k in st["keys"]} == {"mtpu-default-key",
                                                   "extra"}
    assert all(k["healthy"] for k in st["keys"])


def test_data_keys_cross_packages():
    """A data key either package sealed unseals in the other."""
    jax, port = _kms(JAX), _kms(PORT)
    for a, b in ((jax, port), (port, jax)):
        pk, sealed = a.generate_data_key(context={"bucket": "x"})
        assert b.decrypt_data_key("", sealed, {"bucket": "x"}) == pk


def _server(pkg: str, root):
    """tests/test_kms.py's Server: 4 drives, one root credential. The
    port's runs its S3 plane alone: these cases need none of its
    background services."""
    if pkg == JAX:
        return JaxServer([str(root / "disk{1...4}")], port=0,
                         root_user="kmsak", root_password="kmssecret",
                         enable_scanner=False).start()
    srv = Server([str(root / "disk{1...4}")], port=0, root_user="kmsak",
                 root_password="kmssecret", device="cpu")
    srv.s3.start()
    return srv


@pytest.fixture(params=PKGS)
def server(env, tmp_path, request):
    srv = _server(request.param, tmp_path)
    c = S3Client(srv.endpoint, "kmsak", "kmssecret")
    yield c.request
    srv.stop()


def test_sse_kms_put_get_roundtrip(server):
    req = server
    assert req("PUT", "/kmsbkt")[0] == 200
    body = b"kms-protected-data" * 500
    st, h, _ = req("PUT", "/kmsbkt/secret.bin", body=body, headers={
        "x-amz-server-side-encryption": "aws:kms",
        "x-amz-server-side-encryption-context": KMS_CONTEXT})
    assert st == 200, h
    assert h.get("x-amz-server-side-encryption") == "aws:kms"
    assert h.get("x-amz-server-side-encryption-aws-kms-key-id")
    st, h, got = req("GET", "/kmsbkt/secret.bin")
    assert st == 200 and got == body
    assert h.get("x-amz-server-side-encryption") == "aws:kms"
    st, h, _ = req("HEAD", "/kmsbkt/secret.bin")
    assert st == 200
    assert h.get("x-amz-server-side-encryption") == "aws:kms"


def test_sse_kms_named_key(server):
    req = server
    assert req("PUT", "/kmsbkt")[0] == 200
    st, _, raw = req("POST", "/minio/admin/v3/kms/key/create",
                     [("key-id", "bucket-key")])
    assert st == 200, raw
    body = b"named-key-data"
    st, h, _ = req("PUT", "/kmsbkt/named.bin", body=body, headers={
        "x-amz-server-side-encryption": "aws:kms",
        "x-amz-server-side-encryption-aws-kms-key-id": "bucket-key"})
    assert st == 200
    assert h.get("x-amz-server-side-encryption-aws-kms-key-id") == \
        "bucket-key"
    st, _, got = req("GET", "/kmsbkt/named.bin")
    assert st == 200 and got == body
    st, _, _ = req("PUT", "/kmsbkt/bad.bin", body=b"x", headers={
        "x-amz-server-side-encryption": "aws:kms",
        "x-amz-server-side-encryption-aws-kms-key-id": "ghost"})
    assert st == 400


def test_admin_kms_endpoints(server):
    req = server
    st, _, raw = req("GET", "/minio/admin/v3/kms/key/status")
    assert st == 200
    assert all(k["healthy"] for k in json.loads(raw)["keys"])
    st, _, raw = req("GET", "/minio/admin/v3/kms/key/list")
    assert st == 200
    assert "mtpu-default-key" in {k["name"] for k in json.loads(raw)["keys"]}
    st, _, _ = req("GET", "/minio/admin/v3/kms/key/status",
                   [("key-id", "no-such-key")])
    assert st == 404


@pytest.mark.parametrize("pkg", PKGS)
def test_kms_keys_survive_restart(env, tmp_path, pkg):
    srv = _server(pkg, tmp_path)
    try:
        c = S3Client(srv.endpoint, "kmsak", "kmssecret")
        assert c.request("PUT", "/persistkms")[0] == 200
        st, _, raw = c.request("POST", "/minio/admin/v3/kms/key/create",
                               [("key-id", "durable-key")])
        assert st == 200, raw
        st, _, _ = c.request("PUT", "/persistkms/obj", body=b"keep me safe",
                             headers={
                                 "x-amz-server-side-encryption": "aws:kms",
                                 "x-amz-server-side-encryption-aws-kms-"
                                 "key-id": "durable-key"})
        assert st == 200
    finally:
        srv.stop()
    srv = _server(pkg, tmp_path)
    try:
        c = S3Client(srv.endpoint, "kmsak", "kmssecret")
        st, _, got = c.request("GET", "/persistkms/obj")
        assert st == 200 and got == b"keep me safe"
        st, _, raw = c.request("GET", "/minio/admin/v3/kms/key/list")
        assert "durable-key" in {k["name"] for k in json.loads(raw)["keys"]}
    finally:
        srv.stop()


# --- each package reads the other's objects ----------------------------

CROSS = {
    "s3.bin": ({"x-amz-server-side-encryption": "AES256"}, {}, 150_001),
    "c.bin": (SSEC_HEADERS, SSEC_HEADERS, 70_000),
    "kms.bin": ({"x-amz-server-side-encryption": "aws:kms",
                 "x-amz-server-side-encryption-context": KMS_CONTEXT},
                {}, 65_536),
    "kms-named.bin": ({"x-amz-server-side-encryption": "aws:kms",
                       "x-amz-server-side-encryption-aws-kms-key-id":
                           "cross-key"}, {}, 1_000),
}


@pytest.mark.parametrize("writer,reader", ((JAX, PORT), (PORT, JAX)))
def test_each_package_reads_the_others_objects(env, tmp_path, writer,
                                               reader):
    srv = _server(writer, tmp_path)
    try:
        c = S3Client(srv.endpoint, "kmsak", "kmssecret")
        assert c.request("PUT", "/cross")[0] == 200
        assert c.request("POST", "/minio/admin/v3/kms/key/create",
                         [("key-id", "cross-key")])[0] == 200
        for name, (put_h, _, size) in CROSS.items():
            st, _, _ = c.request("PUT", f"/cross/{name}", headers=put_h,
                                 body=_payload(name, size))
            assert st == 200
    finally:
        srv.stop()
    srv = _server(reader, tmp_path)
    try:
        c = S3Client(srv.endpoint, "kmsak", "kmssecret")
        for name, (put_h, get_h, size) in CROSS.items():
            st, h, got = c.request("GET", f"/cross/{name}", headers=get_h)
            assert st == 200 and got == _payload(name, size), name
            st, h, _ = c.request("HEAD", f"/cross/{name}", headers=get_h)
            assert h["Content-Length"] == str(size)
            want = {k.lower(): v for k, v in put_h.items()
                    if k.endswith(("-encryption", "-algorithm",
                                   "-key-md5", "-key-id"))}
            got_h = {k.lower(): v for k, v in h.items()}
            assert all(got_h.get(k) == v for k, v in want.items()), name
        rng = "bytes=65530-70100"
        st, _, got = c.request("GET", "/cross/s3.bin",
                               headers={"Range": rng})
        assert st == 206 and got == _payload("s3.bin", 150_001)[65530:70101]
        st, _, _ = c.request("GET", "/cross/c.bin", headers=WRONG_HEADERS)
        assert st == 403
    finally:
        srv.stop()


# --- byte-identical drive files under a seeded os.urandom --------------

SEEDED = (
    ("s3.bin", {"x-amz-server-side-encryption": "AES256"}, {}, 200_001),
    ("c.bin", SSEC_HEADERS, SSEC_HEADERS, 70_000),
    ("kms.bin", {"x-amz-server-side-encryption": "aws:kms",
                 "x-amz-server-side-encryption-context": KMS_CONTEXT},
     {}, 2 * 65_536),
    ("empty.bin", {"x-amz-server-side-encryption": "AES256"}, {}, 0),
)


def _seeded_run(pkg: str, root, mp) -> dict:
    """The 16-drive 12+4 server of `pkg` under a seeded os.urandom: the
    encrypted PUTs and GETs, the files written, then every object lost
    on drives 0, 5, 12 and 15, degraded GETs, heals, the files after."""
    clock = _alike(mp)
    rng = random.Random(2024)
    mp.setattr(os, "urandom", rng.randbytes)
    srv = _s3server(pkg, root, drives=16, parity=4)
    out = {"responses": []}
    try:
        c = S3Client(srv.endpoint, ACCESS, SECRET)

        def rec(*args, **kw):
            clock.now += 10 ** 9
            st, h, body = c.request(*args, **kw)
            lower = {k.lower(): v for k, v in h.items()}
            out["responses"].append((st, body, {
                k: v for k, v in lower.items()
                if k.startswith("x-amz-server-side") or k in (
                    "etag", "content-length")}))

        rec("PUT", "/enc")
        for name, put_h, get_h, size in SEEDED:
            rec("PUT", f"/enc/{name}", headers=put_h,
                body=_payload(name, size))
            rec("GET", f"/enc/{name}", headers=get_h)
        out["written"] = _tree(root)
        for i in LOST:
            for name, *_ in SEEDED:
                shutil.rmtree(root / f"d{i}" / "enc" / name,
                              ignore_errors=True)
        out["degraded"] = [c.request("GET", f"/enc/{name}", headers=get_h)[2]
                           == _payload(name, size)
                           for name, _, get_h, size in SEEDED]
        ol = srv.handlers.ol
        out["heals"] = [len(ol.heal_object("enc", name)["healed"])
                        for name, *_ in SEEDED]
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
    assert all(st == 200 for st, _, _ in port["responses"])
    assert port["written"].keys() == jax["written"].keys()
    differ = [k for k in jax["written"] if port["written"][k] !=
              jax["written"][k]]
    assert not differ
    assert port["degraded"] == jax["degraded"] == [True] * len(SEEDED)
    assert port["heals"] == jax["heals"]
    for run in runs.values():
        assert run["after"] == run["written"]  # the heals rebuilt them


# --- the SSE-C guard and the bucket's ?encryption ---------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_ssec_over_plain_http_needs_the_opt_out(env, tmp_path, pkg):
    env.delenv("MTPU_ALLOW_INSECURE_SSEC")
    srv = _s3server(pkg, tmp_path)
    try:
        c = S3Client(srv.endpoint, ACCESS, SECRET)
        assert c.request("PUT", "/tls")[0] == 200
        st, _, body = c.request("PUT", "/tls/o", headers=SSEC_HEADERS,
                                body=b"x")
        assert st == 400 and b"InsecureSSECustomerRequest" in body
        st, _, body = c.request("PUT", "/tls/o2", headers={
            "x-amz-copy-source": "/tls/o",
            "x-amz-copy-source-server-side-encryption-customer-algorithm":
                "AES256"})
        assert st == 400 and b"InsecureSSECustomerRequest" in body
        assert c.request("PUT", "/tls/s3", body=b"y", headers={
            "x-amz-server-side-encryption": "AES256"})[0] == 200
        env.setenv("MTPU_ALLOW_INSECURE_SSEC", "1")
        assert c.request("PUT", "/tls/o", headers=SSEC_HEADERS,
                         body=b"x")[0] == 200
    finally:
        srv.stop()


ENCRYPTION_XML = (
    b'<ServerSideEncryptionConfiguration xmlns="http://s3.amazonaws.com/'
    b'doc/2006-03-01/"><Rule><ApplyServerSideEncryptionByDefault>'
    b"<SSEAlgorithm>AES256</SSEAlgorithm>"
    b"</ApplyServerSideEncryptionByDefault></Rule>"
    b"</ServerSideEncryptionConfiguration>")


def test_bucket_encryption_document(env, tmp_path):
    """?encryption PUT, GET and DELETE answer alike; the document applies
    to no PUT on either package."""
    records = {}
    for pkg in PKGS:
        srv = _s3server(pkg, tmp_path / pkg)
        try:
            c = S3Client(srv.endpoint, ACCESS, SECRET)
            q = [("encryption", "")]
            rs = [c.request("PUT", "/bkt"),
                  c.request("GET", "/bkt", q),
                  c.request("PUT", "/bkt", q, body=b"<Bad"),
                  c.request("PUT", "/bkt", q, body=ENCRYPTION_XML),
                  c.request("GET", "/bkt", q),
                  c.request("PUT", "/bkt/o", body=b"plain"),
                  c.request("HEAD", "/bkt/o"),
                  c.request("GET", "/bkt/o"),
                  c.request("DELETE", "/bkt", q),
                  c.request("GET", "/bkt", q)]
        finally:
            srv.stop()
        records[pkg] = [(st, {k.lower(): v for k, v in h.items()
                              if k.lower().startswith("x-amz-server-side")},
                         body if st < 400 else body.split(b"<Message>")[0])
                        for st, h, body in rs]
    assert records[PORT] == records[JAX]
    assert [r[0] for r in records[PORT]] == [200, 404, 400, 200, 200, 200,
                                             200, 200, 204, 404]
    assert records[PORT][4][2] == ENCRYPTION_XML
    assert records[PORT][6][1] == {}  # the PUT was not encrypted


# --- minio_tpu's faults, refused by the port ---------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_encrypted_multipart_upload(env, tmp_path, pkg):
    """minio_tpu's fault, refused by the port: a multipart upload that
    asks for SSE-S3 is stored in plaintext (NewMultipartUpload ignores
    the header). The port answers NotImplemented."""
    srv = _s3server(pkg, tmp_path)
    try:
        c = S3Client(srv.endpoint, ACCESS, SECRET)
        assert c.request("PUT", "/mpu")[0] == 200
        st, _, body = c.request("POST", "/mpu/o", [("uploads", "")],
                                headers={"x-amz-server-side-encryption":
                                         "AES256"})
        if pkg == PORT:
            assert st == 501 and b"NotImplemented" in body
            return
        assert st == 200
        upload = body.split(b"<UploadId>")[1].split(b"</UploadId>")[0]
        part = _payload("mpu", 20_000)
        st, h, _ = c.request("PUT", "/mpu/o", [("partNumber", "1"),
                                               ("uploadId", upload.decode())],
                             body=part)
        assert st == 200
        done = (f"<CompleteMultipartUpload><Part><PartNumber>1</PartNumber>"
                f"<ETag>{h['ETag']}</ETag></Part>"
                "</CompleteMultipartUpload>").encode()
        assert c.request("POST", "/mpu/o", [("uploadId", upload.decode())],
                         body=done)[0] == 200
        st, h, got = c.request("GET", "/mpu/o")
        assert st == 200 and got == part
        assert "x-amz-server-side-encryption" not in {k.lower() for k in h}
    finally:
        srv.stop()


@pytest.mark.parametrize("pkg", PKGS)
def test_upload_part_copy_from_encrypted_source(env, tmp_path, pkg):
    """minio_tpu's fault, refused by the port: UploadPartCopy from an
    SSE-S3 source copies the stored ciphertext into the part. The port
    answers NotImplemented."""
    srv = _s3server(pkg, tmp_path)
    try:
        c = S3Client(srv.endpoint, ACCESS, SECRET)
        assert c.request("PUT", "/upc")[0] == 200
        src = _payload("upc-src", 30_000)
        assert c.request("PUT", "/upc/src", body=src, headers={
            "x-amz-server-side-encryption": "AES256"})[0] == 200
        st, _, body = c.request("POST", "/upc/dst", [("uploads", "")])
        upload = body.split(b"<UploadId>")[1].split(b"</UploadId>")[0]
        q = [("partNumber", "1"), ("uploadId", upload.decode())]
        st, _, body = c.request("PUT", "/upc/dst", q,
                                headers={"x-amz-copy-source": "/upc/src"})
        if pkg == PORT:
            assert st == 501 and b"NotImplemented" in body
            return
        assert st == 200
        etag = body.split(b"<ETag>")[1].split(b"</ETag>")[0].decode()
        done = (f"<CompleteMultipartUpload><Part><PartNumber>1</PartNumber>"
                f"<ETag>{etag}</ETag></Part>"
                "</CompleteMultipartUpload>").encode()
        assert c.request("POST", "/upc/dst", [("uploadId", upload.decode())],
                         body=done)[0] == 200
        st, _, got = c.request("GET", "/upc/dst")
        assert st == 200 and got != src and len(got) == 30_000 + 28
    finally:
        srv.stop()


# --- the streaming transforms themselves --------------------------------

class _Sink:
    def __init__(self):
        self.data = bytearray()

    def write(self, b):
        self.data += b
        return len(b)


def _read_all(reader, n=1 << 20) -> bytes:
    out = bytearray()
    while chunk := reader.read(n):
        out += chunk
    return bytes(out)


@pytest.mark.parametrize("batch", (1, 3, 16))
@pytest.mark.parametrize("size", (0, 1, 65_536, 131_072, 196_613))
def test_encrypt_reader_equals_minio_tpus(monkeypatch, size, batch):
    """Under one seeded os.urandom, the port's EncryptReader gives
    minio_tpu's bytes at any batch depth: no trailing package after an
    exact multiple of 64 KiB, one of 0 B for an empty object."""
    import io

    from minio_tpu.api import transforms as jax_tfm
    from minio_tpu_torch.api import transforms as tfm

    monkeypatch.setattr(tfm, "packages_per_launch", lambda device: batch)
    key, body = bytes(range(32)), _payload("enc", size)
    out = {}
    for pkg in PKGS:
        rng = random.Random(7)
        monkeypatch.setattr(os, "urandom", rng.randbytes)
        meta = {}
        if pkg == JAX:
            reader = jax_tfm.EncryptReader(io.BytesIO(body), key, meta)
        else:
            reader = tfm.EncryptReader(io.BytesIO(body), key, meta,
                                       device="cpu")
        out[pkg] = (_read_all(reader, 100_000), meta)
    assert out[PORT] == out[JAX]
    assert len(out[PORT][0]) == max(1, -(-size // 65_536)) * 28 + size


@pytest.mark.parametrize("bad", (0, 2))
def test_decrypt_writer_stops_at_a_bad_package(bad):
    """A package whose tag fails: both packages write the plaintext of
    the packages before it, then answer AccessDenied naming it."""
    import io

    from minio_tpu.api import transforms as jax_tfm
    from minio_tpu.api.errors import S3Error as JaxS3Error
    from minio_tpu_torch.api import transforms as tfm
    from minio_tpu_torch.api.errors import S3Error

    key, body = bytes(range(32)), _payload("dec", 4 * 65_536 + 100)
    wire = bytearray(_read_all(jax_tfm.EncryptReader(io.BytesIO(body), key,
                                                     {})))
    wire[bad * (65_536 + 28) + 40] ^= 1
    got = {}
    for pkg, writer, err in (
            (JAX, lambda d: jax_tfm.DecryptWriter(d, key), JaxS3Error),
            (PORT, lambda d: tfm.DecryptWriter(d, key, device="cpu"),
             S3Error)):
        sink = _Sink()
        w = writer(sink)
        with pytest.raises(err) as exc:
            for i in range(0, len(wire), 50_000):
                w.write(bytes(wire[i:i + 50_000]))
            w.close()
        got[pkg] = (bytes(sink.data), exc.value.api.code, str(exc.value))
    assert got[PORT] == got[JAX]
    assert got[PORT][0] == body[:bad * 65_536]
    assert got[PORT][1:] == ("AccessDenied", f"SSE package {bad} auth failure")


def test_decrypt_writer_truncated_stream():
    """A stored stream cut inside the last package's nonce: both write
    the whole packages, then answer InvalidRequest."""
    import io

    from minio_tpu.api import transforms as jax_tfm
    from minio_tpu.api.errors import S3Error as JaxS3Error
    from minio_tpu_torch.api import transforms as tfm
    from minio_tpu_torch.api.errors import S3Error

    key, body = bytes(range(32)), _payload("trunc", 2 * 65_536 + 100)
    wire = _read_all(jax_tfm.EncryptReader(io.BytesIO(body), key, {}))
    wire = wire[:2 * (65_536 + 28) + 20]
    got = {}
    for pkg, w, err in ((JAX, jax_tfm.DecryptWriter, JaxS3Error),
                        (PORT, tfm.DecryptWriter, S3Error)):
        sink = _Sink()
        writer = w(sink, key) if pkg == JAX else w(sink, key, device="cpu")
        writer.write(wire)
        with pytest.raises(err) as exc:
            writer.close()
        got[pkg] = (bytes(sink.data), exc.value.api.code)
    assert got[PORT] == got[JAX] == (body[:2 * 65_536], "InvalidRequest")
