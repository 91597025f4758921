"""Remote tiers on the port against minio_tpu, over HTTP on localhost, on
the CPU: a hot server tiered to a cold server (4 drives each, one set),
in each package.

Each case is one request sequence that runs on both packages: the hot
server's answers (status, every header but Date and the request id, the
body, an error's Code, Message and Resource) are recorded, and the hot
and cold drive trees are taken where the case says (after a transition,
a restore, an expiry) and at its end. Ids, clocks and os.urandom are
made alike on both sides (tests/test_torch_s3_core.py's `_alike`, with
the tier modules' and the scanners' clocks too), so every file compares
whole.

- The five cases of tests/test_tiering.py, a compressed and a
  compressed-then-SSE object, a tier that is down and a write that races
  the transition: equal answers and trees.
- A drive set tiered by minio_tpu served by the port (GET through the
  tier, then a restore).
- Where the port differs from minio_tpu on purpose (ROADMAP.md Queue 3),
  each side's own answer: a heal of a tiered version, the ETag after a
  restore, a copy from a tiered source and the restored copy's expiry at
  the scanner's clock. A DELETE that leaves the remote blob and the
  secret key kept in clear are copied, and held on both.
"""

import io
import json
import os
import random
import re
import socket
import sys
import time

import pytest
import torch

from minio_tpu import tier as jax_tier
from minio_tpu.api import S3Server as JaxS3Server
from minio_tpu.background import scanner as jax_scanner_mod
from minio_tpu.background.scanner import DataScanner as JaxDataScanner
from minio_tpu.bucket import BucketMetadataSys as JaxBucketMetadataSys
from minio_tpu.config.config import ConfigSys as JaxConfigSys
from minio_tpu.crypto import SSEConfig as JaxSSEConfig
from minio_tpu.iam import IAMSys as JaxIAMSys
from minio_tpu.object.pools import ErasureServerPools as JaxPools
from minio_tpu.object.sets import ErasureSets as JaxErasureSets
from minio_tpu.storage.local import LocalStorage as JaxLocalStorage
from minio_tpu_torch import tier
from minio_tpu_torch.api import transforms as tfm
from minio_tpu_torch.api.client import S3Client
from minio_tpu_torch.api.server import S3Server
from minio_tpu_torch.background import scanner as scanner_mod
from minio_tpu_torch.background.scanner import DataScanner
from minio_tpu_torch.bucket.metadata import BucketMetadataSys
from minio_tpu_torch.config.config import ConfigSys
from minio_tpu_torch.crypto import SSEConfig
from minio_tpu_torch.iam.store import IAMSys
from minio_tpu_torch.object.pools import ErasureServerPools
from minio_tpu_torch.object.sets import ErasureSets
from minio_tpu_torch.storage.local import LocalStorage
from tests.test_torch_compression import COMPRESS_KV, _text
from tests.test_torch_compression import env  # noqa: F401 - fixture
from tests.test_torch_s3_core import _alike, _Shim, _tree

torch.set_num_threads(1)

PORT, JAX = "port", "jax"
ACCESS, SECRET = "tpuadmin", "tpuadmin-secret-key"
HOT_ID = "aaaaaaaa-aaaa-4aaa-8aaa-aaaaaaaaaaaa"
COLD_ID = "bbbbbbbb-bbbb-4bbb-8bbb-bbbbbbbbbbbb"
# The clock of both sides, a whole second near the real time, set again
# for each test: a restored copy's expiry lies a day ahead of it.
T_NOW = time.time_ns() // 10 ** 9 * 10 ** 9
UNRECORDED = ("date", "x-amz-request-id")
ADMIN = "/minio/admin/v3"
SSE = {"x-amz-server-side-encryption": "AES256"}
TRANSITION_LC = (b"<LifecycleConfiguration><Rule><ID>cold</ID>"
                 b"<Status>Enabled</Status><Filter><Prefix>old/</Prefix>"
                 b"</Filter><Transition><Days>30</Days>"
                 b"<StorageClass>COLD</StorageClass></Transition></Rule>"
                 b"</LifecycleConfiguration>")
DATE_LC = ('<LifecycleConfiguration><Rule><Status>Enabled</Status>'
           '<Filter><Prefix></Prefix></Filter>'
           '<Transition><Date>2020-01-01T00:00:00Z</Date>'
           '<StorageClass>COLD</StorageClass>'
           '</Transition></Rule></LifecycleConfiguration>')


@pytest.fixture(autouse=True)
def _now(monkeypatch):
    monkeypatch.setattr(sys.modules[__name__], "T_NOW",
                        time.time_ns() // 10 ** 9 * 10 ** 9)


def _record(resp) -> dict:
    status, headers, body = resp
    out = {"status": status,
           "headers": {k.lower(): v for k, v in headers.items()
                       if k.lower() not in UNRECORDED}}
    if status >= 400 and body.startswith(b"<?xml"):
        out["error"] = {t: re.search(rf"<{t}>(.*?)</{t}>".encode(),
                                     body).group(1)
                        for t in ("Code", "Message", "Resource")}
    else:
        out["body"] = body
    return out


class Cluster:
    """One package's S3Server over 4 fresh (or existing) drives, with a
    ConfigSys compressing .txt and .log, an SSEConfig, and, when `tiered`,
    a TierConfigMgr and TierEngine."""

    def __init__(self, pkg: str, root, deployment: str, tiered: bool,
                 fresh: bool = True, port: int = 0):
        self.pkg, self.root = pkg, root
        if pkg == PORT:
            disks = [LocalStorage(str(root / f"d{i}"), endpoint=f"d{i}",
                                  device="cpu") for i in range(4)]
            sets = ErasureSets(disks, 4, deployment_id=deployment,
                               device="cpu")
        else:
            disks = [JaxLocalStorage(str(root / f"d{i}"), endpoint=f"d{i}")
                     for i in range(4)]
            sets = JaxErasureSets(disks, 4, deployment_id=deployment)
        sets.init_format() if fresh else sets.load_format()
        mod = tier if pkg == PORT else jax_tier
        if pkg == PORT:
            self.ol = ErasureServerPools([sets], device="cpu")
            cs = ConfigSys(self.ol, secret=SECRET)
            self.bm = BucketMetadataSys(self.ol)
        else:
            self.ol = JaxPools([sets])
            cs = JaxConfigSys(self.ol, secret=SECRET)
            self.bm = JaxBucketMetadataSys(self.ol)
        for target, values in COMPRESS_KV.items():
            cs.config.set_kv(target, **values)
        self.tiers = mod.TierConfigMgr(self.ol) if tiered else None
        self.engine = (mod.TierEngine(self.ol, self.tiers) if tiered
                       else None)
        if pkg == PORT:
            self.srv = S3Server(
                self.ol, IAMSys(ACCESS, SECRET), self.bm, device="cpu",
                port=port, config_sys=cs,
                sse_config=SSEConfig("root-secret", device="cpu"),
                tier_engine=self.engine, tiers=self.tiers)
        else:
            self.srv = JaxS3Server(
                self.ol, JaxIAMSys(ACCESS, SECRET), self.bm, port=port,
                config_sys=cs, sse_config=JaxSSEConfig("root-secret"),
                tier_engine=self.engine, tiers=self.tiers)
        self.srv.start()

    @property
    def endpoint(self) -> str:
        return self.srv.endpoint

    def scanner(self):
        cls = DataScanner if self.pkg == PORT else JaxDataScanner
        return cls(self.ol, bucket_meta=self.bm, tier_engine=self.engine)

    def stop(self) -> None:
        self.srv.stop()


class Run:
    """A case's view of one package: the hot and cold clusters, the
    recorded client of the hot one, and tree snapshots."""

    def __init__(self, pkg, root, mp, cold_port: int):
        self.pkg, self.root, self.mp = pkg, root, mp
        self.cold_port = cold_port
        self.clock = _alike(mp)
        self.clock.now = T_NOW
        shim = _Shim(time, time=lambda: self.clock.now / 1e9,
                     time_ns=self.clock.time_ns)
        for mod in (tier, jax_tier, scanner_mod, jax_scanner_mod):
            mp.setattr(mod, "time", shim)
        mp.setattr(os, "urandom", random.Random(2026).randbytes)
        self.tier = tier if pkg == PORT else jax_tier
        self.log: list = []
        self.trees: dict = {}
        self.cold = Cluster(pkg, root / "cold", COLD_ID, tiered=False,
                            port=cold_port)
        self.cold.ol.make_bucket("coldstore")
        self.hot = Cluster(pkg, root / "hot", HOT_ID, tiered=True)
        self.add_tier()

    def add_tier(self) -> None:
        self.hot.tiers.add("COLD", self.cold.endpoint, ACCESS, SECRET,
                           "coldstore", prefix="tiered")

    def rec(self, *args, **kw):
        self.clock.now += 10 ** 9
        resp = S3Client(self.hot.endpoint, ACCESS, SECRET).request(*args,
                                                                   **kw)
        self.log.append(_record(resp))
        return resp

    def tick(self) -> None:
        self.clock.now += 10 ** 9

    def snap(self, label: str) -> None:
        self.trees[label] = (_tree(self.root / "hot"),
                             _tree(self.root / "cold"))

    def remote_keys(self) -> list[str]:
        return [o.name for o in
                self.cold.ol.list_objects("coldstore").objects]

    def info(self, bucket: str, name: str):
        return self.hot.ol.get_object_info(bucket, name)

    def stop(self) -> None:
        self.hot.stop()
        self.cold.stop()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run(pkg, root, mp, case, cold_port: int) -> Run:
    run = Run(pkg, root, mp, cold_port)
    try:
        case(run)
        run.snap("end")
    finally:
        run.stop()
    return run


def _both(tmp_path, case) -> dict:
    """The case on each package. Both cold servers listen on one port,
    which the hot servers' tiers.json names."""
    runs, cold_port = {}, _free_port()
    for pkg in (JAX, PORT):
        with pytest.MonkeyPatch.context() as mp:
            runs[pkg] = _run(pkg, tmp_path / pkg, mp, case, cold_port)
    return runs


def _assert_alike(runs, trees=None) -> None:
    jax, port = runs[JAX], runs[PORT]
    assert port.log == jax.log
    assert port.trees.keys() == jax.trees.keys()
    for label in trees or jax.trees:
        for side, (j, p) in zip(("hot", "cold"),
                                zip(jax.trees[label], port.trees[label])):
            assert p.keys() == j.keys(), (label, side)
            assert [k for k in j if p[k] != j[k]] == [], (label, side)


# --- the cases of tests/test_tiering.py ----------------------------------

def case_transition_and_transparent_get(run):
    assert run.rec("PUT", "/data")[0] == 200
    body = b"cold data " * 5000
    assert run.rec("PUT", "/data/archive.bin", body=body)[0] == 200
    run.tick()
    run.hot.engine.transition("data", "archive.bin", "COLD")
    run.snap("transition")
    assert run.tier.is_transitioned(run.info("data",
                                             "archive.bin").user_defined)
    assert any(k.startswith("tiered/data/archive.bin/")
               for k in run.remote_keys())
    assert not [p for p in (run.root / "hot").rglob("part.*")
                if "archive.bin" in str(p)]
    st, h, got = run.rec("GET", "/data/archive.bin")
    assert st == 200 and got == body
    assert h.get("x-amz-storage-class") == "COLD"
    st, h, _ = run.rec("HEAD", "/data/archive.bin")
    assert h.get("x-amz-storage-class") == "COLD"
    st, _, got = run.rec("GET", "/data/archive.bin",
                         headers={"Range": "bytes=10-99"})
    assert st == 206 and got == body[10:100]


def case_transition_encrypted_object_keeps_keys_local(run):
    assert run.rec("PUT", "/data")[0] == 200
    body = b"secret cold data" * 2000
    assert run.rec("PUT", "/data/enc.bin", body=body, headers=SSE)[0] == 200
    run.tick()
    run.hot.engine.transition("data", "enc.bin", "COLD")
    run.snap("transition")
    key = next(k for k in run.remote_keys() if "/enc.bin/" in k)
    raw = run.cold.ol.get_object_bytes("coldstore", key)
    assert body[:64] not in raw
    st, _, got = run.rec("GET", "/data/enc.bin")
    assert st == 200 and got == body
    st, _, got = run.rec("GET", "/data/enc.bin",
                         headers={"Range": "bytes=5000-29999"})
    assert st == 206 and got == body[5000:30000]


def case_restore_and_expiry(run):
    assert run.rec("PUT", "/data")[0] == 200
    body = b"restore me" * 4000
    assert run.rec("PUT", "/data/r.bin", body=body)[0] == 200
    run.tick()
    run.hot.engine.transition("data", "r.bin", "COLD")
    run.snap("transition")
    st, _, resp = run.rec(
        "POST", "/data/r.bin", [("restore", "")],
        body=b"<RestoreRequest><Days>2</Days></RestoreRequest>")
    assert st == 202, resp
    run.snap("restore")
    info = run.info("data", "r.bin")
    assert 'ongoing-request="false"' in info.user_defined["x-amz-restore"]
    assert run.tier.is_restored(info.user_defined)
    st, h, got = run.rec("GET", "/data/r.bin")
    assert st == 200 and got == body and "x-amz-restore" in h
    run.tick()
    year = time.strftime("%Y", time.gmtime(run.clock.now / 1e9))
    run.hot.ol.update_object_metadata("data", "r.bin", "", {
        run.tier.META_RESTORE: run.tier.restore_header(days=1).replace(
            year, "2001", 1)})
    info = run.info("data", "r.bin")
    assert not run.tier.is_restored(info.user_defined)
    run.tick()
    assert run.hot.engine.expire_restored("data", "r.bin",
                                          info.user_defined)
    run.snap("expiry")
    assert run.tier.META_RESTORE not in run.info("data",
                                                 "r.bin").user_defined
    st, _, got = run.rec("GET", "/data/r.bin")
    assert st == 200 and got == body


def case_scanner_applies_transition_rule(run):
    run.hot.ol.make_bucket("auto")
    body = b"auto tier" * 1000
    run.tick()
    run.hot.ol.put_object("auto", "old.bin", io.BytesIO(body), len(body))
    run.hot.bm.update("auto", "lifecycle_xml", DATE_LC)
    run.tick()
    run.hot.scanner().scan_cycle()
    run.snap("transition")
    assert run.tier.is_transitioned(run.info("auto", "old.bin").user_defined)
    st, h, got = run.rec("GET", "/auto/old.bin")
    assert st == 200 and got == body and h["x-amz-storage-class"] == "COLD"


def case_admin_tier_endpoints(run):
    st, _, body = run.rec("GET", f"{ADMIN}/list-tiers")
    assert st == 200
    tiers = json.loads(body)
    assert "COLD" in tiers and "secret_key" not in tiers["COLD"]
    spec = {"name": "warm", "endpoint": run.cold.endpoint,
            "access_key": ACCESS, "secret_key": SECRET,
            "bucket": "coldstore", "prefix": "/w/"}
    assert run.rec("PUT", f"{ADMIN}/add-tier",
                   body=json.dumps(spec).encode())[0] == 200
    assert run.rec("PUT", f"{ADMIN}/add-tier",
                   body=b'{"name": "x"}')[0] == 400
    assert run.rec("PUT", f"{ADMIN}/add-tier", body=b"[1]")[0] == 400
    st, _, body = run.rec("GET", f"{ADMIN}/list-tiers")
    assert json.loads(body)["WARM"]["prefix"] == "w"
    assert run.rec("PUT", "/lcb")[0] == 200
    assert run.rec("PUT", "/lcb", [("lifecycle", "")],
                   body=TRANSITION_LC)[0] == 200
    st, _, body = run.rec("DELETE", f"{ADMIN}/remove-tier",
                          [("name", "cold")])
    assert st == 400 and b"InvalidArgument" in body
    assert run.rec("DELETE", f"{ADMIN}/remove-tier")[0] == 400
    assert run.rec("DELETE", f"{ADMIN}/remove-tier",
                   [("name", "warm")])[0] == 200
    assert run.rec("DELETE", "/lcb", [("lifecycle", "")])[0] == 204
    assert run.rec("DELETE", f"{ADMIN}/remove-tier",
                   [("name", "COLD")])[0] == 200
    st, _, body = run.rec("GET", f"{ADMIN}/list-tiers")
    assert json.loads(body) == {}


# --- the other transforms, the tier down, a racing write -----------------

def case_compressed_objects(run):
    """A compressed .log object and a compressed-then-SSE one, each
    transitioned and read whole and ranged through the tier."""
    assert run.rec("PUT", "/data")[0] == 200
    text = _text(150_000, 7)
    assert run.rec("PUT", "/data/plain.log", body=text)[0] == 200
    assert run.rec("PUT", "/data/sealed.log", body=text,
                   headers=SSE)[0] == 200
    stored = run.hot.ol.get_object_info("data", "plain.log").user_defined
    assert stored.get(tfm.META_COMPRESSION) == "s2"
    for name in ("plain.log", "sealed.log"):
        run.tick()
        run.hot.engine.transition("data", name, "COLD")
    run.snap("transition")
    for name in ("plain.log", "sealed.log"):
        st, h, got = run.rec("GET", f"/data/{name}")
        assert st == 200 and got == text
        assert h["x-amz-storage-class"] == "COLD"
        st, h, got = run.rec("GET", f"/data/{name}",
                             headers={"Range": "bytes=70000-100000"})
        assert st == 206 and got == text[70000:100001]
        st, h, _ = run.rec("HEAD", f"/data/{name}")
        assert h["Content-Length"] == str(len(text))


def case_tier_down(run):
    """With the cold server stopped a tiered GET answers 503 and a
    scanner transition leaves its object local; with the tier back the
    next cycle moves it."""
    assert run.rec("PUT", "/data")[0] == 200
    assert run.rec("PUT", "/data/gone.bin", body=b"g" * 20_000)[0] == 200
    assert run.rec("PUT", "/data/later.bin", body=b"l" * 20_000)[0] == 200
    run.tick()
    run.hot.engine.transition("data", "gone.bin", "COLD")
    run.cold.stop()
    st, _, body = run.rec("GET", "/data/gone.bin")
    assert st == 503 and b"ServiceUnavailable" in body
    assert run.rec("HEAD", "/data/gone.bin")[0] == 200
    st, _, body = run.rec("POST", "/data/gone.bin", [("restore", "")])
    assert st == 503
    run.hot.bm.update("data", "lifecycle_xml", DATE_LC)
    run.tick()
    run.hot.scanner().scan_cycle()
    run.snap("tier_down")
    assert not run.tier.is_transitioned(
        run.info("data", "later.bin").user_defined)
    st, _, got = run.rec("GET", "/data/later.bin")
    assert st == 200 and got == b"l" * 20_000
    run.cold = Cluster(run.pkg, run.root / "cold", COLD_ID, tiered=False,
                       fresh=False, port=run.cold_port)
    run.tick()
    run.hot.scanner().scan_cycle()
    assert run.tier.is_transitioned(
        run.info("data", "later.bin").user_defined)
    for name, byte in (("gone.bin", b"g"), ("later.bin", b"l")):
        st, _, got = run.rec("GET", f"/data/{name}")
        assert st == 200 and got == byte * 20_000


def case_write_races_the_transition(run):
    """A PUT that lands between the upload to the tier and the commit
    aborts the transition (expected_mod_time_ns): the new bytes stay
    local, and the uploaded blob is left on the tier."""
    assert run.rec("PUT", "/data")[0] == 200
    assert run.rec("PUT", "/data/race.bin", body=b"old" * 5000)[0] == 200
    client, cfg = run.hot.tiers.client("COLD")
    put = client.put_object

    def racing_put(bucket, key, data, metadata=None):
        out = put(bucket, key, data, metadata)
        assert run.rec("PUT", "/data/race.bin",
                       body=b"new" * 5000)[0] == 200
        return out

    client.put_object = racing_put
    run.mp.setattr(run.hot.tiers, "client", lambda name: (client, cfg))
    run.tick()
    with pytest.raises(Exception, match="changed during transition"):
        run.hot.engine.transition("data", "race.bin", "COLD")
    run.snap("raced")
    assert not run.tier.is_transitioned(
        run.info("data", "race.bin").user_defined)
    assert len(run.remote_keys()) == 1
    st, _, got = run.rec("GET", "/data/race.bin")
    assert st == 200 and got == b"new" * 5000


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_on_both_packages(env, tmp_path, name):  # noqa: F811
    _assert_alike(_both(tmp_path, CASES[name]))


# --- where the port differs from minio_tpu (ROADMAP.md Queue 3) ----------

def _outcome(fn):
    """fn()'s result, or the name of the exception it raised."""
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 - the answer is recorded
        return type(exc).__name__


def test_heal_keeps_a_tiered_version(env, tmp_path):
    """A transitioned version's parts are gone by design. minio_tpu's
    heal checks them: without remove it raises read quorum, with remove
    it deletes the version, the only pointer to the tier's copy. The
    port heals such a version's xl.meta alone (FileInfo.IsRemote)."""
    out = {}

    def case(run):
        assert run.rec("PUT", "/data")[0] == 200
        assert run.rec("PUT", "/data/t.bin", body=b"t" * 30_000)[0] == 200
        run.tick()
        run.hot.engine.transition("data", "t.bin", "COLD")
        xl = run.root / "hot" / "d1" / "data" / "t.bin" / "xl.meta"
        kept = xl.read_bytes()
        xl.unlink()
        ol = run.hot.ol
        out[run.pkg] = {
            "heal": _outcome(lambda: ol.heal_object("data", "t.bin")),
            "xl_meta_back": xl.exists() and xl.read_bytes() == kept,
            "heal_remove": _outcome(lambda: ol.heal_object(
                "data", "t.bin", remove_dangling=True)),
            "get": run.rec("GET", "/data/t.bin")[0]}

    _both(tmp_path, case)
    assert out[JAX] == {"heal": "ErrErasureReadQuorum",
                        "xl_meta_back": False,
                        "heal_remove": {"healed": [], "dangling": True},
                        "get": 404}
    assert out[PORT] == {"heal": {"healed": ["d1"], "dangling": False},
                         "xl_meta_back": True,
                         "heal_remove": {"healed": [], "dangling": False},
                         "get": 200}


def test_restore_keeps_the_etag(env, tmp_path):
    """The ETag a GET answers after a restore, against the PUT's: equal
    for a plain, an SSE-S3 and a compressed object on both packages (the
    stored bytes' MD5 comes back the same); a multipart object's
    `<md5>-2` becomes the MD5 of its stored bytes on minio_tpu, and
    stays on the port."""
    etags = {}
    names = ("plain.bin", "sse.bin", "text.log", "multi.bin")

    def case(run):
        assert run.rec("PUT", "/data")[0] == 200
        put = {}
        for name, headers in (("plain.bin", None), ("sse.bin", SSE),
                              ("text.log", None)):
            _, h, _ = run.rec("PUT", f"/data/{name}",
                              body=_text(20_000, 3), headers=headers)
            put[name] = h["ETag"]
        _, _, body = run.rec("POST", "/data/multi.bin", [("uploads", "")])
        upload = re.search(rb"<UploadId>(.*?)</UploadId>",
                           body).group(1).decode()
        parts = []
        for n in (1, 2):
            _, h, _ = run.rec("PUT", "/data/multi.bin", [
                ("partNumber", str(n)), ("uploadId", upload)],
                body=bytes([n]) * 15_000)
            parts.append(h["ETag"])
        done = "".join(f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag>"
                       "</Part>" for n, e in enumerate(parts, 1))
        _, _, body = run.rec(
            "POST", "/data/multi.bin", [("uploadId", upload)],
            body=f"<CompleteMultipartUpload>{done}</CompleteMultipartUpload>"
            .encode())
        put["multi.bin"] = run.rec("HEAD", "/data/multi.bin")[1]["ETag"]
        after = {}
        for name in names:
            run.tick()
            run.hot.engine.transition("data", name, "COLD")
            assert run.rec("POST", f"/data/{name}", [("restore", "")])[0] \
                == 202
            after[name] = run.rec("GET", f"/data/{name}")[1]["ETag"]
        etags[run.pkg] = {n: put[n] == after[n] for n in names}
        etags[run.pkg]["multi_put"] = put["multi.bin"]

    runs = _both(tmp_path, case)
    assert etags[JAX]["multi_put"] == etags[PORT]["multi_put"]
    assert etags[JAX]["multi_put"].endswith('-2"')
    assert {n: etags[JAX][n] for n in names} == {
        "plain.bin": True, "sse.bin": True, "text.log": True,
        "multi.bin": False}
    assert {n: etags[PORT][n] for n in names} == dict.fromkeys(names, True)
    # Every answer but the multipart object's GET after its restore.
    assert runs[PORT].log[:-1] == runs[JAX].log[:-1]


def test_copy_from_a_tiered_source(env, tmp_path):
    """CopyObject and UploadPartCopy from a transitioned source with no
    restored copy: minio_tpu reads the freed shards and answers 404
    NoSuchKey; the port answers InvalidObjectState, as MinIO does.
    Restored, both copy it."""
    answers = {}

    def case(run):
        assert run.rec("PUT", "/data")[0] == 200
        body = b"c" * 30_000
        assert run.rec("PUT", "/data/src.bin", body=body)[0] == 200
        run.tick()
        run.hot.engine.transition("data", "src.bin", "COLD")
        src = {"x-amz-copy-source": "/data/src.bin"}
        copy = run.rec("PUT", "/data/copy.bin", headers=src)
        _, _, raw = run.rec("POST", "/data/part.bin", [("uploads", "")])
        upload = re.search(rb"<UploadId>(.*?)</UploadId>",
                           raw).group(1).decode()
        part = run.rec("PUT", "/data/part.bin", [
            ("partNumber", "1"), ("uploadId", upload)], headers=src)
        assert run.rec("POST", "/data/src.bin", [("restore", "")])[0] == 202
        restored = run.rec("PUT", "/data/copy2.bin", headers=src)
        answers[run.pkg] = [
            (r[0], _record(r).get("error", {}).get("Code"))
            for r in (copy, part, restored)]
        answers[run.pkg].append(run.rec("GET", "/data/copy2.bin")[2] == body)

    _both(tmp_path, case)
    assert answers[PORT] == [(403, b"InvalidObjectState"),
                             (403, b"InvalidObjectState"), (200, None), True]
    assert answers[JAX] == [(404, b"NoSuchKey"), (404, b"NoSuchKey"),
                            (200, None), True]


def test_restored_copy_expires_at_the_scanners_clock(env, tmp_path):
    """The scanner's lifecycle step with its `now` three days ahead:
    the port drops a one-day restored copy back to metadata only;
    minio_tpu reads the wall clock and keeps it."""
    out = {}

    def case(run):
        assert run.rec("PUT", "/data")[0] == 200
        assert run.rec("PUT", "/data/r.bin", body=b"r" * 20_000)[0] == 200
        run.tick()
        run.hot.engine.transition("data", "r.bin", "COLD")
        assert run.rec("POST", "/data/r.bin", [("restore", "")],
                       body=b"<RestoreRequest><Days>1</Days>"
                            b"</RestoreRequest>")[0] == 202
        scanner = run.hot.scanner()
        rules = scanner_mod.parse_lifecycle("") if run.pkg == PORT else \
            jax_scanner_mod.parse_lifecycle("")
        oi = run.hot.ol.list_objects("data").objects[0]
        scanner._apply_lifecycle("data", oi, rules,
                                 run.clock.now + 3 * 86400 * 10 ** 9)
        meta = run.info("data", "r.bin").user_defined
        parts = [p for p in (run.root / "hot").rglob("part.*")
                 if "r.bin" in str(p)]
        out[run.pkg] = (run.tier.META_RESTORE in meta, len(parts))
        assert run.rec("GET", "/data/r.bin")[2] == b"r" * 20_000

    _both(tmp_path, case)
    assert out[JAX] == (True, 4)
    assert out[PORT] == (False, 0)


def test_delete_leaves_the_remote_blob_and_the_secret_stays_clear(
        env, tmp_path):
    """Copied from minio_tpu: a DELETE of a transitioned object leaves
    its blob on the tier, and tiers.json holds each tier's secret key in
    clear (MinIO deletes the remote copy and seals the tier config)."""
    def case(run):
        assert run.rec("PUT", "/data")[0] == 200
        assert run.rec("PUT", "/data/d.bin", body=b"d" * 20_000)[0] == 200
        run.tick()
        run.hot.engine.transition("data", "d.bin", "COLD")
        assert run.rec("DELETE", "/data/d.bin")[0] == 204
        assert run.rec("GET", "/data/d.bin")[0] == 404
        assert len(run.remote_keys()) == 1
        raw = run.hot.ol.get_object_bytes(".minio.sys", "config/tiers.json")
        assert json.loads(raw)["COLD"]["secret_key"] == SECRET

    _assert_alike(_both(tmp_path, case))


def test_port_serves_a_drive_set_tiered_by_minio_tpu(env, tmp_path):
    """minio_tpu transitions a plain and a compressed-then-SSE object;
    the port, on the same hot and cold drives, loads tiers.json, GETs
    both through the tier (whole and ranged), then restores one."""
    text = _text(60_000, 9)
    plain = b"p" * 30_001
    port = _free_port()

    def tiered_by_jax(run):
        assert run.rec("PUT", "/data")[0] == 200
        assert run.rec("PUT", "/data/p.bin", body=plain)[0] == 200
        assert run.rec("PUT", "/data/s.log", body=text, headers=SSE)[0] \
            == 200
        for name in ("p.bin", "s.log"):
            run.tick()
            run.hot.engine.transition("data", name, "COLD")

    with pytest.MonkeyPatch.context() as mp:
        _run(JAX, tmp_path, mp, tiered_by_jax, port)
    cold = Cluster(PORT, tmp_path / "cold", COLD_ID, tiered=False,
                   fresh=False, port=port)
    hot = Cluster(PORT, tmp_path / "hot", HOT_ID, tiered=True, fresh=False)
    try:
        hot.tiers.load()
        assert hot.tiers.get("COLD")["endpoint"] == cold.endpoint
        c = S3Client(hot.endpoint, ACCESS, SECRET)
        for name, want in (("p.bin", plain), ("s.log", text)):
            st, h, got = c.request("GET", f"/data/{name}")
            assert st == 200 and got == want
            assert h["x-amz-storage-class"] == "COLD"
            st, _, got = c.request("GET", f"/data/{name}",
                                   headers={"Range": "bytes=1000-20999"})
            assert st == 206 and got == want[1000:21000]
        assert c.request("POST", "/data/s.log", [("restore", "")])[0] == 202
        assert hot.tiers is not None and tier.is_restored(
            hot.ol.get_object_info("data", "s.log").user_defined)
        parts = [p for p in (tmp_path / "hot").rglob("part.*")
                 if "s.log" in str(p)]
        assert len(parts) == 4
        st, h, got = c.request("GET", "/data/s.log")
        assert st == 200 and got == text and "x-amz-restore" in h
    finally:
        hot.stop()
        cold.stop()


# --- races and partial commits on the tier path (ROADMAP.md Queue 3) -----

def _get(run, path: str, want: bytes):
    """(status, body == want) of a GET, or the name of the exception a
    GET that breaks off after its status line raises."""
    def get():
        st, _, got = run.rec("GET", path)
        return st, got == want
    return _outcome(get)


def _expired_restore(run, name: str):
    """Transition `name`, restore it, then date its restored copy in 2001
    (expired on both packages' clocks); the listing entry the scanner
    decides on."""
    run.tick()
    run.hot.engine.transition("data", name, "COLD")
    assert run.rec("POST", f"/data/{name}", [("restore", "")])[0] == 202
    year = time.strftime("%Y", time.gmtime(run.clock.now / 1e9))
    run.hot.ol.update_object_metadata("data", name, "", {
        run.tier.META_RESTORE: run.tier.restore_header(days=1).replace(
            year, "2001", 1)})
    return next(o for o in run.hot.ol.list_objects("data").objects
                if o.name == name)


def test_put_races_the_restored_copys_expiry(env, tmp_path):
    """A PUT of the key between the scanner's listing and its expiry of
    the restored copy. minio_tpu strips the new version: its data goes
    and it has no tier pointer. The port's expiry carries the listed
    version's mod time and markers and aborts."""
    out = {}

    def case(run):
        assert run.rec("PUT", "/data")[0] == 200
        assert run.rec("PUT", "/data/e.bin", body=b"o" * 20_000)[0] == 200
        oi = _expired_restore(run, "e.bin")
        assert run.rec("PUT", "/data/e.bin", body=b"n" * 20_000)[0] == 200
        scanner = run.hot.scanner()
        mod = scanner_mod if run.pkg == PORT else jax_scanner_mod
        run.tick()
        scanner._apply_lifecycle("data", oi, mod.parse_lifecycle(""),
                                 run.clock.now)
        meta = run.info("data", "e.bin").user_defined
        out[run.pkg] = {"get": _get(run, "/data/e.bin", b"n" * 20_000),
                        "transitioned": run.tier.is_transitioned(meta)}

    _both(tmp_path, case)
    assert out[PORT] == {"get": (200, True), "transitioned": False}
    # The 200 status line goes out, then the body breaks off.
    assert out[JAX] == {"get": "IncompleteRead", "transitioned": False}


def test_put_races_the_restore(env, tmp_path):
    """A PUT of the key while the restore fetches the tier's copy.
    minio_tpu writes the tier's bytes under the new version's metadata;
    the port's restore carries the version's mod time and markers,
    answers InvalidObjectState and keeps the new bytes."""
    out = {}

    def case(run):
        assert run.rec("PUT", "/data")[0] == 200
        assert run.rec("PUT", "/data/f.bin", body=b"o" * 20_000)[0] == 200
        run.tick()
        run.hot.engine.transition("data", "f.bin", "COLD")
        client, cfg = run.hot.tiers.client("COLD")
        fetch = client.get_object_to

        def racing_fetch(bucket, key, dst, version_id=""):
            got = fetch(bucket, key, dst, version_id)
            assert run.rec("PUT", "/data/f.bin",
                           body=b"n" * 20_000)[0] == 200
            return got

        client.get_object_to = racing_fetch
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(run.hot.tiers, "client", lambda name: (client, cfg))
            st, _, body = run.rec("POST", "/data/f.bin", [("restore", "")])
        code = _record((st, {}, body)).get("error", {}).get("Code")
        out[run.pkg] = {"restore": (st, code),
                        "get": _get(run, "/data/f.bin", b"n" * 20_000)}

    _both(tmp_path, case)
    assert out[PORT] == {"restore": (403, b"InvalidObjectState"),
                         "get": (200, True)}
    # The old bytes under the new version: 200, another body.
    assert out[JAX] == {"restore": (202, None), "get": (200, False)}


def test_transition_below_write_quorum(env, tmp_path):
    """Two of the hot set's four drives (2+2, write quorum 3) fail the
    transition's metadata commit. minio_tpu drops the parts of the two
    that committed; the port rolls them back, drops no part, raises
    ErrErasureWriteQuorum, and the next try moves the object."""
    body = b"q" * 30_000
    out = {}

    def case(run):
        assert run.rec("PUT", "/data")[0] == 200
        assert run.rec("PUT", "/data/q.bin", body=body)[0] == 200
        before = _tree(run.root / "hot")

        def failing(*args, **kwargs):
            raise OSError("drive offline")

        disks = run.hot.ol.pools[0].sets[0].disks
        run.tick()
        with pytest.MonkeyPatch.context() as mp:
            for disk in disks[:2]:
                mp.setattr(disk, "update_metadata", failing)
            raised = _outcome(lambda: run.hot.engine.transition(
                "data", "q.bin", "COLD"))
        hot = _tree(run.root / "hot")
        changed = sorted(k for k in before if hot.get(k) != before[k])
        parts = [p for p in (run.root / "hot").rglob("part.*")
                 if "q.bin" in str(p)]
        out[run.pkg] = {"raised": raised, "parts": len(parts),
                        "changed": changed,
                        "get": _get(run, "/data/q.bin", body)}
        run.tick()
        run.hot.engine.transition("data", "q.bin", "COLD")
        st, h, got = run.rec("GET", "/data/q.bin")
        out[run.pkg]["after_retry"] = (st, got == body,
                                       h.get("x-amz-storage-class"))

    _both(tmp_path, case)
    port = out[PORT]
    assert port["raised"] == "ErrErasureWriteQuorum"
    assert port["parts"] == 4 and port["get"] == (200, True)
    assert port["changed"] == []  # every file as it was, xl.meta too
    assert port["after_retry"] == (200, True, "COLD")
    # Two drives keep the old xl.meta and their parts, which 2+2 still
    # reads; at 12+4 five committed drives leave eleven shards.
    jax = out[JAX]
    assert (jax["raised"], jax["parts"], jax["get"]) == (None, 2, (200, True))
    assert [k.split("/")[0] for k in jax["changed"]] == ["d2", "d2", "d3",
                                                         "d3"]
    assert jax["after_retry"] == (200, True, "COLD")


def test_remove_tier_matches_names_and_transitioned_versions(env, tmp_path):
    """remove-tier: minio_tpu refuses a tier whose name is a substring of
    any bucket's lifecycle XML (COLD while a rule names COLDER) and
    removes one that only a transitioned version names, whose GETs then
    fail. The port compares each rule's StorageClass whole and also
    refuses while a version transitioned to the tier is left."""
    out = {}
    colder = TRANSITION_LC.replace(b">COLD<", b">COLDER<")

    def case(run):
        assert run.rec("PUT", "/lcb")[0] == 200
        assert run.rec("PUT", "/lcb", [("lifecycle", "")],
                       body=colder)[0] == 200
        cold = run.rec("DELETE", f"{ADMIN}/remove-tier", [("name", "COLD")])
        spec = {"name": "WARM", "endpoint": run.cold.endpoint,
                "access_key": ACCESS, "secret_key": SECRET,
                "bucket": "coldstore", "prefix": "w"}
        assert run.rec("PUT", f"{ADMIN}/add-tier",
                       body=json.dumps(spec).encode())[0] == 200
        assert run.rec("PUT", "/data")[0] == 200
        assert run.rec("PUT", "/data/w.bin", body=b"w" * 20_000)[0] == 200
        run.tick()
        run.hot.engine.transition("data", "w.bin", "WARM")
        warm = run.rec("DELETE", f"{ADMIN}/remove-tier", [("name", "WARM")])
        out[run.pkg] = {"cold": cold[0], "warm": warm[0],
                        "get": _get(run, "/data/w.bin", b"w" * 20_000)}

    _both(tmp_path, case)
    assert out[PORT] == {"cold": 200, "warm": 400, "get": (200, True)}
    # WARM's credentials gone: the GET cannot reach the tier.
    assert out[JAX] == {"cold": 400, "warm": 200, "get": (400, False)}
