"""Object lock and bucket quotas on the port against minio_tpu, over HTTP
on localhost, on the CPU.

Each case of tests/test_objectlock_quota.py, and the cases added for
the port, is one request sequence that runs on both packages' S3Servers
(4 fresh drives, one set, a ConfigSys compressing .log objects, an
SSEConfig): every response's status, error Code and Message, body and
its version, delete-marker, lock and ETag headers are recorded, and the
drive files after the sequence compare whole. Ids, clocks and os.urandom
are made alike on both sides (tests/test_torch_s3_core.py's `_alike`),
with the clock near the real time, because a retention is held to
time.time().

Where the port differs from minio_tpu on purpose (ROADMAP.md Queue 3),
the case asserts each side: the governance bypass needs the caller's
s3:BypassGovernanceRetention on the port. A lifecycle document with a
Transition is stored and its bucket served on both (the tiers themselves
are held in tests/test_torch_tiering.py).
"""

import json
import os
import random
import re
import sys
import time

import pytest
import torch

from minio_tpu.bucket import objectlock as jax_objectlock
from minio_tpu_torch.api.client import S3Client
from minio_tpu_torch.bucket import objectlock
from tests.test_torch_compression import COMPRESS_KV, _s3server, _text
from tests.test_torch_compression import env  # noqa: F401 - fixture
from tests.test_torch_s3_core import _alike, _Shim, _tree

torch.set_num_threads(1)

PORT, JAX = "port", "jax"
ACCESS, SECRET = "tpuadmin", "tpuadmin-secret-key"
# The clock of both sides, a whole second near the real time: a default
# retention of a day must lie ahead of time.time(). Set again for each
# test (`_now`), long after the module's import in a whole run.
T_NOW = time.time_ns() // 10 ** 9 * 10 ** 9
RECORDED = ("etag", "x-amz-version-id", "x-amz-delete-marker",
            "x-amz-object-lock-mode", "x-amz-object-lock-retain-until-date",
            "x-amz-object-lock-legal-hold", "content-length",
            "last-modified")

VX = ('<VersioningConfiguration xmlns='
      '"http://s3.amazonaws.com/doc/2006-03-01/">'
      "<Status>Enabled</Status></VersioningConfiguration>").encode()
LOCK_XML = ('<ObjectLockConfiguration xmlns='
            '"http://s3.amazonaws.com/doc/2006-03-01/">'
            "<ObjectLockEnabled>Enabled</ObjectLockEnabled>"
            "{rule}</ObjectLockConfiguration>")
RULE_COMPLIANCE_1D = ("<Rule><DefaultRetention><Mode>COMPLIANCE</Mode>"
                      "<Days>1</Days></DefaultRetention></Rule>")
RULE_GOVERNANCE_1D = ("<Rule><DefaultRetention><Mode>GOVERNANCE</Mode>"
                      "<Days>1</Days></DefaultRetention></Rule>")
BYPASS = {"x-amz-bypass-governance-retention": "true"}
QUOTA = "/minio/admin/v3/set-bucket-quota"
GET_QUOTA = "/minio/admin/v3/get-bucket-quota"
TRANSITION_LC = (b"<LifecycleConfiguration><Rule><ID>cold</ID>"
                 b"<Status>Enabled</Status><Filter><Prefix>old/</Prefix>"
                 b"</Filter><Transition><Days>30</Days>"
                 b"<StorageClass>COLD</StorageClass></Transition></Rule>"
                 b"</LifecycleConfiguration>")


@pytest.fixture(autouse=True)
def _now(monkeypatch):
    monkeypatch.setattr(sys.modules[__name__], "T_NOW",
                        time.time_ns() // 10 ** 9 * 10 ** 9)


def _iso(offset_s: int) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ",
                         time.gmtime(T_NOW // 10 ** 9 + offset_s))


def _record(resp) -> dict:
    status, headers, body = resp
    lower = {k.lower(): v for k, v in headers.items()}
    out = {"status": status,
           "headers": {k: v for k, v in lower.items() if k in RECORDED}}
    if status >= 400 and body.startswith(b"<?xml"):
        out["error"] = {t: re.search(rf"<{t}>(.*?)</{t}>".encode(),
                                     body).group(1)
                        for t in ("Code", "Message", "Resource")}
    else:
        out["body"] = body
    return out


def _upload_id(body: bytes) -> str:
    return re.search(rb"<UploadId>(.*?)</UploadId>", body).group(1).decode()


def _mk_locked_bucket(rec, bucket: str, rule: str) -> None:
    assert rec("PUT", f"/{bucket}")[0] == 200
    assert rec("PUT", f"/{bucket}", [("versioning", "")], body=VX)[0] == 200
    st, _, body = rec("PUT", f"/{bucket}", [("object-lock", "")],
                      body=LOCK_XML.format(rule=rule).encode())
    assert st == 200, body


# --- the cases of tests/test_objectlock_quota.py -------------------------

def case_lock_config_requires_versioning(rec, srv, pkg):
    assert rec("PUT", "/nolock")[0] == 200
    st, _, body = rec("PUT", "/nolock", [("object-lock", "")],
                      body=LOCK_XML.format(rule="").encode())
    assert st == 409 and b"InvalidBucketState" in body
    # The stored document, and its absence, read back.
    assert rec("GET", "/nolock", [("object-lock", "")])[0] == 404


def case_compliance_default_retention_blocks_delete(rec, srv, pkg):
    _mk_locked_bucket(rec, "wormc", RULE_COMPLIANCE_1D)
    assert rec("GET", "/wormc", [("object-lock", "")])[0] == 200
    st, h, _ = rec("PUT", "/wormc/locked", body=b"keep me")
    assert st == 200
    vid = h["x-amz-version-id"]
    _, h, _ = rec("HEAD", "/wormc/locked")
    assert h.get("x-amz-object-lock-mode") == "COMPLIANCE"
    st, _, body = rec("DELETE", "/wormc/locked", [("versionId", vid)])
    assert st == 403 and b"AccessDenied" in body
    st, _, _ = rec("DELETE", "/wormc/locked", [("versionId", vid)],
                   headers=BYPASS)
    assert st == 403
    assert rec("DELETE", "/wormc/locked")[0] == 204
    st, _, got = rec("GET", "/wormc/locked", [("versionId", vid)])
    assert st == 200 and got == b"keep me"


def case_governance_delete_needs_bypass(rec, srv, pkg):
    _mk_locked_bucket(rec, "wormg", RULE_GOVERNANCE_1D)
    _, h, _ = rec("PUT", "/wormg/gov", body=b"governed")
    vid = h["x-amz-version-id"]
    assert rec("DELETE", "/wormg/gov", [("versionId", vid)])[0] == 403
    assert rec("DELETE", "/wormg/gov", [("versionId", vid)],
               headers=BYPASS)[0] == 204
    assert rec("GET", "/wormg/gov", [("versionId", vid)])[0] == 404


def case_legal_hold_blocks_delete_until_lifted(rec, srv, pkg):
    _mk_locked_bucket(rec, "wormh", rule="")
    st, h, _ = rec("PUT", "/wormh/held", body=b"on hold",
                   headers={"x-amz-object-lock-legal-hold": "ON"})
    assert st == 200
    vid = h["x-amz-version-id"]
    st, _, body = rec("DELETE", "/wormh/held", [("versionId", vid)])
    assert st == 403 and b"legal hold" in body
    st, _, body = rec("GET", "/wormh/held", [("legal-hold", "")])
    assert st == 200 and b"ON" in body
    assert rec("PUT", "/wormh/held", [("legal-hold", "")],
               body=b"<LegalHold><Status>OFF</Status></LegalHold>")[0] == 200
    assert rec("DELETE", "/wormh/held", [("versionId", vid)])[0] == 204


def case_retention_subresource_roundtrip_and_tighten_rules(rec, srv, pkg):
    _mk_locked_bucket(rec, "wormr", rule="")
    assert rec("PUT", "/wormr/obj", body=b"r")[0] == 200
    assert rec("GET", "/wormr/obj", [("retention", "")])[0] == 404
    until = _iso(3600)
    ret = (f"<Retention><Mode>GOVERNANCE</Mode>"
           f"<RetainUntilDate>{until}</RetainUntilDate></Retention>")
    assert rec("PUT", "/wormr/obj", [("retention", "")],
               body=ret.encode())[0] == 200
    st, _, body = rec("GET", "/wormr/obj", [("retention", "")])
    assert st == 200 and b"GOVERNANCE" in body and until.encode() in body
    ret2 = (f"<Retention><Mode>GOVERNANCE</Mode>"
            f"<RetainUntilDate>{_iso(60)}</RetainUntilDate></Retention>")
    assert rec("PUT", "/wormr/obj", [("retention", "")],
               body=ret2.encode())[0] == 403
    assert rec("PUT", "/wormr/obj", [("retention", "")], body=ret2.encode(),
               headers=BYPASS)[0] == 200
    # Bad documents, and a past date.
    assert rec("PUT", "/wormr/obj", [("retention", "")],
               body=b"<Retention>")[0] == 400
    past = (f"<Retention><Mode>GOVERNANCE</Mode>"
            f"<RetainUntilDate>{_iso(-60)}</RetainUntilDate></Retention>")
    assert rec("PUT", "/wormr/obj", [("retention", "")],
               body=past.encode())[0] == 400


def case_lock_headers_require_bucket_lock_config(rec, srv, pkg):
    assert rec("PUT", "/plain")[0] == 200
    st, _, body = rec("PUT", "/plain/obj", body=b"x", headers={
        "x-amz-object-lock-mode": "COMPLIANCE",
        "x-amz-object-lock-retain-until-date": _iso(3600)})
    assert st == 400 and b"ObjectLockConfiguration" in body
    # A mode without its date is InvalidArgument.
    assert rec("PUT", "/plain/obj", body=b"x", headers={
        "x-amz-object-lock-mode": "COMPLIANCE"})[0] == 400


def case_unversioned_permanent_delete_enforces_retention(rec, srv, pkg):
    _mk_locked_bucket(rec, "wormu", RULE_COMPLIANCE_1D)
    _, h, _ = rec("PUT", "/wormu/perm", body=b"z")
    vid = h["x-amz-version-id"]
    assert rec("DELETE", "/wormu/perm", [("versionId", vid)])[0] == 403


def case_bulk_delete_enforces_retention(rec, srv, pkg):
    _mk_locked_bucket(rec, "wormb", RULE_COMPLIANCE_1D)
    _, h, _ = rec("PUT", "/wormb/bulk1", body=b"l1")
    vid = h["x-amz-version-id"]
    body = ('<Delete xmlns="http://s3.amazonaws.com/doc/2006-03-01/">'
            f"<Object><Key>bulk1</Key><VersionId>{vid}</VersionId></Object>"
            "<Object><Key>bulk1</Key></Object></Delete>").encode()
    st, _, resp = rec("POST", "/wormb", [("delete", "")], body=body)
    assert st == 200 and b"<Error>" in resp and b"AccessDenied" in resp
    assert rec("GET", "/wormb/bulk1", [("versionId", vid)])[0] == 200


def case_multipart_inherits_default_retention(rec, srv, pkg):
    _mk_locked_bucket(rec, "wormm", RULE_COMPLIANCE_1D)
    st, _, body = rec("POST", "/wormm/mpobj", [("uploads", "")])
    assert st == 200
    upload_id = _upload_id(body)
    st, h, _ = rec("PUT", "/wormm/mpobj", [("partNumber", "1"),
                                           ("uploadId", upload_id)],
                   body=b"p" * 1024)
    assert st == 200
    done = ("<CompleteMultipartUpload><Part><PartNumber>1</PartNumber>"
            f"<ETag>{h['ETag'].strip(chr(34))}</ETag></Part>"
            "</CompleteMultipartUpload>").encode()
    st, _, body = rec("POST", "/wormm/mpobj", [("uploadId", upload_id)],
                      body=done)
    assert st == 200, body
    _, h, _ = rec("HEAD", "/wormm/mpobj")
    assert h.get("x-amz-object-lock-mode") == "COMPLIANCE"


def case_hard_quota_rejects_put_over_limit(rec, srv, pkg):
    # The reference case's sizes over 8 (the plain hash is slow here).
    assert rec("PUT", "/qbucket")[0] == 200
    st, _, body = rec("PUT", QUOTA, [("bucket", "qbucket")], body=json.dumps(
        {"quota": 32 * 1024, "quotatype": "hard"}).encode())
    assert st == 200, body
    st, _, body = rec("GET", GET_QUOTA, [("bucket", "qbucket")])
    assert st == 200 and json.loads(body)["quota"] == 32 * 1024
    assert rec("PUT", "/qbucket/a", body=b"x" * (100 * 128))[0] == 200
    time.sleep(1.1)  # the quota's usage cache lives 1 s
    st, _, body = rec("PUT", "/qbucket/b", body=b"y" * (200 * 128))
    assert st == 409 and b"QuotaExceeded" in body
    assert rec("PUT", QUOTA, [("bucket", "qbucket")], body=b"")[0] == 200
    assert rec("PUT", "/qbucket/b", body=b"y" * (200 * 128))[0] == 200


# --- the port's added cases --------------------------------------------

def case_quota_on_part_and_copy(rec, srv, pkg):
    """UploadPart and CopyObject are held to the hard quota; a compressed
    source is charged its logical size, not its stored one."""
    text = _text(200_000, seed=7)
    assert rec("PUT", "/src")[0] == 200
    assert rec("PUT", "/src/doc.log", body=text)[0] == 200
    assert rec("PUT", "/qbk")[0] == 200
    assert rec("PUT", QUOTA, [("bucket", "qbk")], body=json.dumps(
        {"quota": 150_000}).encode())[0] == 200
    # Stored compressed well under the quota, 200,000 B logical: refused.
    st, _, body = rec("PUT", "/qbk/copy.log",
                      headers={"x-amz-copy-source": "/src/doc.log"})
    assert st == 409 and b"QuotaExceeded" in body
    st, _, body = rec("POST", "/qbk/mp.bin", [("uploads", "")])
    upload_id = _upload_id(body)
    st, _, body = rec("PUT", "/qbk/mp.bin", [("partNumber", "1"),
                                            ("uploadId", upload_id)],
                      body=b"q" * 160_000)
    assert st == 409 and b"QuotaExceeded" in body
    assert rec("PUT", "/qbk/small.bin", body=b"s" * 100_000)[0] == 200
    assert rec("PUT", "/qbk/mp.bin", [("partNumber", "1"),
                                      ("uploadId", upload_id)],
               body=b"q" * 10_000)[0] == 200


def case_admin_quota_routes(rec, srv, pkg):
    assert rec("PUT", "/adq")[0] == 200
    st, _, body = rec("GET", GET_QUOTA, [("bucket", "adq")])
    assert st == 200 and json.loads(body) == {}
    for bad in (b"{not json", b'{"quota": -1}', b'{"quota": 5, '
                b'"quotatype": "soft"}', b'{"quota": "many"}'):
        assert rec("PUT", QUOTA, [("bucket", "adq")], body=bad)[0] == 400
    assert rec("PUT", QUOTA, body=b'{"quota": 5}')[0] == 400  # no bucket
    assert rec("PUT", QUOTA, [("bucket", "adq")],
               body=b'{"quota": 4096, "quotatype": "HARD"}')[0] == 200
    st, _, body = rec("GET", GET_QUOTA, [("bucket", "adq")])
    assert json.loads(body) == {"quota": 4096, "quotatype": "hard"}


def case_fifo_quota_is_stored_not_enforced(rec, srv, pkg):
    """A FIFO quota is accepted and read back, and nothing enforces it
    (ROADMAP.md Queue 3: neither package trims)."""
    assert rec("PUT", "/fifo")[0] == 200
    assert rec("PUT", QUOTA, [("bucket", "fifo")], body=json.dumps(
        {"quota": 1024, "quotatype": "fifo"}).encode())[0] == 200
    st, _, body = rec("GET", GET_QUOTA, [("bucket", "fifo")])
    assert json.loads(body) == {"quota": 1024, "quotatype": "fifo"}
    for i in range(2):
        assert rec("PUT", f"/fifo/o{i}", body=b"f" * 4096)[0] == 200
    time.sleep(1.1)
    assert rec("PUT", "/fifo/o2", body=b"f" * 4096)[0] == 200
    assert rec("GET", "/fifo/o0")[0] == 200


def case_sse_object_under_retention(rec, srv, pkg):
    """An SSE-S3 object (sealed and opened by kernels C and D on the
    card) takes the default retention like any other."""
    _mk_locked_bucket(rec, "wormsse", RULE_COMPLIANCE_1D)
    st, h, _ = rec("PUT", "/wormsse/enc.bin", body=b"secret" * 500,
                   headers={"x-amz-server-side-encryption": "AES256"})
    assert st == 200
    vid = h["x-amz-version-id"]
    assert rec("DELETE", "/wormsse/enc.bin", [("versionId", vid)])[0] == 403
    st, _, got = rec("GET", "/wormsse/enc.bin", [("versionId", vid)])
    assert st == 200 and got == b"secret" * 500
    # A copy takes the destination's default, not the source's dates.
    st, _, _ = rec("PUT", "/wormsse/copy.bin", headers={
        "x-amz-copy-source": "/wormsse/enc.bin",
        "x-amz-server-side-encryption": "AES256"})
    assert st == 200
    _, h, _ = rec("HEAD", "/wormsse/copy.bin")
    assert h.get("x-amz-object-lock-mode") == "COMPLIANCE"


def case_lifecycle_document_roundtrip(rec, srv, pkg):
    """?lifecycle without a Transition: validated, stored, served and
    deleted; bad documents are MalformedXML or InvalidArgument."""
    assert rec("PUT", "/lcd")[0] == 200
    assert rec("GET", "/lcd", [("lifecycle", "")])[0] == 404
    assert rec("PUT", "/lcd", [("lifecycle", "")],
               body=b"<LifecycleConfiguration><Rule>")[0] == 400
    bad = (b"<LifecycleConfiguration><Rule><ID>x</ID><Status>Enabled"
           b"</Status><Expiration><Days>0</Days></Expiration></Rule>"
           b"</LifecycleConfiguration>")
    st, _, body = rec("PUT", "/lcd", [("lifecycle", "")], body=bad)
    assert st == 400 and b"positive" in body
    good = (b"<LifecycleConfiguration><Rule><ID>x</ID><Status>Enabled"
            b"</Status><Filter><Prefix>l/</Prefix></Filter><Expiration>"
            b"<Days>5</Days></Expiration></Rule></LifecycleConfiguration>")
    assert rec("PUT", "/lcd", [("lifecycle", "")], body=good)[0] == 200
    st, _, body = rec("GET", "/lcd", [("lifecycle", "")])
    assert st == 200 and body == good
    assert rec("PUT", "/lcd/l/x", body=b"served")[0] == 200
    assert rec("DELETE", "/lcd", [("lifecycle", "")])[0] == 204


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


def _run(pkg: str, root, mp, case) -> dict:
    clock = _alike(mp)
    clock.now = T_NOW
    for mod in (objectlock, jax_objectlock):
        mp.setattr(mod, "time", _Shim(time, time_ns=clock.time_ns))
    mp.setattr(os, "urandom", random.Random(2026).randbytes)
    srv = _s3server(pkg, root, kv=COMPRESS_KV)
    log = []
    try:
        c = S3Client(srv.endpoint, ACCESS, SECRET)

        def rec(*args, **kw):
            clock.now += 10 ** 9
            resp = c.request(*args, **kw)
            log.append(_record(resp))
            return resp

        case(rec, srv, pkg)
    finally:
        srv.stop()
    return {"log": log, "tree": _tree(root)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_on_both_packages(env, tmp_path, name):  # noqa: F811
    runs = {}
    for pkg in (JAX, PORT):
        with pytest.MonkeyPatch.context() as mp:
            runs[pkg] = _run(pkg, tmp_path / pkg, mp, CASES[name])
    assert runs[PORT]["log"] == runs[JAX]["log"]
    jax, port = runs[JAX]["tree"], runs[PORT]["tree"]
    assert port.keys() == jax.keys()
    assert [k for k in jax if port[k] != jax[k]] == []


# --- where the port differs on purpose -----------------------------------

def _bypass_sequence(rec, policy_actions) -> list:
    """A GOVERNANCE version deleted anonymously with the bypass header,
    under a bucket policy granting `policy_actions`."""
    _mk_locked_bucket(rec, "wormp", RULE_GOVERNANCE_1D)
    _, h, _ = rec("PUT", "/wormp/gov", body=b"governed")
    vid = h["x-amz-version-id"]
    policy = json.dumps({"Version": "2012-10-17", "Statement": [{
        "Effect": "Allow", "Principal": {"AWS": ["*"]},
        "Action": list(policy_actions),
        "Resource": ["arn:aws:s3:::wormp/*"]}]}).encode()
    assert rec("PUT", "/wormp", [("policy", "")], body=policy)[0] == 204
    out = [rec("DELETE", "/wormp/gov", [("versionId", vid)],
               anonymous=True)[0]]
    out.append(rec("DELETE", "/wormp/gov", [("versionId", vid)],
                   headers=BYPASS, anonymous=True)[0])
    return out


@pytest.mark.parametrize("granted", [False, True])
def test_governance_bypass_needs_the_permission(env, tmp_path, granted):
    """MinIO honours x-amz-bypass-governance-retention only for a caller
    with s3:BypassGovernanceRetention; minio_tpu reads the header alone
    (ROADMAP.md Queue 3). Granted the permission, both delete."""
    actions = ["s3:DeleteObject"] + (
        ["s3:BypassGovernanceRetention"] if granted else [])
    statuses = {}

    def case(rec, srv, pkg):
        statuses[pkg] = _bypass_sequence(rec, actions)

    for pkg in (JAX, PORT):
        with pytest.MonkeyPatch.context() as mp:
            _run(pkg, tmp_path / pkg, mp, case)
    assert statuses[JAX] == [403, 204]
    assert statuses[PORT] == ([403, 204] if granted else [403, 403])


def test_transition_rules_are_refused(env, tmp_path):
    """A ?lifecycle document with a Transition is stored on both packages
    and its bucket served (the port has remote tiers now; the name stays
    so no test is lost), and a Transition without a StorageClass is
    InvalidArgument on both."""
    answers = {}

    def case(rec, srv, pkg):
        assert rec("PUT", "/tier")[0] == 200
        no_class = TRANSITION_LC.replace(b"<StorageClass>COLD</StorageClass>",
                                         b"")
        bad = rec("PUT", "/tier", [("lifecycle", "")], body=no_class)
        put = rec("PUT", "/tier", [("lifecycle", "")], body=TRANSITION_LC)
        obj = rec("PUT", "/tier/old/x", body=b"cold")
        stored = rec("GET", "/tier", [("lifecycle", "")])
        answers[pkg] = [(r[0], _record(r).get("error", {}).get("Code"))
                        for r in (bad, put, obj)]
        answers[pkg].append(stored[2] == TRANSITION_LC)

    runs = {}
    for pkg in (JAX, PORT):
        with pytest.MonkeyPatch.context() as mp:
            runs[pkg] = _run(pkg, tmp_path / pkg, mp, case)
    assert answers[PORT] == answers[JAX] == [
        (400, b"InvalidArgument"), (200, None), (200, None), True]
    assert runs[PORT]["log"] == runs[JAX]["log"]
