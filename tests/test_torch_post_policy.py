"""Browser form uploads signed by a POST policy (minio_tpu_torch/api/
handlers.py post_policy_object, PostPolicyBucketHandler and
cmd/postpolicyform.go) on the port against minio_tpu, over HTTP on
localhost, on the CPU.

Each case of tests/test_post_policy.py but its S3 Select over Parquet
(ROADMAP.md Queue 1 item 8) is one sequence of form POSTs and signed
requests that runs on both packages' S3Servers (4 drives, one set, ids
and clocks made alike, tests/test_torch_s3_core.py's `_alike`): the
status lines, the bodies (an error's Code and Message) and the GETs of
the stored objects compare, and so do the drive files after it.

Where the port differs on purpose (ROADMAP.md Queue 3): a form without
its policy, a body that is not multipart/form-data and a form without
its file are MalformedPOSTRequest (400) on the port, as in MinIO, and
500 InternalError on minio_tpu, whose error table lacks the code; and a
form signed by a temporary credential needs its x-amz-security-token on
the port (minio_tpu reads none); a form that carries a bucket field is
checked against the URL's bucket on the port, as in MinIO, and against
its own field on minio_tpu, which so stores a form signed for one bucket
into another.
"""

import base64
import datetime
import hashlib
import hmac
import http.client
import json

import pytest
import torch

from minio_tpu_torch.api.client import S3Client
from minio_tpu_torch.api.sign import signing_key
from tests.test_torch_compression import _s3server
from tests.test_torch_compression import env  # noqa: F401 - fixture
from tests.test_torch_s3_core import _alike, _record, _tree

torch.set_num_threads(1)

PORT, JAX = "port", "jax"
PKGS = (JAX, PORT)
ACCESS, SECRET = "tpuadmin", "tpuadmin-secret-key"
BUCKET = "postbkt"


def _fields(c: S3Client, key_cond, extra_conds=None, expire_s=600,
            secret: str | None = None) -> dict:
    """tests/test_post_policy.py's _policy_fields through the client: a
    policy of the bucket, `key_cond`, the credential and `extra_conds`,
    signed with `secret` (the client's own when None)."""
    signer = c if secret is None else S3Client(c.endpoint, c.access_key,
                                               secret)
    return signer.post_policy_fields(BUCKET, [key_cond] + list(
        extra_conds or []), expire_s=expire_s)


def _signed(c: S3Client, doc: dict) -> dict:
    """A hand-made policy document signed with the client's secret."""
    p64 = base64.b64encode(json.dumps(doc).encode()).decode()
    date = datetime.datetime.now(datetime.timezone.utc).strftime("%Y%m%d")
    cred = f"{c.access_key}/{date}/us-east-1/s3/aws4_request"
    sig = hmac.new(signing_key(c.secret_key, date, "us-east-1"),
                   p64.encode(), hashlib.sha256).hexdigest()
    return {"policy": p64, "x-amz-credential": cred, "x-amz-signature": sig}


def case_upload(post, rec, c):
    assert rec("PUT", f"/{BUCKET}")[0] == 200
    fields = _fields(c, ["starts-with", "$key", "uploads/"])
    fields["key"] = "uploads/${filename}"
    body = b"browser form bytes" * 50
    assert post(fields, body, "photo.jpg")[0] == 204
    st, _, got = rec("GET", f"/{BUCKET}/uploads/photo.jpg")
    assert st == 200 and got == body


def case_201_response(post, rec, c):
    assert rec("PUT", f"/{BUCKET}")[0] == 200
    fields = _fields(c, {"key": "exact.bin"})
    fields.update(key="exact.bin", success_action_status="201")
    st, _, raw = post(fields, b"x" * 100)
    assert st == 201 and b"<Key>exact.bin</Key>" in raw
    assert rec("GET", f"/{BUCKET}/exact.bin")[2] == b"x" * 100


def case_rejects_bad_signature(post, rec, c):
    assert rec("PUT", f"/{BUCKET}")[0] == 200
    fields = _fields(c, {"key": "evil.bin"}, secret="wrong-secret")
    fields["key"] = "evil.bin"
    assert post(fields, b"x")[0] == 403
    assert rec("GET", f"/{BUCKET}/evil.bin")[0] == 404


def case_enforces_conditions(post, rec, c):
    assert rec("PUT", f"/{BUCKET}")[0] == 200
    fields = _fields(c, ["starts-with", "$key", "only/"])
    fields["key"] = "elsewhere/f.bin"
    assert post(fields, b"x")[0] == 403
    fields = _fields(c, {"key": "small.bin"},
                     extra_conds=[["content-length-range", 1, 10]])
    fields["key"] = "small.bin"
    assert post(fields, b"y" * 100)[0] == 400
    fields = _fields(c, {"key": "small.bin"},
                     extra_conds=[["content-length-range", 200, 300]])
    fields["key"] = "small.bin"
    assert post(fields, b"y" * 100)[0] == 400
    fields = _fields(c, {"key": "late.bin"}, expire_s=-5)
    fields["key"] = "late.bin"
    assert post(fields, b"x")[0] == 403
    fields = _fields(c, {"key": "eq.bin"},
                     extra_conds=[["eq", "$content-type", "text/plain"]])
    fields.update(key="eq.bin", **{"content-type": "image/png"})
    assert post(fields, b"x")[0] == 403


def case_rejects_uncovered_fields(post, rec, c):
    assert rec("PUT", f"/{BUCKET}")[0] == 200
    fields = _fields(c, {"key": "covered.bin"})
    fields["key"] = "covered.bin"
    fields["x-amz-meta-mtpu-replication"] = "replica"
    st, _, raw = post(fields, b"x")
    assert st == 403 and b"not covered" in raw


def case_covered_metadata_is_stored(post, rec, c):
    assert rec("PUT", f"/{BUCKET}")[0] == 200
    fields = _fields(c, {"key": "meta.bin"}, extra_conds=[
        ["starts-with", "$x-amz-meta-team", ""],
        {"content-type": "text/plain"}])
    fields.update({"key": "meta.bin", "x-amz-meta-team": "storage",
                   "content-type": "text/plain"})
    assert post(fields, b"with metadata")[0] == 204
    st, h, got = rec("HEAD", f"/{BUCKET}/meta.bin")
    lower = {k.lower(): v for k, v in h.items()}
    assert st == 200 and lower["x-amz-meta-team"] == "storage"


def case_malformed_inputs_are_4xx(post, rec, c):
    assert rec("PUT", f"/{BUCKET}")[0] == 200
    fields = _fields(c, {"key": "a.bin"})
    fields.update(key="a.bin", **{"x-amz-credential": "garbage"})
    assert 400 <= post(fields, b"x")[0] < 500
    naive = _signed(c, {"expiration": "2030-01-01T00:00:00",
                        "conditions": [{"key": "a.bin"}]})
    naive["key"] = "a.bin"
    assert 200 <= post(naive, b"x")[0] < 500
    junk = _signed(c, {"expiration": "2030-01-01T00:00:00Z",
                       "conditions": [[1, 2, 3]]})
    junk["key"] = "a.bin"
    assert 400 <= post(junk, b"x")[0] < 500


def case_unknown_signer(post, rec, c):
    assert rec("PUT", f"/{BUCKET}")[0] == 200
    ghost = S3Client(c.endpoint, "ghost", "ghost-secret")
    fields = _fields(ghost, {"key": "g.bin"})
    fields["key"] = "g.bin"
    st, _, raw = post(fields, b"x")
    assert st == 403 and b"InvalidAccessKeyId" in raw


def case_body_cap(post, rec, c):
    """Declared bodies over the cap are refused before parsing."""
    assert rec("PUT", f"/{BUCKET}")[0] == 200
    conn = http.client.HTTPConnection(c.endpoint, timeout=10)
    try:
        conn.request("POST", f"/{BUCKET}", body=b"", headers={
            "Content-Type": "multipart/form-data; boundary=----cap",
            "Content-Length": str(100 << 20)})
        r = conn.getresponse()
        post.log.append({"status": r.status})
        assert r.status == 400
        r.read()
    finally:
        conn.close()


CASES = {name[len("case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


def _run(pkg: str, root, mp, case, users=()) -> dict:
    clock = _alike(mp)
    srv = _s3server(pkg, root)
    for ak, sk in users:
        srv.iam.add_user(ak, sk)
    log = []
    try:
        c = S3Client(srv.endpoint, ACCESS, SECRET)

        def rec(*args, **kw):
            clock.now += 10 ** 9
            resp = c.request(*args, **kw)
            log.append(_record(resp))
            return resp

        def post(fields, data, filename="upload.bin", client=None):
            clock.now += 10 ** 9
            resp = (client or c).post_form(BUCKET, fields, data, filename)
            log.append(_record(resp))
            return resp

        post.log = log
        case(post, rec, c)
    finally:
        srv.stop()
    return {"log": log, "tree": _tree(root)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_case_on_both_packages(env, tmp_path, name):  # noqa: F811
    runs = {}
    for pkg in PKGS:
        with pytest.MonkeyPatch.context() as mp:
            runs[pkg] = _run(pkg, tmp_path / pkg, mp, CASES[name])
    assert runs[PORT]["log"] == runs[JAX]["log"]
    jax, port = runs[JAX]["tree"], runs[PORT]["tree"]
    assert port.keys() == jax.keys()
    assert [k for k in jax if port[k] != jax[k]] == []


def test_a_users_form_is_authorized_as_the_user(env, tmp_path):  # noqa: F811
    """A user with no policy signs a valid form: the signature holds and
    the IAM refuses s3:PutObject, 403 on both."""
    answers = {}

    def case(post, rec, c):
        assert rec("PUT", f"/{BUCKET}")[0] == 200
        user = S3Client(c.endpoint, "formuser", "formuser-secret")
        fields = _fields(user, {"key": "u.bin"})
        fields["key"] = "u.bin"
        out = [post(fields, b"user bytes", client=user)[0]]
        answers[pkg].append(out)

    for pkg in PKGS:
        answers[pkg] = []
        with pytest.MonkeyPatch.context() as mp:
            _run(pkg, tmp_path / pkg, mp, case,
                 users=[("formuser", "formuser-secret")])
    assert answers[PORT] == answers[JAX] == [[403]]


@pytest.mark.parametrize("case", ["missing_file", "missing_policy",
                                  "not_multipart"])
def test_malformed_post_request(env, tmp_path, case):  # noqa: F811
    """A form the server cannot read: MalformedPOSTRequest (400) on the
    port, as MinIO answers; minio_tpu raises the same code, which its
    error table lacks, so it answers 500 InternalError."""
    answers = {}

    def run(post, rec, c):
        assert rec("PUT", f"/{BUCKET}")[0] == 200
        if case == "missing_policy":
            st, _, body = post({"key": "m.bin"}, b"x")
        else:
            if case == "missing_file":
                boundary = "----nofile"
                body = (f"--{boundary}\r\nContent-Disposition: form-data; "
                        f'name="key"\r\n\r\nk.bin\r\n--{boundary}--\r\n'
                        ).encode()
                ctype = f"multipart/form-data; boundary={boundary}"
            else:
                body, ctype = b"plain text", "multipart/form-data"
            conn = http.client.HTTPConnection(c.endpoint, timeout=10)
            try:
                conn.request("POST", f"/{BUCKET}", body=body, headers={
                    "Content-Type": ctype,
                    "Content-Length": str(len(body))})
                r = conn.getresponse()
                st, body = r.status, r.read()
            finally:
                conn.close()
        code = body.split(b"<Code>")[1].split(b"</Code>")[0] \
            if b"<Code>" in body else b""
        answers[pkg] = (st, code)

    for pkg in PKGS:
        with pytest.MonkeyPatch.context() as mp:
            _run(pkg, tmp_path / pkg, mp, run)
    assert answers[JAX] == (500, b"InternalError")
    assert answers[PORT] == (400, b"MalformedPOSTRequest")


@pytest.mark.parametrize("with_token", [False, True])
def test_temporary_signer_needs_its_token(env, tmp_path,  # noqa: F811
                                          with_token):
    """A form signed by an STS credential of the root's: minio_tpu takes
    it without its x-amz-security-token (204); the port answers 403
    InvalidTokenId, as a signed request without it; with the token both
    store the object."""
    answers = {}

    def run(post, rec, c):
        assert rec("PUT", f"/{BUCKET}")[0] == 200
        st, _, body = c.sts({"Action": "AssumeRole",
                             "Version": "2011-06-15"})
        assert st == 200
        from minio_tpu_torch.entry import sts_credentials

        got = sts_credentials(body)
        temp = S3Client(c.endpoint, got["AccessKeyId"],
                        got["SecretAccessKey"],
                        session_token=got["SessionToken"] if with_token
                        else "")
        fields = _fields(temp, {"key": "t.bin"})
        fields["key"] = "t.bin"
        resp = temp.post_form(BUCKET, fields, b"temporary")
        code = resp[2].split(b"<Code>")[1].split(b"</Code>")[0] \
            if b"<Code>" in resp[2] else b""
        answers[pkg] = (resp[0], code)

    for pkg in PKGS:
        with pytest.MonkeyPatch.context() as mp:
            _run(pkg, tmp_path / pkg, mp, run)
    if with_token:
        assert answers[PORT] == answers[JAX] == (204, b"")
    else:
        assert answers[JAX] == (204, b"")
        assert answers[PORT] == (403, b"InvalidTokenId")


def test_form_bucket_field_is_the_urls(env, tmp_path):  # noqa: F811
    """A form signed for bucket `signed-bkt`, with bucket=signed-bkt among
    its fields. POSTed there, both store it. POSTed to `other-bkt`,
    minio_tpu checks the form's field and stores the object in
    other-bkt (204); the port checks the URL's bucket, as MinIO does,
    and answers 403 with nothing stored."""
    answers = {}

    def run(post, rec, c):
        for b in ("signed-bkt", "other-bkt"):
            assert rec("PUT", f"/{b}")[0] == 200
        out = []
        for target in ("signed-bkt", "other-bkt"):
            fields = c.post_policy_fields("signed-bkt",
                                          [{"key": "moved.bin"}])
            fields.update(key="moved.bin", bucket="signed-bkt")
            out.append((c.post_form(target, fields, b"signed bytes")[0],
                        rec("GET", f"/{target}/moved.bin")[0]))
        answers[pkg] = out

    for pkg in PKGS:
        with pytest.MonkeyPatch.context() as mp:
            _run(pkg, tmp_path / pkg, mp, run)
    assert answers[JAX] == [(204, 200), (204, 200)]
    assert answers[PORT] == [(204, 200), (403, 404)]
