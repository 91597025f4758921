"""The port's SigV4 / SigV2 signing and verification (minio_tpu_torch/
api/sign.py) against minio_tpu's, on the CPU. Every comparison is exact:
canonical requests, strings to sign and signatures are equal strings
(hypothesis over paths, queries and headers); the port's verifiers
accept what minio_tpu's signer signs and refuse a tampered request with
the error code minio_tpu's verifier gives; aws-chunked bodies encode to
the same bytes and decode back through either reader.
"""

import datetime
import io

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from minio_tpu.api import sign as jax_sign
from minio_tpu_torch.api import sign

SECRET, ACCESS = "tpu-secret/key+42", "TPUACCESS"
HOST = "127.0.0.1:9000"
NOW = datetime.datetime(2026, 10, 17, 4, 30, tzinfo=datetime.timezone.utc)
AMZ_DATE = NOW.strftime("%Y%m%dT%H%M%SZ")
CRED = f"{ACCESS}/{NOW:%Y%m%d}/us-east-1/s3/aws4_request"

_text = st.text(alphabet=st.characters(min_codepoint=32, max_codepoint=0x2FF,
                                       blacklist_characters="\x7f"),
                max_size=12)
paths = st.lists(_text.filter(lambda s: s not in (".", "..")), min_size=0,
                 max_size=4).map(lambda segs: "/" + "/".join(segs))
queries = st.lists(st.tuples(_text, _text), max_size=4)
header_names = st.sampled_from(["x-amz-meta-a", "x-amz-meta-b",
                                "Content-Type", "x-amz-tagging",
                                "Content-MD5", "x-amz-date"])
headers = st.dictionaries(header_names,
                          st.text(alphabet="abc XYZ 012\t=/+", max_size=10),
                          max_size=4)


def _code(fn) -> str | None:
    try:
        fn()
    except (sign.SignError, jax_sign.SignError) as exc:
        return exc.code
    return None


@settings(max_examples=60, deadline=None)
@given(method=st.sampled_from(["GET", "PUT", "POST", "DELETE", "HEAD"]),
       path=paths, query=queries, hdrs=headers,
       payload=st.binary(max_size=64))
def test_v4_canonical_request_and_signature(method, path, query, hdrs,
                                            payload):
    hdrs = {**hdrs, "Host": HOST}
    signed = sorted({k.lower() for k in hdrs})
    payload_hash = jax_sign.hashlib.sha256(payload).hexdigest()
    canon = sign.canonical_request(method, path, query, hdrs, signed,
                                   payload_hash)
    assert canon == jax_sign.canonical_request(method, path, query, hdrs,
                                               signed, payload_hash)
    cred = sign.V4Credential(CRED)
    sts = sign.string_to_sign(AMZ_DATE, cred.scope, canon)
    assert sts == jax_sign.string_to_sign(AMZ_DATE, cred.scope, canon)
    assert sign.compute_v4_signature(
        SECRET, method, path, query, hdrs, signed, payload_hash, AMZ_DATE,
        cred) == jax_sign.compute_v4_signature(
        SECRET, method, path, query, hdrs, signed, payload_hash, AMZ_DATE,
        jax_sign.V4Credential(CRED))
    assert sign.sign_v4_request(SECRET, ACCESS, method, HOST, path, query,
                                hdrs, payload, now=NOW) == \
        jax_sign.sign_v4_request(SECRET, ACCESS, method, HOST, path, query,
                                 hdrs, payload, now=NOW)


@settings(max_examples=40, deadline=None)
@given(method=st.sampled_from(["GET", "PUT", "HEAD"]), path=paths,
       query=queries, hdrs=headers, payload=st.binary(max_size=64))
def test_v4_header_verifier_takes_minio_tpu_signatures(method, path, query,
                                                       hdrs, payload):
    signed = jax_sign.sign_v4_request(SECRET, ACCESS, method, HOST, path,
                                      query, hdrs, payload, now=NOW)
    cred = sign.verify_v4_header(SECRET, method, path, query, signed,
                                 now=NOW)
    assert (cred.access_key, cred.scope) == (ACCESS,
                                             CRED.split("/", 1)[1])
    for tampered in (
            lambda h: {**h, "X-Amz-Content-Sha256": "0" * 64},
            lambda h: {**h, "Authorization": h["Authorization"][:-1]
                       + ("0" if h["Authorization"][-1] != "0" else "1")},
            lambda h: {**h, "Host": "10.0.0.1:9000"}):
        h = tampered(signed)
        want = _code(lambda: jax_sign.verify_v4_header(
            SECRET, method, path, query, h, now=NOW))
        assert want == "SignatureDoesNotMatch"
        assert _code(lambda: sign.verify_v4_header(
            SECRET, method, path, query, h, now=NOW)) == want
    assert _code(lambda: sign.verify_v4_header(
        "other-secret", method, path, query, signed, now=NOW)) == \
        "SignatureDoesNotMatch"


@pytest.mark.parametrize("case", [
    "skewed", "no_date", "no_payload_hash", "host_unsigned",
    "bad_scope", "not_v4", "no_signature"])
def test_v4_header_refusals_match(case):
    h = jax_sign.sign_v4_request(SECRET, ACCESS, "GET", HOST, "/b/o", [],
                                 {}, b"", now=NOW)
    now = NOW
    if case == "skewed":
        now = NOW + datetime.timedelta(hours=1)
    elif case == "no_date":
        del h["X-Amz-Date"]
    elif case == "no_payload_hash":
        del h["X-Amz-Content-Sha256"]
    elif case == "host_unsigned":
        h["Authorization"] = h["Authorization"].replace(
            "SignedHeaders=host;", "SignedHeaders=")
    elif case == "bad_scope":
        h["Authorization"] = h["Authorization"].replace("/s3/", "/ec2/")
    elif case == "not_v4":
        h["Authorization"] = "AWS4-HMAC-SHA512" + h["Authorization"][16:]
    elif case == "no_signature":
        h["Authorization"] = h["Authorization"].split(", Signature=")[0]
    want = _code(lambda: jax_sign.verify_v4_header(SECRET, "GET", "/b/o",
                                                   [], h, now=now))
    assert want is not None
    assert _code(lambda: sign.verify_v4_header(SECRET, "GET", "/b/o", [], h,
                                               now=now)) == want


@settings(max_examples=30, deadline=None)
@given(path=paths, extra=queries, expires=st.integers(1, 604800))
def test_presigned_v4(path, extra, expires):
    extra = [(k, v) for k, v in extra if not k.startswith("X-Amz-")]
    qs = sign.presign_v4(SECRET, ACCESS, "GET", HOST, path, expires=expires,
                         extra_query=extra, now=NOW)
    assert qs == jax_sign.presign_v4(SECRET, ACCESS, "GET", HOST, path,
                                     expires=expires, extra_query=extra,
                                     now=NOW)
    query = sign.urllib.parse.parse_qsl(qs, keep_blank_values=True)
    hdrs = {"Host": HOST}
    sign.verify_v4_presigned(SECRET, "GET", path, query, hdrs, now=NOW)
    late = NOW + datetime.timedelta(seconds=expires + 1)
    for now, q in ((late, query),
                   (NOW, [(k, v + "0" if k == "X-Amz-Signature" else v)
                          for k, v in query])):
        want = _code(lambda: jax_sign.verify_v4_presigned(
            SECRET, "GET", path, q, hdrs, now=now))
        assert want in ("ExpiredPresignRequest", "SignatureDoesNotMatch")
        assert _code(lambda: sign.verify_v4_presigned(
            SECRET, "GET", path, q, hdrs, now=now)) == want


@settings(max_examples=40, deadline=None)
@given(method=st.sampled_from(["GET", "PUT", "DELETE", "HEAD"]), path=paths,
       query=st.lists(st.tuples(st.sampled_from(
           ["acl", "uploadId", "partNumber", "versionId", "prefix",
            "uploads", "tagging"]), _text), max_size=3),
       hdrs=headers)
def test_v2_signature_and_verifier(method, path, query, hdrs):
    sig = sign.sign_v2(SECRET, method, path, query, hdrs)
    assert sig == jax_sign.sign_v2(SECRET, method, path, query, hdrs)
    signed = {**hdrs, "Authorization": f"AWS {ACCESS}:{sig}"}
    assert sign.verify_v2_header(SECRET, method, path, query, signed) == \
        ACCESS
    bad = {**hdrs, "Authorization": f"AWS {ACCESS}:{sig[:-2]}AA"}
    want = _code(lambda: jax_sign.verify_v2_header(SECRET, method, path,
                                                   query, bad))
    assert _code(lambda: sign.verify_v2_header(SECRET, method, path, query,
                                               bad)) == want


def _seed() -> str:
    hdrs = {"Host": HOST, "X-Amz-Date": AMZ_DATE,
            "X-Amz-Content-Sha256": sign.STREAMING_CONTENT_SHA256}
    return sign.compute_v4_signature(
        SECRET, "PUT", "/b/o", [], hdrs, sorted(k.lower() for k in hdrs),
        sign.STREAMING_CONTENT_SHA256, AMZ_DATE, sign.V4Credential(CRED))


class _Trickle(io.BytesIO):
    """A body that hands out at most 7 bytes a read, as a socket may."""

    def read(self, n=-1):
        return super().read(7 if n is None or n < 0 else min(n, 7))


@settings(max_examples=40, deadline=None)
@given(payload=st.binary(max_size=3000),
       chunk=st.sampled_from([1, 17, 512, 4096]),
       reads=st.lists(st.integers(-1, 900), min_size=1, max_size=8))
def test_aws_chunked_round_trip(payload, chunk, reads):
    seed = _seed()
    body = sign.encode_chunked(payload, SECRET, sign.V4Credential(CRED),
                               AMZ_DATE, seed, chunk_size=chunk)
    assert body == jax_sign.encode_chunked(
        payload, SECRET, jax_sign.V4Credential(CRED), AMZ_DATE, seed,
        chunk_size=chunk)
    reader = sign.ChunkedReader(_Trickle(body), SECRET,
                                sign.V4Credential(CRED), AMZ_DATE, seed)
    got = b""
    for n in reads:
        got += reader.read(n)
    while True:
        part = reader.read(333)
        if not part:
            break
        got += part
    assert got == payload


@pytest.mark.parametrize("fault", ["chunk_data", "chunk_signature",
                                   "truncated", "no_crlf", "seed"])
def test_aws_chunked_refusals_match(fault):
    payload = bytes(range(256)) * 10
    seed = _seed()
    body = bytearray(sign.encode_chunked(payload, SECRET,
                                         sign.V4Credential(CRED), AMZ_DATE,
                                         seed, chunk_size=1000))
    if fault == "chunk_data":
        body[300] ^= 1
    elif fault == "chunk_signature":
        i = body.index(b"chunk-signature=") + 16
        body[i] = ord("0") if body[i] != ord("0") else ord("1")
    elif fault == "truncated":
        body = body[:1500]
    elif fault == "no_crlf":
        i = body.index(b"\r\n", body.index(b"chunk-signature=")) + 2 + 1000
        body[i:i + 2] = b"XX"
    elif fault == "seed":
        seed = "0" * 64

    def read_all(mod):
        reader = mod.ChunkedReader(io.BytesIO(bytes(body)), SECRET,
                                   mod.V4Credential(CRED), AMZ_DATE, seed)
        return reader.read(-1)

    want = _code(lambda: read_all(jax_sign))
    assert want is not None
    assert _code(lambda: read_all(sign)) == want


@pytest.mark.parametrize("value", [
    "AWS4-HMAC-SHA256 Credential=a/20261017/us-east-1/s3/aws4_request, "
    "SignedHeaders=host, Signature=abc",
    "AWS4-HMAC-SHA256 Credential=a/20261017/us-east-1/s3, "
    "SignedHeaders=host, Signature=abc",
    "AWS4-HMAC-SHA256 Credential=a/20261017/us-east-1/s3/aws4_request",
    "AWS4-HMAC-SHA256 garbage",
    "AWS a:b",
])
def test_parse_v4_auth_header(value):
    def parse(mod):
        cred, signed, sig = mod.parse_v4_auth_header(value)
        return cred.access_key, cred.scope, signed, sig

    try:
        want = parse(jax_sign)
    except jax_sign.SignError as exc:
        with pytest.raises(sign.SignError) as got:
            parse(sign)
        assert got.value.code == exc.code
    else:
        assert parse(sign) == want
