"""AWS Signature V4 and V2 for the S3 front end, the port's copy of
minio_tpu/api/sign.py (MinIO's cmd/signature-v4.go, signature-v2.go and
streaming-signature-v4.go):

- header-based SigV4 verification (Authorization: AWS4-HMAC-SHA256 ...)
- presigned-URL SigV4 (X-Amz-* query parameters, expiry window)
- streaming SigV4: aws-chunked payloads with per-chunk signatures
- legacy SigV2 header verification

The same primitives sign outbound requests: the smoke run's client and
the tests use them.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import urllib.parse

SIGN_V4_ALGORITHM = "AWS4-HMAC-SHA256"
STREAMING_CONTENT_SHA256 = "STREAMING-AWS4-HMAC-SHA256-PAYLOAD"
UNSIGNED_PAYLOAD = "UNSIGNED-PAYLOAD"
EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()
MAX_SKEW_SECONDS = 15 * 60
PRESIGN_MAX_EXPIRES = 7 * 24 * 3600


class SignError(Exception):
    """Signature verification failure; .code maps to an S3 APIError."""

    def __init__(self, code: str, message: str = ""):
        super().__init__(message or code)
        self.code = code


def _hmac(key: bytes, msg: bytes) -> bytes:
    return hmac.new(key, msg, hashlib.sha256).digest()


def signing_key(secret: str, date: str, region: str, service: str = "s3") -> bytes:
    k = _hmac(("AWS4" + secret).encode(), date.encode())
    k = _hmac(k, region.encode())
    k = _hmac(k, service.encode())
    return _hmac(k, b"aws4_request")


def uri_encode(s: str, encode_slash: bool = True) -> str:
    safe = "-._~" if encode_slash else "-._~/"
    return urllib.parse.quote(s, safe=safe)


def canonical_query(params: list[tuple[str, str]]) -> str:
    enc = sorted(
        (uri_encode(k), uri_encode(v)) for k, v in params
    )
    return "&".join(f"{k}={v}" for k, v in enc)


def canonical_request(method: str, path: str, query: list[tuple[str, str]],
                      headers: dict[str, str], signed_headers: list[str],
                      payload_hash: str) -> str:
    lower = {k.lower(): v for k, v in headers.items()}
    canon_headers = "".join(
        f"{h}:{' '.join(lower.get(h, '').split())}\n" for h in signed_headers
    )
    return "\n".join([
        method.upper(),
        uri_encode(path, encode_slash=False) or "/",
        canonical_query(query),
        canon_headers,
        ";".join(signed_headers),
        payload_hash,
    ])


def string_to_sign(amz_date: str, scope: str, canon_req: str) -> str:
    return "\n".join([
        SIGN_V4_ALGORITHM,
        amz_date,
        scope,
        hashlib.sha256(canon_req.encode()).hexdigest(),
    ])


def _parse_amz_date(s: str) -> datetime.datetime:
    try:
        return datetime.datetime.strptime(s, "%Y%m%dT%H%M%SZ").replace(
            tzinfo=datetime.timezone.utc
        )
    except ValueError as exc:
        raise SignError("MalformedDate", str(exc)) from exc


class V4Credential:
    """Parsed Credential= scope element of an Authorization header."""

    def __init__(self, raw: str):
        parts = raw.split("/")
        if len(parts) != 5:
            raise SignError("CredMalformed", f"bad credential scope: {raw!r}")
        self.access_key, self.date, self.region, self.service, terminal = parts
        if terminal != "aws4_request":
            raise SignError("CredMalformed", "scope must end aws4_request")
        if self.service not in ("s3", "sts"):
            raise SignError("InvalidServiceS3", self.service)

    @property
    def scope(self) -> str:
        return f"{self.date}/{self.region}/{self.service}/aws4_request"


def parse_v4_auth_header(value: str) -> tuple[V4Credential, list[str], str]:
    """Parse 'AWS4-HMAC-SHA256 Credential=..., SignedHeaders=..., Signature=...'."""
    if not value.startswith(SIGN_V4_ALGORITHM):
        raise SignError("SignatureVersionNotSupported", value[:32])
    fields = {}
    for item in value[len(SIGN_V4_ALGORITHM):].split(","):
        item = item.strip()
        if "=" not in item:
            raise SignError("AuthHeaderMalformed", item)
        k, v = item.split("=", 1)
        fields[k.strip()] = v.strip()
    try:
        cred = V4Credential(fields["Credential"])
        signed = fields["SignedHeaders"].split(";")
        signature = fields["Signature"]
    except KeyError as exc:
        raise SignError("AuthHeaderMalformed", str(exc)) from exc
    return cred, signed, signature


def compute_v4_signature(secret: str, method: str, path: str,
                         query: list[tuple[str, str]], headers: dict,
                         signed_headers: list[str], payload_hash: str,
                         amz_date: str, cred: V4Credential) -> str:
    canon = canonical_request(
        method, path, query, headers, signed_headers, payload_hash
    )
    sts = string_to_sign(amz_date, cred.scope, canon)
    key = signing_key(secret, cred.date, cred.region, cred.service)
    return hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()


def verify_v4_header(secret: str, method: str, path: str,
                     query: list[tuple[str, str]], headers: dict,
                     now: datetime.datetime | None = None) -> V4Credential:
    """Verify a header-signed SigV4 request. Returns the parsed credential.

    Caller resolves the access key -> secret before calling (IAM lookup).
    """
    auth = headers.get("Authorization") or headers.get("authorization") or ""
    cred, signed, given_sig = parse_v4_auth_header(auth)
    lower = {k.lower(): v for k, v in headers.items()}
    if "host" not in signed:
        raise SignError("UnsignedHeaders", "host must be signed")
    amz_date = lower.get("x-amz-date") or lower.get("date") or ""
    if not amz_date:
        raise SignError("MissingDateHeader")
    ts = _parse_amz_date(amz_date)
    now = now or datetime.datetime.now(datetime.timezone.utc)
    if abs((now - ts).total_seconds()) > MAX_SKEW_SECONDS:
        raise SignError("RequestTimeTooSkewed")
    if ts.strftime("%Y%m%d") != cred.date:
        raise SignError("AuthHeaderMalformed", "credential date mismatch")
    payload_hash = lower.get("x-amz-content-sha256")
    if payload_hash is None:
        # Header-signed V4 must declare the payload hash; silently
        # treating it as UNSIGNED-PAYLOAD would unbind the body from the
        # signature (ref cmd/signature-v4.go getContentSha256Cksum).
        raise SignError("XAmzContentSHA256Mismatch",
                        "missing x-amz-content-sha256")
    want = compute_v4_signature(
        secret, method, path, query, headers, signed, payload_hash,
        amz_date, cred,
    )
    if not hmac.compare_digest(want, given_sig):
        raise SignError("SignatureDoesNotMatch")
    return cred


def verify_v4_presigned(secret: str, method: str, path: str,
                        query: list[tuple[str, str]], headers: dict,
                        now: datetime.datetime | None = None) -> V4Credential:
    """Verify a presigned-URL SigV4 request (X-Amz-* query params)."""
    q = dict(query)
    try:
        if q["X-Amz-Algorithm"] != SIGN_V4_ALGORITHM:
            raise SignError("SignatureVersionNotSupported")
        cred = V4Credential(q["X-Amz-Credential"])
        amz_date = q["X-Amz-Date"]
        expires = int(q["X-Amz-Expires"])
        signed = q["X-Amz-SignedHeaders"].split(";")
        given_sig = q["X-Amz-Signature"]
    except KeyError as exc:
        raise SignError("InvalidQueryParams", str(exc)) from exc
    except ValueError as exc:
        raise SignError("MalformedExpires", str(exc)) from exc
    if expires < 0:
        raise SignError("NegativeExpires")
    if expires > PRESIGN_MAX_EXPIRES:
        raise SignError("MaximumExpires")
    ts = _parse_amz_date(amz_date)
    now = now or datetime.datetime.now(datetime.timezone.utc)
    if (now - ts).total_seconds() > expires:
        raise SignError("ExpiredPresignRequest")
    if (ts - now).total_seconds() > MAX_SKEW_SECONDS:
        raise SignError("RequestNotReadyYet")
    base_query = [(k, v) for k, v in query if k != "X-Amz-Signature"]
    payload_hash = dict(query).get("X-Amz-Content-Sha256", UNSIGNED_PAYLOAD)
    want = compute_v4_signature(
        secret, method, path, base_query, headers, signed, payload_hash,
        amz_date, cred,
    )
    if not hmac.compare_digest(want, given_sig):
        raise SignError("SignatureDoesNotMatch")
    return cred


def presign_v4(secret: str, access_key: str, method: str, host: str,
               path: str, region: str = "us-east-1", expires: int = 604800,
               extra_query: list[tuple[str, str]] | None = None,
               now: datetime.datetime | None = None) -> str:
    """Generate a presigned URL query string (client side / tests)."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    cred = V4Credential(f"{access_key}/{now.strftime('%Y%m%d')}/{region}/s3/aws4_request")
    query = [
        ("X-Amz-Algorithm", SIGN_V4_ALGORITHM),
        ("X-Amz-Credential", f"{access_key}/{cred.scope}"),
        ("X-Amz-Date", amz_date),
        ("X-Amz-Expires", str(expires)),
        ("X-Amz-SignedHeaders", "host"),
    ] + (extra_query or [])
    sig = compute_v4_signature(
        secret, method, path, query, {"Host": host}, ["host"],
        UNSIGNED_PAYLOAD, amz_date, cred,
    )
    query.append(("X-Amz-Signature", sig))
    return urllib.parse.urlencode(query)


def sign_v4_request(secret: str, access_key: str, method: str, host: str,
                    path: str, query: list[tuple[str, str]] | None = None,
                    headers: dict | None = None, payload: bytes = b"",
                    region: str = "us-east-1",
                    now: datetime.datetime | None = None,
                    payload_hash: str | None = None) -> dict:
    """Sign a request with SigV4 headers; returns the full header dict
    (client side — used by tests and the storage-REST client).
    `payload_hash` lets callers stream file-like bodies: pass the
    precomputed hex sha256 instead of the materialized bytes."""
    query = query or []
    headers = dict(headers or {})
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    if payload_hash is None:
        payload_hash = hashlib.sha256(payload).hexdigest()
    headers.setdefault("Host", host)
    headers["X-Amz-Date"] = amz_date
    headers["X-Amz-Content-Sha256"] = payload_hash
    signed = sorted(
        {"host", "x-amz-date", "x-amz-content-sha256"}
        | {k.lower() for k in headers if k.lower().startswith("x-amz-")}
    )
    cred = V4Credential(
        f"{access_key}/{now.strftime('%Y%m%d')}/{region}/s3/aws4_request"
    )
    sig = compute_v4_signature(
        secret, method, path, query, headers, signed, payload_hash,
        amz_date, cred,
    )
    headers["Authorization"] = (
        f"{SIGN_V4_ALGORITHM} Credential={access_key}/{cred.scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={sig}"
    )
    return headers


# --- streaming aws-chunked (SigV4) ---

class ChunkedReader:
    """Decode an aws-chunked body, verifying each chunk signature against
    the seed signature from the Authorization header (the reference's
    newSignV4ChunkedReader, cmd/streaming-signature-v4.go:449)."""

    def __init__(self, raw, secret: str, cred: V4Credential, amz_date: str,
                 seed_signature: str):
        self._raw = raw
        self._key = signing_key(secret, cred.date, cred.region, cred.service)
        self._scope = cred.scope
        self._amz_date = amz_date
        self._prev_sig = seed_signature
        # Decoded bytes not yet handed out are self._buf[self._pos:].
        self._buf = bytearray()
        self._pos = 0
        self._eof = False

    def _read_line(self) -> bytes:
        line = b""
        while not line.endswith(b"\r\n"):
            c = self._raw.read(1)
            if not c:
                raise SignError("IncompleteBody", "truncated chunk header")
            line += c
            if len(line) > 1024:
                raise SignError("MalformedChunkedEncoding", "header too long")
        return line[:-2]

    def _chunk_string_to_sign(self, chunk) -> str:
        return "\n".join([
            "AWS4-HMAC-SHA256-PAYLOAD",
            self._amz_date,
            self._scope,
            self._prev_sig,
            EMPTY_SHA256,
            hashlib.sha256(chunk).hexdigest(),
        ])

    def _next_chunk(self) -> bytearray:
        header = self._read_line().decode("ascii", "replace")
        if ";chunk-signature=" not in header:
            raise SignError("MalformedChunkedEncoding", header[:64])
        size_hex, sig = header.split(";chunk-signature=", 1)
        try:
            size = int(size_hex, 16)
        except ValueError as exc:
            raise SignError("MalformedChunkedEncoding", size_hex) from exc
        data = bytearray()
        while len(data) < size:
            part = self._raw.read(size - len(data))
            if not part:
                raise SignError("IncompleteBody", "truncated chunk data")
            data += part
        want = hmac.new(
            self._key, self._chunk_string_to_sign(data).encode(),
            hashlib.sha256,
        ).hexdigest()
        if not hmac.compare_digest(want, sig):
            raise SignError("SignatureDoesNotMatch", "chunk signature")
        self._prev_sig = want
        trailer = self._raw.read(2)
        if trailer != b"\r\n":
            raise SignError("MalformedChunkedEncoding", "missing CRLF")
        return data

    def read(self, n: int = -1) -> bytes:
        while not self._eof and (n < 0 or len(self._buf) - self._pos < n):
            chunk = self._next_chunk()
            if not chunk:
                self._eof = True
                break
            del self._buf[:self._pos]
            self._pos = 0
            self._buf += chunk
        avail = len(self._buf) - self._pos
        take = avail if n < 0 else min(n, avail)
        out = bytes(self._buf[self._pos:self._pos + take])
        self._pos += take
        return out


def encode_chunked(payload: bytes, secret: str, cred: V4Credential,
                   amz_date: str, seed_signature: str,
                   chunk_size: int = 64 * 1024) -> bytes:
    """Client-side aws-chunked encoder (tests / internal clients)."""
    key = signing_key(secret, cred.date, cred.region, cred.service)
    prev = seed_signature
    out = bytearray()
    offsets = list(range(0, len(payload), chunk_size)) + [len(payload)]
    chunks = [payload[o:o + chunk_size] for o in range(0, len(payload), chunk_size)]
    chunks.append(b"")
    for chunk in chunks:
        sts = "\n".join([
            "AWS4-HMAC-SHA256-PAYLOAD", amz_date, cred.scope, prev,
            EMPTY_SHA256, hashlib.sha256(chunk).hexdigest(),
        ])
        sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
        out += f"{len(chunk):x};chunk-signature={sig}\r\n".encode()
        out += chunk + b"\r\n"
        prev = sig
    return bytes(out)


# --- legacy SigV2 ---

_V2_SUBRESOURCES = {
    "acl", "delete", "lifecycle", "location", "logging", "notification",
    "partNumber", "policy", "requestPayment", "response-cache-control",
    "response-content-disposition", "response-content-encoding",
    "response-content-language", "response-content-type", "response-expires",
    "retention", "select", "select-type", "tagging", "torrent", "uploadId",
    "uploads", "versionId", "versioning", "versions", "website",
}


def _v2_string_to_sign(method: str, path: str, query: list[tuple[str, str]],
                       headers: dict) -> str:
    lower = {k.lower(): v for k, v in headers.items()}
    amz = sorted(
        (k, v) for k, v in lower.items() if k.startswith("x-amz-")
    )
    canon_amz = "".join(f"{k}:{v}\n" for k, v in amz)
    sub = sorted((k, v) for k, v in query if k in _V2_SUBRESOURCES)
    resource = path
    if sub:
        resource += "?" + "&".join(
            k if v == "" else f"{k}={v}" for k, v in sub
        )
    date = lower.get("date", "") if "x-amz-date" not in lower else ""
    return "\n".join([
        method.upper(),
        lower.get("content-md5", ""),
        lower.get("content-type", ""),
        date,
        canon_amz + resource,
    ])


def sign_v2(secret: str, method: str, path: str,
            query: list[tuple[str, str]], headers: dict) -> str:
    import base64

    sts = _v2_string_to_sign(method, path, query, headers)
    return base64.b64encode(
        hmac.new(secret.encode(), sts.encode(), hashlib.sha1).digest()
    ).decode()


def verify_v2_header(secret: str, method: str, path: str,
                     query: list[tuple[str, str]], headers: dict) -> str:
    auth = headers.get("Authorization") or headers.get("authorization") or ""
    if not auth.startswith("AWS "):
        raise SignError("SignatureVersionNotSupported")
    try:
        access_key, given = auth[4:].split(":", 1)
    except ValueError as exc:
        raise SignError("AuthHeaderMalformed", auth[:32]) from exc
    want = sign_v2(secret, method, path, query, headers)
    if not hmac.compare_digest(want, given):
        raise SignError("SignatureDoesNotMatch")
    return access_key
