"""The S3 HTTP front end, the port's copy of the S3Server of
minio_tpu/api/server.py (MinIO's cmd/http/server.go, the globalHandlers
filters of cmd/routers.go and the router of cmd/api-router.go) as one
dispatch pipeline over a threaded HTTP server: each request is parsed,
checked (reserved metadata and header sizes, SSE-C over plain HTTP
unless MTPU_ALLOW_INSECURE_SSEC is set, the body cap, reserved buckets,
object names, upload ids), routed,
authenticated and authorized, and its body is wrapped in the verifier
its signature asks for (aws-chunked decoding, or x-amz-content-sha256),
before the handler runs. The handler, and the body it streams, run
under the caller's admission identity, the request's op class and its
span trace (observability/spans.py), which a streamed body resumes.
With a metrics registry, each request feeds minio_tpu's request series:
in flight, latency to the response's head, rx and tx bytes, requests and
responses by API and status, errors by code, auth failures.

The routes of the slice are the bucket calls, versioning, bucket policy
and tagging, the canned bucket answers and ACLs, ListObjects v1 and v2,
ListObjectVersions, Put/Copy/Get/Head/DeleteObject with server-side
encryption, the bucket's ?encryption, ?lifecycle and ?object-lock
documents, an object's ?retention and ?legal-hold, DeleteObjects, object
tagging, the multipart calls with UploadPartCopy, the admin heal, usage,
KMS, ioflow, metrics, slow-requests and bucket quota routes, the
health probes
/minio/health/{live,ready,cluster} (unauthenticated) and the Prometheus
scrapes /minio/v2/metrics/{cluster,node} and /minio/prometheus/metrics
(SigV4, admin:Prometheus), and the six admin config routes. A copy is
authorized twice: the write on its destination, and s3:GetObject on its
source. The x-amz-bypass-governance-retention header counts only for a
caller who may take s3:BypassGovernanceRetention on the object, as in
MinIO (minio_tpu reads the header alone). Every other route, and the
rest of the /minio/ namespace, answers NotImplemented.

With a ConfigSys, the `api` subsystem sets two things when the server is
built (a change takes a restart, as the set-config-kv answer says): the
request throttle, `requests_max` concurrent data-plane requests (0: no
limit) with a wait of at most `requests_deadline` for a slot before 503
SlowDown, in front of the admission governors (MinIO's maxClients,
cmd/handler-api.go:36-78), and `cors_allow_origin`, the origins the CORS
answers echo (the preflight OPTIONS answered before authentication).
"""

from __future__ import annotations

import hashlib
import io
import os
import re
import sys
import threading
import time
import urllib.parse
import uuid
from fnmatch import fnmatch
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..crypto import sse as ssemod
from ..iam.store import IAMSys
from ..observability import ioflow, spans
from ..pipeline.admission import client_context
from ..utils import parse_duration_s
from ..utils.device import resolve_device
from . import sign
from .admin import ADMIN_PREFIX, AdminHandlers
from .auth import AUTH_STREAMING, authenticate, authorize
from .errors import API_ERRORS, S3Error, error_xml
from .handlers import (
    Response,
    S3ApiHandlers,
    parse_copy_source,
    valid_object_name,
)

# Buckets the S3 data plane never serves: the internal metadata buckets
# and the "minio" route namespace (isMinioReservedBucket).
_RESERVED_BUCKETS = {"minio", ".minio.sys", ".mtpu.sys"}

# Upload ids are UUIDs the server made; anything else is corrupt or a
# path-traversal attempt (the id names a directory on every disk).
_SAFE_UPLOAD_ID = re.compile(r"[A-Za-z0-9][A-Za-z0-9._-]{0,127}")

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()

# S3 action names of the routes (pkg/iam/policy/action.go); a PUT, POST
# or DELETE of a bucket configuration takes its mutating action.
_ACTIONS = {
    "listen_notification": "s3:ListenBucketNotification",
    "get_object_tagging": "s3:GetObjectTagging",
    "put_object_tagging": "s3:PutObjectTagging",
    "delete_object_tagging": "s3:DeleteObjectTagging",
    "get_acl": "s3:GetBucketAcl",
    "put_acl": "s3:PutBucketAcl",
    "get_object_acl": "s3:GetObjectAcl",
    "put_object_acl": "s3:PutObjectAcl",
    "list_buckets": "s3:ListAllMyBuckets",
    "make_bucket": "s3:CreateBucket",
    "head_bucket": "s3:ListBucket",
    "delete_bucket": "s3:DeleteBucket",
    "get_bucket_location": "s3:GetBucketLocation",
    "list_objects_v1": "s3:ListBucket",
    "list_objects_v2": "s3:ListBucket",
    "list_object_versions": "s3:ListBucketVersions",
    "delete_multiple_objects": "s3:DeleteObject",
    "put_bucket_policy": "s3:PutBucketPolicy",
    "get_bucket_policy": "s3:GetBucketPolicy",
    "delete_bucket_policy": "s3:DeleteBucketPolicy",
    "bucket_versioning": "s3:GetBucketVersioning",
    "bucket_tagging": "s3:GetBucketTagging",
    "bucket_lifecycle": "s3:GetLifecycleConfiguration",
    "bucket_encryption": "s3:GetEncryptionConfiguration",
    "bucket_object_lock": "s3:GetBucketObjectLockConfiguration",
    "bucket_replication": "s3:GetReplicationConfiguration",
    "bucket_notification": "s3:GetBucketNotification",
    "put_object": "s3:PutObject",
    "get_object": "s3:GetObject",
    "object_retention": "s3:GetObjectRetention",
    "object_legal_hold": "s3:GetObjectLegalHold",
    "select_object_content": "s3:GetObject",
    "restore_object": "s3:RestoreObject",
    "head_object": "s3:GetObject",
    "delete_object": "s3:DeleteObject",
    "new_multipart_upload": "s3:PutObject",
    "put_object_part": "s3:PutObject",
    "complete_multipart_upload": "s3:PutObject",
    "abort_multipart_upload": "s3:AbortMultipartUpload",
    "list_object_parts": "s3:ListMultipartUploadParts",
    "list_multipart_uploads": "s3:ListBucketMultipartUploads",
}

_MUTATING_SUBRESOURCE_ACTIONS = {
    "bucket_versioning": "s3:PutBucketVersioning",
    "bucket_tagging": "s3:PutBucketTagging",
    "bucket_lifecycle": "s3:PutLifecycleConfiguration",
    "bucket_encryption": "s3:PutEncryptionConfiguration",
    "bucket_object_lock": "s3:PutBucketObjectLockConfiguration",
    "bucket_replication": "s3:PutReplicationConfiguration",
    "bucket_notification": "s3:PutBucketNotification",
    "object_retention": "s3:PutObjectRetention",
    "object_legal_hold": "s3:PutObjectLegalHold",
}

# Routes minio_tpu serves that the port does not yet: answered
# NotImplemented once the request is authenticated and authorized.
_UNPORTED_ROUTES = frozenset({
    "listen_notification", "bucket_replication", "bucket_notification",
    "select_object_content",
})

# The op class of each route, minio_tpu's: the heal pacer counts the disk
# latencies of these classes as foreground.
_OP_CLASSES = {
    "put_object": "put", "post_policy_object": "put",
    "get_object": "get", "head_object": "get",
    "select_object_content": "get", "restore_object": "get",
    "list_objects_v1": "list", "list_objects_v2": "list",
    "list_object_versions": "list", "list_buckets": "list",
    "list_multipart_uploads": "list",
    "new_multipart_upload": "multipart", "put_object_part": "multipart",
    "complete_multipart_upload": "multipart",
    "abort_multipart_upload": "multipart",
    "list_object_parts": "multipart",
}


def op_class(api_name: str) -> str:
    return _OP_CLASSES.get(api_name, "other")


# The Prometheus scrape routes (cmd/metrics-router.go).
_SCRAPE_PATHS = frozenset({"/minio/v2/metrics/cluster",
                           "/minio/v2/metrics/node",
                           "/minio/prometheus/metrics"})

# Error codes counted as auth failures.
_AUTH_FAILURES = frozenset({"AccessDenied", "SignatureDoesNotMatch",
                            "InvalidAccessKeyId"})


# S3 header limits (setRequestHeaderSizeLimitHandler): 8 KiB of headers,
# 2 KiB of user metadata.
_MAX_HEADER_SIZE = 8 * 1024
_MAX_USER_META_SIZE = 2 * 1024
_USER_META_PREFIXES = ("x-amz-meta-", "x-minio-meta-", "x-mtpu-meta-")

# 5 TiB of object plus 64 MiB of form-data headroom (requestMaxBodySize).
_MAX_REQUEST_BODY = 5 * 1024 ** 4 + 64 * 1024 ** 2

# A refused request's unread body up to this size is read and dropped
# before the answer, within _DRAIN_TIMEOUT_S (Go net/http's
# maxPostHandlerReadBytes, which MinIO's server inherits): closing a
# socket with unread bytes sends a reset, which can overtake the answer
# on its way to the client. A longer remainder severs the connection.
_DRAIN_MAX = 256 << 10
_DRAIN_TIMEOUT_S = 1.0

_SSEC_PREFIXES = (ssemod.HDR_SSEC_PREFIX, ssemod.HDR_SSEC_COPY_PREFIX)


def _check_reserved_bucket(bucket: str) -> None:
    if bucket in _RESERVED_BUCKETS or bucket.startswith("."):
        raise S3Error("AccessDenied", f"reserved bucket {bucket!r}")


class LimitedReader:
    """Reads capped at Content-Length: the socket stays open after the
    body, so an unbounded read would wait for the next request."""

    def __init__(self, raw, limit: int):
        self._raw = raw
        self._left = limit

    def read(self, n: int = -1) -> bytes:
        if self._left <= 0:
            return b""
        if n is None or n < 0 or n > self._left:
            n = self._left
        buf = self._raw.read(n)
        self._left -= len(buf)
        return buf


class Sha256VerifyReader:
    """The body checked against the signed x-amz-content-sha256 as it
    streams (pkg/hash/reader.go): at its end a mismatch raises, so the
    object layer aborts before its commit."""

    def __init__(self, raw, want_hex: str, total: int):
        self._raw = raw
        self._want = want_hex.lower()
        self._left = total
        self._h = hashlib.sha256()

    def read(self, n: int = -1) -> bytes:
        buf = self._raw.read(n)
        if buf:
            self._h.update(buf)
            self._left -= len(buf)
        if (not buf or self._left <= 0) and self._want is not None:
            got = self._h.hexdigest()
            want, self._want = self._want, None  # checked once
            if got != want:
                raise S3Error("XAmzContentSHA256Mismatch", got)
        return buf


class _BodyCounter:
    """The innermost body wrapper, counting the wire bytes read: an error
    response closes the connection only when unread body bytes would
    desynchronise it (see _write)."""

    __slots__ = ("_src", "consumed")

    def __init__(self, src):
        self._src = src
        self.consumed = 0

    def read(self, n: int = -1) -> bytes:
        buf = self._src.read(n)
        self.consumed += len(buf)
        return buf


class RequestContext:
    """A parsed request, as the handlers take it."""

    def __init__(self, method: str, path: str,
                 query: list[tuple[str, str]], headers: dict,
                 body_reader, content_length: int | None):
        self.method = method
        self.path = path
        self.query = query
        self.qdict = dict(query)
        self.headers = {k.lower(): v for k, v in headers.items()}
        self.raw_headers = dict(headers)
        self._body_counter = _BodyCounter(body_reader)
        self.body_reader = self._body_counter
        self.content_length = content_length
        # An aws-chunked body's content_length becomes its decoded
        # length; the wire length is what the counter is held to.
        self.wire_length = content_length
        self._body: bytes | None = None
        self.request_id = uuid.uuid4().hex[:16].upper()
        # Whether the caller may bypass GOVERNANCE retention on an object
        # of the bucket; the server sets it once the caller is known.
        self.may_bypass_governance = lambda object_: False
        parts = path.lstrip("/").split("/", 1)
        self.bucket = parts[0] if parts[0] else ""
        self.object = parts[1] if len(parts) > 1 else ""

    @property
    def body(self) -> bytes:
        if self._body is None:
            n = self.content_length if self.content_length is not None \
                else -1
            self._body = self.body_reader.read(n) if n != 0 else b""
        return self._body


def route(ctx: RequestContext) -> str:
    """(method, bucket/object, query) -> the handler's name, minio_tpu's
    decision tree (cmd/api-router.go:143-455)."""
    m, q = ctx.method, ctx.qdict
    if not ctx.bucket:
        if m == "GET":
            return "list_buckets"
        raise S3Error("MethodNotAllowed", "service endpoint")
    _check_rejected_apis(m, q, bool(ctx.object))
    if not ctx.object:
        if m == "GET":
            if "location" in q:
                return "get_bucket_location"
            # Canned answers (cmd/dummy-handlers.go) for SDK probes.
            for sub, op in (("cors", "get_bucket_cors"),
                            ("website", "get_bucket_website"),
                            ("accelerate", "get_bucket_accelerate"),
                            ("requestPayment", "get_bucket_request_payment"),
                            ("logging", "get_bucket_logging"),
                            ("policyStatus", "get_bucket_policy_status")):
                if sub in q:
                    return op
            if "acl" in q:
                return "get_acl"
            if "policy" in q:
                return "get_bucket_policy"
            for sub in ("versioning", "tagging", "lifecycle", "encryption",
                        "object-lock", "replication", "notification"):
                if sub in q:
                    return f"bucket_{sub.replace('-', '_')}"
            if "uploads" in q:
                return "list_multipart_uploads"
            if "versions" in q:
                return "list_object_versions"
            if "events" in q:
                return "listen_notification"
            if q.get("list-type") == "2":
                return "list_objects_v2"
            return "list_objects_v1"
        if m == "PUT":
            if "acl" in q:
                return "put_acl"
            if "policy" in q:
                return "put_bucket_policy"
            for sub in ("versioning", "tagging", "lifecycle", "encryption",
                        "object-lock", "replication", "notification"):
                if sub in q:
                    return f"bucket_{sub.replace('-', '_')}"
            return "make_bucket"
        if m == "HEAD":
            return "head_bucket"
        if m == "DELETE":
            if "policy" in q:
                return "delete_bucket_policy"
            if "website" in q:
                return "delete_bucket_website"
            for sub in ("tagging", "lifecycle", "encryption", "replication"):
                if sub in q:
                    return f"bucket_{sub}"
            return "delete_bucket"
        if m == "POST":
            if "delete" in q:
                return "delete_multiple_objects"
            if ctx.headers.get("content-type", "").startswith(
                    "multipart/form-data"):
                return "post_policy_object"
        raise S3Error("MethodNotAllowed", f"{m} bucket")
    if m == "GET":
        if "uploadId" in q:
            return "list_object_parts"
        if "retention" in q:
            return "object_retention"
        if "legal-hold" in q:
            return "object_legal_hold"
        if "tagging" in q:
            return "get_object_tagging"
        if "acl" in q:
            return "get_object_acl"
        return "get_object"
    if m == "HEAD":
        return "head_object"
    if m == "PUT":
        if "partNumber" in q and "uploadId" in q:
            return "put_object_part"
        if "retention" in q:
            return "object_retention"
        if "legal-hold" in q:
            return "object_legal_hold"
        if "tagging" in q:
            return "put_object_tagging"
        if "acl" in q:
            return "put_object_acl"
        return "put_object"
    if m == "POST":
        if "uploads" in q:
            return "new_multipart_upload"
        if "uploadId" in q:
            return "complete_multipart_upload"
        if "select" in q and q.get("select-type") == "2":
            return "select_object_content"
        if "restore" in q:
            return "restore_object"
        raise S3Error("MethodNotAllowed", f"POST {ctx.object}")
    if m == "DELETE":
        if "uploadId" in q:
            return "abort_multipart_upload"
        if "tagging" in q:
            return "delete_object_tagging"
        return "delete_object"
    raise S3Error("MethodNotAllowed", m)


# S3 APIs minio_tpu refuses up front with NotImplemented
# (rejectUnsupportedAPIs, cmd/api-router.go:87-176); PUT ?acl stays
# served (the canned ACL).
_REJECTED_BUCKET_SUBS = {
    "GET": ("metrics", "publicAccessBlock", "ownershipControls",
            "intelligent-tiering", "analytics"),
    "PUT": ("cors", "metrics", "website", "logging", "accelerate",
            "requestPayment", "publicAccessBlock", "ownershipControls",
            "intelligent-tiering", "analytics"),
    "DELETE": ("cors", "metrics", "logging", "accelerate",
               "requestPayment", "acl", "publicAccessBlock",
               "ownershipControls", "intelligent-tiering", "analytics"),
    "HEAD": ("acl",),
}
_REJECTED_OBJECT_SUBS = {
    "GET": ("torrent",),
    "PUT": ("torrent",),
    "DELETE": ("torrent", "acl"),
}


def _check_rejected_apis(method: str, q: dict, is_object: bool) -> None:
    table = _REJECTED_OBJECT_SUBS if is_object else _REJECTED_BUCKET_SUBS
    for sub in table.get(method, ()):
        if sub in q:
            raise S3Error("NotImplemented", f"{method} ?{sub}")


def _reserved_metadata_check(ctx: RequestContext) -> None:
    """Refuse client-sent internal metadata and oversized headers
    (filterReservedMetadata and the header size limits)."""
    size = usersize = 0
    for k, v in ctx.headers.items():
        if k.startswith(("x-mtpu-internal-", "x-minio-internal-")):
            raise S3Error("AccessDenied", "reserved metadata prefix")
        length = len(k) + len(v)
        size += length
        if k.startswith(_USER_META_PREFIXES):
            usersize += length
        if usersize > _MAX_USER_META_SIZE or size > _MAX_HEADER_SIZE:
            raise S3Error("MetadataTooLarge", "headers exceed S3 limits")


class S3Server:
    """An ObjectLayer bound to a listening threaded HTTP server. `device`
    is the device of the object layer's kernels: it defaults to the card,
    raises when there is none, and must be the object layer's.
    `sse_config` (crypto.sse.SSEConfig, on the same device) holds the
    SSE-S3 master key and the KMS; without it SSE-S3 and SSE-KMS answer
    NotImplemented and the KMS admin routes too. `metrics` (an
    observability.Metrics) receives the request series and serves the
    scrapes; without it a scrape answers an empty body. `config_sys` (a
    config.ConfigSys) backs the admin config routes and gives the
    handlers their compression and storage-class settings and this
    server its throttle and CORS origins; without it the config routes
    answer NotImplemented and the defaults hold. `quota` (a
    bucket.quota.BucketQuotaSys) admits writes under the buckets' hard
    quotas; without it one over a listing walk does. `tier_engine` (a
    tier.TierEngine) serves transitioned objects and ?restore, and
    `tiers` (its tier.TierConfigMgr) backs the admin tier routes;
    without them those answer as the handlers and admin say."""

    def __init__(self, object_layer, iam: IAMSys, bucket_meta,
                 host: str = "127.0.0.1", port: int = 0, device="cuda",
                 sse_config=None, metrics=None, config_sys=None,
                 quota=None, tier_engine=None, tiers=None):
        self.device = resolve_device(device)
        if object_layer.device != self.device:
            raise ValueError(f"the object layer runs on "
                             f"{object_layer.device}, not {self.device}")
        if sse_config is not None and sse_config.device != self.device:
            raise ValueError(f"the SSE config runs on {sse_config.device}, "
                             f"not {self.device}")
        self.handlers = S3ApiHandlers(object_layer, bucket_meta, sse_config,
                                      config_sys=config_sys, quota=quota,
                                      tier_engine=tier_engine)
        # Requests in flight, which a heal sequence yields to.
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self.admin = AdminHandlers(
            object_layer, iam, lambda: self._inflight,
            kms=sse_config.kms if sse_config is not None else None,
            metrics=metrics, config_sys=config_sys, bucket_meta=bucket_meta,
            tiers=tiers)
        self.iam = iam
        self.metrics = metrics
        kvs = config_sys.config.get("api") if config_sys is not None else {}
        self.cors_origin = kvs.get("cors_allow_origin", "*") or "*"
        # The request throttle; its two keys are parsed independently, so
        # a bad deadline never turns off the limit the operator set.
        self._requests_sem = None
        self._requests_deadline_s = 10.0
        try:
            req_max = int(kvs.get("requests_max", "0") or "0")
        except ValueError:
            req_max = 0
        if req_max > 0:
            self._requests_sem = threading.BoundedSemaphore(req_max)
        dl = parse_duration_s(kvs.get("requests_deadline", "10s"))
        if dl is not None:
            self._requests_deadline_s = dl
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _dispatch(self):
                outer._handle(self)

            do_GET = do_PUT = do_POST = do_DELETE = do_HEAD = _dispatch
            do_OPTIONS = _dispatch

        class _Server(ThreadingHTTPServer):
            def handle_error(self, request, client_address):
                # A client that hangs up mid-response is routine.
                if isinstance(sys.exc_info()[1], (ConnectionResetError,
                                                  BrokenPipeError,
                                                  TimeoutError)):
                    return
                super().handle_error(request, client_address)

        self.httpd = _Server((host, port), _Handler)
        self.port = self.httpd.server_address[1]
        self.host = host
        self._thread: threading.Thread | None = None

    # --- lifecycle ---

    def start(self) -> "S3Server":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5)

    @property
    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"

    # --- request pipeline ---

    def _handle(self, h: BaseHTTPRequestHandler) -> None:
        parsed = urllib.parse.urlsplit(h.path)
        query = urllib.parse.parse_qsl(parsed.query, keep_blank_values=True)
        cl_hdr = h.headers.get("Content-Length")
        content_length = int(cl_hdr) if cl_hdr is not None else None
        body_reader = (LimitedReader(h.rfile, content_length)
                       if content_length is not None else io.BytesIO(b""))
        ctx = RequestContext(h.command, urllib.parse.unquote(parsed.path),
                             query, dict(h.headers), body_reader,
                             content_length)
        with self._inflight_lock:
            self._inflight += 1
        try:
            self._respond(h, ctx)
        finally:
            # The throttle's slot covers the request through its written
            # response, and is given back here and nowhere else, so no
            # failure below the dispatch can keep it.
            if getattr(ctx, "held_request_slot", False):
                self._requests_sem.release()
            with self._inflight_lock:
                self._inflight -= 1
            # A deferred trace whose body stream never ran (a client gone
            # before the stream, a HEAD, an error before the first byte)
            # finishes here; resume() is a no-op once the stream did.
            rt = getattr(ctx, "deferred_trace", None)
            if rt is not None and rt.deferred:
                with spans.resume(rt):
                    pass

    def _respond(self, h: BaseHTTPRequestHandler,
                 ctx: RequestContext) -> None:
        t0 = time.monotonic_ns()
        if self.metrics is not None:
            self.metrics.inc_gauge("s3_requests_inflight")
        err_code = ""
        try:
            resp = self._process(ctx)
        except S3Error as exc:
            err_code = exc.api.code
            resp = Response(
                exc.api.status, {"Content-Type": "application/xml"},
                error_xml(exc.api, ctx.path, ctx.request_id, exc.detail))
        except Exception as exc:  # noqa: BLE001 - answered InternalError
            err_code = "InternalError"
            api = API_ERRORS["InternalError"]
            resp = Response(api.status, {"Content-Type": "application/xml"},
                            error_xml(api, ctx.path, ctx.request_id,
                                      str(exc)))
        if self.metrics is not None:
            self._record(ctx, resp, t0, err_code)
        self._write(h, ctx, resp)

    def _record(self, ctx: RequestContext, resp: Response, t0: int,
                err_code: str) -> None:
        """The request's series, once its response exists (before its
        body streams, so s3_request_seconds is the time to the head)."""
        m = self.metrics
        api_name = getattr(ctx, "api_name", "") or "unknown"
        m.inc_gauge("s3_requests_inflight", -1)
        m.observe("s3_request_seconds", (time.monotonic_ns() - t0) / 1e9,
                  api=api_name)
        if ctx.content_length:
            m.inc("s3_rx_bytes_total", ctx.content_length)
        # A streamed body (a GET) has no buffer: its size is the declared
        # Content-Length.
        if resp.body_stream is not None:
            try:
                tx = int(resp.headers.get("Content-Length", "0") or 0)
            except ValueError:
                tx = 0
        else:
            tx = len(resp.body)
        if tx:
            m.inc("s3_tx_bytes_total", tx)
        if err_code:
            m.inc("s3_errors_total", api=api_name, code=err_code)
            if err_code in _AUTH_FAILURES:
                m.inc("s3_auth_failures_total", code=err_code)

    def _cors_allow(self, request_origin: str) -> str | None:
        """The one origin the CORS answers echo: "*" when every origin is
        allowed, else the request's Origin if a pattern of
        cors_allow_origin (comma-separated, wildcards) matches it."""
        conf = self.cors_origin
        if conf == "*":
            return "*"
        if not request_origin:
            return None
        for pat in (o.strip() for o in conf.split(",")):
            if pat and fnmatch(request_origin, pat):
                return request_origin
        return None

    def _process(self, ctx: RequestContext) -> Response:
        if ctx.method == "OPTIONS":
            # The CORS preflight, answered before authentication.
            headers = {"Access-Control-Allow-Methods":
                       "GET, PUT, POST, DELETE, HEAD",
                       "Access-Control-Allow-Headers": "*",
                       "Access-Control-Max-Age": "3600",
                       "Content-Length": "0"}
            allow = self._cors_allow(ctx.headers.get("origin", ""))
            if allow:
                headers["Access-Control-Allow-Origin"] = allow
                if allow != "*":
                    headers["Vary"] = "Origin"
            return Response(200, headers)
        _reserved_metadata_check(ctx)
        # SSE-C over plain HTTP puts the customer's key on the wire
        # (setSSETLSHandler, matching any customer-key header as
        # crypto.SSEC.IsRequested). The port serves no TLS, so SSE-C
        # needs MTPU_ALLOW_INSECURE_SSEC=1, as minio_tpu without TLS: a
        # deployment whose TLS ends at a proxy in front.
        if not os.environ.get("MTPU_ALLOW_INSECURE_SSEC", "") and any(
                k.startswith(_SSEC_PREFIXES) for k in ctx.headers):
            raise S3Error("InsecureSSECustomerRequest", "")
        if ctx.content_length and ctx.content_length > _MAX_REQUEST_BODY:
            raise S3Error("EntityTooLarge", "request body too large")
        # Health probes: unauthenticated, GET and HEAD only
        # (cmd/healthcheck-router.go).
        if ctx.path.startswith("/minio/health/"):
            if ctx.method not in ("GET", "HEAD"):
                raise S3Error("MethodNotAllowed", ctx.method)
            return self._health(ctx)
        # Prometheus scrapes (cmd/metrics-router.go): SigV4 and the
        # admin:Prometheus action.
        if ctx.path in _SCRAPE_PATHS:
            if ctx.method not in ("GET", "HEAD"):
                raise S3Error("MethodNotAllowed", ctx.method)
            auth_result = authenticate(self.iam, ctx.method, ctx.path,
                                       ctx.query, ctx.raw_headers)
            self.admin.authorize(auth_result, "metrics_snapshot")
            return self.admin.metrics_snapshot(ctx)
        if ctx.path.startswith(ADMIN_PREFIX):
            name = self.admin.route(ctx)
            ctx.api_name = f"admin:{name}"
            auth_result = authenticate(self.iam, ctx.method, ctx.path,
                                       ctx.query, ctx.raw_headers)
            if auth_result.auth == AUTH_STREAMING:
                raise S3Error("NotImplemented", "streaming admin request")
            self.admin.authorize(auth_result, name)
            return getattr(self.admin, name)(ctx)
        if ctx.path == "/crossdomain.xml" or ctx.path.startswith("/minio/"):
            # The console and the rest of the minio route namespace.
            raise S3Error("NotImplemented", ctx.path)
        if ctx.method == "POST" and not ctx.bucket:
            raise S3Error("NotImplemented", "STS")
        # One guard for every data-plane route: internal buckets are
        # unreachable, and no handler sees a "." or ".." segment.
        if ctx.bucket:
            _check_reserved_bucket(ctx.bucket)
        if ctx.object and not valid_object_name(ctx.object):
            raise S3Error("InvalidArgument",
                          f"invalid object name {ctx.object!r}")
        upload_id = ctx.qdict.get("uploadId")
        if upload_id is not None and not _SAFE_UPLOAD_ID.fullmatch(upload_id):
            raise S3Error("NoSuchUpload", upload_id[:64])
        name = route(ctx)
        ctx.api_name = name
        if self.metrics is not None:
            self.metrics.inc("s3_requests_total", api=name)
        if self._requests_sem is not None:
            # Held until the response is written (released in _handle),
            # a streamed GET's body included.
            if not self._requests_sem.acquire(
                    timeout=self._requests_deadline_s):
                if self.metrics is not None:
                    self.metrics.inc("s3_requests_rejected_total")
                raise S3Error("SlowDown", "request limit reached")
            ctx.held_request_slot = True
        if name == "post_policy_object":
            # Signed by a form policy, not SigV4: not ported.
            raise S3Error("NotImplemented", name)
        auth_result = authenticate(self.iam, ctx.method, ctx.path, ctx.query,
                                   ctx.raw_headers)
        action = _ACTIONS.get(name, "s3:*")
        if ctx.method in ("PUT", "POST", "DELETE"):
            action = _MUTATING_SUBRESOURCE_ACTIONS.get(name, action)
        bucket_policy = None
        if ctx.bucket:
            bucket_policy = self.handlers.bm.get(ctx.bucket).policy()
        authorize(self.iam, bucket_policy, auth_result, action, ctx.bucket,
                  ctx.object)

        def may_bypass_governance(object_: str) -> bool:
            try:
                authorize(self.iam, bucket_policy, auth_result,
                          "s3:BypassGovernanceRetention", ctx.bucket,
                          object_)
            except S3Error:
                return False
            return True

        ctx.may_bypass_governance = may_bypass_governance
        # A copy reads a second object: s3:GetObject on its source too.
        if name in ("put_object", "put_object_part"):
            copy_source = ctx.headers.get("x-amz-copy-source", "")
            if copy_source:
                sbucket, sobject, _ = parse_copy_source(copy_source)
                _check_reserved_bucket(sbucket)
                authorize(self.iam, self.handlers.bm.get(sbucket).policy(),
                          auth_result, "s3:GetObject", sbucket, sobject)
        if name in _UNPORTED_ROUTES:
            raise S3Error("NotImplemented", name)
        if auth_result.auth == AUTH_STREAMING:
            self._wrap_streaming_body(ctx)
        elif auth_result.content_sha256 not in ("", sign.UNSIGNED_PAYLOAD):
            if ctx.content_length:
                ctx.body_reader = Sha256VerifyReader(
                    ctx.body_reader, auth_result.content_sha256,
                    ctx.content_length)
            elif auth_result.content_sha256.lower() != _EMPTY_SHA256:
                # No body, but the signature promised one.
                raise S3Error("XAmzContentSHA256Mismatch",
                              "empty body, non-empty hash")
        return self._dispatch(name, auth_result.access_key, ctx)

    def _dispatch(self, name: str, access_key: str,
                  ctx: RequestContext) -> Response:
        """Run the handler under the caller's admission identity (the
        access key, else anonymous, and the bucket), the request's op
        tag (with its bucket) and its span trace. A streaming body runs
        after this returns, on the writer's side: the trace is deferred
        and the stream resumes it (spans.resume), which re-enters all
        three, so a GET's decode slot is charged to its caller, its disk
        bytes count under its op class, and its root span covers the
        request through its last byte."""
        rt = spans.request_trace(name, method=ctx.method, path=ctx.path,
                                 request_id=ctx.request_id)
        with client_context(access_key or "anonymous",
                            bucket=ctx.bucket or ""), \
                ioflow.tag(op_class(name), bucket=ctx.bucket or ""), rt:
            resp = getattr(self.handlers, name)(ctx)
            if resp.body_stream is not None:
                rt.defer()
                # The writer may never call the stream (a client gone
                # before the status line, a HEAD): _handle finishes the
                # parked trace then.
                ctx.deferred_trace = rt
                inner = resp.body_stream

                def stream(w):
                    with spans.resume(rt):
                        inner(w)

                resp.body_stream = stream
        if self.metrics is not None:
            self.metrics.inc("s3_responses_total", api=name,
                             status=str(resp.status))
        return resp

    def _health(self, ctx: RequestContext) -> Response:
        """/minio/health/{live,ready,cluster}: live answers while the
        process serves; ready and cluster answer 503 when a set has fewer
        drives online than its write quorum (cmd/healthcheck-router.go,
        ErasureServerPools.health); any other name 404."""
        kind = ctx.path.rsplit("/", 1)[1]
        if kind == "live":
            return Response(200)
        if kind in ("ready", "cluster"):
            return Response(200 if self.handlers.ol.health() else 503)
        return Response(404)

    def _wrap_streaming_body(self, ctx: RequestContext) -> None:
        """The body becomes the verifying aws-chunked decoder, of the
        length x-amz-decoded-content-length declares."""
        cred_scope, _, seed_sig = sign.parse_v4_auth_header(
            ctx.headers.get("authorization", ""))
        secret = self.iam.get_credentials(cred_scope.access_key).secret_key
        decoded_len = ctx.headers.get("x-amz-decoded-content-length")
        if decoded_len is None:
            raise S3Error("MissingContentLength",
                          "x-amz-decoded-content-length")
        ctx.body_reader = sign.ChunkedReader(
            ctx.body_reader, secret, cred_scope,
            ctx.headers.get("x-amz-date", ""), seed_sig)
        ctx.content_length = int(decoded_len)

    @staticmethod
    def _drain(h: BaseHTTPRequestHandler, ctx: RequestContext) -> bool:
        """Read and drop the rest of a refused request's body when it is
        at most _DRAIN_MAX bytes and arrives within _DRAIN_TIMEOUT_S;
        whether the connection can stay open."""
        counter = ctx._body_counter
        if ctx.wire_length - counter.consumed > _DRAIN_MAX:
            return False
        old = h.connection.gettimeout()
        h.connection.settimeout(_DRAIN_TIMEOUT_S)
        try:
            while counter.consumed < ctx.wire_length:
                if not counter.read(ctx.wire_length - counter.consumed):
                    return False
        except OSError:
            return False
        finally:
            h.connection.settimeout(old)
        return True

    def _write(self, h: BaseHTTPRequestHandler, ctx: RequestContext,
               resp: Response) -> None:
        try:
            if (resp.status >= 400 and ctx.wire_length
                    and ctx._body_counter.consumed < ctx.wire_length
                    and not self._drain(h, ctx)):
                # Unread body bytes of a refused request would parse as
                # the next request line: close instead.
                h.close_connection = True
            h.send_response(resp.status)
            headers = dict(resp.headers)
            if h.close_connection:
                headers.setdefault("Connection", "close")
            # Security headers (addSecurityHeaders), CORS, request id.
            headers.setdefault("X-Content-Type-Options", "nosniff")
            headers.setdefault("X-Xss-Protection", "1; mode=block")
            headers.setdefault("Content-Security-Policy",
                               "block-all-mixed-content")
            headers.setdefault("Server", "MinIO-TPU")
            # The browser cache policy of the /minio/ paths
            # (setBrowserCacheControlHandler): versioned assets cache
            # for a year, everything else never.
            if (ctx.method == "GET" and ctx.path.startswith("/minio/")
                    and "Cache-Control" not in headers):
                if (ctx.path.endswith(".js")
                        or ctx.path == "/minio/favicon.ico"):
                    headers["Cache-Control"] = "max-age=31536000"
                else:
                    headers["Cache-Control"] = "no-store"
            allow = self._cors_allow(ctx.headers.get("origin", ""))
            if allow:
                headers.setdefault("Access-Control-Allow-Origin", allow)
                if allow != "*":
                    headers.setdefault("Vary", "Origin")
            headers["x-amz-request-id"] = ctx.request_id
            streaming = resp.body_stream is not None and ctx.method != "HEAD"
            if streaming and "Content-Length" not in headers:
                raise RuntimeError("streaming response needs Content-Length")
            if "Content-Length" not in headers or ctx.method == "HEAD":
                headers["Content-Length"] = headers.get(
                    "Content-Length", str(len(resp.body)))
            for k, v in headers.items():
                h.send_header(k, v)
            h.end_headers()
            if streaming:
                try:
                    resp.body_stream(h.wfile)
                except Exception:  # noqa: BLE001 - the status is sent
                    # The body falls short of its Content-Length: close,
                    # so the client cannot take the stump for the object.
                    h.close_connection = True
            elif resp.body and ctx.method != "HEAD":
                h.wfile.write(resp.body)
        except (BrokenPipeError, ConnectionResetError):
            pass
