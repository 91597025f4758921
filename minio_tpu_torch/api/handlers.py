"""S3 API handlers, the port's copy of the S3ApiHandlers of
minio_tpu/api/handlers.py (MinIO's cmd/bucket-handlers.go,
bucket-listobjects-handlers.go, object-handlers.go, acl-handlers.go and
dummy-handlers.go) on the plain path: the bucket calls, versioning,
bucket policy and tagging, the canned bucket answers and ACLs,
ListObjects v1 and v2, ListObjectVersions, PutObject, CopyObject,
GetObject (whole, ranged, conditional), HeadObject, DeleteObject(s),
object tagging, the multipart calls with UploadPartCopy, server-side
encryption (SSE-S3, SSE-C and SSE-KMS) and compression through
api/transforms.py (PutObject, GetObject whole and ranged, HeadObject,
CopyObject that decodes and re-encodes, and the bucket's ?encryption
document, stored and applied to no PUT, as minio_tpu does), the
`storage_class` setting's parity for REDUCED_REDUNDANCY and STANDARD,
object lock (the bucket's ?object-lock document and its default
retention on PutObject, CopyObject and NewMultipartUpload, the lock
headers, ?retention and ?legal-hold, and retention enforced on the
single DELETE and on DeleteObjects; MinIO's cmd/bucket-object-lock.go),
the hard bucket quota on PutObject, CopyObject (at the source's logical
size) and UploadPart (cmd/bucket-quota.go), the bucket's ?lifecycle
document, validated when written (the scanner applies it), and remote
tiers (cmd/bucket-lifecycle.go): a transitioned object's GET, whole or
ranged, served from its tier through the inversion of the transforms,
the tier's name as its storage class, and POST ?restore.

Each handler takes the parsed request and returns a Response; the
server has checked the signature and the action (a copy's source too)
before. What the port does not serve yet (replication, events) is
refused with NotImplemented, never served half: a bucket with such a
configuration. Two SSE cases that minio_tpu gets wrong are refused too:
an encrypted multipart upload (minio_tpu stores its parts in plaintext)
and an UploadPartCopy from an encrypted source (minio_tpu copies the
ciphertext into the part). An UploadPartCopy from a compressed source,
where minio_tpu copies the compressed bytes into the part, copies the
decoded range, and a copy from a transitioned source with no restored
copy, which minio_tpu reads from the freed shards, answers
InvalidObjectState.
"""

from __future__ import annotations

import base64
import binascii
import datetime
import email
import email.policy
import hashlib
import hmac
import io
import json
import re
import threading
import time
import urllib.parse
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

from .. import tier
from ..bucket import objectlock
from ..bucket.lifecycle import Lifecycle, LifecycleError
from ..bucket.quota import BucketQuotaSys
from ..crypto import sse as ssemod
from ..erasure import registry
from ..iam.policy import Args, Policy
from ..object.types import CompletePart, ObjectOptions
from ..pipeline.admission import client_context, current_client, read_governor
from ..utils.errors import (
    ErrInvalidArgument,
    ErrOperationTimedOut,
    StorageError,
)
from . import sign, transforms
from .auth import check_session_token
from .errors import S3Error, from_object_error

MAX_OBJECT_SIZE = 5 * 1024 ** 4         # 5 TiB
MAX_PART_SIZE = 5 * 1024 ** 3           # 5 GiB
MAX_PARTS = 10000
MAX_DELETE_OBJECTS = 1000
MAX_KEY_LENGTH = 1024

# Bucket configurations whose effect on the data path is not ported: a
# bucket that has one is not served.
_UNPORTED_BUCKET_CONFIG = ("notification_xml", "replication_xml")
# The user metadata that marks an incoming replica.
REPLICA_META = "x-amz-meta-mtpu-replication"
# The prefix of every SSE request header (SSE-S3, SSE-KMS and SSE-C):
# the multipart calls refuse them.
_SSE_HEADER_PREFIX = "x-amz-server-side-encryption"
# A tiered object's stored bytes come back from the tier this much at a
# time.
_TIER_PIECE = 1 << 20


def iso8601(ns: int) -> str:
    dt = datetime.datetime.fromtimestamp(ns / 1e9, datetime.timezone.utc)
    return (dt.strftime("%Y-%m-%dT%H:%M:%S.")
            + f"{dt.microsecond // 1000:03d}Z")


def http_date(ns: int) -> str:
    dt = datetime.datetime.fromtimestamp(ns / 1e9, datetime.timezone.utc)
    return dt.strftime("%a, %d %b %Y %H:%M:%S GMT")


@dataclass
class Response:
    status: int = 200
    headers: dict = field(default_factory=dict)
    body: bytes = b""
    # Streaming: body_stream(dst) writes the body to dst. The headers,
    # Content-Length included, are final before it runs; a failure
    # mid-stream severs the connection (the status line is gone).
    body_stream: object = None

    @classmethod
    def xml(cls, root: ET.Element, status: int = 200,
            headers: dict | None = None) -> "Response":
        body = (b'<?xml version="1.0" encoding="UTF-8"?>\n'
                + ET.tostring(root, encoding="unicode").encode())
        h = {"Content-Type": "application/xml"}
        h.update(headers or {})
        return cls(status, h, body)


def _xml_root(tag: str) -> ET.Element:
    root = ET.Element(tag)
    root.set("xmlns", "http://s3.amazonaws.com/doc/2006-03-01/")
    return root


def valid_bucket_name(bucket: str) -> bool:
    """S3's DNS-compatible bucket names; "minio" is the reserved route
    namespace (minioReservedBucket, cmd/generic-handlers.go)."""
    if bucket == "minio":
        return False
    if not 3 <= len(bucket) <= 63:
        return False
    if bucket.startswith((".", "-")) or bucket.endswith((".", "-")):
        return False
    if ".." in bucket or ".-" in bucket or "-." in bucket:
        return False
    return all(c.islower() or c.isdigit() or c in ".-" for c in bucket)


def valid_object_name(obj: str) -> bool:
    if not obj or len(obj) > MAX_KEY_LENGTH:
        return False
    if obj.startswith("/"):
        return False
    return all(seg not in (".", "..") for seg in obj.split("/"))


# What copies read from their sources: ranged GETs ("pulls") and bytes.
COPY_READS = {"pulls": 0, "bytes": 0}  # guarded-by: _copy_reads_mu
_copy_reads_mu = threading.Lock()


def copy_reads_snapshot() -> dict:
    with _copy_reads_mu:
        return dict(COPY_READS)


class _RangeCopyReader:
    """A source object's range read in pulls of at most 1 MiB, so that a
    copy never holds a whole (up to 5 GiB) part: each pull is a ranged
    GET of the source through the object layer."""

    def __init__(self, ol, bucket, object_, offset, length, opts):
        self._ol = ol
        self._bucket = bucket
        self._object = object_
        self._pos = offset
        self._left = length
        self._opts = opts

    def read(self, n: int = -1) -> bytes:
        if self._left <= 0:
            return b""
        if n is None or n < 0:
            n = self._left
        n = min(n, self._left, 1 << 20)
        data = self._ol.get_object_bytes(
            self._bucket, self._object, offset=self._pos, length=n,
            opts=self._opts)
        self._pos += len(data)
        self._left -= len(data)
        if not data:
            self._left = 0
        with _copy_reads_mu:
            COPY_READS["pulls"] += 1
            COPY_READS["bytes"] += len(data)
        return data


class LimitedSpool:
    """The next `length` bytes of a file-like object."""

    def __init__(self, f, length: int):
        self._f = f
        self._left = length

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0 or n > self._left:
            n = self._left
        out = self._f.read(n)
        self._left -= len(out)
        return out


def parse_copy_source(header: str) -> tuple[str, str, str]:
    """x-amz-copy-source -> (bucket, object, version id). The server
    authorizes the source with it, and the copy handlers read it."""
    # The versionId suffix is split off before percent-decoding: a
    # literal "?" in the key travels as %3F.
    raw, vid = header, ""
    if "?versionId=" in raw:
        raw, _, vid = raw.partition("?versionId=")
    src = urllib.parse.unquote(raw)
    if src.startswith("/"):
        src = src[1:]
    if "/" not in src:
        raise S3Error("InvalidArgument", "bad x-amz-copy-source")
    sbucket, _, sobject = src.partition("/")
    if not sbucket or not valid_object_name(sobject):
        raise S3Error("InvalidArgument", "bad x-amz-copy-source")
    return sbucket, sobject, urllib.parse.unquote(vid)


def _parse_http_date(h: str) -> int | None:
    """RFC 7231 IMF-fixdate -> epoch seconds; None when unparseable."""
    try:
        return int(datetime.datetime.strptime(
            h, "%a, %d %b %Y %H:%M:%S GMT"
        ).replace(tzinfo=datetime.timezone.utc).timestamp())
    except ValueError:
        return None


def _etag_matches(header_value: str, etag: str) -> bool:
    """Whether the header's ETag (quoted, bare or "*") names `etag`."""
    return header_value in (f'"{etag}"', etag, "*")


def parse_range(header: str, size: int) -> tuple[int, int] | None:
    """'bytes=a-b' -> (offset, length); None for the whole object
    (cmd/httprange.go)."""
    if not header:
        return None
    if not header.startswith("bytes="):
        raise S3Error("InvalidRange", header)
    spec = header[len("bytes="):]
    if "," in spec:
        raise S3Error("NotImplemented", "multiple ranges")
    start_s, _, end_s = spec.partition("-")
    try:
        if start_s == "":
            # suffix range: the last N bytes
            n = int(end_s)
            if n <= 0:
                raise S3Error("InvalidRange", header)
            off = max(0, size - n)
            return off, size - off
        start = int(start_s)
        if end_s == "":
            if start >= size:
                raise S3Error("InvalidRange", header)
            return start, size - start
        end = int(end_s)
        if start > end or start >= size:
            raise S3Error("InvalidRange", header)
        end = min(end, size - 1)
        return start, end - start + 1
    except ValueError as exc:
        raise S3Error("InvalidRange", header) from exc


_RESPONSE_OVERRIDES = {
    "response-content-type": "Content-Type",
    "response-content-language": "Content-Language",
    "response-expires": "Expires",
    "response-cache-control": "Cache-Control",
    "response-content-disposition": "Content-Disposition",
    "response-content-encoding": "Content-Encoding",
}

_REMEMBERED_HEADERS = (
    "content-type", "cache-control", "content-disposition",
    "content-encoding", "content-language", "expires",
)


def extract_user_metadata(headers: dict) -> dict:
    """x-amz-meta-* and the standard content headers -> the stored
    metadata (extractMetadata, cmd/utils.go)."""
    meta = {}
    for k, v in headers.items():
        lk = k.lower()
        if lk.startswith("x-amz-meta-"):
            meta[lk] = v
        elif lk in _REMEMBERED_HEADERS:
            meta[lk] = v
        elif lk == "x-amz-storage-class":
            meta["x-amz-storage-class"] = v.upper()
    return meta


def _parse_content_md5(headers: dict) -> str:
    """The Content-MD5 header as hex ("" when absent); malformed base64
    is InvalidDigest."""
    md5_hdr = headers.get("content-md5", "")
    if not md5_hdr:
        return ""
    try:
        raw = base64.b64decode(md5_hdr, validate=True)
    except (binascii.Error, ValueError) as exc:
        raise S3Error("InvalidDigest") from exc
    if len(raw) != 16:
        raise S3Error("InvalidDigest")
    return raw.hex()


class _Sink:
    """A writer whose target is set later: a GET's transform chain is
    built (and its keys checked) before the status line, and bound to
    the socket when the body streams."""

    def __init__(self):
        self.dst = None

    def write(self, data) -> int:
        return self.dst.write(data)


class S3ApiHandlers:
    """The S3 endpoints of the slice, over an ObjectLayer. `sse_config`
    holds the SSE-S3 master key and the KMS (None: SSE-S3 and SSE-KMS
    answer NotImplemented; SSE-C needs none). `config_sys` is the
    server's ConfigSys, whose live config (read at each request, so a
    set or a restore applies at once) gives the compression filters and
    the storage classes' parity (None: no compression, the set's default
    parity for both classes). `quota` is the server's BucketQuotaSys
    (None: one over a listing walk). `tier_engine` is the server's
    tier.TierEngine (None: a transitioned object's GET answers
    InvalidObjectState, ?restore NotImplemented). `iam` is the server's
    IAMSys, which a POST policy's signer and the replica marker's
    s3:ReplicateObject are checked against (None: a form upload answers
    NotImplemented, the marker is refused but under a bucket policy)."""

    # A version's tags live in its metadata, url-encoded (UserTags).
    TAGS_META_KEY = "x-mtpu-internal-tags"
    MAX_TAGS = 10

    def __init__(self, object_layer, bucket_meta, sse_config=None,
                 config_sys=None, quota=None, tier_engine=None, iam=None):
        self.ol = object_layer
        self.iam = iam
        self.bm = bucket_meta
        self.sse_config = sse_config
        self.config_sys = config_sys
        self.quota = quota or BucketQuotaSys(object_layer, bucket_meta)
        self.tier_engine = tier_engine

    @property
    def config(self):
        return self.config_sys.config if self.config_sys is not None \
            else None

    def _opts_for(self, bucket: str, query: dict) -> ObjectOptions:
        bmeta = self.bm.get(bucket)
        for f in _UNPORTED_BUCKET_CONFIG:
            if getattr(bmeta, f):
                raise S3Error("NotImplemented",
                              f"bucket {bucket}: {f} is not ported")
        # versionId "null" stays the literal, so that the object layer
        # sees a targeted request (a delete of the null version removes
        # it instead of writing a marker); the journal maps it to "".
        return ObjectOptions(version_id=query.get("versionId", ""),
                             versioned=bmeta.versioning_enabled,
                             version_suspended=bmeta.versioning_suspended)

    # ---------- object lock (cmd/bucket-object-lock.go) ----------

    def _lock_config(self, bucket: str):
        xml_text = self.bm.get(bucket).object_lock_xml
        if not xml_text:
            return None
        try:
            return objectlock.LockConfig.parse(xml_text)
        except Exception:  # noqa: BLE001 - a bad config never blocks IO
            return None

    def _apply_object_lock(self, ctx, opts) -> None:
        """The x-amz-object-lock-* headers of a new write, checked, or
        else the bucket's default retention, into its metadata
        (ParseObjectLockHeaders and PutObjectHandler's default)."""
        try:
            explicit = objectlock.extract_lock_headers(ctx.headers)
        except ValueError as exc:
            raise S3Error("InvalidArgument", str(exc)) from exc
        cfg = self._lock_config(ctx.bucket)
        if explicit:
            if cfg is None or not cfg.enabled:
                raise S3Error("InvalidRequest",
                              "Bucket is missing ObjectLockConfiguration")
            opts.user_defined.update(explicit)
        elif cfg is not None:
            opts.user_defined.update(cfg.default_retention_meta())

    @staticmethod
    def _bypass_governance(ctx, object_: str) -> bool:
        """The bypass header, honoured only for a caller the server
        allows s3:BypassGovernanceRetention on the object (MinIO's
        enforceRetentionBypassForDelete; minio_tpu reads the header
        alone)."""
        return (ctx.headers.get(objectlock.HDR_BYPASS_GOVERNANCE,
                                "").lower() == "true"
                and ctx.may_bypass_governance(object_))

    def _enforce_retention(self, ctx, bucket: str, object_: str,
                           version_id: str) -> None:
        """Refuse to delete a retained or held version
        (enforceRetentionBypassForDelete)."""
        try:
            oi = self.ol.get_object_info(
                bucket, object_, ObjectOptions(version_id=version_id,
                                               versioned=bool(version_id)))
        except StorageError:
            return  # missing, or a marker: nothing to retain
        reason = objectlock.check_deletable(
            oi.user_defined, self._bypass_governance(ctx, object_))
        if reason is not None:
            raise S3Error("AccessDenied", reason)

    def _enforce_delete_retention(self, ctx, opts, object_: str,
                                  vid: str) -> None:
        """A delete by version id destroys that version, and an untargeted
        one in an unversioned bucket the only copy: both are held to the
        retention. An untargeted versioned delete writes a marker."""
        if vid:
            self._enforce_retention(ctx, ctx.bucket, object_, vid)
        elif not opts.versioned:
            self._enforce_retention(ctx, ctx.bucket, object_, "")

    def _lock_target_info(self, ctx):
        opts = ObjectOptions(
            version_id=ctx.qdict.get("versionId", ""),
            versioned=self.bm.get(ctx.bucket).versioning_enabled)
        try:
            return self.ol.get_object_info(ctx.bucket, ctx.object, opts)
        except StorageError as exc:
            raise from_object_error(exc) from exc

    def _check_quota(self, bucket: str, size: int) -> None:
        try:
            self.quota.check(bucket, size)
        except StorageError as exc:
            raise from_object_error(exc) from exc

    def _validate_tags(self, tags: list[tuple[str, str]]) -> None:
        """The one rule set of both tag writes (the ?tagging XML and the
        x-amz-tagging header)."""
        if len(tags) > self.MAX_TAGS:
            raise S3Error("InvalidTag", f"more than {self.MAX_TAGS} tags")
        if len({k for k, _ in tags}) != len(tags):
            raise S3Error("InvalidTag", "duplicate tag keys")
        for k, v in tags:
            if not k or len(k) > 128 or len(v) > 256:
                raise S3Error("InvalidTag", f"bad tag {k!r}")

    def _apply_tagging_header(self, ctx, opts) -> None:
        """x-amz-tagging on a write: url-encoded tags, checked as the
        ?tagging subresource checks them and stored normalised."""
        tag_hdr = ctx.headers.get("x-amz-tagging", "")
        if tag_hdr:
            tags = urllib.parse.parse_qsl(tag_hdr, keep_blank_values=True)
            self._validate_tags(tags)
            opts.user_defined[self.TAGS_META_KEY] = \
                urllib.parse.urlencode(tags)

    def _apply_storage_class(self, ctx, opts) -> None:
        """x-amz-storage-class: STANDARD or REDUCED_REDUNDANCY, each the
        parity of the storage_class setting's `standard` or `rrs` spec
        ("EC:n"; an empty one keeps the set's default), as
        cmd/erasure-object.go:611-618 applies it."""
        sc = ctx.headers.get("x-amz-storage-class", "").upper()
        if not sc:
            return
        if sc not in ("STANDARD", "REDUCED_REDUNDANCY"):
            raise S3Error("InvalidStorageClass", sc)
        config = self.config
        if config is None:
            return
        spec = config.get("storage_class").get(
            "rrs" if sc == "REDUCED_REDUNDANCY" else "standard", "") or ""
        if spec.upper().startswith("EC:"):
            try:
                opts.parity = int(spec[3:])
            except ValueError as exc:
                raise S3Error("InvalidArgument",
                              f"bad storage class spec {spec!r}") from exc

    @staticmethod
    def _apply_codec(ctx, opts) -> None:
        """x-mtpu-codec: the request's erasure codec id, the top of
        registry.select_codec's order. An unknown id is refused before a
        byte streams; "auto" turns auto-selection back on even where
        MTPU_CODEC forces a codec for the whole server."""
        cid = ctx.headers.get("x-mtpu-codec", "")
        if not cid:
            return
        if cid != "auto" and cid not in registry.codec_ids():
            raise S3Error(
                "InvalidArgument",
                f"unknown erasure codec {cid!r} "
                f"(registered: {sorted(registry.codec_ids())} or auto)")
        opts.codec = cid

    # ---------- service ----------

    def list_buckets(self, ctx) -> Response:
        root = _xml_root("ListAllMyBucketsResult")
        owner = ET.SubElement(root, "Owner")
        ET.SubElement(owner, "ID").text = "minio-tpu"
        ET.SubElement(owner, "DisplayName").text = "minio-tpu"
        buckets = ET.SubElement(root, "Buckets")
        for b in self.ol.list_buckets():
            if b.name.startswith("."):  # the system buckets
                continue
            be = ET.SubElement(buckets, "Bucket")
            ET.SubElement(be, "Name").text = b.name
            ET.SubElement(be, "CreationDate").text = iso8601(b.created_ns)
        return Response.xml(root)

    # ---------- bucket ----------

    def make_bucket(self, ctx) -> Response:
        if not valid_bucket_name(ctx.bucket):
            raise S3Error("InvalidBucketName", ctx.bucket)
        try:
            self.ol.make_bucket(ctx.bucket)
        except StorageError as exc:
            raise from_object_error(exc) from exc
        return Response(200, {"Location": "/" + ctx.bucket})

    def head_bucket(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        return Response(200)

    def delete_bucket(self, ctx) -> Response:
        force = ctx.headers.get("x-minio-force-delete", "") == "true"
        try:
            self.ol.delete_bucket(ctx.bucket, force=force)
        except StorageError as exc:
            raise from_object_error(exc) from exc
        self.bm.delete(ctx.bucket)
        return Response(204)

    def get_bucket_location(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        root = _xml_root("LocationConstraint")
        root.text = ""  # us-east-1 is the empty constraint
        return Response.xml(root)

    def _check_bucket(self, bucket: str) -> None:
        if not self.ol.bucket_exists(bucket):
            raise S3Error("NoSuchBucket", bucket)

    # --- canned bucket subresources (cmd/dummy-handlers.go): S3-shaped
    # answers for SDK feature probes ---

    def get_bucket_cors(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        raise S3Error("NoSuchCORSConfiguration", ctx.bucket)

    def get_bucket_website(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        raise S3Error("NoSuchWebsiteConfiguration", ctx.bucket)

    def delete_bucket_website(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        return Response(200)

    def get_bucket_accelerate(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        return Response.xml(_xml_root("AccelerateConfiguration"))

    def get_bucket_request_payment(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        root = _xml_root("RequestPaymentConfiguration")
        ET.SubElement(root, "Payer").text = "BucketOwner"
        return Response.xml(root)

    def get_bucket_logging(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        return Response.xml(_xml_root("BucketLoggingStatus"))

    def get_bucket_policy_status(self, ctx) -> Response:
        """IsPublic: the policy has an Allow statement whose principal is
        the wildcard, read from the statements' structure."""
        self._check_bucket(ctx.bucket)
        # Loaded outside the try: a storage failure is an error, not
        # IsPublic FALSE.
        meta = self.bm.get(ctx.bucket)
        public = False
        try:
            doc = json.loads(meta.policy_json) if meta.policy_json else {}
            stmts = doc.get("Statement") or []
            if isinstance(stmts, dict):
                stmts = [stmts]
            for st in stmts:
                if st.get("Effect") != "Allow":
                    continue
                pr = st.get("Principal")
                aws = pr.get("AWS") if isinstance(pr, dict) else pr
                if isinstance(aws, str):
                    aws = [aws]
                if aws and "*" in aws:
                    public = True
                    break
        except (ValueError, AttributeError, TypeError):
            public = False  # an unreadable policy is not public
        root = _xml_root("PolicyStatus")
        ET.SubElement(root, "IsPublic").text = "TRUE" if public else "FALSE"
        return Response.xml(root)

    # --- bucket configurations ---

    def put_bucket_policy(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        try:
            Policy.parse(ctx.body)
        except (ValueError, KeyError) as exc:
            raise S3Error("MalformedXML", f"bad policy: {exc}") from exc
        self.bm.update(ctx.bucket, "policy_json", ctx.body.decode())
        return Response(204)

    def get_bucket_policy(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        bm = self.bm.get(ctx.bucket)
        if not bm.policy_json:
            raise S3Error("NoSuchBucketPolicy", ctx.bucket)
        return Response(200, {"Content-Type": "application/json"},
                        bm.policy_json.encode())

    def delete_bucket_policy(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        self.bm.update(ctx.bucket, "policy_json", "")
        return Response(204)

    def _xml_subresource(self, ctx, fld: str, missing_code: str,
                         pre_put=None) -> Response:
        """GET, PUT and DELETE of a bucket configuration kept as an XML
        blob; `pre_put` checks a PUT's document first."""
        self._check_bucket(ctx.bucket)
        if ctx.method == "GET":
            val = getattr(self.bm.get(ctx.bucket), fld)
            if not val:
                raise S3Error(missing_code, ctx.bucket)
            return Response(200, {"Content-Type": "application/xml"},
                            val.encode())
        if ctx.method == "PUT":
            if pre_put is not None:
                pre_put()
            try:
                ET.fromstring(ctx.body)
            except ET.ParseError as exc:
                raise S3Error("MalformedXML", str(exc)) from exc
            self.bm.update(ctx.bucket, fld, ctx.body.decode())
            return Response(200)
        self.bm.update(ctx.bucket, fld, "")
        return Response(204)

    def bucket_versioning(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        if ctx.method == "PUT":
            try:
                root = ET.fromstring(ctx.body)
            except ET.ParseError as exc:
                raise S3Error("MalformedXML", str(exc)) from exc
            status = ""
            for el in root.iter():
                if el.tag.endswith("Status"):
                    status = (el.text or "").strip()
            if status != "Enabled" and \
                    self.bm.get(ctx.bucket).replication_xml:
                # Suspension would break the replication of delete
                # markers (PutBucketVersioningHandler).
                raise S3Error(
                    "InvalidBucketState",
                    "A replication configuration is present on this "
                    "bucket, so the versioning state cannot be suspended.")
            self.bm.update(ctx.bucket, "versioning_xml", ctx.body.decode())
            return Response(200)
        bm = self.bm.get(ctx.bucket)
        if bm.versioning_xml:
            return Response(200, {"Content-Type": "application/xml"},
                            bm.versioning_xml.encode())
        return Response.xml(_xml_root("VersioningConfiguration"))

    def bucket_tagging(self, ctx) -> Response:
        return self._xml_subresource(ctx, "tagging_xml", "NoSuchTagSet")

    def bucket_encryption(self, ctx) -> Response:
        """?encryption: the document is stored and served; no PUT applies
        it (minio_tpu's PutObject reads only the request's headers)."""
        return self._xml_subresource(
            ctx, "sse_xml", "ServerSideEncryptionConfigurationNotFoundError")

    def bucket_lifecycle(self, ctx) -> Response:
        """?lifecycle: a PUT's rules are validated as they are written
        (ParseLifecycleConfig and Validate): XML that does not parse is
        MalformedXML, a rule that does not validate InvalidArgument."""
        def validate():
            try:
                lc = Lifecycle.parse(ctx.body.decode())
            except LifecycleError as exc:
                raise S3Error("MalformedXML", str(exc)) from exc
            try:
                lc.validate()
            except LifecycleError as exc:
                raise S3Error("InvalidArgument", str(exc)) from exc

        return self._xml_subresource(
            ctx, "lifecycle_xml", "NoSuchLifecycleConfiguration",
            pre_put=validate)

    def bucket_object_lock(self, ctx) -> Response:
        """?object-lock: a PUT needs versioning Enabled and a document
        that parses (PutBucketObjectLockConfigHandler)."""
        def validate():
            if not self.bm.get(ctx.bucket).versioning_enabled:
                raise S3Error(
                    "InvalidBucketState",
                    "Versioning must be 'Enabled' on the bucket to apply "
                    "an Object Lock configuration.")
            try:
                objectlock.LockConfig.parse(ctx.body.decode())
            except ET.ParseError as exc:
                raise S3Error("MalformedXML", str(exc)) from exc
            except ValueError as exc:
                raise S3Error("InvalidArgument", str(exc)) from exc

        return self._xml_subresource(
            ctx, "object_lock_xml", "ObjectLockConfigurationNotFoundError",
            pre_put=validate)

    # ---------- listing ----------

    @staticmethod
    def _max_keys(q: dict) -> int:
        return min(int(q.get("max-keys", "1000") or "1000"), 1000)

    def _list(self, ctx, prefix: str, marker: str, delimiter: str,
              max_keys: int):
        try:
            return self.ol.list_objects(ctx.bucket, prefix=prefix,
                                        marker=marker, delimiter=delimiter,
                                        max_keys=max_keys)
        except StorageError as exc:
            raise from_object_error(exc) from exc

    def list_objects_v1(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        q = ctx.qdict
        prefix = q.get("prefix", "")
        marker = q.get("marker", "")
        delimiter = q.get("delimiter", "")
        max_keys = self._max_keys(q)
        if max_keys < 0:
            raise S3Error("InvalidArgument", "max-keys negative")
        res = self._list(ctx, prefix, marker, delimiter, max_keys)
        encode = self._listing_encoder(ctx)
        enc = encode or (lambda s: s)
        root = _xml_root("ListBucketResult")
        ET.SubElement(root, "Name").text = ctx.bucket
        # Under encoding-type=url every key-derived element is encoded,
        # NextMarker too: it is what the client sends back.
        ET.SubElement(root, "Prefix").text = enc(prefix)
        ET.SubElement(root, "Marker").text = enc(marker)
        ET.SubElement(root, "MaxKeys").text = str(max_keys)
        if delimiter:
            ET.SubElement(root, "Delimiter").text = enc(delimiter)
        ET.SubElement(root, "IsTruncated").text = (
            "true" if res.is_truncated else "false")
        if res.is_truncated and res.next_marker:
            ET.SubElement(root, "NextMarker").text = enc(res.next_marker)
        if encode is not None:
            ET.SubElement(root, "EncodingType").text = "url"
        self._fill_entries(root, res, encode=encode)
        return Response.xml(root)

    def list_objects_v2(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        q = ctx.qdict
        prefix = q.get("prefix", "")
        delimiter = q.get("delimiter", "")
        max_keys = self._max_keys(q)
        token = q.get("continuation-token", "")
        start_after = q.get("start-after", "")
        fetch_owner = q.get("fetch-owner", "") == "true"
        marker = token or start_after
        if token:
            try:
                marker = base64.b64decode(token).decode()
            except (binascii.Error, ValueError) as exc:
                raise S3Error("InvalidArgument",
                              "bad continuation-token") from exc
        res = self._list(ctx, prefix, marker, delimiter, max_keys)
        encode = self._listing_encoder(ctx)
        enc = encode or (lambda s: s)
        root = _xml_root("ListBucketResult")
        ET.SubElement(root, "Name").text = ctx.bucket
        ET.SubElement(root, "Prefix").text = enc(prefix)
        ET.SubElement(root, "MaxKeys").text = str(max_keys)
        if delimiter:
            ET.SubElement(root, "Delimiter").text = enc(delimiter)
        if start_after:
            ET.SubElement(root, "StartAfter").text = enc(start_after)
        ET.SubElement(root, "KeyCount").text = str(
            len(res.objects) + len(res.prefixes))
        ET.SubElement(root, "IsTruncated").text = (
            "true" if res.is_truncated else "false")
        if token:
            ET.SubElement(root, "ContinuationToken").text = token
        if res.is_truncated and res.next_marker:
            # An opaque base64 token, XML-safe as it is.
            ET.SubElement(root, "NextContinuationToken").text = (
                base64.b64encode(res.next_marker.encode()).decode())
        if encode is not None:
            ET.SubElement(root, "EncodingType").text = "url"
        self._fill_entries(root, res, owner=fetch_owner, encode=encode)
        return Response.xml(root)

    def list_object_versions(self, ctx) -> Response:
        """GET /bucket?versions (ListObjectVersionsHandler,
        cmd/bucket-listobjects-handlers.go:214-352)."""
        self._check_bucket(ctx.bucket)
        q = ctx.qdict
        prefix = q.get("prefix", "")
        key_marker = q.get("key-marker", "")
        vid_marker = q.get("version-id-marker", "")
        delimiter = q.get("delimiter", "")
        max_keys = self._max_keys(q)
        if max_keys < 0:
            raise S3Error("InvalidArgument", "max-keys negative")
        if vid_marker and not key_marker:
            raise S3Error("InvalidArgument",
                          "version-id-marker without key-marker")
        try:
            res = self.ol.list_object_versions(
                ctx.bucket, prefix=prefix, key_marker=key_marker,
                version_id_marker=vid_marker, delimiter=delimiter,
                max_keys=max_keys)
        except StorageError as exc:
            raise from_object_error(exc) from exc
        encode = self._listing_encoder(ctx)
        enc = encode or (lambda s: s)
        root = _xml_root("ListVersionsResult")
        ET.SubElement(root, "Name").text = ctx.bucket
        ET.SubElement(root, "Prefix").text = enc(prefix)
        ET.SubElement(root, "KeyMarker").text = enc(key_marker)
        if vid_marker:
            ET.SubElement(root, "VersionIdMarker").text = vid_marker
        ET.SubElement(root, "MaxKeys").text = str(max_keys)
        if delimiter:
            ET.SubElement(root, "Delimiter").text = enc(delimiter)
        if encode is not None:
            ET.SubElement(root, "EncodingType").text = "url"
        ET.SubElement(root, "IsTruncated").text = (
            "true" if res.is_truncated else "false")
        if res.is_truncated:
            ET.SubElement(root, "NextKeyMarker").text = enc(
                res.next_key_marker)
            ET.SubElement(root, "NextVersionIdMarker").text = (
                res.next_version_id_marker)
        for oi in res.versions:
            v = ET.SubElement(root, "DeleteMarker" if oi.delete_marker
                              else "Version")
            ET.SubElement(v, "Key").text = enc(oi.name)
            ET.SubElement(v, "VersionId").text = oi.version_id or "null"
            ET.SubElement(v, "IsLatest").text = (
                "true" if oi.is_latest else "false")
            ET.SubElement(v, "LastModified").text = iso8601(oi.mod_time_ns)
            if not oi.delete_marker:
                ET.SubElement(v, "ETag").text = f'"{oi.etag}"'
                ET.SubElement(v, "Size").text = str(oi.size)
                ET.SubElement(v, "StorageClass").text = "STANDARD"
            o = ET.SubElement(v, "Owner")
            ET.SubElement(o, "ID").text = "minio-tpu"
            ET.SubElement(o, "DisplayName").text = "minio-tpu"
        for p in res.prefixes:
            cp = ET.SubElement(root, "CommonPrefixes")
            ET.SubElement(cp, "Prefix").text = enc(p)
        return Response.xml(root)

    def delete_multiple_objects(self, ctx) -> Response:
        """POST /bucket?delete: Quiet, VersionId, at most
        MAX_DELETE_OBJECTS keys; a key already gone is reported Deleted."""
        self._check_bucket(ctx.bucket)
        try:
            req = ET.fromstring(ctx.body)
        except ET.ParseError as exc:
            raise S3Error("MalformedXML", str(exc)) from exc
        ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"
        objects = []
        quiet = False
        for el in req:
            tag = el.tag.removeprefix(ns)
            if tag == "Quiet":
                quiet = (el.text or "").strip() == "true"
            elif tag == "Object":
                key = vid = ""
                for sub in el:
                    st = sub.tag.removeprefix(ns)
                    if st == "Key":
                        key = sub.text or ""
                    elif st == "VersionId":
                        vid = sub.text or ""
                if key:
                    objects.append((key, vid))
        if len(objects) > MAX_DELETE_OBJECTS:
            raise S3Error("InvalidRequest", "too many objects")
        root = _xml_root("DeleteResult")
        for key, vid in objects:
            try:
                opts = self._opts_for(ctx.bucket, {"versionId": vid})
                # Retention is held per key, as on the single DELETE.
                try:
                    self._enforce_delete_retention(ctx, opts, key, vid)
                except S3Error as s3e:
                    e = ET.SubElement(root, "Error")
                    ET.SubElement(e, "Key").text = key
                    if vid:
                        ET.SubElement(e, "VersionId").text = vid
                    ET.SubElement(e, "Code").text = s3e.api.code
                    ET.SubElement(e, "Message").text = str(s3e)
                    continue
                self.ol.delete_object(ctx.bucket, key, opts)
                if not quiet:
                    d = ET.SubElement(root, "Deleted")
                    ET.SubElement(d, "Key").text = key
                    if vid:
                        ET.SubElement(d, "VersionId").text = vid
            except StorageError as exc:
                api = from_object_error(exc)
                if api.api.code in ("NoSuchKey", "NoSuchVersion"):
                    if not quiet:
                        d = ET.SubElement(root, "Deleted")
                        ET.SubElement(d, "Key").text = key
                    continue
                e = ET.SubElement(root, "Error")
                ET.SubElement(e, "Key").text = key
                ET.SubElement(e, "Code").text = api.api.code
                ET.SubElement(e, "Message").text = api.detail
        return Response.xml(root)

    @staticmethod
    def _listing_encoder(ctx):
        """encoding-type=url: keys are URL-encoded on request."""
        enc = ctx.qdict.get("encoding-type", "")
        if not enc:
            return None
        if enc != "url":
            raise S3Error("InvalidArgument",
                          f"encoding-type {enc!r} (only 'url')")
        return lambda s: urllib.parse.quote(s, safe="/")

    @staticmethod
    def _fill_entries(root, res, owner: bool = True, encode=None):
        enc = encode or (lambda s: s)
        for oi in res.objects:
            c = ET.SubElement(root, "Contents")
            ET.SubElement(c, "Key").text = enc(oi.name)
            ET.SubElement(c, "LastModified").text = iso8601(oi.mod_time_ns)
            ET.SubElement(c, "ETag").text = f'"{oi.etag}"'
            ET.SubElement(c, "Size").text = str(oi.size)
            ET.SubElement(c, "StorageClass").text = "STANDARD"
            if owner:
                o = ET.SubElement(c, "Owner")
                ET.SubElement(o, "ID").text = "minio-tpu"
                ET.SubElement(o, "DisplayName").text = "minio-tpu"
        for p in res.prefixes:
            cp = ET.SubElement(root, "CommonPrefixes")
            ET.SubElement(cp, "Prefix").text = enc(p)

    # ---------- object ----------

    def put_object(self, ctx) -> Response:
        if not valid_object_name(ctx.object):
            raise S3Error("InvalidArgument",
                          f"bad object name {ctx.object!r}")
        self._check_bucket(ctx.bucket)
        copy_source = ctx.headers.get("x-amz-copy-source", "")
        if copy_source:
            return self._copy_object(ctx, copy_source)
        size = ctx.content_length
        if size is None:
            raise S3Error("MissingContentLength")
        if size > MAX_OBJECT_SIZE:
            raise S3Error("EntityTooLarge")
        opts = self._opts_for(ctx.bucket, ctx.qdict)
        opts.user_defined = extract_user_metadata(ctx.headers)
        self._apply_tagging_header(ctx, opts)
        self._apply_storage_class(ctx, opts)
        self._apply_codec(ctx, opts)
        self._apply_object_lock(ctx, opts)
        self._check_quota(ctx.bucket, size)
        if opts.user_defined.get(REPLICA_META) == "replica":
            # The replica marker would stop a re-replication, so it takes
            # s3:ReplicateObject, checked here for every way in (SigV4 and
            # POST policy), as minio_tpu does.
            self._check_replicate(ctx)
        reader, resp_extra = ctx.body_reader, {}
        want_md5_hex = _parse_content_md5(ctx.headers)
        if transforms.transforms_active(ctx.headers, self.config,
                                        ctx.object):
            # The streaming chain (md5-verify -> compress -> encrypt): no
            # stage holds the object, and a bad plaintext digest aborts
            # the encode before the commit.
            reader, size, resp_extra = transforms.build_put_stream(
                ctx.headers, self.config, self.sse_config, ctx.bucket,
                ctx.object, reader, opts.user_defined,
                want_md5_hex=want_md5_hex, device=self.ol.device)
        else:
            # Checked inside the object layer as the body streams, before
            # the commit: a bad digest leaves nothing behind.
            opts.want_md5_hex = want_md5_hex
        try:
            oi = self.ol.put_object(ctx.bucket, ctx.object, reader, size,
                                    opts)
        except StorageError as exc:
            raise from_object_error(exc) from exc
        headers = {"ETag": f'"{oi.etag}"'}
        headers.update(resp_extra)
        if oi.version_id and oi.version_id != "null":
            headers["x-amz-version-id"] = oi.version_id
        return Response(200, headers)

    def _check_replicate(self, ctx) -> None:
        account = getattr(ctx, "access_key", "") or ""
        args = Args(account=account, action="s3:ReplicateObject",
                    bucket=ctx.bucket, object=ctx.object)
        bucket_policy = self.bm.get(ctx.bucket).policy()
        if not ((account and self.iam is not None
                 and self.iam.is_allowed(args))
                or (bucket_policy is not None
                    and bucket_policy.is_allowed(args))):
            raise S3Error("AccessDenied",
                          "replica marker requires s3:ReplicateObject")

    # --- POST policy uploads (PostPolicyBucketHandler,
    # cmd/bucket-handlers.go, and cmd/postpolicyform.go) ---

    # A form's body is parsed whole before its file is known, so its
    # size is capped: larger objects take PUT or multipart.
    MAX_POST_POLICY_BODY = 64 << 20

    def post_policy_object(self, ctx) -> Response:
        """A browser form upload, POST multipart/form-data to the bucket.
        The form's x-amz-credential and x-amz-signature sign its policy
        with the signer's IAM secret (the string to sign is the policy);
        a temporary signer's form carries its x-amz-security-token; the
        policy's expiration and conditions hold against the fields; the
        signer may s3:PutObject through the IAM or the bucket policy;
        then the file goes through put_object. Answers 204, or 201 with a
        PostResponse when success_action_status says so."""
        if self.iam is None:
            raise S3Error("NotImplemented", "POST policy without an IAM")
        self._check_bucket(ctx.bucket)
        if (ctx.content_length or 0) > self.MAX_POST_POLICY_BODY:
            raise S3Error("EntityTooLarge",
                          f"POST form bodies are capped at "
                          f"{self.MAX_POST_POLICY_BODY} bytes")
        fields, file_data, filename = _parse_multipart_form(
            ctx.headers.get("content-type", ""), ctx.body)
        policy_b64 = fields.get("policy", "")
        if not policy_b64:
            raise S3Error("MalformedPOSTRequest", "missing policy")
        cred_str = fields.get("x-amz-credential", "")
        sig = fields.get("x-amz-signature", "")
        if not cred_str or not sig:
            raise S3Error("AccessDenied", "missing POST signature fields")
        try:
            cred = sign.V4Credential(cred_str)
        except sign.SignError as exc:
            raise S3Error("InvalidArgument",
                          f"bad x-amz-credential: {exc}") from exc
        creds = self.iam.get_credentials(cred.access_key)
        if creds is None:
            raise S3Error("InvalidAccessKeyId", cred.access_key)
        check_session_token(creds, fields.get("x-amz-security-token", ""))
        key = sign.signing_key(creds.secret_key, cred.date, cred.region,
                               cred.service)
        want = hmac.new(key, policy_b64.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, sig):
            raise S3Error("SignatureDoesNotMatch", "POST policy")
        _check_post_policy(policy_b64, fields, len(file_data), ctx.bucket)
        key_tmpl = fields.get("key", "")
        if not key_tmpl:
            raise S3Error("InvalidArgument", "missing key field")
        object_ = key_tmpl.replace("${filename}", filename)
        if not valid_object_name(object_):
            raise S3Error("InvalidArgument", f"bad key {object_!r}")
        # The signer is authorized as on the SigV4 plane: the IAM, else
        # the bucket policy.
        args = Args(account=cred.access_key, action="s3:PutObject",
                    bucket=ctx.bucket, object=object_)
        bucket_policy = self.bm.get(ctx.bucket).policy()
        if not (self.iam.is_allowed(args)
                or (bucket_policy is not None
                    and bucket_policy.is_allowed(args))):
            raise S3Error("AccessDenied", "PutObject")
        from .server import RequestContext

        headers = {k: v for k, v in fields.items()
                   if k.startswith("x-amz-meta-") or k == "content-type"}
        sub = RequestContext("PUT", f"/{ctx.bucket}/{object_}", [], headers,
                             io.BytesIO(file_data), len(file_data))
        sub.access_key = cred.access_key
        # The form branches off before the dispatch's admission identity
        # is set: the encode slot is charged to the signer here.
        with client_context(cred.access_key or "anonymous",
                            bucket=ctx.bucket or ""):
            resp = self.put_object(sub)
        if fields.get("success_action_status", "204") == "201":
            root = ET.Element("PostResponse")
            ET.SubElement(root, "Bucket").text = ctx.bucket
            ET.SubElement(root, "Key").text = object_
            ET.SubElement(root, "ETag").text = resp.headers.get("ETag", "")
            out = Response.xml(root)
            out.status = 201
            out.headers.update({k: v for k, v in resp.headers.items()
                                if k != "ETag"})
            return out
        return Response(204, dict(resp.headers))

    # --- CopyObject (CopyObjectHandler, cmd/object-handlers.go) ---

    def _copy_source_info(self, ctx, copy_source: str):
        """The copy source's (bucket, object, options, ObjectInfo), its
        x-amz-copy-source-if-* preconditions held."""
        sbucket, sobject, vid = parse_copy_source(copy_source)
        try:
            src_opts = self._opts_for(sbucket, {"versionId": vid})
            src_info = self.ol.get_object_info(sbucket, sobject, src_opts)
        except StorageError as exc:
            raise from_object_error(exc) from exc
        if (tier.is_transitioned(src_info.user_defined)
                and not tier.is_restored(src_info.user_defined)):
            # The source's bytes live on its tier (MinIO answers so;
            # minio_tpu reads the freed shards, ROADMAP.md Queue 3).
            raise S3Error("InvalidObjectState",
                          f"{sobject} is transitioned")
        self._copy_source_conditions(ctx, src_info)
        return sbucket, sobject, src_opts, src_info

    def _copy_object(self, ctx, copy_source: str) -> Response:
        sbucket, sobject, src_opts, src_info = self._copy_source_info(
            ctx, copy_source)
        vid = src_opts.version_id
        opts = self._opts_for(ctx.bucket, ctx.qdict)
        directive = ctx.headers.get("x-amz-metadata-directive", "COPY")
        self_copy = (sbucket, sobject) == (ctx.bucket, ctx.object)
        if directive == "REPLACE":
            opts.user_defined = extract_user_metadata(ctx.headers)
        else:
            # Retention and hold never copy from the source (the
            # destination's come from this request or the bucket's
            # default), nor do the internal markers.
            opts.user_defined = {
                k: v for k, v in src_info.user_defined.items()
                if k not in objectlock.LOCK_META_KEYS
                and not k.startswith("x-mtpu-internal-")}
        # A copy writes a new object: the lock headers or the default
        # retention, and the hard quota at the source's logical size (a
        # compressed source grows back at the destination).
        self._apply_object_lock(ctx, opts)
        self._check_quota(ctx.bucket, transforms.actual_object_size(
            src_info.user_defined, src_info.size))
        if self_copy and not vid and directive != "REPLACE":
            raise S3Error(
                "InvalidRequest",
                "This copy request is illegal because it is being made "
                "to the same object without changing metadata.")
        src_transformed = transforms.is_transformed(src_info.user_defined)
        dest_transforms = transforms.transforms_active(
            ctx.headers, self.config, ctx.object)
        if self_copy and not vid and not opts.versioned \
                and not dest_transforms:
            # An unversioned REPLACE self-copy changes metadata only:
            # re-putting the bytes would deadlock the writer lock against
            # its own locked source read (srcInfo.metadataOnly).
            try:
                mod_time_ns = self.ol.update_object_metadata(
                    ctx.bucket, ctx.object, src_info.version_id or "",
                    opts.user_defined, replace_user_meta=True)
            except StorageError as exc:
                raise from_object_error(exc) from exc
            src_info.mod_time_ns = mod_time_ns or src_info.mod_time_ns
            return self._copy_result(src_info)
        copy_sse_headers = None
        try:
            if src_transformed or dest_transforms or self_copy:
                # The logical stream goes to a spool (the source read
                # finishes before the destination takes the object's
                # write lock), then through the destination's transform
                # chain: an encrypted source's sealed key is bound to its
                # path, so a copy always decodes and re-encodes.
                src_headers = dict(ctx.headers)
                # The copy-source SSE-C headers address the source.
                for suffix in ("algorithm", "key", "key-md5"):
                    v = ctx.headers.get(ssemod.HDR_SSEC_COPY_PREFIX + suffix,
                                        "")
                    if v:
                        src_headers[ssemod.HDR_SSEC_PREFIX + suffix] = v
                with transforms.decode_to_spool(
                        self.ol, sbucket, sobject, src_opts,
                        src_info.user_defined, src_headers,
                        self.sse_config, device=self.ol.device) as spool:
                    size = spool.seek(0, io.SEEK_END)
                    spool.seek(0)
                    reader = spool
                    if dest_transforms:
                        reader, size, copy_sse_headers = \
                            transforms.build_put_stream(
                                ctx.headers, self.config, self.sse_config,
                                ctx.bucket, ctx.object, spool,
                                opts.user_defined, device=self.ol.device)
                    oi = self.ol.put_object(ctx.bucket, ctx.object, reader,
                                            size, opts)
            else:
                # Source to destination in 1 MiB pulls: a copy of many
                # GiB is never held whole.
                reader = _RangeCopyReader(self.ol, sbucket, sobject, 0,
                                          src_info.size, src_opts)
                oi = self.ol.put_object(ctx.bucket, ctx.object, reader,
                                        src_info.size, opts)
        except StorageError as exc:
            raise from_object_error(exc) from exc
        return self._copy_result(oi, copy_sse_headers)

    @staticmethod
    def _copy_result(oi, extra_headers: dict | None = None) -> Response:
        root = _xml_root("CopyObjectResult")
        ET.SubElement(root, "LastModified").text = iso8601(oi.mod_time_ns)
        ET.SubElement(root, "ETag").text = f'"{oi.etag}"'
        headers = dict(extra_headers or {})
        if oi.version_id and oi.version_id != "null":
            headers["x-amz-version-id"] = oi.version_id
        return Response.xml(root, headers=headers)

    @staticmethod
    def _copy_source_conditions(ctx, src_info) -> None:
        """x-amz-copy-source-if-{match,none-match,modified-since,
        unmodified-since} on the copy's source: every failure is 412,
        never 304 (checkCopyObjectPreconditions)."""
        mod_s = src_info.mod_time_ns // 10 ** 9
        im = ctx.headers.get("x-amz-copy-source-if-match", "")
        if im and not _etag_matches(im, src_info.etag):
            raise S3Error("PreconditionFailed", "x-amz-copy-source-if-match")
        inm = ctx.headers.get("x-amz-copy-source-if-none-match", "")
        if inm and _etag_matches(inm, src_info.etag):
            raise S3Error("PreconditionFailed",
                          "x-amz-copy-source-if-none-match")
        ims = ctx.headers.get("x-amz-copy-source-if-modified-since", "")
        if ims and (t := _parse_http_date(ims)) is not None and mod_s <= t:
            raise S3Error("PreconditionFailed",
                          "x-amz-copy-source-if-modified-since")
        ius = ctx.headers.get("x-amz-copy-source-if-unmodified-since", "")
        if ius and (t := _parse_http_date(ius)) is not None and mod_s > t:
            raise S3Error("PreconditionFailed",
                          "x-amz-copy-source-if-unmodified-since")

    @staticmethod
    def _conditional_headers(ctx, oi):
        """If-Match, If-None-Match, If-(Un)Modified-Since
        (checkPreconditions, cmd/object-handlers-common.go): a failed
        none-match or modified-since is 304, the others 412."""
        etag = f'"{oi.etag}"'
        mod_s = oi.mod_time_ns // 10 ** 9
        im = ctx.headers.get("if-match", "")
        if im and not _etag_matches(im, oi.etag):
            raise S3Error("PreconditionFailed", "If-Match")
        inm = ctx.headers.get("if-none-match", "")
        if inm and _etag_matches(inm, oi.etag):
            return Response(304, {"ETag": etag})
        ims = ctx.headers.get("if-modified-since", "")
        if ims and (t := _parse_http_date(ims)) is not None and mod_s <= t:
            return Response(304, {"ETag": etag})
        ius = ctx.headers.get("if-unmodified-since", "")
        if ius and (t := _parse_http_date(ius)) is not None and mod_s > t:
            raise S3Error("PreconditionFailed", "If-Unmodified-Since")
        return None

    @staticmethod
    def _object_headers(ctx, oi) -> dict:
        headers = {
            "ETag": f'"{oi.etag}"',
            "Last-Modified": http_date(oi.mod_time_ns),
            "Content-Type": oi.content_type or "application/octet-stream",
            "Accept-Ranges": "bytes",
        }
        if oi.version_id and oi.version_id != "null":
            headers["x-amz-version-id"] = oi.version_id
        for k, v in oi.user_defined.items():
            if (k.startswith("x-amz-meta-") or k in objectlock.LOCK_META_KEYS
                    or k == tier.META_RESTORE):
                headers[k] = v
            elif k in _REMEMBERED_HEADERS and k != "content-type":
                headers[k.title()] = v
        if tier.is_transitioned(oi.user_defined):
            headers["x-amz-storage-class"] = oi.user_defined[tier.META_TIER]
        elif oi.user_defined.get("x-amz-storage-class",
                                 "STANDARD") != "STANDARD":
            headers["x-amz-storage-class"] = \
                oi.user_defined["x-amz-storage-class"]
        ntags = len(urllib.parse.parse_qsl(
            oi.user_defined.get(S3ApiHandlers.TAGS_META_KEY, ""),
            keep_blank_values=True))
        if ntags:
            headers["x-amz-tagging-count"] = str(ntags)
        for qk, hk in _RESPONSE_OVERRIDES.items():
            if qk in ctx.qdict:
                headers[hk] = ctx.qdict[qk]
        return headers

    def _object_info(self, ctx, opts):
        try:
            oi = self.ol.get_object_info(ctx.bucket, ctx.object, opts)
        except StorageError as exc:
            raise from_object_error(exc) from exc
        if oi.delete_marker:
            raise S3Error("NoSuchKey", ctx.object)
        return oi

    def get_object(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        opts = self._opts_for(ctx.bucket, ctx.qdict)
        oi = self._object_info(ctx, opts)
        early = self._conditional_headers(ctx, oi)
        if early is not None:
            return early
        logical_size = transforms.actual_object_size(oi.user_defined,
                                                     oi.size)
        rng = parse_range(ctx.headers.get("range", ""), logical_size)
        offset, length = rng if rng else (0, logical_size)
        if (tier.is_transitioned(oi.user_defined)
                and not tier.is_restored(oi.user_defined)):
            return self._get_tiered(ctx, oi, rng, offset, length,
                                    logical_size)
        # The decode slot is taken inside the body stream, after the
        # status line, where a queue-full rejection could only sever the
        # connection: probe the read governor now and answer 503
        # SlowDown. The stream runs after the dispatch's identity is gone,
        # so it re-enters the caller's.
        if read_governor().saturated():
            exc = ErrOperationTimedOut("server busy: GET admission queue full")
            raise from_object_error(exc) from exc
        caller = current_client()
        # The stream serves the advertised version or nothing.
        opts.expected_etag = oi.etag
        resp_extra: dict = {}
        if transforms.is_transformed(oi.user_defined):
            # The decrypt -> decompress chain onto the socket
            # (NewGetObjectReader): its keys are checked now, before the
            # status line. A ranged GET decodes the stored stream from its
            # start (through the package that ends the window when only
            # encrypted; all of it when compressed) and ships the window.
            sink = _Sink()
            chain, closers, resp_extra = transforms.build_get_chain(
                oi.user_defined, ctx.headers, self.sse_config, ctx.bucket,
                ctx.object, sink, offset=offset, length=length,
                device=self.ol.device)
            stored = (transforms.stored_prefix(oi.user_defined, oi.size,
                                               offset, length)
                      if rng else oi.size)

            def stream(dst):
                sink.dst = dst
                with client_context(caller):
                    self.ol.get_object(ctx.bucket, ctx.object, chain,
                                       length=stored, opts=opts)
                for c in closers:
                    c.close()
        else:
            def stream(dst):
                # The decode writes each block to the socket as it is
                # made: the object is never held whole.
                with client_context(caller):
                    self.ol.get_object(ctx.bucket, ctx.object, dst,
                                       offset=offset, length=length,
                                       opts=opts)

        headers = self._object_headers(ctx, oi)
        headers.update(resp_extra)
        headers["Content-Length"] = str(length)
        if rng:
            headers["Content-Range"] = (
                f"bytes {offset}-{offset + length - 1}/{logical_size}")
            return Response(206, headers, body_stream=stream)
        return Response(200, headers, body_stream=stream)

    def _get_tiered(self, ctx, oi, rng, offset: int, length: int,
                    logical_size: int) -> Response:
        """GET of a transitioned version with no live restored copy
        (getTransitionedObjectReader): its stored bytes come back from
        the tier whole and run through the decrypt -> decompress -> range
        chain, whose keys (sealed in the local metadata, never on the
        tier) are checked before the status line. A tier that fails
        answers 503 ServiceUnavailable."""
        if self.tier_engine is None:
            raise S3Error("InvalidObjectState", "object is transitioned and "
                          "no tier engine is configured")
        try:
            spool, tier_name = self.tier_engine.open_remote_spool(
                oi.user_defined)
        except StorageError as exc:
            raise from_object_error(exc) from exc
        sink = _Sink()
        try:
            chain, closers, resp_extra = transforms.build_get_chain(
                oi.user_defined, ctx.headers, self.sse_config, ctx.bucket,
                ctx.object, sink, offset=offset, length=length,
                device=self.ol.device)
        except BaseException:
            spool.close()
            raise

        def stream(dst):
            sink.dst = dst
            with spool, self.tier_engine.timed("invert"):
                while True:
                    piece = spool.read(_TIER_PIECE)
                    if not piece:
                        break
                    chain.write(piece)
                for c in closers:
                    c.close()

        headers = self._object_headers(ctx, oi)
        headers.update(resp_extra)
        headers["Content-Length"] = str(length)
        headers["x-amz-storage-class"] = tier_name
        if rng:
            headers["Content-Range"] = (
                f"bytes {offset}-{offset + length - 1}/{logical_size}")
            return Response(206, headers, body_stream=stream)
        return Response(200, headers, body_stream=stream)

    def restore_object(self, ctx) -> Response:
        """POST ?restore (PostRestoreObjectHandler): a temporary local
        copy of a transitioned object for the request's Days (at least
        1), 202; InvalidObjectState for an object that is not
        transitioned."""
        self._check_bucket(ctx.bucket)
        if self.tier_engine is None:
            raise S3Error("NotImplemented", "no tier engine configured")
        days = 1
        if ctx.body:
            try:
                for el in ET.fromstring(ctx.body).iter():
                    if el.tag.endswith("Days"):
                        days = max(1, int((el.text or "1").strip()))
            except (ET.ParseError, ValueError) as exc:
                raise S3Error("MalformedXML", str(exc)) from exc
        try:
            self.tier_engine.restore(ctx.bucket, ctx.object, days)
        except ErrInvalidArgument as exc:
            raise S3Error("InvalidObjectState", str(exc)) from exc
        except StorageError as exc:
            raise from_object_error(exc) from exc
        return Response(202)

    def head_object(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        opts = self._opts_for(ctx.bucket, ctx.qdict)
        oi = self._object_info(ctx, opts)
        early = self._conditional_headers(ctx, oi)
        if early is not None:
            return early
        headers = self._object_headers(ctx, oi)
        headers["Content-Length"] = str(
            transforms.actual_object_size(oi.user_defined, oi.size))
        algo = oi.user_defined.get(ssemod.META_ALGORITHM, "")
        if algo == ssemod.ALGO_SSEC:
            # An SSE-C object asks for the key even on HEAD.
            if ssemod.parse_ssec_key(ctx.headers) is None:
                raise S3Error("InvalidRequest", "SSE-C key required")
            headers[ssemod.HDR_SSEC_ALGO] = "AES256"
            headers[ssemod.HDR_SSEC_KEY_MD5] = oi.user_defined.get(
                ssemod.META_KEY_MD5, "")
        elif algo == ssemod.ALGO_SSES3:
            headers[ssemod.HDR_SSE] = "AES256"
        elif algo == ssemod.ALGO_SSEKMS:
            headers[ssemod.HDR_SSE] = "aws:kms"
            headers[ssemod.HDR_SSE_KMS_ID] = oi.user_defined.get(
                ssemod.META_KMS_KEY_ID, "")
        return Response(200, headers)

    def delete_object(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        opts = self._opts_for(ctx.bucket, ctx.qdict)
        self._enforce_delete_retention(ctx, opts, ctx.object,
                                       ctx.qdict.get("versionId", ""))
        headers = {}
        try:
            oi = self.ol.delete_object(ctx.bucket, ctx.object, opts)
            if oi is not None and oi.delete_marker:
                headers["x-amz-delete-marker"] = "true"
                if oi.version_id and oi.version_id != "null":
                    headers["x-amz-version-id"] = oi.version_id
        except StorageError as exc:
            api = from_object_error(exc)
            if api.api.code not in ("NoSuchKey", "NoSuchVersion"):
                raise api from exc
        return Response(204, headers)

    # ---------- object tagging (PutObjectTaggingHandler and the rest);
    # the tags live in the version's metadata ----------

    def _tag_target_info(self, ctx):
        """The version a tagging or ACL call addresses; a delete marker
        as the latest is NoSuchKey, as for GET."""
        opts = self._opts_for(ctx.bucket, ctx.qdict)
        try:
            oi = self.ol.get_object_info(ctx.bucket, ctx.object, opts)
        except StorageError as exc:
            raise from_object_error(exc) from exc
        if oi.delete_marker:
            raise S3Error("NoSuchKey", ctx.object)
        return oi, opts

    def get_object_tagging(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        oi, _ = self._tag_target_info(ctx)
        tags = urllib.parse.parse_qsl(
            oi.user_defined.get(self.TAGS_META_KEY, ""),
            keep_blank_values=True)
        root = ET.Element("Tagging")
        ts = ET.SubElement(root, "TagSet")
        for k, v in tags:
            tag = ET.SubElement(ts, "Tag")
            ET.SubElement(tag, "Key").text = k
            ET.SubElement(tag, "Value").text = v
        headers = {}
        if oi.version_id and oi.version_id != "null":
            headers["x-amz-version-id"] = oi.version_id
        return Response.xml(root, headers=headers)

    def put_object_tagging(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        _, opts = self._tag_target_info(ctx)
        try:
            root = ET.fromstring(ctx.body)
        except ET.ParseError as exc:
            raise S3Error("MalformedXML", str(exc)) from exc
        tags: list[tuple[str, str]] = []
        for tag in root.iter():
            if not tag.tag.endswith("Tag"):
                continue
            k = v = None
            for sub in tag:
                if sub.tag.endswith("Key"):
                    k = (sub.text or "").strip()
                elif sub.tag.endswith("Value"):
                    v = sub.text or ""
            if k is None or v is None:
                raise S3Error("InvalidTag", "tag missing Key or Value")
            tags.append((k, v))
        self._validate_tags(tags)
        self._update_tags(ctx, opts, urllib.parse.urlencode(tags))
        return Response(200)

    def delete_object_tagging(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        _, opts = self._tag_target_info(ctx)
        self._update_tags(ctx, opts, "")
        return Response(204)

    def _update_tags(self, ctx, opts, encoded: str) -> None:
        try:
            self.ol.update_object_metadata(ctx.bucket, ctx.object,
                                           opts.version_id,
                                           {self.TAGS_META_KEY: encoded})
        except StorageError as exc:
            raise from_object_error(exc) from exc

    # ---------- canned ACLs (cmd/acl-handlers.go): the private,
    # owner-FULL_CONTROL model; policies are the real authorization ----

    def get_acl(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        if ctx.object:
            self._tag_target_info(ctx)
        root = ET.Element("AccessControlPolicy")
        owner = ET.SubElement(root, "Owner")
        ET.SubElement(owner, "ID").text = "minio-tpu"
        ET.SubElement(owner, "DisplayName").text = "minio-tpu"
        acl = ET.SubElement(root, "AccessControlList")
        grant = ET.SubElement(acl, "Grant")
        grantee = ET.SubElement(grant, "Grantee")
        grantee.set("xmlns:xsi", "http://www.w3.org/2001/XMLSchema-instance")
        grantee.set("xsi:type", "CanonicalUser")
        ET.SubElement(grantee, "ID").text = "minio-tpu"
        ET.SubElement(grant, "Permission").text = "FULL_CONTROL"
        return Response.xml(root)

    def put_acl(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        if ctx.object:
            # A missing or delete-marked key is NoSuchKey, as for GET.
            self._tag_target_info(ctx)
        canned = ctx.headers.get("x-amz-acl", "private")
        if canned != "private":
            raise S3Error("NotImplemented",
                          "only the private canned ACL is supported")
        if ctx.body:
            # Only the owner's FULL_CONTROL grant can be held; any other
            # grant is refused, never dropped.
            try:
                root = ET.fromstring(ctx.body)
            except ET.ParseError as exc:
                raise S3Error("MalformedXML", str(exc)) from exc
            perms = [(el.text or "").strip()
                     for el in root.iter() if el.tag.endswith("Permission")]
            if not perms or any(p != "FULL_CONTROL" for p in perms) \
                    or len(perms) > 1:
                raise S3Error("NotImplemented",
                              "custom grants are not supported")
        return Response(200)

    # The object ACL verbs answer as the bucket's; their own names make
    # the server authorize s3:GetObjectAcl / s3:PutObjectAcl.
    def get_object_acl(self, ctx) -> Response:
        return self.get_acl(ctx)

    def put_object_acl(self, ctx) -> Response:
        return self.put_acl(ctx)

    # ---------- retention and legal hold (PutObjectRetentionHandler,
    # PutObjectLegalHoldHandler and their GETs) ----------

    def object_retention(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        oi = self._lock_target_info(ctx)
        if ctx.method == "GET":
            mode, until = objectlock.retention_state(oi.user_defined)
            if not mode:
                raise S3Error("NoSuchObjectLockConfiguration")
            return Response(200, {"Content-Type": "application/xml"},
                            objectlock.retention_xml(
                                mode, objectlock.iso8601_utc(until)))
        cfg = self._lock_config(ctx.bucket)
        if cfg is None or not cfg.enabled:
            raise S3Error("InvalidRequest",
                          "Bucket is missing ObjectLockConfiguration")
        try:
            mode, until_iso = objectlock.parse_retention_body(ctx.body)
        except ET.ParseError as exc:
            raise S3Error("MalformedXML", str(exc)) from exc
        except ValueError as exc:
            raise S3Error("InvalidArgument", str(exc)) from exc
        # Tightening is always allowed. COMPLIANCE is never loosened;
        # GOVERNANCE is shortened only with the bypass.
        old_mode, old_until = objectlock.retention_state(oi.user_defined)
        if old_mode and old_until > time.time():
            shortens = objectlock.parse_iso8601(until_iso) < old_until
            if old_mode == objectlock.MODE_COMPLIANCE and (
                    shortens or mode != objectlock.MODE_COMPLIANCE):
                raise S3Error("AccessDenied",
                              "COMPLIANCE retention cannot be loosened")
            if (old_mode == objectlock.MODE_GOVERNANCE and shortens
                    and not self._bypass_governance(ctx, ctx.object)):
                raise S3Error("AccessDenied",
                              "governance retention shortening requires "
                              "bypass")
        try:
            self.ol.update_object_metadata(
                ctx.bucket, ctx.object, oi.version_id or "",
                {objectlock.META_MODE: mode,
                 objectlock.META_RETAIN_UNTIL: until_iso})
        except StorageError as exc:
            raise from_object_error(exc) from exc
        return Response(200)

    def object_legal_hold(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        oi = self._lock_target_info(ctx)
        if ctx.method == "GET":
            if objectlock.META_LEGAL_HOLD not in oi.user_defined:
                raise S3Error("NoSuchObjectLockConfiguration")
            status = "ON" if objectlock.legal_hold_on(oi.user_defined) \
                else "OFF"
            return Response(200, {"Content-Type": "application/xml"},
                            objectlock.legal_hold_xml(status))
        cfg = self._lock_config(ctx.bucket)
        if cfg is None or not cfg.enabled:
            raise S3Error("InvalidRequest",
                          "Bucket is missing ObjectLockConfiguration")
        try:
            status = objectlock.parse_legal_hold_body(ctx.body)
        except ET.ParseError as exc:
            raise S3Error("MalformedXML", str(exc)) from exc
        except ValueError as exc:
            raise S3Error("InvalidArgument", str(exc)) from exc
        try:
            self.ol.update_object_metadata(
                ctx.bucket, ctx.object, oi.version_id or "",
                {objectlock.META_LEGAL_HOLD: status})
        except StorageError as exc:
            raise from_object_error(exc) from exc
        return Response(200)

    # ---------- multipart ----------

    def new_multipart_upload(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        if not valid_object_name(ctx.object):
            raise S3Error("InvalidArgument", ctx.object)
        self._refuse_multipart_sse(ctx)
        opts = self._opts_for(ctx.bucket, ctx.qdict)
        opts.user_defined = extract_user_metadata(ctx.headers)
        self._apply_tagging_header(ctx, opts)
        self._apply_storage_class(ctx, opts)
        self._apply_codec(ctx, opts)
        self._apply_object_lock(ctx, opts)
        try:
            upload_id = self.ol.new_multipart_upload(ctx.bucket, ctx.object,
                                                     opts)
        except StorageError as exc:
            raise from_object_error(exc) from exc
        root = _xml_root("InitiateMultipartUploadResult")
        ET.SubElement(root, "Bucket").text = ctx.bucket
        ET.SubElement(root, "Key").text = ctx.object
        ET.SubElement(root, "UploadId").text = upload_id
        return Response.xml(root)

    @staticmethod
    def _refuse_multipart_sse(ctx) -> None:
        """An encrypted multipart upload is not served: minio_tpu ignores
        the SSE headers of its calls and stores the parts in plaintext."""
        if any(h.startswith(_SSE_HEADER_PREFIX) for h in ctx.headers):
            raise S3Error("NotImplemented",
                          "server-side encryption of multipart uploads")

    def put_object_part(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        self._refuse_multipart_sse(ctx)
        q = ctx.qdict
        upload_id = q.get("uploadId", "")
        try:
            part_number = int(q.get("partNumber", "0"))
        except ValueError as exc:
            raise S3Error("InvalidArgument", "partNumber") from exc
        if not 1 <= part_number <= MAX_PARTS:
            raise S3Error("InvalidArgument", f"partNumber {part_number}")
        copy_source = ctx.headers.get("x-amz-copy-source", "")
        if copy_source:
            return self._upload_part_copy(ctx, upload_id, part_number,
                                          copy_source)
        size = ctx.content_length
        if size is None:
            raise S3Error("MissingContentLength")
        if size > MAX_PART_SIZE:
            raise S3Error("EntityTooLarge")
        # Multipart is no way round the quota (enforceBucketQuotaHard).
        self._check_quota(ctx.bucket, size)
        part_opts = ObjectOptions(
            want_md5_hex=_parse_content_md5(ctx.headers))
        try:
            pi = self.ol.put_object_part(ctx.bucket, ctx.object, upload_id,
                                         part_number, ctx.body_reader, size,
                                         part_opts)
        except StorageError as exc:
            raise from_object_error(exc) from exc
        return Response(200, {"ETag": f'"{pi.etag}"'})

    def _upload_part_copy(self, ctx, upload_id: str, part_number: int,
                          copy_source: str) -> Response:
        """UploadPartCopy (CopyObjectPartHandler): the part's bytes are a
        range of the source, read in 1 MiB pulls; of a compressed source,
        a range of its decoded stream."""
        sbucket, sobject, src_opts, src_info = self._copy_source_info(
            ctx, copy_source)
        if ssemod.is_encrypted(src_info.user_defined):
            # minio_tpu copies the stored ciphertext into the part.
            raise S3Error("NotImplemented",
                          f"{sobject}: UploadPartCopy of an encrypted "
                          "source")
        compressed = bool(src_info.user_defined.get(
            transforms.META_COMPRESSION))
        src_size = transforms.actual_object_size(src_info.user_defined,
                                                 src_info.size)
        rng = ctx.headers.get("x-amz-copy-source-range", "")
        offset, length = 0, src_size
        if rng:
            # Strictly "bytes=first-last" inside the source: unlike an
            # HTTP Range, a suffix, open or overlong range is refused.
            m = re.fullmatch(r"bytes=(\d+)-(\d+)", rng)
            if not m:
                raise S3Error("InvalidArgument", rng)
            first, last = int(m.group(1)), int(m.group(2))
            if first > last or last >= src_size:
                raise S3Error("InvalidArgument", rng)
            offset, length = first, last - first + 1
        if length > MAX_PART_SIZE:
            raise S3Error("EntityTooLarge")
        try:
            if compressed:
                with transforms.decode_to_spool(
                        self.ol, sbucket, sobject, src_opts,
                        src_info.user_defined, ctx.headers,
                        self.sse_config, device=self.ol.device) as spool:
                    spool.seek(offset)
                    pi = self.ol.put_object_part(
                        ctx.bucket, ctx.object, upload_id, part_number,
                        LimitedSpool(spool, length), length)
            else:
                reader = _RangeCopyReader(self.ol, sbucket, sobject, offset,
                                          length, src_opts)
                pi = self.ol.put_object_part(ctx.bucket, ctx.object,
                                             upload_id, part_number, reader,
                                             length)
        except StorageError as exc:
            raise from_object_error(exc) from exc
        root = _xml_root("CopyPartResult")
        ET.SubElement(root, "LastModified").text = iso8601(pi.mod_time_ns)
        ET.SubElement(root, "ETag").text = f'"{pi.etag}"'
        return Response.xml(root)

    def complete_multipart_upload(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        upload_id = ctx.qdict.get("uploadId", "")
        try:
            req = ET.fromstring(ctx.body)
        except ET.ParseError as exc:
            raise S3Error("MalformedXML", str(exc)) from exc
        ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"
        parts = []
        for el in req:
            if el.tag.removeprefix(ns) != "Part":
                continue
            pn, etag = 0, ""
            for sub in el:
                t = sub.tag.removeprefix(ns)
                if t == "PartNumber":
                    pn = int(sub.text or "0")
                elif t == "ETag":
                    etag = (sub.text or "").strip('"')
            parts.append(CompletePart(pn, etag))
        if not parts:
            raise S3Error("MalformedXML", "no parts")
        if parts != sorted(parts, key=lambda p: p.part_number):
            raise S3Error("InvalidPartOrder")
        opts = self._opts_for(ctx.bucket, ctx.qdict)
        try:
            oi = self.ol.complete_multipart_upload(ctx.bucket, ctx.object,
                                                   upload_id, parts, opts)
        except StorageError as exc:
            raise from_object_error(exc) from exc
        root = _xml_root("CompleteMultipartUploadResult")
        ET.SubElement(root, "Location").text = f"/{ctx.bucket}/{ctx.object}"
        ET.SubElement(root, "Bucket").text = ctx.bucket
        ET.SubElement(root, "Key").text = ctx.object
        ET.SubElement(root, "ETag").text = f'"{oi.etag}"'
        headers = {}
        if oi.version_id and oi.version_id != "null":
            headers["x-amz-version-id"] = oi.version_id
        return Response.xml(root, headers=headers)

    def abort_multipart_upload(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        upload_id = ctx.qdict.get("uploadId", "")
        try:
            self.ol.abort_multipart_upload(ctx.bucket, ctx.object, upload_id)
        except StorageError as exc:
            raise from_object_error(exc) from exc
        return Response(204)

    def list_object_parts(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        q = ctx.qdict
        upload_id = q.get("uploadId", "")
        part_marker = int(q.get("part-number-marker", "0") or "0")
        max_parts = min(int(q.get("max-parts", "1000") or "1000"), 1000)
        try:
            parts = self.ol.list_object_parts(ctx.bucket, ctx.object,
                                              upload_id, part_marker,
                                              max_parts)
        except StorageError as exc:
            raise from_object_error(exc) from exc
        root = _xml_root("ListPartsResult")
        ET.SubElement(root, "Bucket").text = ctx.bucket
        ET.SubElement(root, "Key").text = ctx.object
        ET.SubElement(root, "UploadId").text = upload_id
        ET.SubElement(root, "PartNumberMarker").text = str(part_marker)
        ET.SubElement(root, "MaxParts").text = str(max_parts)
        truncated = len(parts) > max_parts
        parts = parts[:max_parts]
        ET.SubElement(root, "IsTruncated").text = (
            "true" if truncated else "false")
        if truncated and parts:
            ET.SubElement(root, "NextPartNumberMarker").text = str(
                parts[-1].part_number)
        for p in parts:
            pe = ET.SubElement(root, "Part")
            ET.SubElement(pe, "PartNumber").text = str(p.part_number)
            ET.SubElement(pe, "LastModified").text = iso8601(p.mod_time_ns)
            ET.SubElement(pe, "ETag").text = f'"{p.etag}"'
            ET.SubElement(pe, "Size").text = str(p.size)
        return Response.xml(root)

    def list_multipart_uploads(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        prefix = ctx.qdict.get("prefix", "")
        try:
            uploads = self.ol.list_multipart_uploads(ctx.bucket, prefix)
        except StorageError as exc:
            raise from_object_error(exc) from exc
        encode = self._listing_encoder(ctx)
        enc = encode or (lambda s: s)
        root = _xml_root("ListMultipartUploadsResult")
        ET.SubElement(root, "Bucket").text = ctx.bucket
        ET.SubElement(root, "Prefix").text = enc(prefix)
        if encode is not None:
            ET.SubElement(root, "EncodingType").text = "url"
        ET.SubElement(root, "IsTruncated").text = "false"
        for mp in uploads:
            u = ET.SubElement(root, "Upload")
            ET.SubElement(u, "Key").text = enc(mp.object)
            ET.SubElement(u, "UploadId").text = mp.upload_id
        return Response.xml(root)


class PostPolicyError(S3Error):
    """A POST policy whose expiration or conditions the form fails."""


def _parse_multipart_form(content_type: str, body: bytes):
    """multipart/form-data -> (fields, the file's bytes, its filename);
    the field names lower-cased."""
    raw = (f"Content-Type: {content_type}\r\nMIME-Version: 1.0\r\n\r\n"
           .encode() + body)
    msg = email.message_from_bytes(raw, policy=email.policy.HTTP)
    if not msg.is_multipart():
        raise S3Error("MalformedPOSTRequest", "not multipart/form-data")
    fields: dict[str, str] = {}
    file_data: bytes | None = None
    filename = ""
    for part in msg.iter_parts():
        name = part.get_param("name", header="content-disposition")
        if not name:
            continue
        payload = part.get_payload(decode=True) or b""
        if name == "file":
            file_data = payload
            filename = part.get_filename() or ""
        else:
            fields[name.lower()] = payload.decode("utf-8", "replace").strip()
    if file_data is None:
        raise S3Error("MalformedPOSTRequest", "missing file field")
    return fields, file_data, filename


# Form fields no condition has to cover (the AWS POST policy rule).
_POST_EXEMPT_FIELDS = frozenset({
    "policy", "x-amz-signature", "x-amz-algorithm", "x-amz-credential",
    "x-amz-date", "x-amz-security-token", "bucket", "success_action_status",
    "success_action_redirect"})


def _check_post_policy(policy_b64: str, fields: dict, size: int,
                       bucket: str) -> None:
    """The policy document's expiration (a naive time is UTC) and its
    conditions against the form's fields (checkPostPolicy): exact
    matches, eq, starts-with and content-length-range; every field but
    the exempt ones must be covered by a condition, so no metadata rides
    past the signer."""
    try:
        doc = json.loads(base64.b64decode(policy_b64))
    except Exception as exc:  # noqa: BLE001 - any undecodable document
        raise S3Error("MalformedPOSTRequest", "bad policy") from exc
    exp = doc.get("expiration", "")
    try:
        when = datetime.datetime.fromisoformat(
            str(exp).replace("Z", "+00:00"))
    except (ValueError, TypeError) as exc:
        raise S3Error("MalformedPOSTRequest", "bad expiration") from exc
    if when.tzinfo is None:
        when = when.replace(tzinfo=datetime.timezone.utc)
    if when < datetime.datetime.now(datetime.timezone.utc):
        raise PostPolicyError("AccessDenied", "policy expired")
    # The URL names the bucket: the conditions see it, whatever bucket
    # field the form carries (MinIO overwrites the form's; minio_tpu
    # keeps it, so a form signed for one bucket stores into another;
    # ROADMAP.md Queue 3).
    fields = dict(fields)
    fields["bucket"] = bucket
    covered: set[str] = set()
    try:
        for cond in doc.get("conditions", []):
            if isinstance(cond, dict):
                for k, v in cond.items():
                    k = str(k).lower().lstrip("$")
                    covered.add(k)
                    if k in ("policy", "x-amz-signature", "file"):
                        continue
                    if fields.get(k, "") != str(v):
                        raise PostPolicyError(
                            "AccessDenied", f"policy condition failed: {k}")
            elif isinstance(cond, list) and len(cond) == 3:
                op, key, val = str(cond[0]).lower(), str(cond[1]), cond[2]
                if op == "content-length-range":
                    lo, hi = int(cond[1]), int(cond[2])
                    if not lo <= size <= hi:
                        raise PostPolicyError(
                            "EntityTooLarge" if size > hi
                            else "EntityTooSmall",
                            f"{size} outside [{lo},{hi}]")
                    continue
                k = key.lower().lstrip("$")
                covered.add(k)
                have = fields.get(k, "")
                if op == "eq" and have != str(val):
                    raise PostPolicyError(
                        "AccessDenied", f"policy eq condition failed: {k}")
                if op == "starts-with" and not have.startswith(str(val)):
                    raise PostPolicyError(
                        "AccessDenied", f"policy starts-with failed: {k}")
            else:
                raise S3Error("MalformedPOSTRequest",
                              "unsupported condition shape")
    except S3Error:
        raise
    except Exception as exc:  # noqa: BLE001 - malformed document shapes
        raise S3Error("MalformedPOSTRequest",
                      f"bad policy conditions: {exc}") from exc
    for k in fields:
        if k not in _POST_EXEMPT_FIELDS and k not in covered:
            raise PostPolicyError("AccessDenied",
                                  f"form field {k!r} not covered by policy")
