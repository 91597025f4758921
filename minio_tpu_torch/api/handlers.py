"""S3 API handlers, the port's copy of the S3ApiHandlers of
minio_tpu/api/handlers.py (MinIO's cmd/bucket-handlers.go,
bucket-listobjects-handlers.go and object-handlers.go) on the plain
path: the bucket calls, ListObjects v1 and v2, PutObject, GetObject
(whole, ranged, conditional), HeadObject, DeleteObject and the multipart
calls.

Each handler takes the parsed request and returns a Response; the
server has checked the signature and the action before. What the port
does not serve yet (SSE and compression, tagging, object lock, copies,
versioning and the other bucket configurations) is refused with
NotImplemented, never served half.
"""

from __future__ import annotations

import base64
import binascii
import datetime
import urllib.parse
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

from ..erasure import registry
from ..object.types import CompletePart, ObjectOptions
from ..utils.errors import StorageError
from .errors import S3Error, from_object_error

MAX_OBJECT_SIZE = 5 * 1024 ** 4         # 5 TiB
MAX_PART_SIZE = 5 * 1024 ** 3           # 5 GiB
MAX_PARTS = 10000
MAX_KEY_LENGTH = 1024

# Bucket configurations whose effect on the data path is not ported: a
# bucket that has one is not served.
_UNPORTED_BUCKET_CONFIG = (
    "versioning_xml", "lifecycle_xml", "sse_xml", "quota_json",
    "object_lock_xml", "notification_xml", "replication_xml",
)
# Request headers of features not ported.
_UNPORTED_HEADERS = (
    "x-amz-copy-source", "x-amz-tagging", "x-amz-server-side-encryption",
)
_LOCK_HEADERS = (
    "x-amz-object-lock-mode", "x-amz-object-lock-retain-until-date",
    "x-amz-object-lock-legal-hold",
)
# Stored metadata of objects whose bytes need a transform the port does
# not have (compression, SSE) or live on a remote tier.
_UNPORTED_OBJECT_META = (
    "x-mtpu-internal-compression", "x-mtpu-internal-sse-algorithm",
    "x-mtpu-internal-transition-tier",
)


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


class S3ApiHandlers:
    """The S3 endpoints of the slice, over an ObjectLayer."""

    def __init__(self, object_layer, bucket_meta):
        self.ol = object_layer
        self.bm = bucket_meta

    def _opts_for(self, bucket: str, query: dict) -> ObjectOptions:
        bmeta = self.bm.get(bucket)
        for f in _UNPORTED_BUCKET_CONFIG:
            if getattr(bmeta, f):
                raise S3Error("NotImplemented",
                              f"bucket {bucket}: {f} is not ported")
        # No versioning configuration, so no versioned write.
        return ObjectOptions(version_id=query.get("versionId", ""))

    @staticmethod
    def _refuse_unported_headers(ctx) -> None:
        for h in _UNPORTED_HEADERS:
            if h in ctx.headers:
                raise S3Error("NotImplemented", h)
        if any(h in ctx.headers for h in _LOCK_HEADERS):
            # No bucket of the port has an object lock configuration.
            raise S3Error("InvalidRequest",
                          "Bucket is missing ObjectLockConfiguration")

    @staticmethod
    def _apply_storage_class(ctx) -> None:
        """x-amz-storage-class: STANDARD or REDUCED_REDUNDANCY, both the
        set's default parity with no storage_class configuration."""
        sc = ctx.headers.get("x-amz-storage-class", "").upper()
        if sc and sc not in ("STANDARD", "REDUCED_REDUNDANCY"):
            raise S3Error("InvalidStorageClass", sc)

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
        self._refuse_unported_headers(ctx)
        size = ctx.content_length
        if size is None:
            raise S3Error("MissingContentLength")
        if size > MAX_OBJECT_SIZE:
            raise S3Error("EntityTooLarge")
        opts = self._opts_for(ctx.bucket, ctx.qdict)
        opts.user_defined = extract_user_metadata(ctx.headers)
        self._apply_storage_class(ctx)
        self._apply_codec(ctx, opts)
        # Checked inside the object layer as the body streams, before the
        # commit: a bad digest leaves nothing behind.
        opts.want_md5_hex = _parse_content_md5(ctx.headers)
        try:
            oi = self.ol.put_object(ctx.bucket, ctx.object, ctx.body_reader,
                                    size, opts)
        except StorageError as exc:
            raise from_object_error(exc) from exc
        headers = {"ETag": f'"{oi.etag}"'}
        if oi.version_id and oi.version_id != "null":
            headers["x-amz-version-id"] = oi.version_id
        return Response(200, headers)

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
            if k.startswith("x-amz-meta-"):
                headers[k] = v
            elif k in _REMEMBERED_HEADERS and k != "content-type":
                headers[k.title()] = v
        if oi.user_defined.get("x-amz-storage-class",
                               "STANDARD") != "STANDARD":
            headers["x-amz-storage-class"] = \
                oi.user_defined["x-amz-storage-class"]
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
        for k in _UNPORTED_OBJECT_META:
            if oi.user_defined.get(k):
                raise S3Error("NotImplemented", f"{ctx.object}: {k}")
        return oi

    def get_object(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        opts = self._opts_for(ctx.bucket, ctx.qdict)
        oi = self._object_info(ctx, opts)
        early = self._conditional_headers(ctx, oi)
        if early is not None:
            return early
        rng = parse_range(ctx.headers.get("range", ""), oi.size)
        offset, length = rng if rng else (0, oi.size)
        # The stream serves the advertised version or nothing.
        opts.expected_etag = oi.etag

        def stream(dst):
            # The decode writes each block to the socket as it is made:
            # the object is never held whole.
            self.ol.get_object(ctx.bucket, ctx.object, dst, offset=offset,
                               length=length, opts=opts)

        headers = self._object_headers(ctx, oi)
        headers["Content-Length"] = str(length)
        if rng:
            headers["Content-Range"] = (
                f"bytes {offset}-{offset + length - 1}/{oi.size}")
            return Response(206, headers, body_stream=stream)
        return Response(200, headers, body_stream=stream)

    def head_object(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        opts = self._opts_for(ctx.bucket, ctx.qdict)
        oi = self._object_info(ctx, opts)
        early = self._conditional_headers(ctx, oi)
        if early is not None:
            return early
        headers = self._object_headers(ctx, oi)
        headers["Content-Length"] = str(oi.size)
        return Response(200, headers)

    def delete_object(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        opts = self._opts_for(ctx.bucket, ctx.qdict)
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

    # ---------- multipart ----------

    def new_multipart_upload(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        if not valid_object_name(ctx.object):
            raise S3Error("InvalidArgument", ctx.object)
        self._refuse_unported_headers(ctx)
        opts = self._opts_for(ctx.bucket, ctx.qdict)
        opts.user_defined = extract_user_metadata(ctx.headers)
        self._apply_storage_class(ctx)
        self._apply_codec(ctx, opts)
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

    def put_object_part(self, ctx) -> Response:
        self._check_bucket(ctx.bucket)
        q = ctx.qdict
        upload_id = q.get("uploadId", "")
        try:
            part_number = int(q.get("partNumber", "0"))
        except ValueError as exc:
            raise S3Error("InvalidArgument", "partNumber") from exc
        if not 1 <= part_number <= MAX_PARTS:
            raise S3Error("InvalidArgument", f"partNumber {part_number}")
        if "x-amz-copy-source" in ctx.headers:
            raise S3Error("NotImplemented", "UploadPartCopy")
        size = ctx.content_length
        if size is None:
            raise S3Error("MissingContentLength")
        if size > MAX_PART_SIZE:
            raise S3Error("EntityTooLarge")
        part_opts = ObjectOptions(
            want_md5_hex=_parse_content_md5(ctx.headers))
        try:
            pi = self.ol.put_object_part(ctx.bucket, ctx.object, upload_id,
                                         part_number, ctx.body_reader, size,
                                         part_opts)
        except StorageError as exc:
            raise from_object_error(exc) from exc
        return Response(200, {"ETag": f'"{pi.etag}"'})

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
