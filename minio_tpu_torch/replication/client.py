"""The remote S3 client of the port's tiers, its copy of
minio_tpu/replication/client.py (MinIO reaches its remote targets with
minio-go, cmd/bucket-targets.go): PUT, GET, HEAD and DELETE of an object
with metadata and version ids, and HEAD of a bucket, signed with SigV4
by the port's own api/sign.py.

A file-like body is hashed in 1 MiB pieces for the payload hash, then
streamed over the wire (http.client sends a file-like body with its
Content-Length set), and `get_object_to` writes a GET's body to its
destination 1 MiB at a time: neither holds an object whole.
"""

from __future__ import annotations

import hashlib
import http.client
import time
import urllib.parse

from ..api.sign import sign_v4_request

PIECE = 1 << 20


class S3Error(Exception):
    def __init__(self, status: int, body: bytes):
        super().__init__(f"HTTP {status}: {body[:200]!r}")
        self.status = status
        self.body = body


class S3Client:
    """One remote endpoint ("host:port", plain HTTP) and its credential
    pair."""

    def __init__(self, endpoint: str, access_key: str, secret_key: str,
                 region: str = "us-east-1", timeout: int = 30):
        self.endpoint = endpoint
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region
        self.timeout = timeout
        # Host seconds spent hashing file-like bodies for SigV4.
        self.hash_seconds = 0.0

    def _request(self, method: str, path: str,
                 query: list[tuple[str, str]] | None = None,
                 headers: dict | None = None, body=b""):
        query = query or []
        qs = urllib.parse.urlencode(query)
        url = urllib.parse.quote(path) + (f"?{qs}" if qs else "")
        headers = dict(headers or {})
        payload_hash = None
        if not isinstance(body, (bytes, bytearray)):
            # The signature's payload hash, read from where the body
            # stands, which is then rewound for the send.
            t0 = time.perf_counter()
            pos = body.tell()
            h = hashlib.sha256()
            n = 0
            while True:
                chunk = body.read(PIECE)
                if not chunk:
                    break
                h.update(chunk)
                n += len(chunk)
            body.seek(pos)
            payload_hash = h.hexdigest()
            self.hash_seconds += time.perf_counter() - t0
            headers["Content-Length"] = str(n)
        headers = sign_v4_request(
            self.secret_key, self.access_key, method, self.endpoint,
            path, query, headers, body if payload_hash is None else b"",
            region=self.region, payload_hash=payload_hash)
        # A file-like body goes out PIECE bytes a send (http.client's
        # default is 8 KiB).
        conn = http.client.HTTPConnection(self.endpoint, timeout=self.timeout,
                                          blocksize=PIECE)
        try:
            conn.request(method, url, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, dict(resp.getheaders()), data
        finally:
            conn.close()

    # --- object calls ---

    def put_object(self, bucket: str, key: str, data,
                   metadata: dict | None = None) -> dict:
        """`data` is bytes or a seekable file-like (streamed)."""
        st, h, body = self._request("PUT", f"/{bucket}/{key}",
                                    headers=dict(metadata or {}), body=data)
        if st != 200:
            raise S3Error(st, body)
        return h

    def get_object(self, bucket: str, key: str,
                   version_id: str = "") -> tuple[bytes, dict]:
        q = [("versionId", version_id)] if version_id else []
        st, h, body = self._request("GET", f"/{bucket}/{key}", query=q)
        if st != 200:
            raise S3Error(st, body)
        return body, h

    def get_object_to(self, bucket: str, key: str, dst,
                      version_id: str = "") -> dict:
        """Stream a GET's body into `dst` 1 MiB at a time; returns the
        response headers."""
        query = [("versionId", version_id)] if version_id else []
        qs = urllib.parse.urlencode(query)
        path = f"/{bucket}/{key}"
        url = urllib.parse.quote(path) + (f"?{qs}" if qs else "")
        headers = sign_v4_request(
            self.secret_key, self.access_key, "GET", self.endpoint,
            path, query, {}, b"", region=self.region)
        conn = http.client.HTTPConnection(self.endpoint, timeout=self.timeout)
        try:
            conn.request("GET", url, headers=headers)
            resp = conn.getresponse()
            if resp.status != 200:
                raise S3Error(resp.status, resp.read())
            while True:
                chunk = resp.read(PIECE)
                if not chunk:
                    break
                dst.write(chunk)
            return dict(resp.getheaders())
        finally:
            conn.close()

    def head_object(self, bucket: str, key: str,
                    version_id: str = "") -> dict:
        q = [("versionId", version_id)] if version_id else []
        st, h, body = self._request("HEAD", f"/{bucket}/{key}", query=q)
        if st != 200:
            raise S3Error(st, body)
        return h

    def delete_object(self, bucket: str, key: str,
                      version_id: str = "") -> dict:
        q = [("versionId", version_id)] if version_id else []
        st, h, body = self._request("DELETE", f"/{bucket}/{key}", query=q)
        if st not in (200, 204):
            raise S3Error(st, body)
        return h

    def bucket_exists(self, bucket: str) -> bool:
        st, _, _ = self._request("HEAD", f"/{bucket}")
        return st == 200
