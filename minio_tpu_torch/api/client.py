"""A minimal signed S3 client over http.client, signing with the port's
own api/sign.py: SigV4 headers (the payload hashed, or UNSIGNED), the
aws-chunked streaming signature minio-go uses for PutObject over plain
HTTP, and SigV2. It drives the S3 server in `entry.s3_put_get_heal`;
`put_stream` and `get_stream` move a body in pieces, so a large object
is never held whole on the client's side (`entry.s3_sse`).
"""

from __future__ import annotations

import datetime
import http.client
import urllib.parse

from . import sign


REGION = "us-east-1"
TIMEOUT_S = 600.0


class S3Client:
    def __init__(self, endpoint: str, access_key: str, secret_key: str):
        self.endpoint = endpoint
        self.access_key = access_key
        self.secret_key = secret_key

    def _send(self, method: str, path: str, query: list, headers: dict,
              body: bytes) -> tuple[int, dict, bytes]:
        qs = urllib.parse.urlencode(query)
        url = urllib.parse.quote(path) + (f"?{qs}" if qs else "")
        conn = http.client.HTTPConnection(self.endpoint, timeout=TIMEOUT_S)
        try:
            conn.request(method, url, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
            return resp.status, dict(resp.getheaders()), data
        finally:
            conn.close()

    def request(self, method: str, path: str, query=None, headers=None,
                body: bytes = b"", anonymous: bool = False,
                v2: bool = False) -> tuple[int, dict, bytes]:
        """One request, SigV4-signed unless `anonymous` or `v2`:
        (status, headers, body)."""
        query = list(query or [])
        headers = dict(headers or {})
        if v2:
            sig = sign.sign_v2(self.secret_key, method, path, query, headers)
            headers["Authorization"] = f"AWS {self.access_key}:{sig}"
            headers["Host"] = self.endpoint
        elif not anonymous:
            headers = sign.sign_v4_request(self.secret_key, self.access_key,
                                           method, self.endpoint, path,
                                           query, headers, body,
                                           region=REGION)
        return self._send(method, path, query, headers, body)

    def put_chunked(self, path: str, payload: bytes, headers=None,
                    chunk_size: int = 64 * 1024
                    ) -> tuple[int, dict, bytes]:
        """PutObject with the aws-chunked streaming signature."""
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        cred = sign.V4Credential(f"{self.access_key}/{now:%Y%m%d}/"
                                 f"{REGION}/s3/aws4_request")
        headers = dict(headers or {})
        headers.update({
            "Host": self.endpoint,
            "X-Amz-Date": amz_date,
            "X-Amz-Content-Sha256": sign.STREAMING_CONTENT_SHA256,
            "X-Amz-Decoded-Content-Length": str(len(payload)),
        })
        signed = sorted(k.lower() for k in headers)
        seed = sign.compute_v4_signature(
            self.secret_key, "PUT", path, [], headers, signed,
            sign.STREAMING_CONTENT_SHA256, amz_date, cred)
        headers["Authorization"] = (
            f"{sign.SIGN_V4_ALGORITHM} Credential={self.access_key}/"
            f"{cred.scope}, SignedHeaders={';'.join(signed)}, "
            f"Signature={seed}")
        body = sign.encode_chunked(payload, self.secret_key, cred, amz_date,
                                   seed, chunk_size=chunk_size)
        return self._send("PUT", path, [], headers, body)

    def put_stream(self, path: str, reader, size: int, headers=None
                   ) -> tuple[int, dict, bytes]:
        """PUT `size` bytes read from `reader` in pieces of 1 MiB, signed
        UNSIGNED-PAYLOAD."""
        headers = dict(headers or {})
        headers["Content-Length"] = str(size)
        headers = sign.sign_v4_request(self.secret_key, self.access_key,
                                       "PUT", self.endpoint, path, [],
                                       headers, region=REGION,
                                       payload_hash=sign.UNSIGNED_PAYLOAD)
        conn = http.client.HTTPConnection(self.endpoint, timeout=TIMEOUT_S,
                                          blocksize=1 << 20)
        try:
            conn.request("PUT", urllib.parse.quote(path), body=reader,
                         headers=headers)
            resp = conn.getresponse()
            return resp.status, dict(resp.getheaders()), resp.read()
        finally:
            conn.close()

    def put_refused(self, path: str, size: int, query=None
                    ) -> tuple[int, dict, bytes]:
        """Send the headers of a `size`-byte PUT (signed UNSIGNED-PAYLOAD)
        and read the answer before any body byte: the answer of a write
        the server refuses from its headers alone (a hard quota). A
        server that waits for the body instead times out the read."""
        query = list(query or [])
        headers = sign.sign_v4_request(self.secret_key, self.access_key,
                                       "PUT", self.endpoint, path, query,
                                       {"Content-Length": str(size)},
                                       region=REGION,
                                       payload_hash=sign.UNSIGNED_PAYLOAD)
        qs = urllib.parse.urlencode(query)
        url = urllib.parse.quote(path) + (f"?{qs}" if qs else "")
        conn = http.client.HTTPConnection(self.endpoint, timeout=TIMEOUT_S)
        try:
            conn.putrequest("PUT", url, skip_host=True,
                            skip_accept_encoding=True)
            for k, v in headers.items():
                conn.putheader(k, v)
            conn.endheaders()
            resp = conn.getresponse()
            return resp.status, dict(resp.getheaders()), resp.read()
        finally:
            conn.close()

    def get_stream(self, path: str, sink, query=None, headers=None
                   ) -> tuple[int, dict, int]:
        """GET with the body handed to sink(piece) in pieces of at most
        1 MiB: (status, headers, body bytes)."""
        query = list(query or [])
        headers = sign.sign_v4_request(self.secret_key, self.access_key,
                                       "GET", self.endpoint, path, query,
                                       dict(headers or {}), region=REGION)
        qs = urllib.parse.urlencode(query)
        url = urllib.parse.quote(path) + (f"?{qs}" if qs else "")
        conn = http.client.HTTPConnection(self.endpoint, timeout=TIMEOUT_S)
        try:
            conn.request("GET", url, headers=headers)
            resp = conn.getresponse()
            n = 0
            while piece := resp.read(1 << 20):
                sink(piece)
                n += len(piece)
            return resp.status, dict(resp.getheaders()), n
        finally:
            conn.close()
