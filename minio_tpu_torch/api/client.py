"""A minimal signed S3 client over http.client, signing with the port's
own api/sign.py: SigV4 headers (the payload hashed, or UNSIGNED), the
aws-chunked streaming signature minio-go uses for PutObject over plain
HTTP, and SigV2. It drives the S3 server in `entry.s3_put_get_heal`;
`put_stream` and `get_stream` move a body in pieces, so a large object
is never held whole on the client's side (`entry.s3_sse`). A client of a
temporary credential sends its `session_token` with every signed
request. `sts` posts an STS form, signed or not, and `post_policy` makes
and signs a browser form's POST policy and uploads a file with it.
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import hmac
import http.client
import json
import urllib.parse
import uuid

from . import sign


REGION = "us-east-1"
TIMEOUT_S = 600.0


class S3Client:
    def __init__(self, endpoint: str, access_key: str, secret_key: str,
                 session_token: str = ""):
        self.endpoint = endpoint
        self.access_key = access_key
        self.secret_key = secret_key
        self.session_token = session_token

    def _with_token(self, headers: dict) -> dict:
        if self.session_token:
            headers["X-Amz-Security-Token"] = self.session_token
        return headers

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
        if not anonymous:
            self._with_token(headers)
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
        headers = self._with_token(dict(headers or {}))
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
        headers = self._with_token(dict(headers or {}))
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
                                       self._with_token(
                                           {"Content-Length": str(size)}),
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
                                       self._with_token(dict(headers or {})),
                                       region=REGION)
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

    def sts(self, form: dict, signed: bool = True
            ) -> tuple[int, dict, bytes]:
        """POST an STS form to "/": AssumeRole signed by this client's
        key, the federated actions unsigned."""
        body = urllib.parse.urlencode(form).encode()
        headers = {"Content-Type": "application/x-www-form-urlencoded"}
        return self.request("POST", "/", headers=headers, body=body,
                            anonymous=not signed)

    def post_policy_fields(self, bucket: str, conditions: list,
                           expire_s: int = 600) -> dict:
        """The signed fields of a browser form: a policy document of the
        bucket's, the credential's and `conditions` expiring in
        `expire_s` seconds, signed with this client's secret (SigV4's
        policy signing: the string to sign is the policy)."""
        now = datetime.datetime.now(datetime.timezone.utc)
        date = now.strftime("%Y%m%d")
        cred = f"{self.access_key}/{date}/{REGION}/s3/aws4_request"
        conds = [{"bucket": bucket}, {"x-amz-credential": cred}]
        if self.session_token:
            conds.append({"x-amz-security-token": self.session_token})
        policy = {"expiration": (now + datetime.timedelta(seconds=expire_s)
                                 ).strftime("%Y-%m-%dT%H:%M:%SZ"),
                  "conditions": conds + list(conditions)}
        policy_b64 = base64.b64encode(json.dumps(policy).encode()).decode()
        sig = hmac.new(sign.signing_key(self.secret_key, date, REGION),
                       policy_b64.encode(), hashlib.sha256).hexdigest()
        fields = {"policy": policy_b64, "x-amz-credential": cred,
                  "x-amz-signature": sig,
                  "x-amz-algorithm": sign.SIGN_V4_ALGORITHM}
        if self.session_token:
            fields["x-amz-security-token"] = self.session_token
        return fields

    def post_form(self, bucket: str, fields: dict, data: bytes,
                  filename: str = "upload.bin") -> tuple[int, dict, bytes]:
        """POST multipart/form-data to the bucket: `fields`, then the file
        part (unsigned: the form's policy signs it)."""
        boundary = f"----mtpu{uuid.uuid4().hex}"
        parts = [f"--{boundary}\r\nContent-Disposition: form-data; "
                 f'name="{k}"\r\n\r\n{v}\r\n'.encode()
                 for k, v in fields.items()]
        parts.append(f"--{boundary}\r\nContent-Disposition: form-data; "
                     f'name="file"; filename="{filename}"\r\n'
                     f"Content-Type: application/octet-stream\r\n\r\n"
                     .encode() + data + b"\r\n")
        parts.append(f"--{boundary}--\r\n".encode())
        body = b"".join(parts)
        headers = {"Content-Type":
                   f"multipart/form-data; boundary={boundary}",
                   "Content-Length": str(len(body))}
        return self._send("POST", f"/{bucket}", [], headers, body)
