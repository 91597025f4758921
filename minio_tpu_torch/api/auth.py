"""Request authentication and authorization, the port's copy of
minio_tpu/api/auth.py (MinIO's cmd/auth-handler.go checkRequestAuthType):
classify the auth type (anonymous, SigV2, SigV4, presigned, streaming),
verify the signature against the IAM credentials (the root, users,
service accounts and temporary credentials), and allow the action. An
anonymous request, or one the IAM refuses, is let through only by the
bucket's policy, as minio_tpu does.

A temporary (STS) credential is accepted only with its session token,
X-Amz-Security-Token in a header or the query, and a static one only
without a token, as MinIO's checkClaimsFromToken (cmd/auth-handler.go)
answers; minio_tpu reads no token at all (ROADMAP.md Queue 3). An
expired temporary credential is an unknown key, InvalidAccessKeyId, as
in minio_tpu (MinIO answers ExpiredToken).
"""

from __future__ import annotations

import hmac

from ..iam.policy import Args
from ..iam.store import IAMSys
from . import sign
from .errors import S3Error

AUTH_ANONYMOUS = "anonymous"
AUTH_SIGNED_V4 = "signed-v4"
AUTH_SIGNED_V2 = "signed-v2"
AUTH_PRESIGNED_V4 = "presigned-v4"
AUTH_PRESIGNED_V2 = "presigned-v2"
AUTH_STREAMING = "streaming-v4"
AUTH_JWT = "jwt"


def auth_type(headers: dict, query: dict) -> str:
    """Classify the request's auth mechanism (cmd/auth-handler.go:66)."""
    auth = headers.get("Authorization", headers.get("authorization", ""))
    sha = headers.get(
        "X-Amz-Content-Sha256", headers.get("x-amz-content-sha256", "")
    )
    if auth.startswith(sign.SIGN_V4_ALGORITHM):
        if sha == sign.STREAMING_CONTENT_SHA256:
            return AUTH_STREAMING
        return AUTH_SIGNED_V4
    if auth.startswith("AWS "):
        return AUTH_SIGNED_V2
    if auth.startswith("Bearer "):
        return AUTH_JWT
    if "X-Amz-Credential" in query:
        return AUTH_PRESIGNED_V4
    if "AWSAccessKeyId" in query:
        return AUTH_PRESIGNED_V2
    return AUTH_ANONYMOUS


class AuthResult:
    def __init__(self, access_key: str = "", auth: str = AUTH_ANONYMOUS,
                 cred=None, content_sha256: str = ""):
        self.access_key = access_key
        self.auth = auth
        self.cred = cred
        # Declared payload hash (bound by the signature): the server
        # checks the body against it as the handler reads it.
        self.content_sha256 = content_sha256

    @property
    def is_anonymous(self) -> bool:
        return self.auth == AUTH_ANONYMOUS


SECURITY_TOKEN = "X-Amz-Security-Token"


def session_token(headers: dict, query: dict) -> str:
    """The request's session token: the header, else the query
    parameter (getSessionToken)."""
    for k, v in headers.items():
        if k.lower() == SECURITY_TOKEN.lower() and v:
            return v
    return query.get(SECURITY_TOKEN, "")


def check_session_token(cred, token: str) -> None:
    """checkClaimsFromToken: a temporary credential needs its own token
    (compared in constant time), a static one none; else InvalidTokenId.
    A service account carries no token."""
    if cred.is_temp():
        if not hmac.compare_digest(token.encode(),
                                   cred.session_token.encode()):
            raise S3Error("InvalidTokenId", "session token")
    elif token:
        raise S3Error("InvalidTokenId", "a static key sent a session token")


def authenticate(iam: IAMSys, method: str, path: str,
                 query: list[tuple[str, str]], headers: dict) -> AuthResult:
    """Verify the request's signature. Raises S3Error on failure."""
    qdict = dict(query)
    at = auth_type(headers, qdict)
    if at == AUTH_ANONYMOUS:
        return AuthResult()
    if at == AUTH_JWT:
        raise S3Error("AccessDenied", "JWT auth is for the admin/web plane")

    def secret_for(access_key: str) -> str:
        cred = iam.get_credentials(access_key)
        if cred is None:
            raise S3Error("InvalidAccessKeyId", access_key)
        check_session_token(cred, session_token(headers, qdict))
        return cred.secret_key

    try:
        if at in (AUTH_SIGNED_V4, AUTH_STREAMING):
            auth_hdr = headers.get(
                "Authorization", headers.get("authorization", "")
            )
            cred_scope, _, _ = sign.parse_v4_auth_header(auth_hdr)
            secret = secret_for(cred_scope.access_key)
            sign.verify_v4_header(secret, method, path, query, headers)
            lower = {k.lower(): v for k, v in headers.items()}
            return AuthResult(
                cred_scope.access_key, at,
                iam.get_credentials(cred_scope.access_key),
                content_sha256=lower.get("x-amz-content-sha256", ""),
            )
        if at == AUTH_PRESIGNED_V4:
            cred_scope = sign.V4Credential(qdict.get("X-Amz-Credential", ""))
            secret = secret_for(cred_scope.access_key)
            sign.verify_v4_presigned(secret, method, path, query, headers)
            return AuthResult(
                cred_scope.access_key, at,
                iam.get_credentials(cred_scope.access_key),
                content_sha256=qdict.get("X-Amz-Content-Sha256", ""),
            )
        if at == AUTH_SIGNED_V2:
            auth_hdr = headers.get(
                "Authorization", headers.get("authorization", "")
            )
            access_key = auth_hdr[4:].split(":", 1)[0]
            secret = secret_for(access_key)
            sign.verify_v2_header(secret, method, path, query, headers)
            return AuthResult(access_key, at, iam.get_credentials(access_key))
        if at == AUTH_PRESIGNED_V2:
            raise S3Error("NotImplemented", "presigned V2")
    except sign.SignError as exc:
        raise S3Error(exc.code, str(exc)) from exc
    raise S3Error("SignatureVersionNotSupported")


def authorize(iam: IAMSys, bucket_policy, result: AuthResult, action: str,
              bucket: str, object_: str = "",
              conditions: dict | None = None) -> None:
    """Allow or deny the S3 action: an anonymous request falls back to
    the bucket policy, a signed one to the IAM and then the bucket policy
    (isPutActionAllowed / checkRequestAuthTypeCredential)."""
    conditions = conditions or {}
    if result.is_anonymous:
        if bucket_policy is not None and bucket_policy.is_allowed(Args(
                account="", action=action, bucket=bucket, object=object_,
                conditions=conditions)):
            return
        raise S3Error("AccessDenied", f"anonymous {action}")
    args = Args(account=result.access_key, action=action, bucket=bucket,
                object=object_, conditions=conditions)
    if iam.is_allowed(args):
        return
    if bucket_policy is not None and bucket_policy.is_allowed(args):
        return
    raise S3Error("AccessDenied", f"{result.access_key} {action}")
