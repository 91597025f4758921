"""STS, temporary credentials: the port's copy of minio_tpu/api/sts.py
(MinIO's cmd/sts-handlers.go). AssumeRole (:149) is a SigV4-signed POST
of a form, with an optional session Policy and DurationSeconds; the
federated flows AssumeRoleWithWebIdentity and AssumeRoleWithClientGrants
(:324) and AssumeRoleWithLDAPIdentity (:534) are unsigned: the token, or
the directory's bind, is the credential.

The server has no egress, so an OIDC token's keys come from the
`identity_openid` config inline: `jwks` (a JWKS document of RSA keys,
RS256) or `hmac_secret` (HS256); the policy claim (`claim_name`, default
"policy") names the IAM policies the credential gets, and the token's
`exp` bounds its life. RS256 is verified here, with Python integers:
RSASSA-PKCS1-v1_5 with SHA-256 (RFC 8017 8.2.2), where minio_tpu calls
the `cryptography` package.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
import urllib.parse
import xml.etree.ElementTree as ET

from ..iam.policy import Policy
from ..iam.store import IAMSys
from ..utils.ldap import LDAPError, simple_bind
from .errors import S3Error
from .handlers import Response, iso8601

STS_VERSION = "2011-06-15"
MIN_DURATION_S = 900
MAX_DURATION_S = 7 * 24 * 3600
FEDERATED_ACTIONS = ("AssumeRoleWithWebIdentity",
                     "AssumeRoleWithClientGrants",
                     "AssumeRoleWithLDAPIdentity")

# The DER DigestInfo of a SHA-256 digest (RFC 8017 9.2, note 1).
SHA256_DIGEST_INFO = bytes.fromhex("3031300d060960864801650304020105000420")


def _b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def _verify_jwt(token: str, openid_cfg) -> dict:
    """The claims of an OIDC token checked against the configured keys;
    S3Error AccessDenied when it is malformed, its signature does not
    hold, it has expired or its audience is another client's."""
    parts = token.split(".")
    if len(parts) != 3:
        raise S3Error("AccessDenied", "malformed web identity token")
    try:
        header = json.loads(_b64url_decode(parts[0]))
        claims = json.loads(_b64url_decode(parts[1]))
        sig = _b64url_decode(parts[2])
    except (ValueError, json.JSONDecodeError) as exc:
        raise S3Error("AccessDenied", "malformed web identity token") from exc
    signing_input = f"{parts[0]}.{parts[1]}".encode()
    alg = header.get("alg", "")
    ok = False
    if alg == "HS256":
        secret = openid_cfg.get("hmac_secret", "")
        if secret:
            want = hmac.new(secret.encode(), signing_input,
                            hashlib.sha256).digest()
            ok = hmac.compare_digest(want, sig)
    elif alg == "RS256":
        jwks_raw = openid_cfg.get("jwks", "")
        if jwks_raw:
            ok = _verify_rs256(signing_input, sig, jwks_raw,
                               header.get("kid"))
    else:
        raise S3Error("AccessDenied", f"unsupported JWT alg {alg!r}")
    if not ok:
        raise S3Error("AccessDenied", "web identity token signature invalid")
    exp = claims.get("exp")
    if not isinstance(exp, (int, float)) or exp <= time.time():
        raise S3Error("AccessDenied", "web identity token expired")
    client_id = openid_cfg.get("client_id", "")
    if client_id:
        aud = claims.get("aud", "")
        auds = aud if isinstance(aud, list) else [aud]
        if client_id not in auds and claims.get("azp") != client_id:
            raise S3Error("AccessDenied", "token audience mismatch")
    return claims


def pkcs1v15_sha256(message: bytes, k: int) -> bytes | None:
    """EMSA-PKCS1-v1_5 of SHA-256(message) in `k` bytes (RFC 8017 9.2):
    00 01 FF..FF 00 || DigestInfo || H; None when k is too short."""
    t = SHA256_DIGEST_INFO + hashlib.sha256(message).digest()
    if k < len(t) + 11:
        return None
    return b"\x00\x01" + b"\xff" * (k - len(t) - 3) + b"\x00" + t


def rsa_pkcs1v15_verify(n: int, e: int, message: bytes,
                        sig: bytes) -> bool:
    """RSASSA-PKCS1-v1_5-VERIFY with SHA-256 (RFC 8017 8.2.2): the
    signature must be exactly as long as the modulus and below it, and
    s^e mod n must equal the encoded message, compared in constant time.
    A key the `cryptography` package refuses (an even or tiny modulus,
    e < 3, e >= n, an even e) verifies nothing."""
    if n < 3 or not n & 1 or e < 3 or e >= n or not e & 1:
        return False
    k = (n.bit_length() + 7) // 8
    if len(sig) != k:
        return False
    s = int.from_bytes(sig, "big")
    if s >= n:
        return False
    want = pkcs1v15_sha256(message, k)
    if want is None:
        return False
    return hmac.compare_digest(pow(s, e, n).to_bytes(k, "big"), want)


def _verify_rs256(signing_input: bytes, sig: bytes, jwks_raw: str,
                  kid: str | None) -> bool:
    """Whether an RSA key of the JWKS document verifies `sig`: each key
    of kty RSA whose kid is the header's (or either has none) is tried in
    turn, as minio_tpu does."""
    try:
        jwks = json.loads(jwks_raw)
    except ValueError:
        return False
    for key in jwks.get("keys", []):
        if key.get("kty") != "RSA":
            continue
        if kid and key.get("kid") and key["kid"] != kid:
            continue
        try:
            n = int.from_bytes(_b64url_decode(key["n"]), "big")
            e = int.from_bytes(_b64url_decode(key["e"]), "big")
        except (ValueError, KeyError, TypeError):
            continue
        if rsa_pkcs1v15_verify(n, e, signing_input, sig):
            return True
    return False


def is_sts_request(ctx) -> bool:
    """POST / with a form body (Action=AssumeRole*)."""
    if ctx.method != "POST" or ctx.bucket:
        return False
    return "x-www-form-urlencoded" in ctx.headers.get("content-type", "")


def sts_form(ctx) -> dict:
    return dict(urllib.parse.parse_qsl(ctx.body.decode(errors="replace")))


def handle_sts(ctx, iam: IAMSys, access_key: str, config=None) -> Response:
    """One STS call. `access_key` is the signer of an AssumeRole ("" for
    the unsigned federated actions)."""
    form = sts_form(ctx)
    action = form.get("Action", "")
    if action in ("AssumeRoleWithWebIdentity",
                  "AssumeRoleWithClientGrants"):
        return _handle_federated(ctx, iam, form, action, config)
    if action == "AssumeRoleWithLDAPIdentity":
        return _handle_ldap(ctx, iam, form, config)
    if action != "AssumeRole":
        raise S3Error("NotImplemented", f"STS action {action!r}")
    if form.get("Version") != STS_VERSION:
        raise S3Error("InvalidArgument", "missing STS Version")
    duration = _parse_duration(form)
    session_policy = None
    if form.get("Policy"):
        try:
            session_policy = Policy.parse(form["Policy"])
        except (ValueError, KeyError) as exc:
            raise S3Error("MalformedXML", f"session policy: {exc}") from exc
        if len(form["Policy"]) > 2048:
            raise S3Error("InvalidArgument", "session policy too large")
    cred = iam.new_sts_credentials(parent_user=access_key,
                                   duration_s=duration,
                                   session_policy=session_policy)
    return _creds_response(ctx, cred)


def _parse_duration(form: dict) -> int:
    try:
        duration = int(form.get("DurationSeconds", "3600"))
    except ValueError as exc:
        raise S3Error("InvalidArgument", "DurationSeconds") from exc
    if not MIN_DURATION_S <= duration <= MAX_DURATION_S:
        raise S3Error("InvalidArgument", f"DurationSeconds {duration}")
    return duration


def _handle_federated(ctx, iam: IAMSys, form: dict, action: str,
                      config) -> Response:
    """AssumeRoleWithWebIdentity and AssumeRoleWithClientGrants
    (cmd/sts-handlers.go:324, :441): the token's policy claim names the
    policies attached to the credential."""
    if form.get("Version") != STS_VERSION:
        raise S3Error("InvalidArgument", "missing STS Version")
    openid = config.get("identity_openid") if config is not None else None
    if openid is None or not (openid.get("jwks")
                              or openid.get("hmac_secret")):
        raise S3Error("NotImplemented", "identity_openid is not configured")
    token = form.get("WebIdentityToken") or form.get("Token") or ""
    if not token:
        raise S3Error("InvalidArgument", "missing token")
    claims = _verify_jwt(token, openid)
    duration = _parse_duration(form)
    # The token's exp bounds the credential's life: a token near its end
    # mints a credential near its end.
    duration = min(duration, int(claims["exp"] - time.time()))
    if duration <= 0:
        raise S3Error("AccessDenied", "web identity token expired")
    claim_name = openid.get("claim_name") or "policy"
    policy_claim = claims.get(claim_name, "")
    if isinstance(policy_claim, str):
        policy_names = [p.strip() for p in policy_claim.split(",")
                        if p.strip()]
    else:
        policy_names = [str(p) for p in policy_claim]
    if not policy_names:
        raise S3Error("AccessDenied",
                      f"token lacks the {claim_name!r} policy claim")
    cred = iam.new_federated_credentials(
        subject=str(claims.get("sub", "")), duration_s=duration,
        policy_names=policy_names)
    return _creds_response(ctx, cred, action=action)


def _handle_ldap(ctx, iam: IAMSys, form: dict, config) -> Response:
    """AssumeRoleWithLDAPIdentity (cmd/sts-handlers.go:534): the user's
    DN, uid=<LDAPUsername>,<user_dn_search_base_dn>, is bound with
    LDAPPassword against `identity_ldap`'s server, and the credential
    gets the policies mapped to `ldap:<username>`."""
    if form.get("Version") != STS_VERSION:
        raise S3Error("InvalidArgument", "missing STS Version")
    ldap_cfg = config.get("identity_ldap") if config is not None else None
    if ldap_cfg is None or not ldap_cfg.get("server_addr"):
        raise S3Error("NotImplemented", "identity_ldap is not configured")
    username = form.get("LDAPUsername", "")
    password = form.get("LDAPPassword", "")
    if not username or not password:
        raise S3Error("InvalidArgument", "missing LDAP credentials")
    # A name that could reach into the DN's syntax is refused outright.
    if any(c in username for c in ",=+<>#;\\\"\0"):
        raise S3Error("InvalidArgument", "invalid LDAP username")
    base_dn = ldap_cfg.get("user_dn_search_base_dn", "")
    dn = f"uid={username},{base_dn}" if base_dn else f"uid={username}"
    try:
        ok = simple_bind(ldap_cfg["server_addr"], dn, password)
    except LDAPError as exc:
        raise S3Error("InternalError", f"ldap: {exc}") from exc
    if not ok:
        raise S3Error("AccessDenied", "LDAP bind failed")
    subject = f"ldap:{username}"
    policy_names = list(iam.user_policy.get(subject, []))
    if not policy_names:
        raise S3Error("AccessDenied", f"no policies mapped for {subject}")
    duration = _parse_duration(form)
    cred = iam.new_federated_credentials(subject=subject,
                                         duration_s=duration,
                                         policy_names=policy_names)
    return _creds_response(ctx, cred, action="AssumeRoleWithLDAPIdentity")


def _creds_response(ctx, cred, action: str = "AssumeRole") -> Response:
    root = ET.Element(f"{action}Response")
    root.set("xmlns", "https://sts.amazonaws.com/doc/2011-06-15/")
    result = ET.SubElement(root, f"{action}Result")
    creds = ET.SubElement(result, "Credentials")
    ET.SubElement(creds, "AccessKeyId").text = cred.access_key
    ET.SubElement(creds, "SecretAccessKey").text = cred.secret_key
    ET.SubElement(creds, "SessionToken").text = cred.session_token
    ET.SubElement(creds, "Expiration").text = iso8601(cred.expiration_ns)
    meta = ET.SubElement(root, "ResponseMetadata")
    ET.SubElement(meta, "RequestId").text = ctx.request_id
    return Response.xml(root)
