"""STS on the port (minio_tpu_torch/api/sts.py, the STS plane of
api/server.py, utils/ldap.py) against minio_tpu's, over HTTP on
localhost, on the CPU.

Both packages' S3Servers (4 drives, one set) carry a ConfigSys with
identity_openid (an HS256 secret, the JWKS of an RSA key this file makes
with Python integers, a client id) and identity_ldap (tests/
test_ldap_sts.py's ToyLDAPServer), and the same IAM policies:

- AssumeRole (signed, with a session Policy and DurationSeconds),
  AssumeRoleWithWebIdentity with HS256 and RS256 tokens,
  AssumeRoleWithClientGrants and AssumeRoleWithLDAPIdentity: the same
  status, the same answer field for field but the random keys and token,
  an Expiration the duration (or the token's exp) ahead, and credentials
  that work as their policies say;
- the rejections of tests/test_sts_observability.py:114 and
  tests/test_ldap_sts.py:160-178, and the form's own (Version,
  DurationSeconds, Policy, an unknown action, an unsigned AssumeRole):
  the same status and error code;
- the port's RS256 verify (RSASSA-PKCS1-v1_5 with SHA-256 in Python
  integers) against minio_tpu's, which calls the `cryptography` package,
  on a valid signature and on tampered signatures, digests, paddings,
  lengths and key sets: the same verdict;
- where the port differs on purpose (ROADMAP.md Queue 3): a temporary
  credential without its session token, or with another, and a static
  key with a token, are served by minio_tpu and answered 403
  InvalidTokenId by the port (MinIO's checkClaimsFromToken); an expired
  temporary credential is InvalidAccessKeyId on both (copied: MinIO
  answers ExpiredToken).
"""

import calendar
import hashlib
import json
import re
import time
import xml.etree.ElementTree as ET

import pytest
import torch

from minio_tpu.api import sts as jax_sts
from minio_tpu.iam.policy import Policy as JaxPolicy
from minio_tpu_torch import entry
from minio_tpu_torch.api import sts
from minio_tpu_torch.api.client import S3Client
from minio_tpu_torch.iam.policy import Policy
from tests.test_ldap_sts import USERS, ToyLDAPServer
from tests.test_torch_compression import _s3server
from tests.test_torch_compression import env  # noqa: F401 - fixture

torch.set_num_threads(1)

PORT, JAX = "port", "jax"
PKGS = (JAX, PORT)
ACCESS, SECRET = "tpuadmin", "tpuadmin-secret-key"
HMAC_SECRET = "oidc-shared-secret"
CLIENT_ID = "mtpu-app"
KID = "test-rsa"
KEY = entry.rsa_keypair(2026)
OTHER_KEY = entry.rsa_keypair(2027)
NS = "{https://sts.amazonaws.com/doc/2011-06-15/}"
READONLY_DATA = json.dumps({"Version": "2012-10-17", "Statement": [{
    "Effect": "Allow", "Action": ["s3:GetObject", "s3:ListBucket"],
    "Resource": ["arn:aws:s3:::*"]}]})
DATA_RW = json.dumps({"Version": "2012-10-17", "Statement": [{
    "Effect": "Allow", "Action": ["s3:*"],
    "Resource": ["arn:aws:s3:::stsdata", "arn:aws:s3:::stsdata/*"]}]})
GET_ONLY = json.dumps({"Version": "2012-10-17", "Statement": [{
    "Effect": "Allow", "Action": ["s3:GetObject"],
    "Resource": ["arn:aws:s3:::stsdata/*"]}]})


@pytest.fixture(scope="module")
def ldap_server():
    srv = ToyLDAPServer()
    yield srv
    srv.stop()


@pytest.fixture
def servers(env, tmp_path, ldap_server):  # noqa: F811
    """Both packages' servers, each with bucket stsdata holding `doc`, the
    policies readonly-data and data-rw, the user alice (data-rw) and the
    mapping ldap:alice -> data-rw."""
    kv = {"identity_openid": {"hmac_secret": HMAC_SECRET,
                              "client_id": CLIENT_ID,
                              "jwks": entry.jwks_of(KEY, KID)},
          "identity_ldap": {"server_addr": ldap_server.addr,
                            "user_dn_search_base_dn": "dc=example,dc=org"}}
    out = {}
    for pkg in PKGS:
        srv = _s3server(pkg, tmp_path / pkg, kv=kv)
        policy_cls = Policy if pkg == PORT else JaxPolicy
        srv.iam.set_policy("readonly-data", policy_cls.parse(READONLY_DATA))
        srv.iam.set_policy("data-rw", policy_cls.parse(DATA_RW))
        srv.iam.add_user("alice", "alice-secret-key")
        srv.iam.attach_policy("alice", ["data-rw"])
        srv.iam.attach_policy("ldap:alice", ["data-rw"])
        c = S3Client(srv.endpoint, ACCESS, SECRET)
        assert c.request("PUT", "/stsdata")[0] == 200
        assert c.request("PUT", "/stsdata/doc", body=b"federated read")[0] \
            == 200
        out[pkg] = srv
    yield out
    for srv in out.values():
        srv.stop()


def _claims(**over) -> dict:
    c = {"sub": "user@idp", "aud": CLIENT_ID,
         "exp": int(time.time()) + 3600, "policy": "readonly-data"}
    c.update(over)
    return {k: v for k, v in c.items() if v is not None}


def _token(alg: str, claims: dict, secret: str = HMAC_SECRET,
           key: dict = KEY, kid: str = KID) -> str:
    if alg == "HS256":
        return entry.jwt_hs256(claims, secret)
    return entry.jwt_rs256(claims, key, kid)


def _sts(srv, form: dict, signed_by=None, token: str = ""):
    """POST an STS form: unsigned, or signed by (access, secret)."""
    if signed_by is None:
        return S3Client(srv.endpoint, "", "").sts(form, signed=False)
    return S3Client(srv.endpoint, *signed_by,
                    session_token=token).sts(form)


def _code(body: bytes) -> str:
    m = re.search(rb"<Code>(.*?)</Code>", body)
    return m.group(1).decode() if m else ""


def _answer(status: int, body: bytes, duration_s: float) -> dict:
    """What two STS answers share: the status, the element tree's tags
    with the keys and token masked, the Expiration's distance from now
    to the second, an error's code."""
    out = {"status": status}
    if status != 200:
        out["code"] = _code(body)
        return out
    root = ET.fromstring(body)
    out["tags"] = [el.tag for el in root.iter()]
    creds = {t: root.findtext(f".//{NS}{t}")
             for t in ("AccessKeyId", "SecretAccessKey", "SessionToken",
                       "Expiration")}
    out["key_lengths"] = (len(creds["AccessKeyId"]),
                          len(creds["SecretAccessKey"]) > 0,
                          len(creds["SessionToken"]) > 0)
    exp = calendar.timegm(time.strptime(creds["Expiration"][:19],
                                        "%Y-%m-%dT%H:%M:%S"))
    out["expires_in_duration"] = abs(exp - time.time() - duration_s) < 5
    out["request_id"] = bool(root.findtext(f".//{NS}RequestId"))
    return out


def _creds(body: bytes) -> dict:
    return entry.sts_credentials(body)


# --- the flows -------------------------------------------------------------

@pytest.mark.parametrize("alg", ["HS256", "RS256"])
def test_web_identity_flow(servers, alg):
    """tests/test_sts_observability.py's web identity flow, with an HS256
    and an RS256 token: the temporary credential reads and cannot write."""
    answers = {}
    for pkg, srv in servers.items():
        st, _, body = _sts(srv, {
            "Action": "AssumeRoleWithWebIdentity", "Version": "2011-06-15",
            "WebIdentityToken": _token(alg, _claims()),
            "DurationSeconds": "900"})
        got = _creds(body)
        fed = S3Client(srv.endpoint, got["AccessKeyId"],
                       got["SecretAccessKey"],
                       session_token=got["SessionToken"])
        answers[pkg] = (_answer(st, body, 900),
                        fed.request("GET", "/stsdata/doc")[::2],
                        fed.request("PUT", "/stsdata/nope", body=b"x")[0])
    assert answers[PORT] == answers[JAX]
    assert answers[PORT][1] == (200, b"federated read")
    assert answers[PORT][2] == 403


def test_client_grants_flow(servers):
    answers = {}
    for pkg, srv in servers.items():
        st, _, body = _sts(srv, {
            "Action": "AssumeRoleWithClientGrants", "Version": "2011-06-15",
            "Token": _token("HS256", _claims(sub="svc"))})
        answers[pkg] = (_answer(st, body, 3600),
                        b"AssumeRoleWithClientGrantsResult" in body)
    assert answers[PORT] == answers[JAX]
    assert answers[PORT][0]["status"] == 200 and answers[PORT][1]


def test_token_exp_bounds_the_credential(servers):
    """A token that ends in 1,000 s mints a credential that ends with it,
    whatever DurationSeconds asks."""
    answers = {}
    for pkg, srv in servers.items():
        st, _, body = _sts(srv, {
            "Action": "AssumeRoleWithWebIdentity", "Version": "2011-06-15",
            "WebIdentityToken": _token("RS256", _claims(
                exp=int(time.time()) + 1000)),
            "DurationSeconds": "3600"})
        answers[pkg] = _answer(st, body, 1000)
    assert answers[PORT] == answers[JAX]
    assert answers[PORT]["expires_in_duration"]


WEB_REJECTIONS = {
    "wrong_signature": lambda: _token("HS256", _claims(), secret="wrong"),
    "expired": lambda: _token("HS256", _claims(exp=int(time.time()) - 10)),
    "audience_mismatch": lambda: _token("HS256", _claims(aud="other-app")),
    "no_policy_claim": lambda: _token("HS256", _claims(policy=None)),
    "rs256_other_key": lambda: _token("RS256", _claims(), key=OTHER_KEY),
    "rs256_other_kid": lambda: _token("RS256", _claims(), kid="rotated"),
    "rs256_expired": lambda: _token("RS256", _claims(
        exp=int(time.time()) - 10)),
    "unsupported_alg": lambda: entry.jwt_hs256(_claims(), HMAC_SECRET
                                               ).replace(
        entry._b64url(b'{"alg": "HS256", "typ": "JWT"}'),
        entry._b64url(b'{"alg": "none", "typ": "JWT"}')),
    "malformed": lambda: "not-a-jwt",
    "missing_token": lambda: "",
}


@pytest.mark.parametrize("case", sorted(WEB_REJECTIONS))
def test_web_identity_rejections(servers, case):
    """tests/test_sts_observability.py:114's rejections and more: the
    same status and error code on both packages."""
    answers = {}
    for pkg, srv in servers.items():
        action = ("AssumeRoleWithClientGrants" if case == "no_policy_claim"
                  else "AssumeRoleWithWebIdentity")
        form = {"Action": action, "Version": "2011-06-15"}
        token = WEB_REJECTIONS[case]()
        if token:
            form["Token" if action.endswith("Grants")
                 else "WebIdentityToken"] = token
        st, _, body = _sts(srv, form)
        answers[pkg] = (st, _code(body))
    assert answers[PORT] == answers[JAX]
    assert answers[PORT][0] in (400, 403)


def test_assume_role_with_a_session_policy(servers):
    """AssumeRole signed by alice with a session policy of GetObject
    alone: the credential reads, cannot write (its parent could), and
    never widens past its parent (nothing outside stsdata)."""
    answers = {}
    for pkg, srv in servers.items():
        st, _, body = _sts(srv, {
            "Action": "AssumeRole", "Version": "2011-06-15",
            "DurationSeconds": "1800", "Policy": GET_ONLY},
            signed_by=("alice", "alice-secret-key"))
        got = _creds(body)
        temp = S3Client(srv.endpoint, got["AccessKeyId"],
                        got["SecretAccessKey"],
                        session_token=got["SessionToken"])
        root = S3Client(srv.endpoint, ACCESS, SECRET)
        root.request("PUT", "/elsewhere")
        answers[pkg] = (_answer(st, body, 1800),
                        temp.request("GET", "/stsdata/doc")[::2],
                        temp.request("PUT", "/stsdata/n", body=b"x")[0],
                        temp.request("GET", "/elsewhere")[0])
    assert answers[PORT] == answers[JAX]
    assert answers[PORT][1:] == ((200, b"federated read"), 403, 403)


ASSUME_ROLE_REJECTIONS = {
    "unsigned": ({"Action": "AssumeRole", "Version": "2011-06-15"}, False),
    "no_version": ({"Action": "AssumeRole"}, True),
    "duration_short": ({"Action": "AssumeRole", "Version": "2011-06-15",
                        "DurationSeconds": "899"}, True),
    "duration_long": ({"Action": "AssumeRole", "Version": "2011-06-15",
                       "DurationSeconds": str(7 * 86400 + 1)}, True),
    "duration_nan": ({"Action": "AssumeRole", "Version": "2011-06-15",
                      "DurationSeconds": "soon"}, True),
    "policy_malformed": ({"Action": "AssumeRole", "Version": "2011-06-15",
                          "Policy": "{not json"}, True),
    "policy_too_large": ({"Action": "AssumeRole", "Version": "2011-06-15",
                          "Policy": json.dumps({
                              "Version": "2012-10-17", "Statement": [{
                                  "Effect": "Allow",
                                  "Action": ["s3:GetObject"],
                                  "Resource": [f"arn:aws:s3:::b{i}/*"
                                               for i in range(120)]}]})},
                         True),
    "unknown_action": ({"Action": "GetFederationToken",
                        "Version": "2011-06-15"}, True),
    "federated_without_version": ({"Action": "AssumeRoleWithWebIdentity",
                                   "WebIdentityToken": "x"}, False),
}


@pytest.mark.parametrize("case", sorted(ASSUME_ROLE_REJECTIONS))
def test_sts_form_rejections(servers, case):
    form, signed = ASSUME_ROLE_REJECTIONS[case]
    answers = {}
    for pkg, srv in servers.items():
        st, _, body = _sts(srv, form, (ACCESS, SECRET) if signed else None)
        answers[pkg] = (st, _code(body))
    assert answers[PORT] == answers[JAX]
    assert answers[PORT][0] >= 400


def test_ldap_flow(servers):
    """tests/test_ldap_sts.py's flow: the minted credential makes a
    bucket."""
    answers = {}
    for pkg, srv in servers.items():
        st, _, body = _sts(srv, {
            "Action": "AssumeRoleWithLDAPIdentity", "Version": "2011-06-15",
            "LDAPUsername": "alice", "LDAPPassword": "wonderland"})
        got = _creds(body)
        temp = S3Client(srv.endpoint, got["AccessKeyId"],
                        got["SecretAccessKey"],
                        session_token=got["SessionToken"])
        answers[pkg] = (_answer(st, body, 3600),
                        temp.request("PUT", "/stsdata/ldap",
                                     body=b"bound")[0],
                        temp.request("PUT", "/ldapbkt")[0])
    assert answers[PORT] == answers[JAX]
    assert answers[PORT][0]["status"] == 200
    assert answers[PORT][1:] == (200, 403)


def _ldap_form(user: str, password: str) -> dict:
    return {"Action": "AssumeRoleWithLDAPIdentity", "Version": "2011-06-15",
            "LDAPUsername": user, "LDAPPassword": password}


@pytest.mark.parametrize("case", ["bad_password", "unmapped_user",
                                  "dn_injection", "empty_password",
                                  "directory_down"])
def test_ldap_rejections(servers, case, monkeypatch):
    """tests/test_ldap_sts.py:160-178 and more: the same status and error
    code on both packages."""
    monkeypatch.setitem(USERS, "uid=ursula,dc=example,dc=org", "unmapped")
    form = {"bad_password": _ldap_form("alice", "nope"),
            "unmapped_user": _ldap_form("ursula", "unmapped"),
            "dn_injection": _ldap_form("alice,dc=example,dc=org", "x"),
            "empty_password": _ldap_form("alice", ""),
            "directory_down": _ldap_form("alice", "wonderland")}[case]
    answers = {}
    for pkg, srv in servers.items():
        if case == "directory_down":
            srv.handlers.config.set_kv("identity_ldap",
                                       server_addr="127.0.0.1:1")
        st, _, body = _sts(srv, form)
        answers[pkg] = (st, _code(body), b"no policies mapped" in body)
    assert answers[PORT] == answers[JAX]
    assert answers[PORT][0] == {"bad_password": 403, "unmapped_user": 403,
                                "dn_injection": 400, "empty_password": 400,
                                "directory_down": 500}[case]


def test_ldap_bind_codec_matches():
    """The port's BER bind request and response parse equal minio_tpu's."""
    from minio_tpu.utils import ldap as jax_ldap
    from minio_tpu_torch.utils import ldap

    for mid, dn, pw in ((1, "uid=a,dc=b", "pw"), (300, "x" * 200, "y" * 130)):
        assert ldap.bind_request(mid, dn, pw) == jax_ldap.bind_request(
            mid, dn, pw)
    resp = ldap._ber(0x30, ldap._ber_int(7) + ldap._ber(
        0x61, bytes([0x0A, 0x01, 49]) + ldap._ber(0x04, b"")
        + ldap._ber(0x04, b"")))
    assert ldap.parse_bind_response(resp) == 49
    assert jax_ldap.parse_bind_response(resp) == 49
    with pytest.raises(ldap.LDAPError):
        ldap.parse_bind_response(b"\x30\x05\x02")


# --- the RS256 verify --------------------------------------------------------

def _sign_em(em: bytes, key: dict = KEY) -> bytes:
    k = (key["n"].bit_length() + 7) // 8
    return pow(int.from_bytes(em, "big"), key["d"], key["n"]).to_bytes(
        k, "big")


def _em(message: bytes, digest_info: bytes = sts.SHA256_DIGEST_INFO,
        block_type: int = 1, fill: int = 0xFF, sep: int = 0,
        hash_fn=hashlib.sha256) -> bytes:
    t = digest_info + hash_fn(message).digest()
    k = (KEY["n"].bit_length() + 7) // 8
    return bytes([0, block_type]) + bytes([fill]) * (k - len(t) - 3) \
        + bytes([sep]) + t


MSG = b"header.payload"
SHA1_INFO = bytes.fromhex("3021300906052b0e03021a05000414")
JWKS = entry.jwks_of(KEY, KID)


def _jwks_without_kid() -> str:
    doc = json.loads(JWKS)
    del doc["keys"][0]["kid"]
    return json.dumps(doc)


def _jwks_kty(kty: str) -> str:
    doc = json.loads(JWKS)
    doc["keys"][0]["kty"] = kty
    return json.dumps(doc)


def _jwks_two_keys() -> str:
    a = json.loads(entry.jwks_of(OTHER_KEY, "old"))["keys"]
    b = json.loads(JWKS)["keys"]
    return json.dumps({"keys": a + b})


RS256_CASES = {
    "valid": (MSG, lambda: _sign_em(_em(MSG)), JWKS, KID, True),
    "valid_no_kid_in_header": (MSG, lambda: _sign_em(_em(MSG)), JWKS, None,
                               True),
    "valid_no_kid_in_key": (MSG, lambda: _sign_em(_em(MSG)),
                            _jwks_without_kid(), KID, True),
    "valid_second_key": (MSG, lambda: _sign_em(_em(MSG)), _jwks_two_keys(),
                         None, True),
    "flipped_signature_bit": (MSG, lambda: bytes(
        [_sign_em(_em(MSG))[0] ^ 1]) + _sign_em(_em(MSG))[1:], JWKS, KID,
        False),
    "other_message": (b"header.payload2", lambda: _sign_em(_em(MSG)), JWKS,
                      KID, False),
    "sha1_digest_info": (MSG, lambda: _sign_em(_em(
        MSG, SHA1_INFO, hash_fn=hashlib.sha1)), JWKS, KID, False),
    "block_type_2": (MSG, lambda: _sign_em(_em(MSG, block_type=2)), JWKS,
                     KID, False),
    "padding_not_ff": (MSG, lambda: _sign_em(_em(MSG, fill=0xFE)), JWKS,
                       KID, False),
    "no_separator": (MSG, lambda: _sign_em(_em(MSG, sep=0xFF)), JWKS, KID,
                     False),
    "short_signature": (MSG, lambda: _sign_em(_em(MSG))[1:], JWKS, KID,
                        False),
    "long_signature": (MSG, lambda: b"\x00" + _sign_em(_em(MSG)), JWKS, KID,
                       False),
    "signature_above_modulus": (MSG, lambda: (KEY["n"] + 5).to_bytes(
        256, "big"), JWKS, KID, False),
    "other_key": (MSG, lambda: _sign_em(_em(MSG), OTHER_KEY), JWKS, KID,
                  False),
    "kid_mismatch": (MSG, lambda: _sign_em(_em(MSG)), JWKS, "rotated",
                     False),
    "kty_ec": (MSG, lambda: _sign_em(_em(MSG)), _jwks_kty("EC"), KID, False),
    "jwks_junk": (MSG, lambda: _sign_em(_em(MSG)), "{not json", KID, False),
    "jwks_missing_n": (MSG, lambda: _sign_em(_em(MSG)), json.dumps(
        {"keys": [{"kty": "RSA", "kid": KID, "e": "AQAB"}]}), KID, False),
}


@pytest.mark.parametrize("case", sorted(RS256_CASES))
def test_rs256_verify_matches_cryptography(case):
    message, make_sig, jwks, kid, want = RS256_CASES[case]
    sig = make_sig()
    port = sts._verify_rs256(message, sig, jwks, kid)
    jax = jax_sts._verify_rs256(message, sig, jwks, kid)
    assert port == jax == want


def test_pkcs1v15_encoding_is_rfc8017():
    """The encoded message of a 2048-bit key: 00 01, 202 bytes of FF, 00,
    the SHA-256 DigestInfo and the digest."""
    em = sts.pkcs1v15_sha256(MSG, 256)
    assert em[:2] == b"\x00\x01" and em[2:204] == b"\xff" * 202
    assert em[204] == 0 and em[205:224] == sts.SHA256_DIGEST_INFO
    assert em[224:] == hashlib.sha256(MSG).digest()
    assert sts.pkcs1v15_sha256(MSG, 61) is None


# --- where the port differs on purpose -----------------------------------------

def _alice_role(srv) -> dict:
    st, _, body = _sts(srv, {"Action": "AssumeRole",
                             "Version": "2011-06-15"},
                       signed_by=("alice", "alice-secret-key"))
    assert st == 200
    return _creds(body)


@pytest.mark.parametrize("case", ["right_token", "no_token", "wrong_token",
                                  "static_key_with_token",
                                  "web_identity_no_token"])
def test_session_token_is_checked(servers, case):
    """minio_tpu never reads X-Amz-Security-Token: a temporary credential
    is served without its token or with another's, and a static key with
    one. The port answers those 403 InvalidTokenId, as MinIO's
    checkClaimsFromToken does; with the right token both serve."""
    answers = {}
    for pkg, srv in servers.items():
        if case == "static_key_with_token":
            c = S3Client(srv.endpoint, "alice", "alice-secret-key",
                         session_token="made-up")
        elif case == "web_identity_no_token":
            st, _, body = _sts(srv, {
                "Action": "AssumeRoleWithWebIdentity",
                "Version": "2011-06-15",
                "WebIdentityToken": _token("RS256", _claims())})
            got = _creds(body)
            c = S3Client(srv.endpoint, got["AccessKeyId"],
                         got["SecretAccessKey"])
        else:
            got = _alice_role(srv)
            token = {"right_token": got["SessionToken"], "no_token": "",
                     "wrong_token": got["SessionToken"][::-1]}[case]
            c = S3Client(srv.endpoint, got["AccessKeyId"],
                         got["SecretAccessKey"], session_token=token)
        st, _, body = c.request("GET", "/stsdata/doc")
        answers[pkg] = (st, _code(body))
    if case == "right_token":
        assert answers[PORT] == answers[JAX] == (200, "")
    else:
        assert answers[JAX] == (200, "")
        assert answers[PORT] == (403, "InvalidTokenId")


def test_expired_temporary_credential_is_an_unknown_key(servers):
    """Copied from minio_tpu: an expired temporary credential answers
    InvalidAccessKeyId (MinIO answers ExpiredToken)."""
    answers = {}
    for pkg, srv in servers.items():
        got = _alice_role(srv)
        srv.iam.sts[got["AccessKeyId"]].expiration_ns = time.time_ns() - 1
        c = S3Client(srv.endpoint, got["AccessKeyId"],
                     got["SecretAccessKey"],
                     session_token=got["SessionToken"])
        st, _, body = c.request("GET", "/stsdata/doc")
        answers[pkg] = (st, _code(body))
    assert answers[PORT] == answers[JAX] == (403, "InvalidAccessKeyId")
