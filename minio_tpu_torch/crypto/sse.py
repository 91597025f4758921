"""Server-side encryption, the port's copy of minio_tpu/crypto/sse.py:
SSE-C (the client's key), SSE-S3 (the server's master key) and SSE-KMS
(a KMS data key), MinIO's envelope scheme (cmd/encryption-v1.go,
cmd/crypto/sse-c.go, sse-s3.go, key.go): a random object key sealed by a
key-encryption key, the data encrypted in authenticated packages.

The wire format of encrypted object data is minio_tpu's: 64 KiB
plaintext packages, each stored as nonce (12) || ciphertext || tag (16),
the package's sequence number bound into the GCM AAD so packages cannot
be reordered. The only change is the AEAD: crypto/aead.py on the
server's device (kernels C and D on the card) instead of `cryptography`.
Random bytes come from os.urandom in minio_tpu's order: the object key,
then the seal's nonce.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os

from .aead import AESGCM, InvalidTag

PACKAGE_SIZE = 64 * 1024
PACKAGE_OVERHEAD = 12 + 16  # nonce + tag

# Internal metadata keys (MinIO's X-Minio-Internal-Server-Side-Encryption-*)
META_ALGORITHM = "x-mtpu-internal-sse-algorithm"
META_SEALED_KEY = "x-mtpu-internal-sse-sealed-key"
META_KEY_MD5 = "x-mtpu-internal-sse-key-md5"
META_ACTUAL_SIZE = "x-mtpu-internal-actual-size"

ALGO_SSEC = "SSE-C"
ALGO_SSES3 = "SSE-S3"
ALGO_SSEKMS = "SSE-KMS"

META_KMS_KEY_ID = "x-mtpu-internal-sse-kms-key-id"
META_KMS_CONTEXT = "x-mtpu-internal-sse-kms-context"

# Request headers (AWS SSE-C and SSE header names, lowercased)
HDR_SSEC_ALGO = "x-amz-server-side-encryption-customer-algorithm"
HDR_SSEC_KEY = "x-amz-server-side-encryption-customer-key"
HDR_SSEC_KEY_MD5 = "x-amz-server-side-encryption-customer-key-md5"
HDR_SSE = "x-amz-server-side-encryption"
HDR_SSE_KMS_ID = "x-amz-server-side-encryption-aws-kms-key-id"
HDR_SSE_KMS_CONTEXT = "x-amz-server-side-encryption-context"
HDR_SSEC_COPY_ALGO = (
    "x-amz-copy-source-server-side-encryption-customer-algorithm"
)
# Prefixes of every SSE-C header (algorithm, key, key-md5; direct and
# copy-source): what the TLS guard matches, as crypto.SSEC.IsRequested.
HDR_SSEC_PREFIX = "x-amz-server-side-encryption-customer-"
HDR_SSEC_COPY_PREFIX = (
    "x-amz-copy-source-server-side-encryption-customer-"
)


class SSEError(Exception):
    def __init__(self, code: str, message: str = ""):
        super().__init__(message or code)
        self.code = code


def parse_ssec_key(headers: dict, copy_source: bool = False) -> bytes | None:
    """The SSE-C client key of the request headers, checked; None when
    no SSE-C header is present."""
    prefix = "x-amz-copy-source-server-side-encryption-customer" \
        if copy_source else "x-amz-server-side-encryption-customer"
    algo = headers.get(f"{prefix}-algorithm", "")
    key_b64 = headers.get(f"{prefix}-key", "")
    md5_b64 = headers.get(f"{prefix}-key-md5", "")
    if not algo and not key_b64:
        return None
    if algo != "AES256":
        raise SSEError("InvalidEncryptionAlgorithmError", algo)
    try:
        key = base64.b64decode(key_b64, validate=True)
    except Exception as exc:
        raise SSEError("InvalidArgument", "bad SSE-C key") from exc
    if len(key) != 32:
        raise SSEError("InvalidArgument", "SSE-C key must be 32 bytes")
    want_md5 = base64.b64encode(hashlib.md5(key).digest()).decode()
    if md5_b64 != want_md5:
        raise SSEError("AccessDenied", "SSE-C key MD5 mismatch")
    return key


def wants_sse_s3(headers: dict) -> bool:
    return headers.get(HDR_SSE, "") == "AES256"


def wants_sse_kms(headers: dict) -> bool:
    return headers.get(HDR_SSE, "") == "aws:kms"


def _parse_kms_context(headers: dict) -> dict:
    """x-amz-server-side-encryption-context: base64(JSON), as AWS."""
    raw = headers.get(HDR_SSE_KMS_CONTEXT, "")
    if not raw:
        return {}
    try:
        ctx = json.loads(base64.b64decode(raw))
        if not isinstance(ctx, dict):
            raise ValueError("context must be a JSON object")
        return {str(k): str(v) for k, v in ctx.items()}
    except Exception as exc:
        raise SSEError("InvalidArgument", "bad KMS context") from exc


def _kek(key: bytes, bucket: str, object_: str) -> bytes:
    """Key-encryption key bound to the object path (key.go Seal takes
    bucket/object as its context)."""
    return hashlib.sha256(
        b"mtpu-sse-kek\x00" + key + b"\x00" +
        f"{bucket}/{object_}".encode()
    ).digest()


def seal_object_key(object_key: bytes, kek_source: bytes, bucket: str,
                    object_: str, device="cuda") -> str:
    kek = _kek(kek_source, bucket, object_)
    nonce = os.urandom(12)
    sealed = nonce + AESGCM(kek, device).encrypt(nonce, object_key, b"OEK")
    return base64.b64encode(sealed).decode()


def unseal_object_key(sealed_b64: str, kek_source: bytes, bucket: str,
                      object_: str, device="cuda") -> bytes:
    kek = _kek(kek_source, bucket, object_)
    try:
        sealed = base64.b64decode(sealed_b64)
        return AESGCM(kek, device).decrypt(sealed[:12], sealed[12:], b"OEK")
    except (InvalidTag, ValueError) as exc:
        raise SSEError(
            "AccessDenied", "cannot unseal object key (wrong key?)"
        ) from exc


def encrypted_size(plain_size: int) -> int:
    packages = max(1, -(-plain_size // PACKAGE_SIZE))
    return plain_size + packages * PACKAGE_OVERHEAD


class SSEConfig:
    """The server's key material: the SSE-S3 master key and the KMS of
    SSE-KMS data keys (LocalKMS, derived from operator secret material;
    cmd/crypto/key.go and pkg/kms), and the device the AEAD runs on."""

    def __init__(self, master_secret: str, kms=None,
                 default_kms_key: str = "", device="cuda"):
        from ..utils.device import resolve_device

        self.device = resolve_device(device)
        self.master_key = hashlib.sha256(
            b"mtpu-sse-master\x00" + master_secret.encode()
        ).digest()
        if kms is None:
            from .kms import LocalKMS

            kms = LocalKMS(master_secret, default_kms_key,
                           device=self.device)
        self.kms = kms


def setup_encryption(headers: dict, bucket: str, object_: str,
                     sse_config: SSEConfig | None):
    """The SSE mode a new write asks for.

    Returns (object_key | None, metadata_updates, response_headers);
    object_key is None when no SSE was asked for. The caller feeds the
    key to a streaming encryptor (api/transforms.EncryptReader)."""
    ssec_key = parse_ssec_key(headers)
    use_s3 = wants_sse_s3(headers)
    use_kms = wants_sse_kms(headers)
    if ssec_key is None and not use_s3 and not use_kms:
        return None, {}, {}
    if ssec_key is not None and (use_s3 or use_kms):
        raise SSEError("InvalidRequest", "SSE-C and SSE-S3 both requested")
    if use_kms:
        # SSE-KMS: the data key comes from (and is sealed by) the KMS,
        # the encryption context bound into the seal (newEncryptMetadata,
        # kms.GenerateKey).
        if sse_config is None or sse_config.kms is None:
            raise SSEError("NotImplemented", "KMS not configured")
        from .kms import KMSError

        key_id = headers.get(HDR_SSE_KMS_ID, "") \
            or sse_config.kms.default_key_id
        context = _parse_kms_context(headers)
        try:
            object_key, sealed = sse_config.kms.generate_data_key(
                key_id, context
            )
        except KMSError as exc:
            raise SSEError("InvalidArgument", str(exc)) from exc
        meta = {
            META_ALGORITHM: ALGO_SSEKMS,
            META_SEALED_KEY: sealed,
            META_KMS_KEY_ID: key_id,
            META_KMS_CONTEXT: base64.b64encode(
                json.dumps(context, sort_keys=True).encode()
            ).decode(),
        }
        resp = {HDR_SSE: "aws:kms", HDR_SSE_KMS_ID: key_id}
        return object_key, meta, resp
    object_key = os.urandom(32)
    if ssec_key is not None:
        device = sse_config.device if sse_config is not None else "cuda"
        meta = {
            META_ALGORITHM: ALGO_SSEC,
            META_SEALED_KEY: seal_object_key(
                object_key, ssec_key, bucket, object_, device
            ),
            META_KEY_MD5: headers.get(HDR_SSEC_KEY_MD5, ""),
        }
        resp = {
            HDR_SSEC_ALGO: "AES256",
            HDR_SSEC_KEY_MD5: headers.get(HDR_SSEC_KEY_MD5, ""),
        }
    else:
        if sse_config is None:
            raise SSEError("NotImplemented", "SSE-S3 master key not configured")
        meta = {
            META_ALGORITHM: ALGO_SSES3,
            META_SEALED_KEY: seal_object_key(
                object_key, sse_config.master_key, bucket, object_,
                sse_config.device
            ),
        }
        resp = {HDR_SSE: "AES256"}
    return object_key, meta, resp


def resolve_decryption_key(stored_meta: dict, headers: dict, bucket: str,
                           object_: str, sse_config: SSEConfig | None):
    """Hold the request to a stored object's SSE metadata and unseal its
    object key.

    Returns (object_key | None, response_headers); None when the object
    is not encrypted. Raises SSEError on a missing or wrong key: callers
    run it BEFORE streaming, so a failure is a proper error response."""
    algo = stored_meta.get(META_ALGORITHM, "")
    if not algo:
        return None, {}
    sealed = stored_meta.get(META_SEALED_KEY, "")
    if algo == ALGO_SSEC:
        ssec_key = parse_ssec_key(headers)
        if ssec_key is None:
            raise SSEError(
                "InvalidRequest", "object is SSE-C encrypted; key required"
            )
        if headers.get(HDR_SSEC_KEY_MD5, "") != stored_meta.get(META_KEY_MD5):
            raise SSEError("AccessDenied", "SSE-C key mismatch")
        device = sse_config.device if sse_config is not None else "cuda"
        object_key = unseal_object_key(sealed, ssec_key, bucket, object_,
                                       device)
        resp = {
            HDR_SSEC_ALGO: "AES256",
            HDR_SSEC_KEY_MD5: stored_meta.get(META_KEY_MD5, ""),
        }
    elif algo == ALGO_SSES3:
        if sse_config is None:
            raise SSEError("NotImplemented", "SSE-S3 master key not configured")
        object_key = unseal_object_key(
            sealed, sse_config.master_key, bucket, object_, sse_config.device
        )
        resp = {HDR_SSE: "AES256"}
    elif algo == ALGO_SSEKMS:
        if sse_config is None or sse_config.kms is None:
            raise SSEError("NotImplemented", "KMS not configured")
        from .kms import KMSError

        key_id = stored_meta.get(META_KMS_KEY_ID, "")
        try:
            ctx_raw = stored_meta.get(META_KMS_CONTEXT, "")
            context = json.loads(
                base64.b64decode(ctx_raw)
            ) if ctx_raw else {}
            object_key = sse_config.kms.decrypt_data_key(
                key_id, sealed, context
            )
        except KMSError as exc:
            raise SSEError("AccessDenied", str(exc)) from exc
        except Exception as exc:  # noqa: BLE001 - corrupt context blob
            raise SSEError("InternalError", "bad KMS metadata") from exc
        resp = {HDR_SSE: "aws:kms", HDR_SSE_KMS_ID: key_id}
    else:
        raise SSEError("InvalidRequest", f"unknown SSE algorithm {algo!r}")
    return object_key, resp


def is_encrypted(meta: dict) -> bool:
    return bool(meta.get(META_ALGORITHM))
