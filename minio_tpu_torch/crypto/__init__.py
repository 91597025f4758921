"""Server-side encryption (SSE-C, SSE-S3 and SSE-KMS envelope crypto),
the port's copy of minio_tpu/crypto (MinIO's cmd/encryption-v1.go and
cmd/crypto/) without the KES client; its AEAD is crypto/aead.py."""

from .aead import AESGCM, InvalidTag
from .kms import KMSError, LocalKMS
from .sse import (
    SSEConfig,
    SSEError,
    is_encrypted,
    parse_ssec_key,
    resolve_decryption_key,
    setup_encryption,
    wants_sse_s3,
)

__all__ = [
    "AESGCM", "InvalidTag", "SSEConfig", "SSEError", "is_encrypted",
    "parse_ssec_key", "resolve_decryption_key", "setup_encryption",
    "wants_sse_s3", "KMSError", "LocalKMS",
]
