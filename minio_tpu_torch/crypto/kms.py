"""KMS, the port's copy of minio_tpu/crypto/kms.py: named master keys
that seal per-object data keys (MinIO's pkg/kms and cmd/crypto/kes.go
surface: CreateKey, GenerateKey, DecryptKey with an encryption context
bound into the seal). LocalKMS derives a master for each key id from
operator secret material; its seals run on crypto/aead.py on the
server's device. minio_tpu's KES client (crypto/kes.py, which needs
TLS) is not ported.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import threading
import time

from .aead import AESGCM, InvalidTag


class KMSError(Exception):
    def __init__(self, code: str, message: str = ""):
        super().__init__(message or code)
        self.code = code


def _context_aad(context: dict | None) -> bytes:
    return json.dumps(context or {}, sort_keys=True).encode()


def validate_key_id(key_id: str):
    """The one key-id rule of every backend."""
    if not key_id or "/" in key_id:
        raise KMSError("InvalidArgument", f"bad key id {key_id!r}")


def render_key_list(keys: dict[str, int]) -> list[dict]:
    return [
        {"name": k, "createdNs": ts} for k, ts in sorted(keys.items())
    ]


class LocalKMS:
    """In-process KMS keyed off operator secret material.

    Key ids are registered names; each derives its own 256-bit master.
    Data keys are random 32-byte keys sealed as
    nonce(12) || AESGCM(master).encrypt(data_key, aad=context)."""

    def __init__(self, master_secret: str, default_key_id: str = "",
                 persist=None, device="cuda"):
        """persist: an object with save(bytes) and load() -> bytes | None:
        the key REGISTRY (names only, never key material) must survive
        restarts, or SSE-KMS objects under admin-created keys become
        unreadable. Key material always derives from the secret, so the
        registry is not sensitive. `device` runs the seals."""
        from ..utils.device import resolve_device

        self.device = resolve_device(device)
        self._secret = master_secret.encode()
        self.default_key_id = default_key_id or "mtpu-default-key"
        self._keys: dict[str, int] = {self.default_key_id: time.time_ns()}
        self._lock = threading.Lock()
        self._persist = persist
        if persist is not None:
            try:
                raw = persist.load()
                if raw:
                    for name, ts in json.loads(raw).items():
                        self._keys.setdefault(name, int(ts))
            except Exception:  # noqa: BLE001 - unreadable registry
                pass

    def _save_locked(self):
        if self._persist is None:
            return
        try:
            self._persist.save(
                json.dumps(self._keys, sort_keys=True).encode()
            )
        except Exception:  # noqa: BLE001 - persistence is best-effort
            pass

    # --- key registry (KES CreateKey / ListKeys) ---

    def create_key(self, key_id: str):
        validate_key_id(key_id)
        with self._lock:
            if key_id in self._keys:
                raise KMSError("KeyAlreadyExists", key_id)
            self._keys[key_id] = time.time_ns()
            self._save_locked()

    def list_keys(self) -> list[dict]:
        with self._lock:
            return render_key_list(self._keys)

    def has_key(self, key_id: str) -> bool:
        with self._lock:
            return key_id in self._keys

    def _master(self, key_id: str) -> bytes:
        with self._lock:
            if key_id not in self._keys:
                raise KMSError("KeyNotFound", key_id)
        return hashlib.sha256(
            b"mtpu-kms\x00" + self._secret + b"\x00" + key_id.encode()
        ).digest()

    # --- data keys (GenerateKey / DecryptKey) ---

    def generate_data_key(self, key_id: str = "",
                          context: dict | None = None) -> tuple[bytes, str]:
        """(the 32-byte data key, its sealed blob in base64)."""
        key_id = key_id or self.default_key_id
        master = self._master(key_id)
        data_key = os.urandom(32)
        nonce = os.urandom(12)
        sealed = nonce + AESGCM(master, self.device).encrypt(
            nonce, data_key, _context_aad(context)
        )
        return data_key, base64.b64encode(sealed).decode()

    def decrypt_data_key(self, key_id: str, sealed_b64: str,
                         context: dict | None = None) -> bytes:
        master = self._master(key_id or self.default_key_id)
        try:
            sealed = base64.b64decode(sealed_b64)
            return AESGCM(master, self.device).decrypt(
                sealed[:12], sealed[12:], _context_aad(context)
            )
        except (InvalidTag, ValueError) as exc:
            raise KMSError(
                "AccessDenied",
                "cannot unseal data key (wrong key or context)",
            ) from exc

    # --- health (KES status) ---

    def status(self) -> dict:
        """A round trip for each key (KMSKeyStatusHandler's
        encrypt/decrypt probe)."""
        out = []
        for entry in self.list_keys():
            name = entry["name"]
            try:
                pk, sealed = self.generate_data_key(name, {"probe": "1"})
                ok = self.decrypt_data_key(name, sealed, {"probe": "1"}) == pk
            except KMSError:
                ok = False
            out.append({"keyName": name, "healthy": ok})
        return {"keys": out, "backend": "local"}
