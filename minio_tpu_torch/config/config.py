"""Subsystem KV configuration, the port's copy of minio_tpu/config/config.py
(MinIO's cmd/config/config.go:97-118).

Twenty subsystems, each a map of keys with defaults; a key's value is
looked up env > stored > default, the env name MTPU_<SUBSYS>_<KEY>
(with _<TARGET> for a named target); `subsys[:target]` addressing; a
write that fails validation is reverted, never stored. The stored blob
is sealed with AES-256-GCM under sha256("mtpu-config:" + root secret):
b"AESG\\0\\0" + nonce + ciphertext || tag, the nonce from os.urandom, as
minio_tpu seals it. Here the seal is the port's AESGCM on the config's
device: one launch of kernel C to save and one of kernel D to load on
the card. A b"PLAIN\\0" blob (no secret) stays readable.

What reads each subsystem in the port: `api` the S3 server's request
throttle and CORS origin, `storage_class` the PUT handlers' parity,
`compression` the transform chain, `drive` the drive health wrapper's
deadlines, `heal` the admin heal's I/O gate and pause, `region` and
`scanner` nothing yet; the rest (cache, etcd, identity_*, policy_opa,
kms_kes, the webhooks, notify_*) are stored, validated and listed in
help, and read by nothing (ROADMAP.md).
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import time

from ..crypto.aead import AESGCM
from ..utils.errors import ErrBucketNotFound, StorageError

META_BUCKET = ".minio.sys"
CONFIG_PATH = "config/config.json"
HISTORY_PREFIX = "config/history"
ENV_PREFIX = "MTPU"
SEALED_HEADER = b"AESG\x00\x00"
PLAIN_HEADER = b"PLAIN\x00"

# subsystem -> {key: default}, minio_tpu's table.
SUBSYSTEMS: dict[str, dict[str, str]] = {
    "api": {
        "requests_max": "0",
        "requests_deadline": "10s",
        "cors_allow_origin": "*",
        "replication_workers": "100",
    },
    "credentials": {"access_key": "", "secret_key": ""},
    "region": {"name": "us-east-1"},
    "storage_class": {"standard": "", "rrs": "EC:2"},
    "cache": {"drives": "", "expiry": "90", "quota": "80", "exclude": ""},
    "compression": {"enable": "off", "extensions": ".txt,.log,.csv,.json,.tar,.xml,.bin", "mime_types": "text/*,application/json,application/xml"},
    "etcd": {"endpoints": "", "path_prefix": ""},
    "identity_openid": {"config_url": "", "client_id": "", "jwks": "", "hmac_secret": "", "claim_name": "policy"},
    "identity_ldap": {"server_addr": "", "user_dn_search_base_dn": ""},
    "policy_opa": {"url": "", "auth_token": ""},
    "kms_kes": {"endpoint": "", "key_name": "", "cert_file": "", "key_file": "", "capath": "", "insecure": "off"},
    "logger_webhook": {"enable": "off", "endpoint": "", "auth_token": ""},
    "audit_webhook": {"enable": "off", "endpoint": "", "auth_token": ""},
    "drive": {
        # In-band hung-drive tolerance (storage/diskcheck.py).
        "enable": "on",
        "op_deadline": "30s",        # wall clock per metadata/data op
        "long_op_deadline": "120s",  # walk_dir / read_file_stream / create
        "hedge_delay": "150ms",      # GET: dispatch parity after this wait
        "straggler_grace": "2s",     # fan-out wait past write quorum
        "breaker_threshold": "3",    # consecutive timeouts before latch
        "probe_interval": "5s",      # faulty-disk re-admission probe
        "max_inflight": "16",        # per-disk in-flight token budget
    },
    "heal": {"bitrotscan": "off", "max_sleep": "1s", "max_io": "10"},
    "scanner": {"delay": "10", "max_wait": "15s", "cycle": "1m"},
    "notify_webhook": {"enable": "off", "endpoint": "", "auth_token": "", "queue_dir": "", "queue_limit": "0"},
    "notify_mysql": {"enable": "off", "dsn_string": "", "table": "", "format": "namespace", "queue_dir": "", "queue_limit": "0"},
    "notify_postgres": {"enable": "off", "connection_string": "", "table": "", "format": "namespace", "queue_dir": "", "queue_limit": "0"},
    "notify_redis": {"enable": "off", "address": "", "key": "", "format": "namespace", "password": "", "queue_dir": "", "queue_limit": "0"},
}

HELP: dict[str, str] = {
    "api": "manage global HTTP API call specific features",
    "credentials": "set root credentials",
    "region": "label the location of the server",
    "storage_class": "define object level redundancy",
    "cache": "add caching storage tier",
    "compression": "enable streaming compression of objects",
    "etcd": "federate multiple clusters for IAM and Bucket DNS",
    "identity_openid": "enable OpenID SSO support",
    "identity_ldap": "enable LDAP SSO support",
    "policy_opa": "enable external OPA for policy enforcement",
    "kms_kes": "enable external MinIO key encryption service",
    "logger_webhook": "send server logs to webhook endpoints",
    "audit_webhook": "send audit logs to webhook endpoints",
    "drive": "tune hung-drive tolerance: per-op deadlines, hedged reads, circuit breaker",
    "heal": "manage object healing frequency and bitrot verification",
    "scanner": "manage namespace scanning for usage calculation, lifecycle, healing",
    "notify_webhook": "publish bucket notifications to webhook endpoints",
    "notify_mysql": "publish bucket notifications to MySQL databases (live delivery over the MySQL wire protocol; events queue in queue_dir while the server is down)",
    "notify_postgres": "publish bucket notifications to Postgres databases (live delivery over the Postgres wire protocol; events queue in queue_dir while the server is down)",
    "notify_redis": "publish bucket notifications to Redis datastores (live delivery over a built-in RESP client)",
}

DEFAULT_TARGET = "_"

# Keys that must be non-empty for a target with enable=on: a config that
# would be skipped at boot is refused when it is written.
_REQUIRED_WHEN_ENABLED = {
    "notify_redis": ("address",),
    "notify_webhook": ("endpoint",),
    "notify_mysql": ("dsn_string", "table"),
    "notify_postgres": ("connection_string", "table"),
}


def validate_subsys(sub: str, kvs) -> None:
    req = _REQUIRED_WHEN_ENABLED.get(sub)
    if not req or kvs.get("enable") != "on":
        return
    for k in req:
        if not (kvs.get(k) or "").strip():
            raise ValueError(f"{sub}: {k} is required when enable=on")


class KVS(dict):
    """One target's key-value set."""

    def get_str(self, key: str, default: str = "") -> str:
        return self.get(key, default)


class Config:
    """config[subsys][target] = KVS: parse, serialize, look up."""

    def __init__(self):
        self._data: dict[str, dict[str, KVS]] = {
            sub: {DEFAULT_TARGET: KVS(defaults)}
            for sub, defaults in SUBSYSTEMS.items()
        }

    @staticmethod
    def split_subsys(s: str) -> tuple[str, str]:
        """'notify_webhook:primary' -> (subsys, target)."""
        sub, _, target = s.partition(":")
        return sub, target or DEFAULT_TARGET

    def set_kv(self, subsys_target: str, **kv: str):
        sub, target = self.split_subsys(subsys_target)
        if sub not in SUBSYSTEMS:
            raise ValueError(f"unknown config subsystem {sub!r}")
        bad = set(kv) - set(SUBSYSTEMS[sub])
        if bad:
            raise ValueError(f"unknown keys for {sub}: {sorted(bad)}")
        cur = self._data[sub].setdefault(target, KVS(SUBSYSTEMS[sub]))
        before = dict(cur)
        cur.update(kv)
        try:
            validate_subsys(sub, self.get(subsys_target))
        except ValueError:
            # Reject and revert: an invalid combination is never stored
            # to be skipped at the next boot.
            cur.clear()
            cur.update(before)
            raise

    def validate(self):
        """Whole-config validation: the guard of the bulk write (history
        restore) that bypasses set_kv."""
        for sub in _REQUIRED_WHEN_ENABLED:
            for target in self.targets(sub):
                suffix = "" if target == DEFAULT_TARGET else f":{target}"
                validate_subsys(sub, self.get(f"{sub}{suffix}"))

    def del_target(self, subsys_target: str):
        sub, target = self.split_subsys(subsys_target)
        if target == DEFAULT_TARGET:
            self._data[sub][DEFAULT_TARGET] = KVS(SUBSYSTEMS[sub])
        else:
            self._data[sub].pop(target, None)

    def get(self, subsys_target: str) -> KVS:
        """The resolved view: default < stored < env."""
        sub, target = self.split_subsys(subsys_target)
        if sub not in SUBSYSTEMS:
            raise ValueError(f"unknown config subsystem {sub!r}")
        out = KVS(SUBSYSTEMS[sub])
        out.update(self._data[sub].get(target, {}))
        for key in SUBSYSTEMS[sub]:
            env = f"{ENV_PREFIX}_{sub.upper()}_{key.upper()}"
            if target != DEFAULT_TARGET:
                env += f"_{target.upper()}"
            if env in os.environ:
                out[key] = os.environ[env]
        return out

    def targets(self, subsys: str) -> list[str]:
        return sorted(self._data.get(subsys, {}))

    def to_json(self) -> bytes:
        return json.dumps(self._data, sort_keys=True).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "Config":
        c = cls()
        for sub, targets in json.loads(raw).items():
            if sub not in SUBSYSTEMS:
                continue
            for target, kvs in targets.items():
                known = {k: v for k, v in kvs.items()
                         if k in SUBSYSTEMS[sub]}
                c._data[sub][target] = KVS(SUBSYSTEMS[sub])
                c._data[sub][target].update(known)
        return c


def config_key(secret: str) -> bytes:
    """The blob's AES-256 key: sha256("mtpu-config:" + root secret)."""
    return hashlib.sha256(("mtpu-config:" + secret).encode()).digest()


class ConfigSys:
    """Load and save the cluster Config in the object layer, with
    history. `device` is the seal's (default: the object layer's)."""

    def __init__(self, object_layer, secret: str = "", device=None):
        self._ol = object_layer
        self._secret = secret
        self.device = device if device is not None else getattr(
            object_layer, "device", "cuda")
        self.config = Config()

    # --- the sealed envelope ---

    def _seal(self, raw: bytes) -> bytes:
        if not self._secret:
            return PLAIN_HEADER + raw
        nonce = os.urandom(12)
        return SEALED_HEADER + nonce + AESGCM(
            config_key(self._secret), self.device).encrypt(nonce, raw, None)

    def _unseal(self, blob: bytes) -> bytes:
        if blob.startswith(PLAIN_HEADER):
            return blob[len(PLAIN_HEADER):]
        if blob.startswith(SEALED_HEADER):
            nonce, ct = blob[6:18], blob[18:]
            return AESGCM(config_key(self._secret), self.device).decrypt(
                nonce, ct, None)
        raise ValueError("unknown config blob header")

    # --- persistence ---

    def load(self):
        try:
            blob = self._ol.get_object_bytes(META_BUCKET, CONFIG_PATH)
        except StorageError:
            return  # a fresh deployment: the defaults
        self.config = Config.from_json(self._unseal(blob))

    def save(self, keep_history: bool = True):
        blob = self._seal(self.config.to_json())
        if keep_history:
            # A nanosecond suffix: two saves in one second must not
            # overwrite each other's history.
            ts = time.strftime("%Y-%m-%dT%H-%M-%S", time.gmtime())
            self._put(
                f"{HISTORY_PREFIX}/{ts}.{time.time_ns() % 10**9:09d}.kv",
                blob)
        self._put(CONFIG_PATH, blob)

    def _put(self, path: str, blob: bytes):
        try:
            self._ol.put_object(META_BUCKET, path, io.BytesIO(blob),
                                len(blob))
        except ErrBucketNotFound:
            self._ol.make_bucket(META_BUCKET)
            self._ol.put_object(META_BUCKET, path, io.BytesIO(blob),
                                len(blob))

    def history(self) -> list[str]:
        try:
            res = self._ol.list_objects(META_BUCKET,
                                        prefix=HISTORY_PREFIX + "/",
                                        max_keys=1000)
        except StorageError:
            return []
        return [o.name.rsplit("/", 1)[1] for o in res.objects]

    def history_get(self, name: str) -> bytes:
        """The unsealed JSON of one history entry."""
        if "/" in name or ".." in name:
            raise ValueError(f"invalid history id {name!r}")
        blob = self._ol.get_object_bytes(META_BUCKET,
                                         f"{HISTORY_PREFIX}/{name}")
        return self._unseal(blob)

    def restore(self, name: str):
        """Make a history entry the live config; the config it replaces
        is kept in history too."""
        cfg = Config.from_json(self.history_get(name))
        # Validated before it replaces the live config: an entry older
        # than a validation rule must not break the subsystem.
        cfg.validate()
        self.config = cfg
        self.save(keep_history=True)
