"""IAMSys, the port's copy of minio_tpu/iam/store.py (MinIO's cmd/iam.go
and cmd/iam-object-store.go): users, groups, named policies, service
accounts and temporary (STS) credentials, persisted as JSON blobs under
`.minio.sys/config/iam/` in the object layer (ObjectStoreBackend, so
every IAM write is an erasure-coded PUT: kernels A and B on the card),
in etcd (iam/etcd.py), or in a dict (IAMStore).

The blobs hold each user's secret key in clear, as minio_tpu's do (MinIO
seals its IAM store; ROADMAP.md Queue 3). STS credentials and their
session policies live in memory only: a restart drops them, and a reload
keeps them.
"""

from __future__ import annotations

import io
import json
import secrets
import threading
import time
from dataclasses import dataclass, field

from ..utils.errors import (ErrBucketNotFound, ErrObjectNotFound,
                            ErrVersionNotFound)
from .policy import CANNED_POLICIES, Args, Policy

IAM_PREFIX = "config/iam"
_NOT_FOUND = (ErrObjectNotFound, ErrVersionNotFound, ErrBucketNotFound)


@dataclass
class Credentials:
    access_key: str
    secret_key: str
    session_token: str = ""
    status: str = "on"  # "on" | "off"
    expiration_ns: int = 0  # 0: never
    parent_user: str = ""   # set for service accounts and STS credentials
    groups: list = field(default_factory=list)
    description: str = ""   # "oidc:<subject>" when federated

    def is_expired(self) -> bool:
        return self.expiration_ns > 0 and time.time_ns() > self.expiration_ns

    def is_temp(self) -> bool:
        return bool(self.session_token) and self.expiration_ns > 0

    def is_service_account(self) -> bool:
        return bool(self.parent_user) and not self.session_token

    def to_dict(self) -> dict:
        return {
            "accessKey": self.access_key,
            "secretKey": self.secret_key,
            "sessionToken": self.session_token,
            "status": self.status,
            "expirationNs": self.expiration_ns,
            "parentUser": self.parent_user,
            "groups": self.groups,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Credentials":
        return cls(
            access_key=d["accessKey"], secret_key=d["secretKey"],
            session_token=d.get("sessionToken", ""),
            status=d.get("status", "on"),
            expiration_ns=d.get("expirationNs", 0),
            parent_user=d.get("parentUser", ""),
            groups=d.get("groups", []),
        )


def generate_credentials() -> tuple[str, str]:
    """A random access and secret key pair (pkg/auth GetNewCredentials)."""
    alphabet = "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
    access = "".join(secrets.choice(alphabet) for _ in range(20))
    secret = secrets.token_urlsafe(30)[:40]
    return access, secret


class IAMStore:
    """The persistence adapter, over a dict; ObjectStoreBackend and
    iam/etcd.py's EtcdIAMBackend persist for real."""

    def __init__(self):
        self._items: dict[str, bytes] = {}

    def save(self, path: str, data: bytes):
        self._items[path] = data

    def load(self, path: str) -> bytes | None:
        return self._items.get(path)

    def delete(self, path: str):
        self._items.pop(path, None)

    def list(self, prefix: str) -> list[str]:
        return sorted(k for k in self._items if k.startswith(prefix))


class ObjectStoreBackend(IAMStore):
    """The IAM blobs as objects `.minio.sys/config/iam/<path>` of the
    object layer (cmd/iam-object-store.go)."""

    META_BUCKET = ".minio.sys"

    def __init__(self, object_layer):
        super().__init__()
        self._ol = object_layer

    def save(self, path: str, data: bytes):
        name = f"{IAM_PREFIX}/{path}"
        try:
            self._ol.put_object(self.META_BUCKET, name, io.BytesIO(data),
                                len(data))
        except ErrBucketNotFound:
            # The first IAM write of a fresh deployment makes the meta
            # bucket.
            self._ol.make_bucket(self.META_BUCKET)
            self._ol.put_object(self.META_BUCKET, name, io.BytesIO(data),
                                len(data))

    # A blob or the meta bucket that is not there reads as nothing; any
    # other error (a lost read quorum) propagates, so that IAMSys.load
    # fails rather than serve, and later persist, a partial state
    # (minio_tpu reads every StorageError as nothing; ROADMAP.md
    # Queue 3).

    def load(self, path: str) -> bytes | None:
        try:
            return self._ol.get_object_bytes(self.META_BUCKET,
                                             f"{IAM_PREFIX}/{path}")
        except _NOT_FOUND:
            return None

    def delete(self, path: str):
        try:
            self._ol.delete_object(self.META_BUCKET, f"{IAM_PREFIX}/{path}")
        except _NOT_FOUND:
            pass

    def list(self, prefix: str) -> list[str]:
        try:
            res = self._ol.list_objects(self.META_BUCKET,
                                        prefix=f"{IAM_PREFIX}/{prefix}",
                                        max_keys=10000)
        except ErrBucketNotFound:
            return []
        plen = len(IAM_PREFIX) + 1
        return [o.name[plen:] for o in res.objects]


class IAMSys:
    """The identity and authorization system (cmd/iam.go:204): the root
    credential, users and service accounts, STS credentials, groups and
    named policies over `store` (a dict when None)."""

    def __init__(self, root_access: str, root_secret: str,
                 store: IAMStore | None = None):
        self.root = Credentials(root_access, root_secret)
        self.store = store or IAMStore()
        self._lock = threading.RLock()
        self.users: dict[str, Credentials] = {}
        self.policies: dict[str, Policy] = dict(CANNED_POLICIES)
        self.user_policy: dict[str, list[str]] = {}   # user -> policy names
        self.group_policy: dict[str, list[str]] = {}
        self.group_members: dict[str, list[str]] = {}
        self.sts: dict[str, Credentials] = {}

    # --- load and persist ---

    def _read_store(self) -> tuple[dict, dict, dict | None]:
        """The users, the stored policies and the mappings document (None
        when there is none) that the store holds; nothing of the state
        changes."""
        users: dict[str, Credentials] = {}
        policies: dict[str, Policy] = {}
        for path in self.store.list("users/"):
            raw = self.store.load(path)
            if raw:
                c = Credentials.from_dict(json.loads(raw))
                users[c.access_key] = c
        for path in self.store.list("policies/"):
            raw = self.store.load(path)
            if raw:
                name = path.split("/", 1)[1].removesuffix(".json")
                policies[name] = Policy.parse(raw)
        raw = self.store.load("policy-mappings.json")
        return users, policies, json.loads(raw) if raw else None

    def load(self):
        # Under the lock: a request must never authorize against a half
        # loaded policy map. The store is read whole first, so a read
        # that fails leaves the state as it was.
        with self._lock:
            users, policies, mappings = self._read_store()
            self.users.update(users)
            self.policies.update(policies)
            if mappings is not None:
                self.user_policy = mappings.get("users", {})
                self.group_policy = mappings.get("groups", {})
                self.group_members = mappings.get("members", {})

    def reload(self):
        """Rebuild the state from the store: what the etcd watch calls
        (the iam-etcd-store.go watch loop). The STS credentials, their
        mappings and session policies live in memory and are kept. The
        new state is built aside and takes the old one's place only once
        the store has been read whole: a failed read keeps the old state
        (minio_tpu empties it first; ROADMAP.md Queue 3)."""
        with self._lock:
            users, stored, mappings = self._read_store()
            mappings = mappings or {}
            # Keyed by the live STS credentials, never by the "sts-" name
            # prefix: a stored policy of that name follows the store.
            policies = dict(CANNED_POLICIES)
            policies.update(stored)
            policies.update({
                name: self.policies[name]
                for name in (f"sts-{k}" for k in self.sts)
                if name in self.policies})
            user_policy = dict(mappings.get("users", {}))
            user_policy.update({k: v for k, v in self.user_policy.items()
                                if k in self.sts})
            self.users = users
            self.policies = policies
            self.user_policy = user_policy
            self.group_policy = mappings.get("groups", {})
            self.group_members = mappings.get("members", {})

    def _persist_mappings(self):
        # A temporary key's mapping dies with the credential: never
        # stored.
        self.store.save("policy-mappings.json", json.dumps({
            "users": {k: v for k, v in self.user_policy.items()
                      if k not in self.sts},
            "groups": self.group_policy,
            "members": self.group_members,
        }).encode())

    def _prune_expired_sts_locked(self):
        dead = [k for k, c in self.sts.items() if c.is_expired()]
        for k in dead:
            self.sts.pop(k, None)
            self.user_policy.pop(k, None)
            self.policies.pop(f"sts-{k}", None)

    def _save_user(self, c: Credentials):
        self.store.save(f"users/{c.access_key}.json",
                        json.dumps(c.to_dict()).encode())

    # --- users (cmd/admin-handlers-users.go) ---

    def add_user(self, access_key: str, secret_key: str,
                 status: str = "on") -> Credentials:
        with self._lock:
            c = Credentials(access_key, secret_key, status=status)
            self.users[access_key] = c
            self._save_user(c)
            return c

    def delete_user(self, access_key: str):
        with self._lock:
            self.users.pop(access_key, None)
            self.user_policy.pop(access_key, None)
            self.store.delete(f"users/{access_key}.json")
            self._persist_mappings()

    def set_user_status(self, access_key: str, status: str):
        with self._lock:
            c = self.users.get(access_key)
            if c is None:
                raise KeyError(access_key)
            c.status = status
            self._save_user(c)

    def list_users(self) -> dict[str, Credentials]:
        with self._lock:
            return dict(self.users)

    # --- service accounts and STS ---

    def new_service_account(self, parent_user: str) -> Credentials:
        with self._lock:
            access, secret = generate_credentials()
            c = Credentials(access, secret, parent_user=parent_user)
            self.users[access] = c
            self._save_user(c)
            return c

    def new_sts_credentials(self, parent_user: str, duration_s: int = 3600,
                            session_policy: Policy | None = None
                            ) -> Credentials:
        with self._lock:
            self._prune_expired_sts_locked()
            access, secret = generate_credentials()
            token = secrets.token_urlsafe(32)
            c = Credentials(
                access, secret, session_token=token,
                expiration_ns=time.time_ns() + duration_s * 10 ** 9,
                parent_user=parent_user,
            )
            self.sts[access] = c
            if session_policy is not None:
                # A session policy narrows the parent's rights: is_allowed
                # asks both.
                self.policies[f"sts-{access}"] = session_policy
            return c

    def new_federated_credentials(self, subject: str, duration_s: int,
                                  policy_names: list[str]) -> Credentials:
        """Temporary credentials of an outside identity (OIDC web
        identity or client grants, LDAP; cmd/sts-handlers.go:324): no
        parent user, the rights are the policies the token or the
        directory mapping names, attached to the temporary key."""
        with self._lock:
            self._prune_expired_sts_locked()
            access, secret = generate_credentials()
            token = secrets.token_urlsafe(32)
            c = Credentials(
                access, secret, session_token=token,
                expiration_ns=time.time_ns() + duration_s * 10 ** 9,
                parent_user="",
            )
            c.description = f"oidc:{subject}"
            self.sts[access] = c
            if policy_names:
                self.user_policy[access] = list(policy_names)
            return c

    # --- groups ---

    def add_group_members(self, group: str, members: list[str]):
        with self._lock:
            cur = set(self.group_members.get(group, []))
            cur.update(members)
            self.group_members[group] = sorted(cur)
            self._persist_mappings()

    def remove_group_members(self, group: str, members: list[str]):
        with self._lock:
            cur = set(self.group_members.get(group, []))
            cur -= set(members)
            if cur:
                self.group_members[group] = sorted(cur)
            else:
                self.group_members.pop(group, None)
                self.group_policy.pop(group, None)
            self._persist_mappings()

    def groups_of(self, user: str) -> list[str]:
        with self._lock:
            return [g for g, members in self.group_members.items()
                    if user in members]

    # --- policies ---

    def set_policy(self, name: str, policy: Policy):
        with self._lock:
            self.policies[name] = policy
            self.store.save(f"policies/{name}.json",
                            json.dumps(policy.to_dict()).encode())

    def delete_policy(self, name: str):
        with self._lock:
            self.policies.pop(name, None)
            self.store.delete(f"policies/{name}.json")

    def attach_policy(self, user_or_group: str, names: list[str],
                      is_group: bool = False):
        with self._lock:
            target = self.group_policy if is_group else self.user_policy
            target[user_or_group] = names
            self._persist_mappings()

    # --- lookup and authorization ---

    def get_credentials(self, access_key: str) -> Credentials | None:
        """The credential of `access_key`; None when it is unknown,
        expired or disabled."""
        with self._lock:
            if access_key == self.root.access_key:
                return self.root
            c = self.users.get(access_key) or self.sts.get(access_key)
            if c is None or c.is_expired() or c.status != "on":
                return None
            return c

    def effective_policy(self, access_key: str) -> Policy:
        """The policies attached to a user and to its groups, merged; no
        parent or session policy (is_allowed decides those)."""
        with self._lock:
            names: list[str] = list(self.user_policy.get(access_key, []))
            for g in self.groups_of(access_key):
                names += self.group_policy.get(g, [])
            merged = Policy([])
            for n in names:
                p = self.policies.get(n)
                if p is not None:
                    merged = merged.merge(p)
            return merged

    def is_allowed(self, args: Args) -> bool:
        """Authorization (cmd/iam.go IsAllowed): the root may do
        everything; a service account or STS credential is held to its
        parent's rights, and a session policy narrows them further (never
        widens); a user or federated credential to its attached
        policies."""
        if args.account == self.root.access_key:
            return True
        # Under the lock, as a reload swaps the maps under it: a decision
        # never sees a credential without its session policy.
        with self._lock:
            cred = self.users.get(args.account) or self.sts.get(
                args.account)
            if cred is not None and cred.parent_user:
                if cred.parent_user == self.root.access_key:
                    parent_ok = True
                else:
                    parent_ok = self.effective_policy(
                        cred.parent_user).is_allowed(args)
                if not parent_ok:
                    return False
                session = self.policies.get(f"sts-{args.account}")
                if session is not None:
                    return session.is_allowed(args)
                return True
            return self.effective_policy(args.account).is_allowed(args)
