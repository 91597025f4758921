"""IAMSys, the part of minio_tpu/iam/store.py the slice's requests reach
(MinIO's cmd/iam.go): the root credential and its lookup. The root may
do every action; users, groups, policies, STS credentials and service
accounts are not ported yet, so every other access key is unknown.
"""

from __future__ import annotations

from dataclasses import dataclass

from .policy import Args


@dataclass
class Credentials:
    access_key: str
    secret_key: str


class IAMSys:
    """The identity system: one root credential (MinIO's root user)."""

    def __init__(self, root_access: str, root_secret: str):
        self.root = Credentials(root_access, root_secret)

    def get_credentials(self, access_key: str) -> Credentials | None:
        if access_key == self.root.access_key:
            return self.root
        return None

    def is_allowed(self, args: Args) -> bool:
        """Authorization: the root may do everything, and there is no
        other account."""
        return args.account == self.root.access_key
