"""Identity of the port (minio_tpu/iam): the policy engine, users,
groups, service accounts and STS credentials, and their stores (the
object layer, etcd, or a dict)."""

from .etcd import EtcdIAMBackend, EtcdKV
from .policy import CANNED_POLICIES, Args, Policy, Statement
from .store import Credentials, IAMStore, IAMSys, ObjectStoreBackend

__all__ = [
    "CANNED_POLICIES", "Args", "Policy", "Statement",
    "Credentials", "IAMStore", "IAMSys", "ObjectStoreBackend",
    "EtcdIAMBackend", "EtcdKV",
]
