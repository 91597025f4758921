"""Per-bucket configuration of the port: the metadata, the lifecycle
rules, object lock and quotas (minio_tpu/bucket/)."""

from .lifecycle import Lifecycle, LifecycleError, Rule, RuleFilter
from .metadata import BucketMetadata, BucketMetadataSys
from .quota import BucketQuotaSys

__all__ = [
    "BucketMetadata", "BucketMetadataSys", "BucketQuotaSys",
    "Lifecycle", "LifecycleError", "Rule", "RuleFilter",
]
