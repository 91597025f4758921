"""Remote S3 targets of the port (minio_tpu/replication/). Only the
client is ported: the remote tiers use it. The replication configuration
and its worker pool are not ported yet."""

from .client import S3Client, S3Error

__all__ = ["S3Client", "S3Error"]
