"""Background services of the port: the data scanner and its usage
snapshot, the update tracker, the MRF drain, admin heal sequences, the
erasure-set sweep, the disk liveness monitor, fresh-drive back-fill and
the heal pacer (MinIO's cmd/data-scanner.go, cmd/data-update-tracker.go,
cmd/background-heal-ops.go, cmd/global-heal.go, cmd/admin-heal-ops.go,
cmd/background-newdisks-heal-ops.go). minio_tpu's `parse_lifecycle` is
not exported: the port has no lifecycle engine."""

from .heal import MRFHealer, heal_erasure_set
from .healseq import AllHealState, HealSequence
from .monitor import DiskMonitor
from .newdisk import FreshDiskHealer, HealingTracker
from .scanner import DataScanner, DataUsageInfo, DynamicSleeper
from .tracker import DataUpdateTracker

__all__ = [
    "DataScanner", "DataUsageInfo", "DynamicSleeper",
    "DataUpdateTracker", "DiskMonitor",
    "FreshDiskHealer", "HealingTracker",
    "AllHealState", "HealSequence", "MRFHealer", "heal_erasure_set",
]
