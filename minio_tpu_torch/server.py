"""Server bootstrap, the port's copy of the part of minio_tpu/server.py
that a single-node erasure deployment runs (MinIO's serverMain,
cmd/server-main.go): the self-tests of the erasure code and the bitrot
hash on the device, the drives and one pool of erasure sets per
ellipses argument, the root credential, the bucket metadata, the S3
server with its SSE key material (the SSE-S3 master key and a LocalKMS
whose key-name registry persists under .minio.sys, minio_tpu's
_build_kms without KES), and the background services that keep the sets
healthy (the MRF drain, the disk monitor, fresh-drive back-fill, the
data scanner with its update tracker; MinIO's initAutoHeal and
initDataScanner). FS mode, distributed endpoints, TLS, the config
subsystem, KES, events and metrics are not ported.
"""

from __future__ import annotations

import io
import os
import signal
import threading

import numpy as np
import torch

from .api.server import S3Server
from .background import (
    DataScanner,
    DataUpdateTracker,
    DiskMonitor,
    FreshDiskHealer,
    MRFHealer,
)
from .bucket.metadata import BucketMetadataSys
from .crypto import LocalKMS, SSEConfig
from .erasure.codec import Erasure
from .iam.store import IAMSys
from .object.pools import ErasureServerPools
from .object.sets import ErasureSets, read_format
from .ops.highwayhash_torch import hash256_batch
from .storage.fileinfo import new_uuid
from .storage.local import LocalStorage
from .utils import ellipses
from .utils.device import resolve_device
from .utils.errors import StorageError

# HighwayHash-256 (MinIO's magic key) of bytes(range(256)).
_HIGHWAYHASH_OF_0_TO_255 = bytes.fromhex(
    "7c4b54c324348b596045255e02c3faf3d38014229758f467de84926de69f7cf0")


def erasure_self_test(device) -> None:
    """The boot gate of the erasure code (erasureSelfTest,
    cmd/erasure-coding.go:157-215): encode and rebuild a few geometries
    on `device` (kernel A on the card); a mismatch stops the server."""
    rng = np.random.default_rng(0xC0DEC)
    for k, m in ((2, 2), (4, 2), (12, 4)):
        e = Erasure(k, m, k * 256, device=device)
        data = rng.integers(0, 256, k * 256, dtype=np.uint8).tobytes()
        shards = e.encode_data(data)
        for dead in range(m):
            shards[dead] = None
        e.decode_data_blocks(shards)
        if e.join(shards, len(data)) != data:
            raise RuntimeError(f"erasure self-test failed at {k}+{m}")


def bitrot_self_test(device) -> None:
    """The boot gate of the bitrot hash (bitrotSelfTest,
    cmd/bitrot.go:207-238): HighwayHash-256 on `device` (kernel B on the
    card) against a known digest."""
    payload = torch.arange(256, dtype=torch.uint8).reshape(1, 256)
    got = bytes(hash256_batch(payload.to(device)).cpu().numpy()[0])
    if got != _HIGHWAYHASH_OF_0_TO_255:
        raise RuntimeError("bitrot self-test failed: highwayhash256")


class _KMSRegistry:
    """The LocalKMS key-name registry as the object .minio.sys/kms/keys.json
    (minio_tpu's _build_kms persistence)."""

    BUCKET, PATH = ".minio.sys", "kms/keys.json"

    def __init__(self, object_layer):
        self._ol = object_layer

    def load(self):
        try:
            return self._ol.get_object_bytes(self.BUCKET, self.PATH)
        except StorageError:
            return None

    def save(self, data: bytes):
        try:
            self._ol.put_object(self.BUCKET, self.PATH, io.BytesIO(data),
                                len(data))
        except StorageError:
            self._ol.make_bucket(self.BUCKET)
            self._ol.put_object(self.BUCKET, self.PATH, io.BytesIO(data),
                                len(data))


class Server:
    """One assembled server: endpoints (ellipses allowed, one pool an
    argument) -> drives -> ErasureSets -> ErasureServerPools -> S3Server.
    The root credential comes from MTPU_ROOT_USER / MTPU_ROOT_PASSWORD
    (default minioadmin). `default_parity` None is half the set, as in
    minio_tpu. `device` defaults to the card and raises when there is
    none."""

    def __init__(self, endpoint_args: list[str], address: str = "127.0.0.1",
                 port: int = 9000, root_user: str | None = None,
                 root_password: str | None = None,
                 set_drive_count: int | None = None,
                 default_parity: int | None = None, device="cuda"):
        self.device = resolve_device(device)
        erasure_self_test(self.device)
        bitrot_self_test(self.device)
        self.root_user = root_user or os.environ.get("MTPU_ROOT_USER",
                                                     "minioadmin")
        self.root_password = root_password or os.environ.get(
            "MTPU_ROOT_PASSWORD", "minioadmin")
        if any("://" in ep for ep in endpoint_args):
            raise NotImplementedError("distributed endpoints are not ported")
        if (len(endpoint_args) == 1
                and not ellipses.has_ellipses(endpoint_args[0])):
            raise NotImplementedError("FS mode (one plain directory) is not "
                                      "ported")
        layout = ellipses.parse_server_endpoints(endpoint_args,
                                                 set_drive_count)
        pools = []
        for pi, endpoints in enumerate(layout["pools"]):
            disks = [LocalStorage(ep, endpoint=ep, device=self.device)
                     for ep in endpoints]
            es = ErasureSets(disks, layout["set_drive_count"],
                             deployment_id=self._deployment_id(disks),
                             default_parity=default_parity, pool_index=pi,
                             device=self.device)
            if self._any_formatted(disks):
                es.load_format()
            else:
                es.init_format()
            pools.append(es)
        self.object_layer = ErasureServerPools(pools, device=self.device)
        self.iam = IAMSys(self.root_user, self.root_password)
        self.bucket_meta = BucketMetadataSys(self.object_layer)
        # The background services (initAutoHeal, initDataScanner), in
        # minio_tpu's order. Every write marks the update tracker, and
        # the scanner skips the buckets it finds unmarked.
        self.mrf = MRFHealer(self.object_layer)
        self.update_tracker = DataUpdateTracker(self.object_layer)
        self.object_layer.update_tracker = self.update_tracker
        self.scanner = DataScanner(self.object_layer,
                                   tracker=self.update_tracker)
        # Disk liveness: offline detection, and the MRF drained on a
        # reconnect (monitorAndConnectEndpoints).
        self.disk_monitor = DiskMonitor(self.object_layer,
                                        mrf_healer=self.mrf)
        # Replaced-drive detection and the resumable back-fill.
        self.fresh_disk_healer = FreshDiskHealer(self.object_layer)
        # SSE: the master key and the KMS derive from the root secret;
        # the KMS's key names persist in the cluster's meta bucket, so
        # admin-created keys survive a restart.
        self.sse_config = SSEConfig(
            self.root_password, device=self.device,
            kms=LocalKMS(self.root_password,
                         persist=_KMSRegistry(self.object_layer),
                         device=self.device))
        self.s3 = S3Server(self.object_layer, self.iam, self.bucket_meta,
                           host=address, port=port, device=self.device,
                           sse_config=self.sse_config)
        self.s3.admin.scanner = self.scanner
        self._stop = threading.Event()

    @staticmethod
    def _formats(disks):
        for d in disks:
            try:
                yield read_format(d)
            except StorageError:
                continue  # unformatted or unreadable

    @classmethod
    def _any_formatted(cls, disks) -> bool:
        return next(cls._formats(disks), None) is not None

    @classmethod
    def _deployment_id(cls, disks) -> str:
        """The deployment id of a formatted disk, else a new one."""
        fmt = next(cls._formats(disks), None)
        return fmt["id"] if fmt is not None else new_uuid()

    def start(self) -> "Server":
        """Start the background services, then the S3 server."""
        self.mrf.start()
        self.disk_monitor.start()
        self.fresh_disk_healer.start()
        self.update_tracker.load()
        self.scanner.start()
        self.s3.start()
        return self

    def stop(self) -> None:
        self.s3.stop()
        self.scanner.stop()
        self.mrf.stop()
        self.disk_monitor.stop()
        self.fresh_disk_healer.stop()
        self.object_layer.close()

    @property
    def endpoint(self) -> str:
        return self.s3.endpoint

    def wait(self) -> None:
        """Block until SIGTERM or SIGINT."""
        def handler(signum, frame):
            self._stop.set()

        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)
        self._stop.wait()
