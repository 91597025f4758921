"""Server bootstrap, the port's copy of the part of minio_tpu/server.py
that a single-node erasure deployment runs (MinIO's serverMain,
cmd/server-main.go): the self-tests of the erasure code, the bitrot
hash and AES-256-GCM on the device, the drives (each under the health
wrapper of storage/diskcheck.py: per-op deadlines and the faulty-drive
breaker) and one pool of erasure sets per ellipses argument, the root
credential, the bucket metadata, the config subsystem (a ConfigSys
sealed under the root secret and loaded from .minio.sys/config; the
`drive` subsystem's deadlines applied from the environment before the
drives are wrapped and again once the stored config is loaded, as
minio_tpu/server.py:208-211 and :302-310 do), the S3 server with its SSE key
material (the SSE-S3 master key and a LocalKMS whose key-name registry
persists under .minio.sys, minio_tpu's _build_kms without KES) and the
config, the bucket quotas (a BucketQuotaSys over the scanner's usage
snapshot), the remote tiers (a TierConfigMgr persisted under
.minio.sys/config/tiers.json, loaded at start, and the TierEngine that
the S3 handlers and the scanner share), and the background services that
keep the sets healthy (the MRF drain, the disk monitor, fresh-drive
back-fill, the data scanner with its update tracker, which applies the
buckets' lifecycle rules, transitions included; MinIO's initAutoHeal and
initDataScanner). The metrics registry and the
logger come up first, as in minio_tpu:
every subsystem's hook is set to it, every drive's wrapper counts its
ops into it, and a MetricsCollector over the object layer, the scanner
and the MRF drain fills its snapshot gauges at each scrape. FS mode,
distributed endpoints, TLS, KES, events, the trace hub and the audit log
are not ported.

On the card the server also sets up, once, the state its first request
would otherwise build inside its own memory window (`_warm`): the
threads started from then on get stacks of THREAD_STACK bytes, below the
2 MiB of a transparent huge page, so each costs the pages it touches
rather than a huge page; the workers of the fan-out pools and of each
drive's pool are started; the pipelined PUT's pool of pinned batch
buffers is filled to its capacity; the compression codec passes its
self-test (kernels E and F); and each set geometry passes the
streaming self-test, an encrypted object through the pipelined PUT and
a degraded GET in memory, which loads kernels A to D and leaves the
caching host allocator the pinned blocks, and the threads' allocator
arenas the room, that a request's batches take.
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
from .bucket.quota import BucketQuotaSys
from .config import Config, ConfigSys
from .crypto import LocalKMS, SSEConfig
from .crypto.aead import AESGCM
from .erasure import registry as codec_registry
from .erasure import streaming
from .erasure.bitrot import StreamingBitrotReader, StreamingBitrotWriter
from .erasure.codec import Erasure
from .erasure.streaming import (
    decode_stream,
    encode_stream,
    prefill_blocks_pool,
)
from .iam.store import IAMSys
from .object import erasure_objects, metadata
from .object.pools import ErasureServerPools
from .object.sets import ErasureSets, read_format
from .observability import Logger, Metrics, spans
from .observability.metrics_v2 import MetricsCollector
from .ops import s2
from .ops.highwayhash_torch import hash256_batch
from .pipeline import admission
from .pipeline import metrics as pipeline_metrics
from .storage.diskcheck import DiskHealth, MetricsDisk, configure_robustness
from .storage.fileinfo import new_uuid
from .storage.local import LocalStorage
from .tier import TierConfigMgr, TierEngine
from .utils import ellipses, fanout
from .utils.device import resolve_device
from .utils.errors import StorageError

# The streaming self-test's object: two batches of 8 full blocks, one
# more and a ragged tail, so the PUT and the GET take the pipelined
# drivers.
_SELF_TEST_BLOCKS = 17

# The stack of each thread started once the server is up on the card.
# Smaller than a 2 MiB transparent huge page: a thread's stack then holds
# only the pages it touches, where an 8 MiB stack took a whole huge page
# on its first touch.
THREAD_STACK = 1 << 20

# AES-256-GCM known answer: test case 16 of the GCM specification
# (McGrew and Viega), a 256-bit key with a 20-byte AAD.
_GCM_KEY = bytes.fromhex(
    "feffe9928665731c6d6a8f9467308308feffe9928665731c6d6a8f9467308308")
_GCM_NONCE = bytes.fromhex("cafebabefacedbaddecaf888")
_GCM_PLAIN = bytes.fromhex(
    "d9313225f88406e5a55909c5aff5269a86a7a9531534f7da2e4c303d8a318a72"
    "1c3c0c95956809532fcf0e2449a6b525b16aedf5aa0de657ba637b39")
_GCM_AAD = bytes.fromhex("feedfacedeadbeeffeedfacedeadbeefabaddad2")
_GCM_SEALED = bytes.fromhex(
    "522dc1f099567d07f47f37a32a84427d643a8cdcbfe5c0c97598a2bd2555d1aa"
    "8cb08e48590dbb3da7b08b1056828838c5f61e6393ba7a0abcc9f662"
    "76fc6ece0f4e1768cddf8853bb2d551b")

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


def aead_self_test(device) -> None:
    """The boot gate of server-side encryption: AES-256-GCM on `device`
    (kernels C and D on the card) sealing and opening a known answer."""
    aead = AESGCM(_GCM_KEY, device)
    if (aead.encrypt(_GCM_NONCE, _GCM_PLAIN, _GCM_AAD) != _GCM_SEALED
            or aead.decrypt(_GCM_NONCE, _GCM_SEALED, _GCM_AAD)
            != _GCM_PLAIN):
        raise RuntimeError("aead self-test failed: aes-256-gcm")


def streaming_self_test(device, data_blocks: int, parity_blocks: int,
                        block_size: int) -> None:
    """The data path of an encrypted PUT and degraded GET at one set
    geometry, in memory: a seeded object of two full batches of blocks
    and a ragged tail sealed (kernel C), encoded by the pipelined PUT
    driver (kernels A and B) into bitrot-framed shards, then read back
    with its first `parity_blocks` shards lost, rebuilt (A), verified
    (B) and opened (D); a byte that differs stops the server."""
    from .api.transforms import DecryptWriter, EncryptReader

    erasure = Erasure(data_blocks, parity_blocks, block_size, device=device)
    payload = np.random.default_rng(0x5E1F).bytes(
        _SELF_TEST_BLOCKS * block_size + 12_345)
    key = bytes(32)
    sinks = [io.BytesIO() for _ in range(erasure.total_shards)]
    stored = encode_stream(
        erasure, EncryptReader(io.BytesIO(payload), key, {}, device),
        [StreamingBitrotWriter(s, device) for s in sinks],
        data_blocks + (1 if data_blocks == parity_blocks else 0))

    def reader(data: bytes) -> StreamingBitrotReader:
        def open_stream(offset: int, length: int):
            return io.BytesIO(data[offset:offset + length])

        r = StreamingBitrotReader(open_stream, stored, erasure.shard_size(),
                                  device=device)
        r.local = True
        return r

    readers = [None if i < parity_blocks else reader(s.getvalue())
               for i, s in enumerate(sinks)]
    out = io.BytesIO()
    opened = DecryptWriter(out, key, device)
    decode_stream(erasure, opened, readers, 0, stored, stored)
    opened.close()
    if out.getvalue() != payload:
        raise RuntimeError(f"streaming self-test failed at "
                           f"{data_blocks}+{parity_blocks}")


def s2_self_test(device) -> None:
    """The compression codec on `device` (kernels E and F on the card):
    one batch of a known chunk (32 zero bytes, CRC32C 0x8a9136aa), 64 KiB
    of repeated text and a ragged tail compressed, framed and decoded
    back; a compressed chunk not shorter than its text, a wrong CRC or a
    byte that differs stops the server."""
    text = b"minio_tpu_torch s2 self-test " * 2260
    sizes = [32, s2.CHUNK, 12_345]
    raw = bytes(32) + text[:s2.CHUNK] + text[:12_345]
    codec = s2.S2Batch(device)
    crcs, blocks = codec.compress_chunks(raw, sizes)
    framed = s2.frames_of(raw, sizes, crcs, blocks)
    dec = s2.FrameDecoder(device)
    dec.feed(s2.STREAM_ID + framed)
    if (crcs[0] != s2.mask_crc(0x8A9136AA) or len(blocks[1]) >= s2.CHUNK
            or dec.finish() != raw):
        raise RuntimeError("s2 self-test failed")


def bitrot_self_test(device) -> None:
    """The boot gate of the bitrot hash (bitrotSelfTest,
    cmd/bitrot.go:207-238): HighwayHash-256 on `device` (kernel B on the
    card) against a known digest."""
    payload = torch.arange(256, dtype=torch.uint8).reshape(1, 256)
    got = bytes(hash256_batch(payload.to(device)).cpu().numpy()[0])
    if got != _HIGHWAYHASH_OF_0_TO_255:
        raise RuntimeError("bitrot self-test failed: highwayhash256")


def _install_metrics(metrics) -> None:
    """Point every subsystem's registry hook at `metrics` (minio_tpu's
    Server.__init__): the pipeline counters, the fan-out robustness
    counters (hedged reads, detached stragglers, late drops), the
    admission governors, the codec registry and the span plane."""
    pipeline_metrics.set_registry(metrics)
    streaming.set_metrics(metrics)
    fanout.set_metrics(metrics)
    admission.set_metrics(metrics)
    codec_registry.set_metrics(metrics)
    spans.set_metrics(metrics)


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
        # Metrics come up first, so the drives count their ops from the
        # first format read, and every subsystem's hook points at them.
        self.metrics = Metrics()
        _install_metrics(self.metrics)
        self.logger = Logger()
        erasure_self_test(self.device)
        bitrot_self_test(self.device)
        aead_self_test(self.device)
        self.root_user = root_user or os.environ.get("MTPU_ROOT_USER",
                                                     "minioadmin")
        self.root_password = root_password or os.environ.get(
            "MTPU_ROOT_PASSWORD", "minioadmin")
        # The drive deadlines from the environment now, before the drives
        # are wrapped; the stored config's once it is loaded (below).
        configure_robustness(Config().get("drive"))
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
            # Every drive is wrapped in the per-op deadline and breaker
            # of its own DiskHealth (MinIO's xlStorageDiskIDCheck).
            disks = [self._wrap_disk(
                LocalStorage(ep, endpoint=ep, device=self.device), ep)
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
        if self.device.type == "cuda":
            self._warm()
        self.iam = IAMSys(self.root_user, self.root_password)
        self.bucket_meta = BucketMetadataSys(self.object_layer)
        # The config, sealed under the root secret (one launch of kernel D
        # to load it on the card); the env still wins inside Config.get.
        self.config_sys = ConfigSys(self.object_layer,
                                    secret=self.root_password,
                                    device=self.device)
        self.config_sys.load()
        configure_robustness(self.config_sys.config.get("drive"))
        # The background services (initAutoHeal, initDataScanner), in
        # minio_tpu's order. Every write marks the update tracker, and
        # the scanner skips the buckets it finds unmarked.
        self.mrf = MRFHealer(self.object_layer)
        self.update_tracker = DataUpdateTracker(self.object_layer)
        self.object_layer.update_tracker = self.update_tracker
        # The remote tiers and the transition engine (transitionState).
        self.tiers = TierConfigMgr(self.object_layer)
        self.tier_engine = TierEngine(self.object_layer, self.tiers,
                                      metrics=self.metrics,
                                      logger=self.logger)
        self.scanner = DataScanner(self.object_layer, self.bucket_meta,
                                   metrics=self.metrics, logger=self.logger,
                                   tracker=self.update_tracker,
                                   tier_engine=self.tier_engine)
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
        # Quota admission reads the scanner's usage, never a walk on the
        # PUT path, once a cycle has run (a 1 s TTL cache over it).
        self.quota = BucketQuotaSys(self.object_layer, self.bucket_meta,
                                    usage_fn=self._scanner_usage)
        self.s3 = S3Server(self.object_layer, self.iam, self.bucket_meta,
                           host=address, port=port, device=self.device,
                           sse_config=self.sse_config, metrics=self.metrics,
                           config_sys=self.config_sys, quota=self.quota,
                           tier_engine=self.tier_engine, tiers=self.tiers)
        self.s3.admin.scanner = self.scanner
        # The scrape-time collector over the live subsystems.
        self.s3.admin.collector = MetricsCollector(
            self.metrics, object_layer=self.object_layer,
            scanner=self.scanner, iam=self.iam, mrf=self.mrf)
        self._stop = threading.Event()

    def _scanner_usage(self) -> dict | None:
        """{bucket: bytes} of the scanner's last snapshot; None before
        its first cycle, when the quota falls back to a listing walk."""
        if not self.scanner.usage.last_update_ns:
            return None
        return {b: u.objects_size
                for b, u in self.scanner.usage.buckets_usage.items()}

    def _warm(self) -> None:
        """The card's state that the first request would set up (the
        module docstring): thread stacks, the pools' workers and pinned
        buffers, and each set geometry's streaming self-test."""
        threading.stack_size(THREAD_STACK)
        if not fanout.SINGLE_CORE:
            streaming.start_io_pool()
            metadata.start_io_pool()
        for pool in self.object_layer.pools:
            for d in pool.disks:
                if isinstance(d, MetricsDisk):
                    d.start_pool()
        geometries = {(len(es.disks) - es.default_parity, es.default_parity)
                      for pool in self.object_layer.pools
                      for es in pool.sets}
        for k, m in sorted(geometries):
            block = erasure_objects.BLOCK_SIZE_V2
            prefill_blocks_pool(Erasure(k, m, block, device=self.device))
            streaming_self_test(self.device, k, m, block)
        s2_self_test(self.device)

    def _wrap_disk(self, raw, ep: str):
        """A drive as the sets see it: `raw` under the metrics, disk-id
        and health wrapper, with per-op deadlines and the faulty-drive
        breaker (minio_tpu's Server._wrap_disk without the fault
        injector), counting its ops into the server's registry. The
        wrapper caches each method on its first call, so a subclass that
        puts its own layer around `raw` does it here."""
        return MetricsDisk(raw, self.metrics, health=DiskHealth(ep))

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
        # The tiers gate the reads of transitioned objects: loaded
        # before any request, the scanner's own or a client's.
        self.tiers.load()
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
