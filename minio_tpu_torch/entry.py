"""Entry points of the port.

`entry()` is the twin of `__graft_entry__.entry()`: 12+4 parity over a
batch of 8 x 1 MiB blocks. `put_get_heal()` drives the erasure data plane
end to end on shard files: PUT, degraded GET (full and ranged), heal.
`object_put_get_heal()` drives the same through the object layer and the
drive storage: PutObject, GetObject healthy and degraded, HealObject and
a bitrot check on 16 drive directories at 12+4;
`object_codec_put_get_heal()` does it under one erasure codec at any
set size, with a heal of one lost drive through the repair plane.
`s3_put_get_heal()` drives the S3 server over HTTP on localhost: signed
PUTs (aws-chunked, multipart, small objects), listing, GETs, lost
drives, degraded GETs and an admin heal; `s3_codec_put_get()` one PUT
with the x-mtpu-codec header. `s3_core()` drives the S3 object core:
versioned PUTs, a delete marker, versioned GETs with drives lost,
CopyObject from the degraded source, UploadPartCopy, a metadata-only
self-copy, tagging, DeleteObjects, a bucket policy with anonymous
requests, and the heals of every version. `self_heal()` drives the
self-healing services of a whole running server: a drive outage with
writes (the MRF drain on reconnect), a replaced drive (the fresh-drive
sweep) and the scanner; `object_self_heal()` the same services on the
object layer, called directly. `s3_sse()` drives server-side encryption
over HTTP: SSE-S3, SSE-C and SSE-KMS PUTs, GETs whole and ranged, HEAD,
four drives lost, degraded GETs, HealObject (which never decrypts), a
CopyObject that re-encrypts, and a GET with the wrong SSE-C key.
`observability()` drives the health probes through an outage, the
scrapes, every request's span tree and the byte-flow ledger, held to
the bytes on the drives, over HTTP. `config_compression()` drives the
config subsystem and compression over HTTP: settings saved sealed with
history, a compressed PUT, GETs whole, ranged and degraded, the heal,
compress-then-encrypt, an incompressible PUT, an RRS PUT at 14+2, and a
restart that loads the config and throttles. `s3_lock_quota_lifecycle()`
drives object lock, the hard bucket quota and lifecycle expiry over HTTP:
WORM versions refused deletion, read degraded and healed, GOVERNANCE and
legal hold, PUT and UploadPart refused by the quota, the quota reading
the scanner's usage, and the scanner's lifecycle sweep. `s3_tiering()`
drives remote tiers over HTTP, a server tiered to a second one in the
same process: the admin tier routes, the scanner's transition of a
plain, an SSE-S3 and a compressed-then-sealed object, GETs whole and
ranged through the tier, degraded on the cold server, a restore and its
expiry, and a heal that keeps the tiered versions. `s3_identity()` drives
identity over HTTP: users, policies and their mappings over the admin
routes, AssumeRole with a session policy, web identity with HS256 and
RS256 tokens, LDAP, a service account, POST policy uploads, refusals,
and a restart that loads the IAM from degraded blobs; its test doubles
(`rsa_keypair`, `jwt_hs256`, `jwt_rs256`, `ToyLDAPServer`) serve the CPU
tests too.
"""

from __future__ import annotations

import base64
import contextlib
import hashlib
import hmac
import io
import json
import os
import re
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .erasure import device_engine, registry, repair, streaming
from .erasure.bitrot import (
    StreamingBitrotReader,
    StreamingBitrotWriter,
    bitrot_verify,
)
from .erasure.codec import Erasure
from .erasure.streaming import (
    decode_stream,
    encode_stream,
    heal_stream,
)
from .api.client import S3Client
from .api.handlers import copy_reads_snapshot
from .background import healpace
from .background.scanner import parse_lifecycle
from .object import erasure_objects
from .object.sets import ErasureSets
from .object.types import ObjectOptions
from .crypto import sse as ssemod
from .ops import (aes_gcm_cuda, gf, highwayhash_torch, host_feed, rs_cuda,
                  s2_cuda)
from .ops.rs import apply_gf_matrix
from .pipeline import admission
from .server import Server
from .storage.diskcheck import _TIMED_OPS as TIMED_OPS
from .storage.diskcheck import robust_overrides, unwrap
from .storage.local import LocalStorage
from .storage.xlmeta import XLMeta
from .utils import ceil_frac
from .utils.device import resolve_device
from .utils.errors import (
    ErrDiskFaulty,
    ErrDiskNotFound,
    ErrFileCorrupt,
    ErrFileNotFound,
    StorageError,
)


def entry(device="cuda"):
    """Return (fn, args): fn(*args) is the 12+4 parity of 8 blocks of
    1 MiB from np.random.default_rng(0), on `device`."""
    dev = resolve_device(device)
    k, m, batch = 12, 4, 8
    shard = ceil_frac(1 << 20, k)
    bitmat = gf.to_device_bitmat(gf.bit_matrix(gf.parity_matrix(k, m)), dev)
    rng = np.random.default_rng(0)
    blocks = torch.from_numpy(
        rng.integers(0, 256, size=(batch, k, shard), dtype=np.uint8)).to(dev)
    return apply_gf_matrix, (bitmat, blocks)


def counters() -> dict:
    """Device-engine STATS, the fan-out and reader counters, the copies
    to the card by kind (pinned or pageable), and the kernels' own launch
    counts."""
    snap = device_engine.stats_snapshot()
    snap.update(streaming.stats_snapshot())
    snap.update({f"h2d_{k}": v for k, v in host_feed.h2d_snapshot().items()})
    snap.update({f"repair_{k}": v for k, v in repair.stats_snapshot().items()})
    snap.update({f"copy_{k}": v for k, v in copy_reads_snapshot().items()})
    snap["kernel_gf_launches"] = rs_cuda.LAUNCHES.value
    snap["kernel_hash_launches"] = highwayhash_torch.LAUNCHES.value
    snap["kernel_seal_launches"] = aes_gcm_cuda.SEAL_LAUNCHES.value
    snap["kernel_open_launches"] = aes_gcm_cuda.OPEN_LAUNCHES.value
    snap["kernel_compress_launches"] = s2_cuda.COMPRESS_LAUNCHES.value
    snap["kernel_decompress_launches"] = s2_cuda.DECOMPRESS_LAUNCHES.value
    return snap


def _delta(before: dict, after: dict) -> dict:
    return {key: after[key] - before[key] for key in after}


def _phases(device: torch.device, out: dict):
    """phase(name, fn): run fn between two device syncs, recording its
    seconds and counter deltas under `name` in out."""
    def phase(name, fn):
        _sync(device)
        before = counters()
        t0 = time.perf_counter()
        result = fn()
        _sync(device)
        out["seconds"][name] = time.perf_counter() - t0
        out["counters"][name] = _delta(before, counters())
        return result
    return phase


def _shard_path(root: Path, i: int) -> Path:
    return root / f"disk{i}" / "part.1"


def _reader(path: Path, size: int, erasure: Erasure):
    def open_stream(offset: int, length: int):
        try:
            f = open(path, "rb")
        except FileNotFoundError as exc:
            raise ErrFileNotFound(str(path)) from exc
        f.seek(offset)
        return f

    r = StreamingBitrotReader(open_stream, size, erasure.shard_size(),
                              device=erasure.device)
    r.local = True
    return r


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def put_get_heal(root, size: int, k: int = 12, m: int = 4,
                 lost=(0, 5, 12, 15), seed: int = 0, device="cuda",
                 block_size: int = 1 << 20) -> dict:
    """PUT a seeded payload of `size` bytes as root/disk{i}/part.1 shard
    files, GET it back, remove the `lost` shards, GET it back degraded
    (whole, and one unaligned range), heal the lost shards, and re-verify
    every frame. Which drivers run is `utils.fanout.SINGLE_CORE`'s
    choice (serial when True, pipelined when False).

    Returns the GET bytes, the SHA-256 of each shard file as PUT wrote
    it, each phase's seconds and counter deltas, and the checks:
    healthy_get_ok, get_ok, range_ok, healed_identical, reverified."""
    root = Path(root)
    dev = resolve_device(device)
    erasure = Erasure(k, m, block_size, device=dev)
    payload = np.random.default_rng(seed).bytes(size)
    quorum = k + 1 if k == m else k
    out: dict = {"size": size, "k": k, "m": m, "lost": list(lost),
                 "seconds": {}, "counters": {}}
    phase = _phases(dev, out)

    # PUT
    for i in range(k + m):
        _shard_path(root, i).parent.mkdir(parents=True, exist_ok=True)
    files = [open(_shard_path(root, i), "wb") for i in range(k + m)]
    try:
        writers = [StreamingBitrotWriter(f, device=dev) for f in files]
        n = phase("put", lambda: encode_stream(
            erasure, io.BytesIO(payload), writers, quorum))
    finally:
        for f in files:
            f.close()
    if n != size:
        raise AssertionError(f"PUT consumed {n} bytes, want {size}")
    out["shard_sha256"] = [hashlib.sha256(
        _shard_path(root, i).read_bytes()).hexdigest() for i in range(k + m)]

    def readers():
        return [_reader(_shard_path(root, i), size, erasure)
                for i in range(k + m)]

    # Healthy GET, then the lost shards go, then a degraded GET, whole
    # object and an unaligned range.
    sink = io.BytesIO()
    _, hint = phase("get_healthy", lambda: decode_stream(
        erasure, sink, readers(), 0, size, size))
    out["healthy_get_ok"] = sink.getvalue() == payload and hint is None
    originals = {i: _shard_path(root, i).read_bytes() for i in lost}
    for i in lost:
        _shard_path(root, i).unlink()

    sink = io.BytesIO()
    _, hint = phase("get", lambda: decode_stream(
        erasure, sink, readers(), 0, size, size))
    got = sink.getvalue()
    out["get_ok"] = got == payload
    out["heal_hint"] = type(hint).__name__ if hint is not None else None
    r_off = min(size - 1, 3 * block_size + 12345)
    r_len = min(size - r_off, 5 * block_size + 777)
    rsink = io.BytesIO()
    phase("range_get", lambda: decode_stream(
        erasure, rsink, readers(), r_off, r_len, size))
    out["range_ok"] = rsink.getvalue() == payload[r_off: r_off + r_len]

    # Heal the lost shards from the survivors.
    files = {i: open(_shard_path(root, i), "wb") for i in lost}
    try:
        hwriters = [StreamingBitrotWriter(files[i], device=dev)
                    if i in files else None for i in range(k + m)]
        hreaders = [None if i in files else
                    _reader(_shard_path(root, i), size, erasure)
                    for i in range(k + m)]
        phase("heal", lambda: heal_stream(erasure, hwriters, hreaders, size))
    finally:
        for f in files.values():
            f.close()
    out["healed_identical"] = all(
        _shard_path(root, i).read_bytes() == originals[i] for i in lost)

    def reverify():
        for i in range(k + m):
            path = _shard_path(root, i)
            with open(path, "rb") as f:
                bitrot_verify(f, path.stat().st_size,
                              erasure.shard_file_size(size),
                              erasure.shard_size(), device=dev)
        return True

    out["reverified"] = phase("verify", reverify)
    out["bytes"] = got
    return out


OBJECT_BUCKET = "smoke"
OBJECT_LOST = (0, 5, 12, 15)  # data 0, 5; parity 12, 15 at 12+4


def object_put_get_heal(root, size: int, device="cuda",
                        inline_size: int = 100 << 10, seed: int = 0) -> dict:
    """Drive the object layer over 16 fresh drive directories under
    `root`, one 12+4 set: init_format, make_bucket, then

    1. PutObject of a seeded `size`-byte object and an inline one of
       `inline_size` bytes;
    2. GetObject of both, every shard present;
    3. losses by shard index, mapped to drives through the object's
       distribution: part.1 of data shards 0 and 5 deleted, shard 12's
       object directory removed, part.1 of shard 15 truncated;
    4. degraded GetObject, whole and an unaligned range;
    5. HealObject, then the rebuilt part.1 and xl.meta files against the
       SHA-256 of the originals, and verify_file on all 16 drives;
    6. one byte of data shard 3's part.1 flipped: a GetObject, and
       verify_file on that drive.

    Returns each phase's seconds and counter deltas (`counters()`) and
    the checks, each True when it held."""
    dev = resolve_device(device)
    root = Path(root)
    bucket, name, small_name = OBJECT_BUCKET, "object", "inline-object"
    disks = [LocalStorage(str(root / f"d{i}"), endpoint=f"d{i}", device=dev)
             for i in range(16)]
    sets = ErasureSets(disks, 16, default_parity=4, device=dev)
    sets.init_format()
    sets.make_bucket(bucket)
    rng = np.random.default_rng(seed)
    payload, small = rng.bytes(size), rng.bytes(inline_size)
    out: dict = {"size": size, "inline_size": inline_size, "k": 12, "m": 4,
                 "lost": list(OBJECT_LOST), "seconds": {}, "counters": {}}
    phase = _phases(dev, out)
    checks: dict = {}

    def get(obj, offset=0, length=-1) -> bytes:
        sink = io.BytesIO()
        sets.get_object(bucket, obj, sink, offset, length)
        return sink.getvalue()

    phase("put", lambda: sets.put_object(bucket, name, io.BytesIO(payload),
                                         size))
    phase("put_inline", lambda: sets.put_object(
        bucket, small_name, io.BytesIO(small), inline_size))
    checks["get_ok"] = phase("get", lambda: get(name)) == payload
    checks["inline_get_ok"] = phase("get_inline",
                                    lambda: get(small_name)) == small
    fi = disks[0].read_version(bucket, name)
    checks["inline_stored_inline"] = bool(
        disks[0].read_version(bucket, small_name, read_data=True).data)
    shard_disk = {d - 1: i for i, d in enumerate(fi.erasure.distribution)}

    def obj_dir(shard: int) -> Path:
        return root / f"d{shard_disk[shard]}" / bucket / name

    def part(shard: int) -> Path:
        return obj_dir(shard) / fi.data_dir / "part.1"

    def digests(shard: int) -> tuple:
        return tuple(hashlib.sha256(p.read_bytes()).hexdigest()
                     for p in (part(shard), obj_dir(shard) / "xl.meta"))

    originals = {s: digests(s) for s in OBJECT_LOST}
    part(0).unlink()
    part(5).unlink()
    shutil.rmtree(obj_dir(12))
    with open(part(15), "r+b") as f:
        f.truncate(part(15).stat().st_size // 2)

    the_set = sets.get_hashed_set(name)
    the_set.drain_mrf()
    checks["degraded_get_ok"] = phase("degraded_get",
                                      lambda: get(name)) == payload
    checks["degraded_get_queued_heal"] = the_set.drain_mrf() == [
        (bucket, name, "")]
    block = erasure_objects.BLOCK_SIZE_V2
    r_off = min(size - 1, 3 * block + 12345)
    r_len = min(size - r_off, 5 * block + 777)
    checks["range_ok"] = phase("range_get", lambda: get(
        name, r_off, r_len)) == payload[r_off:r_off + r_len]

    healed = phase("heal", lambda: sets.heal_object(bucket, name))
    out["heal_result"] = healed
    checks["heal_result_ok"] = healed == {
        "healed": [f"d{shard_disk[s]}" for s in OBJECT_LOST],
        "dangling": False}
    checks["healed_identical"] = all(digests(s) == originals[s]
                                     for s in OBJECT_LOST)

    def verify_all() -> bool:
        for disk in disks:
            for obj in (name, small_name):
                disk.verify_file(bucket, obj, disk.read_version(
                    bucket, obj, read_data=True))
        return True

    checks["verified_all"] = phase("verify", verify_all)

    bad = part(3)
    with open(bad, "r+b") as f:
        f.seek(32 + fi.erasure.shard_size() // 2)
        byte = f.read(1)[0]
        f.seek(-1, io.SEEK_CUR)
        f.write(bytes([byte ^ 0x5A]))
    the_set.drain_mrf()  # the range GET queued the object too
    checks["bitrot_get_ok"] = phase("bitrot_get",
                                    lambda: get(name)) == payload
    checks["bitrot_get_queued_heal"] = the_set.drain_mrf() == [
        (bucket, name, "")]
    bad_disk = disks[shard_disk[3]]

    def verify_bad() -> bool:
        try:
            bad_disk.verify_file(bucket, name,
                                 bad_disk.read_version(bucket, name))
        except ErrFileCorrupt:
            return True
        return False

    checks["bitrot_detected"] = phase("bitrot_verify", verify_bad)
    out["checks"] = checks
    return out


# How object_codec_put_get_heal loses the shards of `lost`, in turn:
# part.1 deleted twice, the object's directory removed, part.1 cut in
# half (the losses of object_put_get_heal).
_LOSSES = ("unlink", "unlink", "rmtree", "truncate")


def object_codec_put_get_heal(root, size: int, codec: str,
                              drives: int = 16, parity: int = 4,
                              lost=OBJECT_LOST, repair_target=None,
                              device="cuda", seed: int = 0) -> dict:
    """Drive the object layer under one erasure codec: `drives` fresh
    drive directories under `root` as one set of default parity
    `parity`, then

    1. PutObject of a seeded `size`-byte object with
       ObjectOptions(codec=codec), and its xl.meta checked to name the
       codec and its wire algorithm;
    2. GetObject, every shard present;
    3. the shards `lost` lost (by shard index, mapped to drives through
       the object's distribution; in turn part.1 deleted, part.1
       deleted, the object directory removed, part.1 cut in half);
    4. degraded GetObject, whole and an unaligned range;
    5. HealObject, then each rebuilt part.1 and xl.meta against the
       SHA-256 of its original;
    6. when `repair_target` is a shard index: that shard's drive loses
       the object, and HealObject rebuilds it through the repair plane
       (erasure/repair.py): one part repaired, no fallback, the bytes
       read a byte healed equal to the plan's total_symbols / alpha,
       and the rebuilt files equal to the originals.

    Returns each phase's seconds and counter deltas (`counters()`, the
    repair plane's STATS under "repair_"), the repair ratio, and the
    checks, each True when it held."""
    dev = resolve_device(device)
    root = Path(root)
    bucket, name = OBJECT_BUCKET, "object"
    disks = [LocalStorage(str(root / f"d{i}"), endpoint=f"d{i}", device=dev)
             for i in range(drives)]
    sets = ErasureSets(disks, drives, default_parity=parity, device=dev)
    sets.init_format()
    sets.make_bucket(bucket)
    payload = np.random.default_rng(seed).bytes(size)
    out: dict = {"size": size, "codec": codec, "k": drives - parity,
                 "m": parity, "lost": list(lost),
                 "repair_target": repair_target, "seconds": {},
                 "counters": {}}
    phase = _phases(dev, out)
    checks: dict = {}

    def get(offset=0, length=-1) -> bytes:
        sink = io.BytesIO()
        sets.get_object(bucket, name, sink, offset, length)
        return sink.getvalue()

    phase("put", lambda: sets.put_object(bucket, name, io.BytesIO(payload),
                                         size, ObjectOptions(codec=codec)))
    fi = disks[0].read_version(bucket, name)
    checks["codec_stamped"] = (
        fi.erasure.codec == codec
        and fi.erasure.algorithm == registry.get(codec).wire_algorithm)
    checks["get_ok"] = phase("get", get) == payload
    shard_disk = {d - 1: i for i, d in enumerate(fi.erasure.distribution)}

    def obj_dir(shard: int) -> Path:
        return root / f"d{shard_disk[shard]}" / bucket / name

    def part(shard: int) -> Path:
        return obj_dir(shard) / fi.data_dir / "part.1"

    def digests(shard: int) -> tuple:
        return tuple(hashlib.sha256(p.read_bytes()).hexdigest()
                     for p in (part(shard), obj_dir(shard) / "xl.meta"))

    originals = {s: digests(s) for s in range(drives)}
    for i, s in enumerate(lost):
        loss = _LOSSES[i % len(_LOSSES)]
        if loss == "unlink":
            part(s).unlink()
        elif loss == "rmtree":
            shutil.rmtree(obj_dir(s))
        else:
            with open(part(s), "r+b") as f:
                f.truncate(part(s).stat().st_size // 2)
    checks["degraded_get_ok"] = phase("degraded_get", get) == payload
    block = erasure_objects.BLOCK_SIZE_V2
    r_off = min(size - 1, 3 * block + 12345)
    r_len = min(size - r_off, 5 * block + 777)
    checks["range_ok"] = phase("range_get", lambda: get(
        r_off, r_len)) == payload[r_off:r_off + r_len]
    healed = phase("heal", lambda: sets.heal_object(bucket, name))
    checks["heal_result_ok"] = healed == {
        "healed": [f"d{shard_disk[s]}" for s in sorted(lost)],
        "dangling": False}
    checks["healed_identical"] = all(digests(s) == originals[s]
                                     for s in lost)

    if repair_target is not None:
        shutil.rmtree(obj_dir(repair_target))
        healed = phase("repair_heal", lambda: sets.heal_object(bucket, name))
        c = out["counters"]["repair_heal"]
        plan = registry.get(codec).repair_plan(drives - parity, parity,
                                               repair_target)
        ratio = (c["repair_bytes_read"] / c["repair_bytes_written"]
                 if c["repair_bytes_written"] else float("nan"))
        out["repair"] = {"bytes_read": c["repair_bytes_read"],
                         "bytes_written": c["repair_bytes_written"],
                         "ratio": ratio,
                         "plan_ratio": plan.total_symbols / plan.alpha}
        checks["repair_result_ok"] = healed == {
            "healed": [f"d{shard_disk[repair_target]}"], "dangling": False}
        checks["repaired_by_plane"] = (c["repair_parts_repaired"] == 1
                                       and c["repair_fallbacks"] == 0)
        checks["repair_ratio_ok"] = ratio == plan.total_symbols / plan.alpha
        checks["repaired_identical"] = (digests(repair_target)
                                        == originals[repair_target])
        checks["get_after_repair_ok"] = get() == payload
    out["checks"] = checks
    return out


def s3_codec_put_get(root, size: int, codec: str, device="cuda",
                     seed: int = 0) -> dict:
    """A Server over 16 fresh drive directories under `root` (one 12+4
    set) takes one signed PUT of a seeded `size`-byte object with the
    header x-mtpu-codec: `codec`, and one GET of it. Returns the seconds
    and counter deltas of both, and the checks: the PUT's ETag, the GET's
    bytes, and the codec id xl.meta names on every drive."""
    dev = resolve_device(device)
    root = Path(root)
    payload = np.random.default_rng(seed).bytes(size)
    out: dict = {"size": size, "codec": codec, "seconds": {},
                 "counters": {}}
    phase = _phases(dev, out)
    checks: dict = {}
    key = f"/{S3_BUCKET}/codec.bin"
    server = Server([str(root / "d{1...16}")], port=0,
                    root_user=S3_ACCESS, root_password=S3_SECRET,
                    default_parity=4, device=dev)
    # The S3 plane alone: the background services (Server.start()) would
    # heal this entry's degraded objects and write the scanner's usage
    # object meanwhile, which its launch counts and checks do not expect.
    server.s3.start()
    try:
        c = S3Client(server.endpoint, S3_ACCESS, S3_SECRET)
        checks["make_bucket_ok"] = c.request("PUT", f"/{S3_BUCKET}")[0] == 200
        status, headers, _ = phase("put", lambda: c.request(
            "PUT", key, headers={"x-mtpu-codec": codec}, body=payload))
        checks["put_ok"] = (status == 200 and headers.get("ETag") ==
                            f'"{hashlib.md5(payload).hexdigest()}"')
        status, _, body = phase("get", lambda: c.request("GET", key))
        checks["get_ok"] = status == 200 and body == payload
    finally:
        server.stop()
    codecs = {LocalStorage(str(root / f"d{i}"), device=dev).read_version(
        S3_BUCKET, key.rsplit("/", 1)[1]).erasure.codec
        for i in range(1, 17)}
    out["xl_meta_codecs"] = sorted(codecs)
    checks["codec_stamped"] = codecs == {codec}
    out["checks"] = checks
    return out


S3_BUCKET = "smoke"
S3_WIPED = (0, 5, 12, 15)  # drives of the set whose objects are all lost
S3_ACCESS, S3_SECRET = "smoke-admin", "smoke-admin-secret"
SMALL_SIZES = (1 << 10, (4 << 10) + 1, 33 << 10, 100 << 10)


def s3_object_names(small_count: int) -> list[str]:
    """The keys s3_put_get_heal writes: the aws-chunked object, the
    multipart one, then `small_count` small ones under four prefixes."""
    return ["big/chunked.bin", "big/multipart.bin"] + [
        f"small-{i % 4}/obj-{i:04d}" for i in range(small_count)]


def _heal_bucket(client: S3Client, bucket: str,
                 timeout_s: float = 600.0, remove: bool = False) -> dict:
    """Start an admin heal of `bucket` (with `remove`: dangling objects
    deleted) and poll it to its end."""
    path = f"/minio/admin/v3/heal/{bucket}"
    status, _, body = client.request(
        "POST", path, [("remove", "true")] if remove else None)
    if status != 200:
        raise AssertionError(f"admin heal: {status} {body[:200]!r}")
    token = json.loads(body)["clientToken"]
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        status, _, body = client.request("POST", path,
                                         [("clientToken", token)])
        state = json.loads(body)
        if status != 200 or state["Summary"] != "running":
            return state
        time.sleep(0.01)
    raise TimeoutError(f"heal of {bucket} still running after {timeout_s} s")


def _listed(client: S3Client, bucket: str, page: int,
            delimiter: str = "") -> tuple[list, list, int]:
    """Every key and common prefix of a ListObjectsV2 walk in pages of
    `page`, and the number of pages."""
    keys, prefixes, token, pages = [], [], "", 0
    while True:
        q = [("list-type", "2"), ("max-keys", str(page))]
        if delimiter:
            q.append(("delimiter", delimiter))
        if token:
            q.append(("continuation-token", token))
        status, _, body = client.request("GET", f"/{bucket}", q)
        if status != 200:
            raise AssertionError(f"list: {status} {body[:200]!r}")
        pages += 1
        keys += [k.decode() for k in re.findall(rb"<Key>(.*?)</Key>", body)]
        prefixes += [p.decode() for p in re.findall(
            rb"<CommonPrefixes><Prefix>(.*?)</Prefix>", body)]
        m = re.search(rb"<NextContinuationToken>(.*?)<", body)
        if not m:
            return keys, prefixes, pages
        token = m.group(1).decode()


def s3_put_get_heal(root, size: int, device="cuda",
                    part_size: int = 16 << 20, parts: int = 8,
                    last_part: int = 12_345, small_count: int = 256,
                    small_sizes=SMALL_SIZES, page: int = 100,
                    concurrent: int = 4, seed: int = 0) -> dict:
    """Drive the S3 plane over HTTP on localhost: a Server over 16 fresh
    drive directories under `root` (one 12+4 set), a client signing with
    the port's api/sign.py, and in order:

    1. MakeBucket; an aws-chunked PutObject of a seeded `size`-byte
       object; a multipart upload of `parts` parts of `part_size` bytes
       and a last one of `last_part`; `small_count` small objects, sizes
       cycling over `small_sizes`, under four prefixes;
    2. ListObjectsV2 in pages of `page`, without a delimiter and with
       "/";
    3. a whole GET and a ranged GET of the big object, then `concurrent`
       GETs at once of both big objects (bytes checked; their launches
       are not counted apart);
    4. every object of the bucket lost on drives 0, 5, 12 and 15, and
       degraded GETs of both big objects;
    5. an admin heal of the bucket, polled to its end, then every file
       of the lost drives against the SHA-256 of its original.

    Returns each serial phase's seconds and counter deltas
    (`counters()`), the concurrent GETs' seconds, the heal's final
    status, and the checks, each True when it held."""
    dev = resolve_device(device)
    root = Path(root)
    rng = np.random.default_rng(seed)
    payload = rng.bytes(size)
    mp_sizes = [part_size] * parts + ([last_part] if last_part else [])
    mp_payload = rng.bytes(sum(mp_sizes))
    big, mp, *small_names = s3_object_names(small_count)
    smalls = {name: rng.bytes(small_sizes[i % len(small_sizes)])
              for i, name in enumerate(small_names)}
    out: dict = {"size": size, "multipart_size": len(mp_payload),
                 "parts": len(mp_sizes), "small_count": small_count,
                 "k": 12, "m": 4, "wiped_drives": list(S3_WIPED),
                 "seconds": {}, "counters": {}}
    phase = _phases(dev, out)
    checks: dict = {}
    server = Server([str(root / "d{1...16}")], port=0,
                    root_user=S3_ACCESS, root_password=S3_SECRET,
                    default_parity=4, device=dev)
    # The S3 plane alone: the background services (Server.start()) would
    # heal this entry's degraded objects and write the scanner's usage
    # object meanwhile, which its launch counts and checks do not expect.
    server.s3.start()
    try:
        c = S3Client(server.endpoint, S3_ACCESS, S3_SECRET)
        b = f"/{S3_BUCKET}"
        checks["make_bucket_ok"] = phase(
            "make_bucket", lambda: c.request("PUT", b))[0] == 200

        status, headers, _ = phase("put", lambda: c.put_chunked(
            f"{b}/{big}", payload))
        checks["put_ok"] = (status == 200 and headers.get("ETag") ==
                            f'"{hashlib.md5(payload).hexdigest()}"')

        def multipart():
            status, _, body = c.request("POST", f"{b}/{mp}", [("uploads", "")])
            upload = re.search(rb"<UploadId>(.*?)<", body).group(1).decode()
            etags, off = [], 0
            for n, ln in enumerate(mp_sizes, 1):
                status, h, _ = c.request(
                    "PUT", f"{b}/{mp}", [("partNumber", str(n)),
                                         ("uploadId", upload)],
                    body=mp_payload[off:off + ln])
                if status != 200:
                    return None
                etags.append(h["ETag"])
                off += ln
            xml = "<CompleteMultipartUpload>" + "".join(
                f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
                for n, e in enumerate(etags, 1)) + \
                "</CompleteMultipartUpload>"
            status, _, body = c.request("POST", f"{b}/{mp}",
                                        [("uploadId", upload)],
                                        body=xml.encode())
            return status, body

        md5s = b"".join(hashlib.md5(mp_payload[o:o + ln]).digest()
                        for o, ln in zip(np.cumsum([0] + mp_sizes[:-1]),
                                         mp_sizes))
        want_etag = f"{hashlib.md5(md5s).hexdigest()}-{len(mp_sizes)}"
        done = phase("multipart", multipart)
        checks["multipart_ok"] = (done is not None and done[0] == 200 and
                                  f'"{want_etag}"'.encode() in done[1])

        def put_smalls() -> bool:
            return all(c.request("PUT", f"{b}/{k}", body=v)[0] == 200
                       for k, v in smalls.items())

        checks["small_ok"] = phase("put_small", put_smalls)

        keys, prefixes, pages = phase("list", lambda: _listed(c, S3_BUCKET,
                                                              page))
        checks["list_ok"] = keys == sorted([big, mp, *smalls])
        out["list_pages"] = pages
        keys, prefixes, _ = phase("list_delimiter", lambda: _listed(
            c, S3_BUCKET, page, "/"))
        checks["list_delimiter_ok"] = (keys == [] and prefixes == sorted(
            {"big/"} | {k.split("/")[0] + "/" for k in smalls}))

        status, _, got = phase("get", lambda: c.request("GET", f"{b}/{big}"))
        checks["get_ok"] = status == 200 and got == payload
        block = erasure_objects.BLOCK_SIZE_V2
        r_off = min(size - 1, 3 * block + 12345)
        r_len = min(size - r_off, 5 * block + 777)
        status, _, got = phase("range_get", lambda: c.request(
            "GET", f"{b}/{big}",
            headers={"Range": f"bytes={r_off}-{r_off + r_len - 1}"}))
        checks["range_ok"] = (status == 206 and
                              got == payload[r_off:r_off + r_len])

        results: list = [None] * concurrent
        wants = [(big, payload), (mp, mp_payload)]
        before = counters()

        def get_one(i):
            name, want = wants[i % 2]
            status, _, body = c.request("GET", f"{b}/{name}")
            results[i] = status == 200 and body == want

        threads = [threading.Thread(target=get_one, args=(i,))
                   for i in range(concurrent)]
        _sync(dev)
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        _sync(dev)
        out["concurrent_get_seconds"] = time.perf_counter() - t0
        out["counters"]["concurrent_get"] = _delta(before, counters())
        checks["concurrent_get_ok"] = all(results)

        # Every object of the bucket lost on the wiped drives.
        wiped = [root / f"d{i + 1}" / S3_BUCKET for i in S3_WIPED]
        originals = {p: hashlib.sha256(p.read_bytes()).hexdigest()
                     for d in wiped for p in d.rglob("*") if p.is_file()}
        for d in wiped:
            for entry in d.iterdir():
                shutil.rmtree(entry)
        status, _, got = phase("degraded_get", lambda: c.request(
            "GET", f"{b}/{big}"))
        checks["degraded_get_ok"] = status == 200 and got == payload
        status, _, got = phase("degraded_get_multipart", lambda: c.request(
            "GET", f"{b}/{mp}"))
        checks["degraded_multipart_ok"] = status == 200 and got == mp_payload

        state = phase("heal", lambda: _heal_bucket(c, S3_BUCKET))
        out["heal"] = {k: state[k] for k in ("Summary", "NumScanned",
                                             "NumHealed", "NumFailed")}
        checks["heal_ok"] = (state["Summary"] == "finished" and
                             state["NumFailed"] == 0 and
                             state["NumHealed"] == 2 + small_count)
        checks["healed_identical"] = bool(originals) and all(
            p.is_file() and hashlib.sha256(p.read_bytes()).hexdigest() == h
            for p, h in originals.items())
        out["healed_files"] = len(originals)
    finally:
        server.stop()
    out["checks"] = checks
    return out


ENABLED_XML = (b"<VersioningConfiguration><Status>Enabled</Status>"
               b"</VersioningConfiguration>")


def part_copy_ranges(size: int) -> list[tuple[int, int]]:
    """The three x-amz-copy-source-range spans (first, last) s3_core's
    UploadPartCopy takes from a `size`-byte source: whole blocks to a
    quarter of it, then to three quarters plus 7 bytes, then the rest,
    so that the last two parts end in ragged blocks."""
    block = erasure_objects.BLOCK_SIZE_V2
    quarter = size // 4 // block * block
    if quarter == 0:
        raise ValueError(f"a {size}-byte source has fewer than 4 blocks "
                         f"of {block} B")
    cuts = (0, quarter, 3 * quarter + 7, size)
    return [(a, b - 1) for a, b in zip(cuts, cuts[1:])]


def _listed_versions(client: S3Client, bucket: str, prefix: str,
                     page: int) -> tuple[list, int]:
    """Every (key, version id, delete marker, latest) of a paged
    ListObjectVersions walk, and the number of pages."""
    entries, key_marker, vid_marker, pages = [], "", "", 0
    while True:
        q = [("versions", ""), ("prefix", prefix), ("max-keys", str(page))]
        if key_marker:
            q += [("key-marker", key_marker),
                  ("version-id-marker", vid_marker)]
        status, _, body = client.request("GET", f"/{bucket}", q)
        if status != 200:
            raise AssertionError(f"versions: {status} {body[:200]!r}")
        pages += 1
        for kind, block in re.findall(
                rb"<(Version|DeleteMarker)>(.*?)</\1>", body, re.S):
            entries.append((
                re.search(rb"<Key>(.*?)</Key>", block).group(1).decode(),
                re.search(rb"<VersionId>(.*?)</VersionId>",
                          block).group(1).decode(),
                kind == b"DeleteMarker",
                b"<IsLatest>true</IsLatest>" in block))
        if b"<IsTruncated>true</IsTruncated>" not in body:
            return entries, pages
        key_marker = re.search(rb"<NextKeyMarker>(.*?)<",
                               body).group(1).decode()
        vid_marker = re.search(rb"<NextVersionIdMarker>(.*?)<",
                               body).group(1).decode()


def _part_digests(root: Path, bucket: str, prefix: str = "") -> dict:
    """SHA-256 of every part file of the bucket's objects under `prefix`
    on the 16 drives."""
    return {p: hashlib.sha256(p.read_bytes()).hexdigest()
            for i in range(1, 17)
            for p in (root / f"d{i}" / bucket).glob(f"{prefix}**/part.*")
            if p.is_file()}


def _journal(root: Path, drive: int, bucket: str, name: str):
    """(version id, mod time, delete marker) of each version in a drive's
    xl.meta of the object, None when it has none."""
    path = root / f"d{drive}" / bucket / name / "xl.meta"
    if not path.is_file():
        return None
    return [(v["vid"], v["mt"], v["del"])
            for v in XLMeta.from_bytes(path.read_bytes()).versions]


def _wipe(root: Path, bucket: str) -> None:
    """Every object of the bucket lost on the drives of S3_WIPED."""
    for i in S3_WIPED:
        for entry in (root / f"d{i + 1}" / bucket).iterdir():
            shutil.rmtree(entry)


def s3_core(root, size: int, device="cuda", small_count: int = 256,
            small_size: int = 1 << 10, page: int = 100,
            seed: int = 0) -> dict:
    """Drive the S3 object core over HTTP on localhost: a Server over 16
    fresh drive directories under `root` (one 12+4 set), one client
    signing with the port's api/sign.py, the object writes stamped
    dense-gf8 (x-mtpu-codec), and in order:

    1. MakeBucket ver, PUT ?versioning Enabled, GET ?versioning;
       MakeBucket dst, unversioned;
    2. two PUTs of ver/big, `size` bytes each: v1 = payload A, then
       v2 = payload B with x-amz-tagging; ListObjectVersions;
    3. DELETE ver/big (a delete marker); a GET (404); GETs of v1 and v2
       by versionId;
    4. ver's objects lost on drives 0, 5, 12 and 15; a degraded GET of
       v1 by versionId;
    5. CopyObject of ver/big?versionId=v1 to dst/copy from the degraded
       source; a GET of it;
    6. a multipart upload of dst/parts from three UploadPartCopy parts
       of v2 (part_copy_ranges); Complete; a GET of it;
    7. a self-copy of dst/copy with x-amz-metadata-directive REPLACE,
       metadata only: its part files keep their bytes;
    8. tagging of v1: put, get, delete; a HEAD of v2 (its tag count);
    9. `small_count` PUTs of `small_size` bytes under small/ in ver, one
       POST ?delete of all of them, ListObjectsV2 of ver (empty: every
       latest version is a delete marker), ListObjectVersions of small/
       in pages of `page` (2 x small_count entries);
    10. a bucket policy on dst letting anonymous requests GET public/*:
        anonymous GETs of dst/public/x (200) and dst/copy (403), an
        anonymous PUT (403), and after DELETE ?policy the first GET
        again (403);
    11. dst's objects lost on the same drives; an admin heal of dst
        polled to its end; heal_object of ver/big at v1, v2 and the
        marker (the heal walk visits latest versions only); every part
        file of both buckets then equal to its pre-loss copy by SHA-256,
        and each healed drive's journal of ver/big equal to a surviving
        drive's.

    Returns each step's seconds and counter deltas (`counters()`, with
    the copy pulls and bytes read), the bytes each copy read and wrote,
    and the checks, each True when it held."""
    dev = resolve_device(device)
    root = Path(root)
    rng = np.random.default_rng(seed)
    payload_a, payload_b = rng.bytes(size), rng.bytes(size)
    small = rng.bytes(small_size)
    out: dict = {"size": size, "k": 12, "m": 4,
                 "wiped_drives": list(S3_WIPED), "small_count": small_count,
                 "part_copy_ranges": part_copy_ranges(size),
                 "seconds": {}, "counters": {}}
    phase = _phases(dev, out)
    checks: dict = {}
    dense = {"x-mtpu-codec": "dense-gf8"}
    server = Server([str(root / "d{1...16}")], port=0,
                    root_user=S3_ACCESS, root_password=S3_SECRET,
                    default_parity=4, device=dev)
    # The S3 plane alone: the background services (Server.start()) would
    # heal this entry's degraded objects and write the scanner's usage
    # object meanwhile, which its launch counts and checks do not expect.
    server.s3.start()
    try:
        c = S3Client(server.endpoint, S3_ACCESS, S3_SECRET)
        big = "/ver/big"

        def versioning():
            return [c.request("PUT", "/ver")[0],
                    c.request("PUT", "/ver", [("versioning", "")],
                              body=ENABLED_XML)[0],
                    c.request("GET", "/ver", [("versioning", "")]),
                    c.request("PUT", "/dst")[0]]

        got = phase("versioning", versioning)
        checks["versioning_ok"] = (got[:2] == [200, 200] and got[3] == 200
                                   and b"<Status>Enabled</Status>"
                                   in got[2][2])

        # 2. Two versions, the second tagged.
        _, h, _ = phase("put_v1", lambda: c.request(
            "PUT", big, headers=dense, body=payload_a))
        v1 = h.get("x-amz-version-id", "")
        _, h, _ = phase("put_v2", lambda: c.request(
            "PUT", big, headers={**dense, "x-amz-tagging":
                                 "team=storage&copy=none"},
            body=payload_b))
        v2 = h.get("x-amz-version-id", "")
        listed, _ = phase("list_versions", lambda: _listed_versions(
            c, "ver", "big", page))
        checks["two_versions_ok"] = bool(v1 and v2 and v1 != v2) and \
            listed == [("big", v2, False, True), ("big", v1, False, False)]

        # 3. A delete marker over both.
        status, h, _ = phase("delete_marker", lambda: c.request("DELETE",
                                                                big))
        marker = h.get("x-amz-version-id", "")
        checks["delete_marker_ok"] = (status == 204 and h.get(
            "x-amz-delete-marker") == "true" and marker not in ("", v1, v2))
        status, _, body = phase("get_marked", lambda: c.request("GET", big))
        checks["get_marked_404"] = (status == 404
                                    and b"<Code>NoSuchKey</Code>" in body)
        for name, vid, want in (("get_v1", v1, payload_a),
                                ("get_v2", v2, payload_b)):
            status, _, body = phase(name, lambda vid=vid: c.request(
                "GET", big, [("versionId", vid)]))
            checks[f"{name}_ok"] = status == 200 and body == want

        # 4. Drives lost; v1 read degraded.
        ver_digests = _part_digests(root, "ver")
        _wipe(root, "ver")
        status, _, body = phase("degraded_get_v1", lambda: c.request(
            "GET", big, [("versionId", v1)]))
        checks["degraded_get_v1_ok"] = status == 200 and body == payload_a

        # 5. CopyObject from the degraded source.
        status, _, body = phase("copy", lambda: c.request(
            "PUT", "/dst/copy",
            headers={"x-amz-copy-source": f"{big}?versionId={v1}"}))
        etag_a = hashlib.md5(payload_a).hexdigest()
        checks["copy_ok"] = status == 200 and f'"{etag_a}"'.encode() in body
        status, _, body = phase("get_copy", lambda: c.request("GET",
                                                              "/dst/copy"))
        checks["get_copy_ok"] = status == 200 and body == payload_a

        # 6. UploadPartCopy of v2 in three ranges, the last two ragged.
        def part_copy():
            status, _, body = c.request("POST", "/dst/parts",
                                        [("uploads", "")], headers=dense)
            upload = re.search(rb"<UploadId>(.*?)<", body).group(1).decode()
            etags = []
            for n, (first, last) in enumerate(part_copy_ranges(size), 1):
                status, _, body = c.request(
                    "PUT", "/dst/parts", [("partNumber", str(n)),
                                          ("uploadId", upload)],
                    headers={"x-amz-copy-source": f"{big}?versionId={v2}",
                             "x-amz-copy-source-range":
                                 f"bytes={first}-{last}"})
                if status != 200:
                    return status, body
                etags.append(re.search(rb"<ETag>(.*?)</ETag>",
                                       body).group(1).decode())
            xml = "<CompleteMultipartUpload>" + "".join(
                f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
                for n, e in enumerate(etags, 1)) + \
                "</CompleteMultipartUpload>"
            status, _, body = c.request("POST", "/dst/parts",
                                        [("uploadId", upload)],
                                        body=xml.encode())
            return status, body

        status, _ = phase("part_copy", part_copy)
        checks["part_copy_ok"] = status == 200
        status, _, body = phase("get_parts", lambda: c.request(
            "GET", "/dst/parts"))
        checks["get_parts_ok"] = status == 200 and body == payload_b

        # 7. A metadata-only self-copy.
        before = _part_digests(root, "dst", "copy/")
        status, _, _ = phase("self_copy", lambda: c.request(
            "PUT", "/dst/copy", headers={
                "x-amz-copy-source": "/dst/copy",
                "x-amz-metadata-directive": "REPLACE",
                "x-amz-meta-note": "replaced"}))
        _, h, _ = c.request("HEAD", "/dst/copy")
        checks["self_copy_ok"] = (status == 200 and h.get("x-amz-meta-note")
                                  == "replaced")
        checks["self_copy_parts_unchanged"] = bool(before) and \
            _part_digests(root, "dst", "copy/") == before

        # 8. Tagging of v1.
        def tagging():
            q = [("tagging", ""), ("versionId", v1)]
            xml = (b"<Tagging><TagSet><Tag><Key>tier</Key><Value>cold"
                   b"</Value></Tag></TagSet></Tagging>")
            return (c.request("PUT", big, q, body=xml)[0],
                    c.request("GET", big, q)[2],
                    c.request("DELETE", big, q)[0],
                    c.request("GET", big, q)[2],
                    c.request("HEAD", big, [("versionId", v2)])[1])

        put_s, tags, del_s, tags_after, head_v2 = phase("tagging", tagging)
        checks["tagging_ok"] = (
            put_s == 200 and b"<Key>tier</Key>" in tags and del_s == 204
            and b"<Tag>" not in tags_after
            and head_v2.get("x-amz-tagging-count") == "2")

        # 9. Small objects, one DeleteObjects, the listings.
        names = [f"small/obj-{i:04d}" for i in range(small_count)]
        checks["small_put_ok"] = phase("put_small", lambda: all(
            c.request("PUT", f"/ver/{n}", headers=dense,
                      body=small)[0] == 200 for n in names))
        delete_xml = ("<Delete>" + "".join(
            f"<Object><Key>{n}</Key></Object>" for n in names)
            + "</Delete>").encode()
        status, _, body = phase("delete_objects", lambda: c.request(
            "POST", "/ver", [("delete", "")], body=delete_xml))
        checks["delete_objects_ok"] = (status == 200 and body.count(
            b"<Deleted>") == small_count and b"<Error>" not in body)
        keys, prefixes, _ = phase("list_after_delete", lambda: _listed(
            c, "ver", page))
        checks["list_empty"] = keys == [] and prefixes == []
        listed, pages = phase("list_versions_small", lambda: _listed_versions(
            c, "ver", "small/", page))
        out["version_pages"] = pages
        checks["list_versions_ok"] = (
            len(listed) == 2 * small_count
            and sorted({e[0] for e in listed}) == names
            and sum(e[2] for e in listed) == small_count
            and all(e[3] == e[2] for e in listed))

        # 10. A bucket policy and anonymous requests.
        policy = json.dumps({"Version": "2012-10-17", "Statement": [{
            "Effect": "Allow", "Principal": {"AWS": ["*"]},
            "Action": ["s3:GetObject"],
            "Resource": ["arn:aws:s3:::dst/public/*"]}]}).encode()

        def policy_calls():
            c.request("PUT", "/dst/public/x", headers=dense, body=small)
            put = c.request("PUT", "/dst", [("policy", "")], body=policy)[0]
            anon = [c.request("GET", "/dst/public/x", anonymous=True),
                    c.request("GET", "/dst/copy", anonymous=True),
                    c.request("PUT", "/dst/public/y", body=small,
                              anonymous=True)]
            deleted = c.request("DELETE", "/dst", [("policy", "")])[0]
            after = c.request("GET", "/dst/public/x", anonymous=True)
            return put, anon, deleted, after

        put, anon, deleted, after = phase("policy", policy_calls)
        checks["policy_ok"] = (
            put == 204 and deleted == 204
            and anon[0][0] == 200 and anon[0][2] == small
            and [a[0] for a in anon[1:]] == [403, 403] and after[0] == 403)

        # 11. dst lost too; the heals.
        dst_digests = _part_digests(root, "dst")
        _wipe(root, "dst")
        state = phase("heal_bucket", lambda: _heal_bucket(c, "dst"))
        out["heal"] = {k: state[k] for k in ("Summary", "NumScanned",
                                             "NumHealed", "NumFailed")}
        checks["heal_bucket_ok"] = (state["Summary"] == "finished"
                                    and state["NumFailed"] == 0)
        ol = server.object_layer
        heals = phase("heal_versions", lambda: [
            ol.heal_object("ver", "big", vid) for vid in (v1, v2, marker)])
        checks["heal_versions_ok"] = all(len(h["healed"]) == len(S3_WIPED)
                                         for h in heals)
    finally:
        server.stop()
    checks["healed_identical"] = bool(ver_digests) and bool(dst_digests) \
        and all(p.is_file() and hashlib.sha256(p.read_bytes()).hexdigest()
                == h for p, h in {**ver_digests, **dst_digests}.items())
    survivor = next(i for i in range(1, 17) if i - 1 not in S3_WIPED)
    journal = _journal(root, survivor, "ver", "big")
    checks["healed_journals_ok"] = len(journal) == 3 and all(
        _journal(root, i + 1, "ver", "big") == journal for i in S3_WIPED)
    out["healed_files"] = len(ver_digests) + len(dst_digests)
    out["copy_bytes"] = {
        name: {"pulls": out["counters"][name]["copy_pulls"],
               "read": out["counters"][name]["copy_bytes"],
               "written": sum(p.stat().st_size for i in range(1, 17)
                              for p in (root / f"d{i}" / "dst").glob(
                                  f"{obj}/*/part.*"))}
        for name, obj in (("copy", "copy"), ("part_copy", "parts"))}
    out["checks"] = checks
    return out


def _wait_for(cond, timeout_s: float, what: str, poll_s: float = 0.005):
    """Poll cond() until it is true; returns the monotonic time it first
    held. Raises TimeoutError after `timeout_s`."""
    deadline = time.monotonic() + timeout_s
    while True:
        now = time.monotonic()
        if cond():
            return now
        if now > deadline:
            raise TimeoutError(f"{what}: not within {timeout_s} s")
        time.sleep(poll_s)


def repairable_names(bucket: str, prefix: str, count: int, drive: int,
                     k: int, drives: int) -> list[str]:
    """The first `count` names prefix + "0", "1", ... whose shard on drive
    index `drive` is a data shard under their distribution: msr-pm's
    piggyback plans cover data shards only, so a heal of that drive alone
    takes the repair plane."""
    from .object.metadata import hash_order

    out, i = [], 0
    while len(out) < count:
        name = f"{prefix}{i}"
        if hash_order(f"{bucket}/{name}", drives)[drive] - 1 < k:
            out.append(name)
        i += 1
    return out


def _drive_files(root: Path, drive: str, buckets) -> dict:
    """SHA-256 of every file under `buckets` on drive directory `drive`,
    by path relative to the drive."""
    base = root / drive
    return {str(p.relative_to(base)): hashlib.sha256(p.read_bytes())
            .hexdigest()
            for b in buckets for p in sorted((base / b).rglob("*"))
            if p.is_file()}


def _journal_versions(path: Path) -> list:
    """(version id, mod time, delete marker, data dir, size) of each
    version in an xl.meta file."""
    return [(v["vid"], v["mt"], v["del"], v.get("dd"), v.get("size"))
            for v in XLMeta.from_bytes(path.read_bytes()).versions]


def _replace_drive(disk, path: Path) -> None:
    """A replaced drive: an empty directory at the same mount point, the
    same LocalStorage object re-opened on it (under a server's health
    wrapper, the raw drive is re-opened and the wrapper kept)."""
    raw = unwrap(disk)
    shutil.rmtree(path)
    raw.__init__(str(path), endpoint=raw.endpoint(), device=raw.device)


SELF_HEAL_OUTAGE = 3    # drive d3 goes offline during writes
SELF_HEAL_WIPED = 8     # drive d8 is replaced by an empty one
SELF_HEAL_OFFLINE = (1, 6, 13, 16)  # drives off for the check of d3's shards
SELF_HEAL_VERSIONED = ("ver", "doc")


def self_heal_names(big_count: int, msr_count: int, small_count: int):
    """The keys self_heal writes in S3_BUCKET: (dense, msr-pm, small,
    outage dense, outage msr-pm). The msr-pm ones are chosen so that the
    replaced drive holds a data shard of each (its repair plan exists)."""
    msr = repairable_names(S3_BUCKET, "msr/obj-", msr_count + 1,
                           SELF_HEAL_WIPED - 1, 12, 16)
    return ([f"big/obj-{i}" for i in range(big_count)], msr[:msr_count],
            s3_object_names(small_count)[2:], "outage/dense", msr[-1])


def self_heal(root, size: int, device="cuda", big_count: int = 6,
              msr_count: int = 2, small_count: int = 256,
              small_sizes=SMALL_SIZES, seed: int = 0) -> dict:
    """Drive the self-healing services of a running Server over HTTP: a
    Server over 16 fresh drive directories d1..d16 under `root` (one 12+4
    set, 1 MiB blocks) started whole (Server.start(): the MRF drain every
    5 s, the disk monitor every 1 s, the fresh-drive healer every 10 s,
    the scanner), a client signing with the port's api/sign.py, and:

    1. load: `big_count` objects of `size` bytes with no codec header
       (the server's choice), `msr_count` with x-mtpu-codec: msr-pm,
       `small_count` small ones (sizes cycling over `small_sizes`), and a
       versioned bucket whose key holds two versions and a delete marker;
    2. outage: drive d3 offline until the monitor's loop pulls it, two
       more objects of `size` (one msr-pm) PUT on the other 15 drives
       (queued in the MRF), d3 back: the monitor's reconnect drains the
       MRF. Then d3's shard of both is verified (verify_file), and with
       d1, d6, d13 and d16 offline, so that d3's shards are needed, both
       are read back exactly over HTTP;
    3. replacement: d8 emptied and re-opened while the server runs; the
       fresh-drive healer's loop reformats and sweeps it: every file
       hashed before is back, the tracker (healing.json) is gone, the
       msr-pm objects took the repair plane at its plan's ratio, and the
       pacer granted one token a heal, none at its deadline;
    4. the scanner, its loop stopped: one cycle whose per-bucket usage
       equals the admin datausage walk, a second that skips through the
       tracker every bucket the first left unchanged (all but those its
       1-in-512 sampled heals touched), and the admin usage snapshot
       over HTTP.

    Returns seconds, counter deltas, the sweep's numbers and the checks,
    each True when it held."""

    dev = resolve_device(device)
    root = Path(root)
    rng = np.random.default_rng(seed)
    bigs, msrs, smalls, outage_dense, outage_msr = self_heal_names(
        big_count, msr_count, small_count)
    payloads = {name: rng.bytes(size) for name in
                bigs + msrs + [outage_dense, outage_msr]}
    for i, name in enumerate(smalls):
        payloads[name] = rng.bytes(small_sizes[i % len(small_sizes)])
    versions = [rng.bytes(small_sizes[2 % len(small_sizes)]),
                rng.bytes(small_sizes[-1])]
    vbucket, vkey = SELF_HEAL_VERSIONED
    out: dict = {"size": size, "k": 12, "m": 4, "outage_drive":
                 f"d{SELF_HEAL_OUTAGE}", "wiped_drive": f"d{SELF_HEAL_WIPED}",
                 "offline_drives": [f"d{i}" for i in SELF_HEAL_OFFLINE],
                 "objects": {"dense": bigs, "msr-pm": msrs,
                             "small": len(smalls),
                             "outage": [outage_dense, outage_msr],
                             "versioned": f"{vbucket}/{vkey}"},
                 "seconds": {}, "counters": {}}
    phase = _phases(dev, out)
    checks: dict = {}
    server = Server([str(root / "d{1...16}")], port=0,
                    root_user=S3_ACCESS, root_password=S3_SECRET,
                    default_parity=4, device=dev).start()
    pool = server.object_layer.pools[0]
    es = pool.sets[0]
    drive = {n: pool.disks[n - 1] for n in range(1, 17)}  # d1..d16
    try:
        c = S3Client(server.endpoint, S3_ACCESS, S3_SECRET)
        b = f"/{S3_BUCKET}"
        msr_header = {"x-mtpu-codec": "msr-pm"}

        def put(name, headers=None) -> bool:
            status, h, _ = c.request("PUT", f"{b}/{name}", headers=headers,
                                     body=payloads[name])
            return status == 200 and h.get("ETag") == \
                f'"{hashlib.md5(payloads[name]).hexdigest()}"'

        def load() -> bool:
            ok = c.request("PUT", b)[0] == 200
            ok &= all(put(n) for n in bigs)
            ok &= all(put(n, msr_header) for n in msrs)
            ok &= all(put(n) for n in smalls)
            ok &= c.request("PUT", f"/{vbucket}")[0] == 200
            ok &= c.request("PUT", f"/{vbucket}", [("versioning", "")],
                            body=ENABLED_XML)[0] == 200
            for body in versions:
                ok &= c.request("PUT", f"/{vbucket}/{vkey}",
                                body=body)[0] == 200
            ok &= c.request("DELETE", f"/{vbucket}/{vkey}")[0] == 204
            return ok

        checks["load_ok"] = phase("load", load)
        out["codecs"] = {name: drive[1].read_version(
            S3_BUCKET, name).erasure.codec for name in bigs + msrs}
        checks["msr_stamped"] = all(out["codecs"][n] == "msr-pm"
                                    for n in msrs)

        # 2. The outage: the monitor's own loop pulls d3.
        slot = SELF_HEAL_OUTAGE - 1
        t0 = time.monotonic()
        drive[SELF_HEAL_OUTAGE].set_online(False)
        out["seconds"]["outage_pulled"] = _wait_for(
            lambda: es.disks[slot] is None, 10, "d3 pulled") - t0
        checks["outage_put_ok"] = phase("outage_put", lambda: put(
            outage_dense) and put(outage_msr, msr_header))
        queued = es.mrf_stats()["pending"]
        out["mrf_queued"] = queued
        checks["mrf_queued_ok"] = queued == 2
        healed0 = server.mrf.healed_total
        _sync(dev)
        before = counters()
        t_return = time.monotonic()
        drive[SELF_HEAL_OUTAGE].set_online(True)
        t_slot = _wait_for(lambda: es.disks[slot] is not None, 10,
                           "d3 reconnected")
        t_done = _wait_for(
            lambda: (es.mrf_stats()["pending"] == 0
                     and server.mrf.healed_total >= healed0 + queued),
            30, "MRF drained")
        _sync(dev)
        out["counters"]["mrf_drain"] = _delta(before, counters())
        out["seconds"]["return_to_empty_mrf"] = t_done - t_return
        out["seconds"]["reconnect"] = t_slot - t_return
        out["seconds"]["mrf_drain"] = t_done - t_slot

        def shard_verified(name) -> bool:
            fi = drive[SELF_HEAL_OUTAGE].read_version(S3_BUCKET, name)
            drive[SELF_HEAL_OUTAGE].verify_file(S3_BUCKET, name, fi)
            return True

        checks["outage_shards_verified"] = (
            shard_verified(outage_dense) and shard_verified(outage_msr))
        for n in SELF_HEAL_OFFLINE:
            drive[n].set_online(False)
        gets = phase("outage_degraded_get", lambda: [
            c.request("GET", f"{b}/{name}")
            for name in (outage_dense, outage_msr)])
        checks["outage_get_ok"] = all(
            status == 200 and body == payloads[name]
            for (status, _, body), name in zip(gets, (outage_dense,
                                                      outage_msr)))
        for n in SELF_HEAL_OFFLINE:
            drive[n].set_online(True)
        # Every drive back in its slot, and the MRF entries the degraded
        # GETs queued drained, before the replacement.
        _wait_for(lambda: all(d is not None for d in es.disks)
                  and es.mrf_stats()["pending"] == 0, 30,
                  "drives back and MRF empty")

        # 3. The replacement: d8 emptied while the server runs.
        wiped = f"d{SELF_HEAL_WIPED}"
        user = (S3_BUCKET, vbucket)
        originals = _drive_files(root, wiped, user)
        fmt = hashlib.sha256((root / wiped / ".mtpu.sys" / "format.json")
                             .read_bytes()).hexdigest()
        multi = f"{vbucket}/{vkey}/xl.meta"
        journal = _journal_versions(root / wiped / multi)
        n_versions = sum(len(server.object_layer.list_object_versions(
            bk, max_keys=100000).versions) for bk in user)
        pace0 = healpace.pacer().snapshot()
        repair0 = repair.stats_snapshot()
        # Every heal in the window by the thread that ran it: the sweep's
        # loop, or the MRF drain, the monitor's reconnect drain and the
        # scanner when their loops land in it.
        window_heals: dict = {}
        window_mu = threading.Lock()
        heal_object = es.heal_object

        def counted_heal(*args, **kwargs):
            name = threading.current_thread().name
            with window_mu:
                window_heals[name] = window_heals.get(name, 0) + 1
            return heal_object(*args, **kwargs)

        es.heal_object = counted_heal
        _sync(dev)
        before = counters()
        t_wipe = time.monotonic()
        try:
            _replace_drive(drive[SELF_HEAL_WIPED], root / wiped)
            tracker = root / wiped / ".mtpu.sys" / "healing.json"
            t_tracker = _wait_for(tracker.is_file, 30,
                                  "healing.json written")
            endpoint = drive[SELF_HEAL_WIPED].endpoint()
            t_healed = _wait_for(
                lambda: endpoint in server.fresh_disk_healer.healed_disks,
                120, f"{wiped} healed")
        finally:
            del es.heal_object
        _sync(dev)
        out["counters"]["sweep"] = _delta(before, counters())
        out["seconds"]["wipe_to_healed"] = t_healed - t_wipe
        out["seconds"]["detect"] = t_tracker - t_wipe
        out["seconds"]["sweep"] = t_healed - t_tracker
        healed_files = _drive_files(root, wiped, user)
        pace1 = healpace.pacer().snapshot()
        repair1 = repair.stats_snapshot()
        rep = {k: repair1[k] - repair0[k] for k in repair1}
        part_bytes = sum((root / wiped / p).stat().st_size
                         for p in healed_files
                         if p.rsplit("/", 1)[-1].startswith("part."))
        out["sweep"] = {
            "versions_healed": n_versions,
            "part_bytes_rebuilt": part_bytes,
            "part_bytes_per_s": part_bytes / out["seconds"]["sweep"],
            "repair": {**rep, "bytes_read_per_byte_healed": (
                rep["bytes_read"] / rep["bytes_written"]
                if rep["bytes_written"] else None)},
            "pacer": pace1,
            "pacer_grants": pace1["grants_total"] - pace0["grants_total"],
            "pacer_deadline_grants": (pace1["deadline_grants_total"]
                                      - pace0["deadline_grants_total"]),
            "heals_by_thread": dict(sorted(window_heals.items())),
        }
        # Every file back equal, but the versioned key's journal: a heal
        # writes each version's is-latest flag as it reads it, and the
        # delete marker's erasure stamp from the version it copies, so
        # its bytes differ from the survivors' (minio_tpu's heal does the
        # same); its versions must be the same.
        out["sweep"]["files_differing"] = sorted(
            p for p in originals if healed_files.get(p) != originals[p])
        checks["files_restored"] = (
            set(healed_files) == set(originals)
            and out["sweep"]["files_differing"] in ([], [multi]))
        checks["journal_versions_restored"] = (
            _journal_versions(root / wiped / multi) == journal)
        checks["format_restored"] = hashlib.sha256(
            (root / wiped / ".mtpu.sys" / "format.json").read_bytes()
        ).hexdigest() == fmt
        checks["tracker_removed"] = not tracker.exists()
        ratio = out["sweep"]["repair"]["bytes_read_per_byte_healed"]
        # The repair plane serves every msr-pm object with part files
        # whose shard on the replaced drive has a plan (a data shard).
        out["sweep"]["repairable"] = sum(
            1 for name in bigs + msrs + smalls + [outage_dense, outage_msr]
            for fi in [drive[1].read_version(S3_BUCKET, name)]
            if fi.erasure.codec == "msr-pm" and fi.data_dir
            and fi.erasure.distribution[SELF_HEAL_WIPED - 1] - 1 < 12)
        checks["repair_plane_ok"] = (
            rep["parts_repaired"] == out["sweep"]["repairable"]
            >= msr_count + 1 and rep["fallbacks"] == 0 and ratio == 8.0)
        checks["pacer_one_grant_a_heal"] = (
            out["sweep"]["pacer_grants"] == n_versions
            and out["sweep"]["pacer_deadline_grants"] == 0)

        # 4. The scanner, its 60 s loop stopped so the cycles are ours.
        server.scanner.stop()
        checks["scanner_loop_stopped"] = not server.scanner._thread.is_alive()
        # A cycle heals 1 object in 512 it visits (the count runs across
        # cycles, the loop's own included), and a heal marks its bucket
        # changed: the second cycle rescans exactly those buckets.
        sampled: list = []
        heal_one = server.scanner._heal_one

        def sampled_heal(bucket, object_):
            sampled.append(f"{bucket}/{object_}")
            heal_one(bucket, object_)

        server.scanner._heal_one = sampled_heal
        usage = phase("scan_cycle", server.scanner.scan_cycle)
        out["scan_sampled_heals"] = list(sampled)
        status, _, body = c.request("GET", "/minio/admin/v3/datausage")
        walk = json.loads(body)["bucketsUsage"] if status == 200 else {}
        checks["scan_equals_walk"] = bool(walk) and walk == {
            bk: {"objectsCount": u.objects_count, "size": u.objects_size}
            for bk, u in usage.buckets_usage.items()}
        phase("scan_cycle_2", server.scanner.scan_cycle)
        healed_buckets = {key.split("/", 1)[0]
                          for key in out["scan_sampled_heals"]}
        checks["second_cycle_skips"] = (
            server.scanner.buckets_skipped_last_cycle
            == len(walk) - len(healed_buckets & set(walk)))
        status, _, body = c.request("GET", "/minio/admin/v3/usage",
                                    [("histogram", "true")])
        snap = json.loads(body) if status == 200 else {}
        checks["usage_over_http"] = (
            status == 200
            and snap["objectsTotalCount"] == usage.objects_total_count
            and snap["objectsTotalSize"] == usage.objects_total_size
            and all("sizeHistogram" in v
                    for v in snap["bucketsUsage"].values()))
        out["usage"] = snap
        out["system_objects"] = {
            oi.name: oi.size for oi in server.object_layer.list_objects(
                ".minio.sys", max_keys=1000).objects}
    finally:
        server.stop()
    out["checks"] = checks
    return out


def object_self_heal(root, size: int, device="cuda", drives: int = 16,
                     parity: int = 4, seed: int = 0) -> dict:
    """The self-healing services on the object layer, called directly (no
    HTTP, no service loops): `drives` fresh drive directories d0.. under
    `root` as one set of parity `parity` (ErasureServerPools), and

    1. a dense and an msr-pm object of `size` bytes PUT;
    2. drive d1 offline, pulled by a DiskMonitor after two failed probes;
       a dense and an msr-pm object PUT on the rest (queued in the MRF);
       d1 back: the monitor's reconnect drains the MRF through an
       MRFHealer;
    3. drive d2 emptied and re-opened; FreshDiskHealer.check_once()
       reformats and sweeps it.

    The msr-pm objects' shards on d2 are data shards, so the sweep
    repairs them through the repair plane. Returns each step's seconds
    and counter deltas, the checks (d1 holds a verified shard of the
    outage objects; every file of d2 back equal; the tracker gone; the
    repair plane used with no fallback), and `files`: the SHA-256 of
    every file under the drives' bucket, by path, to compare runs."""
    from .background import DiskMonitor, FreshDiskHealer, MRFHealer
    from .object.pools import ErasureServerPools

    dev = resolve_device(device)
    root = Path(root)
    bucket = OBJECT_BUCKET
    k = drives - parity
    disks = [LocalStorage(str(root / f"d{i}"), endpoint=f"d{i}", device=dev)
             for i in range(drives)]
    sets = ErasureSets(disks, drives, default_parity=parity, device=dev)
    sets.init_format()
    ol = ErasureServerPools([sets], device=dev)
    ol.make_bucket(bucket)
    es = sets.sets[0]
    rng = np.random.default_rng(seed)
    msr = repairable_names(bucket, "msr-", 2, 2, k, drives)
    names = {"dense-0": "dense-gf8", msr[0]: "msr-pm",
             "outage-dense": "dense-gf8", msr[1]: "msr-pm"}
    payloads = {n: rng.bytes(size) for n in names}
    out: dict = {"size": size, "k": k, "m": parity, "seconds": {},
                 "counters": {}}
    phase = _phases(dev, out)
    checks: dict = {}

    def put(name):
        ol.put_object(bucket, name, io.BytesIO(payloads[name]), size,
                      ObjectOptions(codec=names[name]))

    phase("put", lambda: [put(n) for n in ("dense-0", msr[0])])
    mrf = MRFHealer(ol)
    mon = DiskMonitor(ol, mrf_healer=mrf)
    disks[1].set_online(False)
    mon.check_once()
    checks["pulled"] = mon.check_once()["offline"] == ["d1"]
    phase("outage_put", lambda: [put(n) for n in ("outage-dense", msr[1])])
    checks["mrf_queued"] = es.mrf_stats()["pending"] == 2
    disks[1].set_online(True)
    res = phase("mrf_drain", mon.check_once)
    checks["reconnect_drained"] = (res["reconnected"] == ["d1"]
                                   and es.mrf_stats()["pending"] == 0
                                   and mrf.healed_total == 2)
    for n in ("outage-dense", msr[1]):
        disks[1].verify_file(bucket, n, disks[1].read_version(bucket, n))
    checks["outage_shards_verified"] = True

    originals = _drive_files(root, "d2", (bucket,))
    repair0 = repair.stats_snapshot()
    _replace_drive(disks[2], root / "d2")
    healer = FreshDiskHealer(ol)
    checks["swept"] = phase("sweep", healer.check_once) == ["d2"]
    rep = {key: v - repair0[key] for key, v in repair.stats_snapshot().items()}
    out["repair"] = rep
    checks["files_restored"] = _drive_files(root, "d2", (bucket,)) == \
        originals
    checks["tracker_removed"] = not (root / "d2" / ".mtpu.sys" /
                                     "healing.json").exists()
    checks["repair_plane_ok"] = (rep["parts_repaired"] == 2
                                 and rep["fallbacks"] == 0)
    checks["get_ok"] = all(ol.get_object_bytes(bucket, n) == payloads[n]
                           for n in names)
    out["files"] = {f"d{i}/{p}": h for i in range(drives)
                    for p, h in _drive_files(root, f"d{i}",
                                             (bucket,)).items()}
    ol.close()
    out["checks"] = checks
    return out


SSE_MODES = ("sse-s3", "sse-c", "sse-kms")
SSE_KMS_KEY = "smoke-kms-key"
SSE_C_KEY = bytes(range(32))
SSE_C_WRONG_KEY = bytes(range(1, 33))


def ssec_headers(key: bytes, copy_source: bool = False) -> dict:
    """The three SSE-C headers of `key` (the copy-source ones when
    `copy_source`)."""
    prefix = (ssemod.HDR_SSEC_COPY_PREFIX if copy_source
              else ssemod.HDR_SSEC_PREFIX)
    return {prefix + "algorithm": "AES256",
            prefix + "key": base64.b64encode(key).decode(),
            prefix + "key-md5": base64.b64encode(
                hashlib.md5(key).digest()).decode()}


def sse_put_headers(mode: str) -> dict:
    if mode == "sse-s3":
        return {ssemod.HDR_SSE: "AES256"}
    if mode == "sse-c":
        return ssec_headers(SSE_C_KEY)
    return {ssemod.HDR_SSE: "aws:kms", ssemod.HDR_SSE_KMS_ID: SSE_KMS_KEY,
            ssemod.HDR_SSE_KMS_CONTEXT: base64.b64encode(
                json.dumps({"bucket": S3_BUCKET}).encode()).decode()}


class _PayloadReader:
    """A file-like view of bytes, read in pieces (no copy of the whole)."""

    def __init__(self, data: bytes):
        self._view = memoryview(data)
        self._pos = 0

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            n = len(self._view) - self._pos
        out = self._view[self._pos:self._pos + n]
        self._pos += len(out)
        return bytes(out)


class _Compare:
    """A GET sink that holds the body to `want` piece by piece."""

    def __init__(self, want: bytes):
        self._want = memoryview(want)
        self._pos = 0
        self.equal = True

    def __call__(self, piece: bytes) -> None:
        end = self._pos + len(piece)
        if self._want[self._pos:end] != piece:
            self.equal = False
        self._pos = end

    @property
    def ok(self) -> bool:
        return self.equal and self._pos == len(self._want)


def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


@contextlib.contextmanager
def _rss_peak(out: dict, name: str, period_s: float = 0.005):
    """Record under out[name] the peak resident set growth (bytes) of
    the process while the block runs, sampled every `period_s`."""
    base = _rss_bytes()
    peak = [base]
    done = threading.Event()

    def sample():
        while not done.wait(period_s):
            peak[0] = max(peak[0], _rss_bytes())

    t = threading.Thread(target=sample, daemon=True)
    t.start()
    try:
        yield
    finally:
        done.set()
        t.join()
        out[name] = max(peak[0], _rss_bytes()) - base


def _object_files(root: Path, bucket: str, name: str) -> dict:
    """SHA-256 of the object's xl.meta and part files on the 16 drives."""
    return {str(p.relative_to(root)): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for i in range(1, 17)
        for p in sorted((root / f"d{i}" / bucket / name).rglob("*"))
        if p.is_file()}


@contextlib.contextmanager
def _insecure_ssec():
    """MTPU_ALLOW_INSECURE_SSEC=1 for the block: the port serves no TLS."""
    old = os.environ.get("MTPU_ALLOW_INSECURE_SSEC")
    os.environ["MTPU_ALLOW_INSECURE_SSEC"] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("MTPU_ALLOW_INSECURE_SSEC", None)
        else:
            os.environ["MTPU_ALLOW_INSECURE_SSEC"] = old


def sse_range(size: int) -> tuple[int, int]:
    """The ranged GET's window: from 7 bytes before the middle package
    boundary, across 48 packages and one erasure block boundary, within
    the object."""
    ps = ssemod.PACKAGE_SIZE
    first = max(0, (size // 2) // ps * ps - 7)
    return first, min(size - first, 48 * ps + 13)


def s3_sse(root, size: int, device="cuda", modes=SSE_MODES,
           seed: int = 50) -> dict:
    """Drive server-side encryption over HTTP on localhost: a Server over
    16 fresh drive directories under `root` (one 12+4 set), its S3 plane
    alone, MTPU_ALLOW_INSECURE_SSEC=1 while it runs (the port has no
    TLS). A KMS key is made through the admin route; then for each mode
    of `modes` (sse-s3, sse-c, sse-kms), on its own seeded `size`-byte
    object:

    1. PUT streamed from the client in 1 MiB pieces; the stored size in
       xl.meta must be ssemod.encrypted_size(size);
    2. GET, and a ranged GET across package and block boundaries, each
       body held to the payload piece by piece;
    3. HEAD with the mode's SSE answers and the logical size;
    4. the object lost on drives 0, 5, 12 and 15, a degraded GET;
    5. HealObject, after which every xl.meta and part file of the 16
       drives equals its original by SHA-256 (the heal never decrypts);
    6. a GET again.

    Then a CopyObject of the sse-c object to an SSE-S3 destination (a
    decrypt and a re-encrypt) with a GET of the copy, and a GET of the
    sse-c object with a wrong key (AccessDenied). Returns each step's
    seconds and counter deltas ("{mode}:{step}"), the peak growth of the
    process's resident set in each PUT and GET, and the checks."""
    dev = resolve_device(device)
    root = Path(root)
    out: dict = {"size": size, "k": 12, "m": 4, "modes": list(modes),
                 "wiped_drives": list(S3_WIPED), "seconds": {},
                 "counters": {}, "rss_peak_bytes": {},
                 "stored_size": ssemod.encrypted_size(size),
                 "packages": max(1, -(-size // ssemod.PACKAGE_SIZE))}
    phase = _phases(dev, out)
    checks: dict = {}
    payloads = {m: np.random.default_rng(seed + i).bytes(size)
                for i, m in enumerate(modes)}
    first, length = sse_range(size)
    out["range"] = [first, length]
    with _insecure_ssec():
        server = Server([str(root / "d{1...16}")], port=0,
                        root_user=S3_ACCESS, root_password=S3_SECRET,
                        default_parity=4, device=dev)
        # The S3 plane alone, as in s3_put_get_heal: the background
        # services would heal the lost drives on their own.
        server.s3.start()
        try:
            c = S3Client(server.endpoint, S3_ACCESS, S3_SECRET)
            checks["make_bucket_ok"] = c.request(
                "PUT", f"/{S3_BUCKET}")[0] == 200
            if "sse-kms" in modes:
                checks["kms_key_ok"] = c.request(
                    "POST", "/minio/admin/v3/kms/key/create",
                    [("key-id", SSE_KMS_KEY)])[0] == 200
            for mode in modes:
                _sse_object(c, server, root, mode, payloads[mode], phase,
                            out, checks, first, length)
            if "sse-c" in modes:
                _sse_copy_and_wrong_key(c, payloads["sse-c"], phase, out,
                                        checks)
        finally:
            server.stop()
    out["checks"] = checks
    return out


def _get_exact(c: S3Client, key: str, want: bytes, headers=None,
               query=None):
    """GET `key`, holding the body to `want` piece by piece: (status,
    headers, equal)."""
    cmp = _Compare(want)
    status, h, _ = c.get_stream(key, cmp, query, headers)
    return status, h, cmp.ok


def _sse_object(c, server, root: Path, mode: str, payload: bytes, phase,
                out: dict, checks: dict, first: int, length: int) -> None:
    """Steps 1-6 of s3_sse for one mode."""
    name = f"sse/{mode}.bin"
    key = f"/{S3_BUCKET}/{name}"
    get_headers = ssec_headers(SSE_C_KEY) if mode == "sse-c" else {}
    want_resp = {"sse-s3": {ssemod.HDR_SSE: "AES256"},
                 "sse-c": {ssemod.HDR_SSEC_ALGO: "AES256"},
                 "sse-kms": {ssemod.HDR_SSE: "aws:kms",
                             ssemod.HDR_SSE_KMS_ID: SSE_KMS_KEY}}[mode]

    def has_sse(h: dict) -> bool:
        lower = {k.lower(): v for k, v in h.items()}
        return all(lower.get(k) == v for k, v in want_resp.items())

    with _rss_peak(out["rss_peak_bytes"], f"{mode}:put"):
        status, h, _ = phase(f"{mode}:put", lambda: c.put_stream(
            key, _PayloadReader(payload), len(payload),
            sse_put_headers(mode)))
    checks[f"{mode}:put_ok"] = status == 200 and has_sse(h)
    fi = LocalStorage(str(root / "d1"), device=server.device).read_version(
        S3_BUCKET, name)
    checks[f"{mode}:stored_size_ok"] = (
        fi.size == ssemod.encrypted_size(len(payload))
        and fi.metadata.get(ssemod.META_ACTUAL_SIZE) == str(len(payload)))
    with _rss_peak(out["rss_peak_bytes"], f"{mode}:get"):
        status, h, ok = phase(f"{mode}:get", lambda: _get_exact(
            c, key, payload, get_headers))
    checks[f"{mode}:get_ok"] = status == 200 and ok and has_sse(h)
    rng = dict(get_headers, Range=f"bytes={first}-{first + length - 1}")
    status, h, ok = phase(f"{mode}:range_get", lambda: _get_exact(
        c, key, payload[first:first + length], rng))
    checks[f"{mode}:range_get_ok"] = status == 206 and ok and h.get(
        "Content-Range") == (f"bytes {first}-{first + length - 1}/"
                             f"{len(payload)}")
    status, h, _ = phase(f"{mode}:head", lambda: c.request(
        "HEAD", key, headers=get_headers))
    checks[f"{mode}:head_ok"] = (status == 200 and has_sse(h) and h.get(
        "Content-Length") == str(len(payload)))
    originals = _object_files(root, S3_BUCKET, name)
    for i in S3_WIPED:
        shutil.rmtree(root / f"d{i + 1}" / S3_BUCKET / name)
    status, _, ok = phase(f"{mode}:degraded_get", lambda: _get_exact(
        c, key, payload, get_headers))
    checks[f"{mode}:degraded_get_ok"] = status == 200 and ok
    healed = phase(f"{mode}:heal", lambda: server.object_layer.heal_object(
        S3_BUCKET, name))
    checks[f"{mode}:heal_ok"] = len(healed["healed"]) == len(S3_WIPED)
    checks[f"{mode}:healed_identical"] = bool(originals) and _object_files(
        root, S3_BUCKET, name) == originals
    status, _, ok = phase(f"{mode}:get_after_heal", lambda: _get_exact(
        c, key, payload, get_headers))
    checks[f"{mode}:get_after_heal_ok"] = status == 200 and ok


def _sse_copy_and_wrong_key(c, payload: bytes, phase, out: dict,
                            checks: dict) -> None:
    """The SSE-C object copied to an SSE-S3 destination, a GET of the
    copy, and a GET with the wrong SSE-C key."""
    src, dst = f"/{S3_BUCKET}/sse/sse-c.bin", f"/{S3_BUCKET}/sse/copy.bin"
    headers = {"x-amz-copy-source": src, ssemod.HDR_SSE: "AES256",
               **ssec_headers(SSE_C_KEY, copy_source=True)}
    status, h, _ = phase("copy_ssec_to_sses3", lambda: c.request(
        "PUT", dst, headers=headers))
    checks["copy_ok"] = status == 200 and h.get(ssemod.HDR_SSE) == "AES256"
    status, h, ok = phase("get_copy", lambda: _get_exact(c, dst, payload))
    checks["get_copy_ok"] = status == 200 and ok and h.get(
        ssemod.HDR_SSE) == "AES256"
    status, _, body = phase("wrong_key_get", lambda: c.request(
        "GET", src, headers=ssec_headers(SSE_C_WRONG_KEY)))
    checks["wrong_key_denied"] = status == 403 and b"AccessDenied" in body


# ---------------------------------------------------------------------------
# Admission and drive health (phase 4l of chip_smoke.py)

ADMISSION_BUCKET = "adm"
ADMISSION_HUNG_BUCKET = "adm-hung"
ADMISSION_TENANT_BUCKETS = ("adm-hot", "adm-quiet")
ADMISSION_STALLED = 5              # the drive index (d6) that hangs
ADMISSION_HOT_PUTS = 6
ADMISSION_QUIET, ADMISSION_QUIET_SECRET = "smoke-quiet", "smoke-quiet-secret"
ADMISSION_REJECTED_SIZE = (64 << 10) + 12_345
ADMISSION_DEADLINES = {"op_deadline_s": 1.0, "long_op_deadline_s": 2.0,
                       "breaker_threshold": 3, "probe_interval_s": 0.5}
# The same as the `drive` subsystem's environment: a Server applies the
# subsystem to the live settings when it is built.
ADMISSION_DRIVE_ENV = {"MTPU_DRIVE_OP_DEADLINE": "1s",
                       "MTPU_DRIVE_LONG_OP_DEADLINE": "2s",
                       "MTPU_DRIVE_BREAKER_THRESHOLD": "3",
                       "MTPU_DRIVE_PROBE_INTERVAL": "500ms"}


class StallingDrive:
    """A raw drive whose ops in `ops` hang while `hold()` is in force: an
    op that arrives then waits until `release()` and then fails with
    `error`, as a drive whose controller reset drops what it had in
    flight, so a stalled op has no late side effect. Every other
    attribute passes through."""

    def __init__(self, disk, ops, error=ErrDiskNotFound):
        self._disk = disk
        self._ops = frozenset(ops)
        self._error = error
        self._cv = threading.Condition()
        self._held = False      # guarded-by: _cv
        self._epoch = 0         # guarded-by: _cv
        self.stalled = 0        # guarded-by: _cv

    def hold(self) -> None:
        with self._cv:
            self._held = True

    def release(self) -> None:
        with self._cv:
            self._held = False
            self._epoch += 1
            self._cv.notify_all()

    def __getattr__(self, name: str):
        attr = getattr(self._disk, name)
        if name not in self._ops:
            return attr

        def call(*args, **kwargs):
            with self._cv:
                if self._held:
                    self.stalled += 1
                    epoch = self._epoch
                    while self._epoch == epoch:
                        self._cv.wait()
                    raise self._error(f"{self._disk.endpoint()}: {name} "
                                      "stalled, dropped at release")
            return attr(*args, **kwargs)

        call.__name__ = name
        return call


class _AdmissionServer(Server):
    """The phase's server: the drive at index ADMISSION_STALLED is a
    StallingDrive under the health wrapper, put there before the server's
    first op (the wrapper caches each method at its first call), and the
    phase's second client is an IAM user with the readwrite policy."""

    def __init__(self, *args, **kwargs):
        self.stall = None
        super().__init__(*args, **kwargs)
        self.iam.add_user(ADMISSION_QUIET, ADMISSION_QUIET_SECRET)
        self.iam.attach_policy(ADMISSION_QUIET, ["readwrite"])

    def _wrap_disk(self, raw, ep: str):
        if Path(ep).name == f"d{ADMISSION_STALLED + 1}":
            raw = self.stall = StallingDrive(raw, TIMED_OPS)
        return super()._wrap_disk(raw, ep)


class _GatedReader(_PayloadReader):
    """A request body that stops at byte `at` until `gate` is set, so the
    PUT holds its admission slot until the phase lets it go on."""

    def __init__(self, data: bytes, gate: threading.Event | None, at: int):
        super().__init__(data)
        self._gate, self._at = gate, at

    def read(self, n: int = -1) -> bytes:
        if self._gate is not None and self._pos >= self._at:
            if not self._gate.wait(120):
                raise TimeoutError("gate never opened")
            self._gate = None
        if self._gate is not None and n is not None and n >= 0:
            n = min(n, self._at - self._pos)
        return super().read(n)


def _grant_probe(g) -> list:
    """Record (client, monotonic time) of every grant `g` makes, in
    order, by wrapping the governor's grant step."""
    grants: list = []
    grant_to = g._grant_to

    def probe(client):
        grants.append((client, time.monotonic()))
        grant_to(client)

    g._grant_to = probe
    return grants


def _conserved(snap: dict) -> bool:
    """The governor's conservation identity: every arrival ends admitted
    or rejected, less the late grants handed back."""
    return snap["arrivals_total"] == (
        snap["admitted_total"] + snap["rejected_queue_full"]
        + snap["rejected_deadline"] - snap["late_grant_returns"])


def _gated_puts(client, bucket: str, names, payloads: dict, gate, at: int,
                results: dict) -> list:
    """Start one PUT thread a name, its body stopping at `at` until
    `gate` is set (no gate: straight through)."""
    def put(name):
        results[name] = client.put_stream(
            f"/{bucket}/{name}", _GatedReader(payloads[name], gate, at),
            len(payloads[name]))

    threads = [threading.Thread(target=put, args=(n,), daemon=True)
               for n in names]
    for t in threads:
        t.start()
    return threads


def _join(threads, timeout_s: float = 300.0) -> None:
    for t in threads:
        t.join(timeout_s)
    if any(t.is_alive() for t in threads):
        raise TimeoutError("a client thread did not finish")


def admission_drive_health(root, size: int, hung_size: int, device="cuda",
                           seed: int = 60) -> dict:
    """Drive admission and drive health on a Server over 16 fresh drive
    directories under `root` (one 12+4 set, its S3 plane alone), with
    per-op deadlines of 1 s (2 s for long ops), a breaker threshold of 3
    and a probe every 0.5 s, the governors pinned, the heal pacer at its
    defaults:

    a. fairness: encode governor of 2 slots, client cap 2, queue 16; the
       hot key's 6 PUTs of `size` bytes (the two admitted hold their
       slots until the quiet PUT has queued), then the quiet key's one;
       the grants in order, every object read back, the conservation
       identity;
    b. overload: queue 2, the PUTs past it refused with 503 SlowDown and
       nothing stored; a GET refused with 503 SlowDown before its status
       line while the read governor is saturated;
       MTPU_ADMISSION_TENANT=bucket giving two buckets of one key their
       own turns;
    c. a hung drive (index ADMISSION_STALLED): `hung_size`-byte objects
       written healthy, then with the drive stalled a degraded GET and a
       PUT before and after the breaker latches, the latched drive
       failing fast with ErrDiskFaulty, the stall lifted and the probe
       letting it back in;
    d. pacing: the admin heal of c under a foreground backlog of 2
       (yields, every heal granted by the pacer's max wait), whose
       rebuilt part files equal by SHA-256 those written while the drive
       was healthy; a heal with no backlog granted at once.

    Returns each step's seconds and counter deltas, the grant orders,
    the governors' and the drives' health snapshots, the pacer's
    counters and the checks."""
    dev = resolve_device(device)
    root = Path(root)
    out: dict = {"size": size, "hung_size": hung_size, "k": 12, "m": 4,
                 "stalled_drive": ADMISSION_STALLED, "seconds": {},
                 "counters": {}, "robust": dict(ADMISSION_DEADLINES)}
    phase = _phases(dev, out)
    checks: dict = {}
    rng = np.random.default_rng(seed)
    with env_vars(**ADMISSION_DRIVE_ENV), \
            robust_overrides(**ADMISSION_DEADLINES):
        healpace.reconfigure(healpace.PaceConfig())
        admission.reconfigure_read(admission.AdmissionConfig(
            slots=4, per_client_cap=4, max_queue=16, deadline_s=60.0))
        server = _AdmissionServer(
            [str(root / "d{1...16}")], port=0, root_user=S3_ACCESS,
            root_password=S3_SECRET, default_parity=4, device=dev)
        # The S3 plane alone: the monitor would pull the hung drive and
        # the MRF drain would heal behind the phase's back.
        server.s3.start()
        try:
            hot = S3Client(server.endpoint, S3_ACCESS, S3_SECRET)
            quiet = S3Client(server.endpoint, ADMISSION_QUIET,
                             ADMISSION_QUIET_SECRET)
            checks["buckets_ok"] = all(
                hot.request("PUT", f"/{b}")[0] == 200
                for b in (ADMISSION_BUCKET, ADMISSION_HUNG_BUCKET,
                          *ADMISSION_TENANT_BUCKETS))
            _admission_fairness(hot, quiet, size, rng, phase, out, checks)
            _admission_overload(root, hot, quiet, size, rng, phase, out,
                                checks)
            _admission_hung_drive(server, root, hot, hung_size, size, rng,
                                  phase, out, checks)
            out["disk_health"] = {
                Path(d.health.endpoint).name: d.health_info()
                for d in server.object_layer.pools[0].disks}
            checks["healthy_drives_never_timed_out"] = all(
                h["timeouts"] == 0 and h["latched"] == 0
                for name, h in out["disk_health"].items()
                if name != f"d{ADMISSION_STALLED + 1}")
        finally:
            if server.stall is not None:
                server.stall.release()
            server.stop()
            admission.reconfigure()
            admission.reconfigure_read()
            healpace.reset()
    out["checks"] = checks
    return out


def _admission_fairness(hot, quiet, size, rng, phase, out, checks) -> None:
    """Step a."""
    b = ADMISSION_BUCKET
    g = admission.reconfigure(admission.AdmissionConfig(
        slots=2, per_client_cap=2, max_queue=16, deadline_s=60.0))
    grants = _grant_probe(g)
    read_grants = _grant_probe(admission.read_governor())
    hot_names = [f"fair/hot-{i}" for i in range(ADMISSION_HOT_PUTS)]
    quiet_name = "fair/quiet"
    payloads = {n: rng.bytes(size) for n in hot_names + [quiet_name]}
    results: dict = {}
    gate = threading.Event()
    at = min(4 << 20, size // 2)
    arrived = {}

    def run():
        threads = _gated_puts(hot, b, hot_names, payloads, gate, at, results)
        _wait_for(lambda: g.snapshot()["waiting"] == ADMISSION_HOT_PUTS - 2,
                  60, "hot PUTs queued")
        threads += _gated_puts(quiet, b, [quiet_name], payloads, None, at,
                               results)
        arrived["t"] = _wait_for(
            lambda: g.snapshot()["waiting"] == ADMISSION_HOT_PUTS - 1, 60,
            "quiet PUT queued")
        gate.set()
        _join(threads)

    phase("fair_puts", run)
    checks["fair_puts_ok"] = all(results[n][0] == 200 for n in payloads)
    order = [c for c, _ in grants]
    want = [S3_ACCESS] * 3 + [ADMISSION_QUIET] + [S3_ACCESS] * 3
    checks["fair_grant_order"] = order == want
    quiet_at = order.index(ADMISSION_QUIET) if ADMISSION_QUIET in order \
        else -1
    gets = phase("fair_gets", lambda: [
        _get_exact(hot, f"/{b}/{n}", payloads[n]) for n in payloads])
    checks["fair_gets_exact"] = all(s == 200 and ok for s, _, ok in gets)
    checks["fair_gets_charged_to_caller"] = (
        [c for c, _ in read_grants] == [S3_ACCESS] * len(payloads))
    # A stream's slot is released just after its last byte is sent.
    _wait_for(lambda: admission.read_governor().snapshot()["inflight"] == 0,
              30, "GETs released")
    snap = g.snapshot()
    checks["fair_conserved"] = _conserved(snap) and \
        snap["arrivals_total"] == len(payloads)
    out["fairness"] = {
        "governor": {"slots": 2, "per_client_cap": 2, "max_queue": 16},
        "grant_order": ["hot" if c == S3_ACCESS else "quiet"
                        for c in order],
        "quiet_wait_s": (grants[quiet_at][1] - arrived["t"]
                         if quiet_at >= 0 else None),
        "snapshot": snap,
        "read_snapshot": admission.read_governor().snapshot()}


def _admission_overload(root, hot, quiet, size, rng, phase, out,
                        checks) -> None:
    """Step b."""
    b = ADMISSION_BUCKET
    res: dict = {}
    # Queue full: 2 in flight, 2 queued, the next PUTs refused at once.
    g = admission.reconfigure(admission.AdmissionConfig(
        slots=2, per_client_cap=2, max_queue=2, deadline_s=60.0))
    held = [f"over/held-{i}" for i in range(4)]
    rejected = [f"over/rejected-{i}" for i in range(2)]
    payloads = {n: rng.bytes(size) for n in held}
    payloads.update({n: rng.bytes(ADMISSION_REJECTED_SIZE)
                     for n in rejected})
    results: dict = {}
    gate = threading.Event()
    at = min(4 << 20, size // 2)
    refusals: list = []

    def queue_full():
        threads = _gated_puts(hot, b, held, payloads, gate, at, results)
        try:
            _wait_for(lambda: g.snapshot()["waiting"] == 2, 60,
                      "two PUTs queued")
            for n in rejected:
                t0 = time.perf_counter()
                status, _, body = quiet.request("PUT", f"/{b}/{n}",
                                                body=payloads[n])
                refusals.append((status, b"SlowDown" in body,
                                 time.perf_counter() - t0))
        finally:
            gate.set()
            _join(threads)

    phase("queue_full_puts", queue_full)
    checks["held_puts_ok"] = all(results[n][0] == 200 for n in held)
    checks["queue_full_503"] = all(s == 503 and slow
                                   for s, slow, _ in refusals)
    checks["queue_full_stored_nothing"] = all(
        hot.request("HEAD", f"/{b}/{n}")[0] == 404
        and not any((root / f"d{i}" / b / n).exists()
                    for i in range(1, 17))
        for n in rejected)
    snap = g.snapshot()
    checks["queue_full_conserved"] = _conserved(snap) and \
        snap["rejected_queue_full"] == len(rejected)
    res["queue_full"] = {"refusal_seconds": [s for *_, s in refusals],
                         "snapshot": snap}

    # The read governor saturated: a GET is refused before its status
    # line, then served once the queue drains.
    steady = admission.read_governor().cfg
    rg = admission.reconfigure_read(admission.AdmissionConfig(
        slots=1, per_client_cap=1, max_queue=1, deadline_s=60.0))
    key = f"/{b}/{held[0]}"

    def saturated_get():
        rg.acquire("occupant")
        waiter = threading.Thread(
            target=lambda: (rg.acquire("waiter"), rg.release("waiter")),
            daemon=True)
        try:
            waiter.start()
            _wait_for(rg.saturated, 30, "read governor saturated")
            refused = hot.request("GET", key)
        finally:
            rg.release("occupant")
            _join([waiter])
        return refused, _get_exact(hot, key, payloads[held[0]])

    (status, h, body), (status2, _, ok) = phase("saturated_get",
                                                saturated_get)
    checks["saturated_get_503"] = (
        status == 503 and b"SlowDown" in body
        and h.get("Content-Length") == str(len(body)))
    checks["get_after_drain_exact"] = status2 == 200 and ok
    # The stream's slot is released just after its last byte is sent.
    _wait_for(lambda: rg.snapshot()["inflight"] == 0, 30, "GET released")
    snap = rg.snapshot()
    checks["read_conserved"] = _conserved(snap)
    res["saturated_get"] = {"status": status, "snapshot": snap}
    admission.reconfigure_read(steady)

    # One key, two buckets: with MTPU_ADMISSION_TENANT=bucket each bucket
    # is a tenant of its own, so the quiet bucket's PUT takes the second
    # turn instead of the last.
    hot_b, quiet_b = ADMISSION_TENANT_BUCKETS
    g = admission.reconfigure(admission.AdmissionConfig(
        slots=1, per_client_cap=1, max_queue=8, deadline_s=60.0))
    grants = _grant_probe(g)
    names = [f"tenant/obj-{i}" for i in range(3)]
    tpayloads = {n: rng.bytes(size) for n in names}
    qname = "tenant/quiet"
    tpayloads[qname] = rng.bytes(size)
    tresults: dict = {}
    gate = threading.Event()
    old = os.environ.get("MTPU_ADMISSION_TENANT")
    os.environ["MTPU_ADMISSION_TENANT"] = "bucket"

    def tenant_puts():
        threads = _gated_puts(hot, hot_b, names, tpayloads, gate, at,
                              tresults)
        try:
            _wait_for(lambda: g.snapshot()["waiting"] == 2, 60,
                      "hot bucket's PUTs queued")
            threads += _gated_puts(hot, quiet_b, [qname], tpayloads, None,
                                   at, tresults)
            _wait_for(lambda: g.snapshot()["waiting"] == 3, 60,
                      "quiet bucket's PUT queued")
        finally:
            gate.set()
            _join(threads)

    try:
        phase("tenant_puts", tenant_puts)
    finally:
        if old is None:
            os.environ.pop("MTPU_ADMISSION_TENANT", None)
        else:
            os.environ["MTPU_ADMISSION_TENANT"] = old
    hk, qk = f"{S3_ACCESS}\x1f{hot_b}", f"{S3_ACCESS}\x1f{quiet_b}"
    order = [c for c, _ in grants]
    checks["tenant_puts_ok"] = all(r[0] == 200 for r in tresults.values())
    checks["tenant_grant_order"] = order == [hk, hk, qk, hk]
    res["tenant"] = {"grant_order": [c.split("\x1f")[1] for c in order],
                     "snapshot": g.snapshot()}
    out["overload"] = res


def _drive_part_sha(root: Path, bucket: str, name: str, drive: int,
                    data_dir: str) -> str | None:
    path = root / f"d{drive + 1}" / bucket / name / data_dir / "part.1"
    return hashlib.sha256(path.read_bytes()).hexdigest() \
        if path.is_file() else None


def _admission_hung_drive(server, root, hot, hung_size, size, rng, phase,
                          out, checks) -> None:
    """Steps c and d."""
    b = ADMISSION_HUNG_BUCKET
    stall = server.stall
    drive = server.object_layer.pools[0].disks[ADMISSION_STALLED]
    health = drive.health
    raw = unwrap(drive)
    names = repairable_names(b, "hung/obj-", 2, ADMISSION_STALLED, 12, 16)
    payloads = {n: rng.bytes(hung_size) for n in names}
    keys = {n: f"/{b}/{n}" for n in names}
    res: dict = {"names": names, "health": {}}

    def put(n) -> bool:
        status, _, _ = hot.put_stream(keys[n], _PayloadReader(payloads[n]),
                                      len(payloads[n]))
        return status == 200

    def current_dd(n) -> str:
        return raw.read_version(b, n).data_dir

    def latch(poke) -> int:
        """HEADs until the breaker latches (each pays a deadline);
        returns how many it took."""
        pokes = 0
        while not health.is_faulty():
            if pokes >= 5:
                raise AssertionError(f"breaker never latched: "
                                     f"{health.state()}")
            poke()
            pokes += 1
        return pokes

    # c0: both objects written while every drive answers.
    checks["healthy_puts_ok"] = phase("healthy_put", lambda: all(
        put(n) for n in names))
    healthy_sha = {n: _drive_part_sha(root, b, n, ADMISSION_STALLED,
                                      current_dd(n)) for n in names}
    checks["healthy_parts_present"] = all(healthy_sha.values())
    res["health"]["before"] = health.state()

    # c1: a GET before and after the latch.
    stall.hold()
    try:
        status, _, ok = phase("get_before_latch", lambda: _get_exact(
            hot, keys[names[0]], payloads[names[0]]))
        checks["get_before_latch_exact"] = status == 200 and ok
        res["health"]["after_get_before_latch"] = health.state()
        res["latch_pokes_get"] = latch(
            lambda: hot.request("HEAD", keys[names[0]]))
        res["health"]["latched_get"] = health.state()
        t0 = time.perf_counter()
        try:
            drive.stat_vol(b)
            fast = False
        except ErrDiskFaulty:
            fast = True
        res["fail_fast_s"] = time.perf_counter() - t0
        checks["fails_fast_when_latched"] = fast and res["fail_fast_s"] < 0.1
        timeouts = health.timeouts_total
        status, _, ok = phase("get_after_latch", lambda: _get_exact(
            hot, keys[names[0]], payloads[names[0]]))
        checks["get_after_latch_exact"] = status == 200 and ok
        checks["get_after_latch_paid_no_deadline"] = \
            health.timeouts_total == timeouts
    finally:
        stall.release()
    t0 = time.monotonic()
    _wait_for(lambda: not health.is_faulty() and health.inflight == 0, 30,
              "drive readmitted")
    res["readmit_s"] = [time.monotonic() - t0]

    # c2: a PUT before and after the latch (the drive misses both).
    stall.hold()
    try:
        checks["put_before_latch_ok"] = phase(
            "put_before_latch", lambda: put(names[1]))
        res["health"]["after_put_before_latch"] = health.state()
        res["latch_pokes_put"] = latch(
            lambda: hot.request("HEAD", keys[names[1]]))
        timeouts = health.timeouts_total
        checks["put_after_latch_ok"] = phase(
            "put_after_latch", lambda: put(names[0]))
        checks["put_after_latch_paid_no_deadline"] = \
            health.timeouts_total == timeouts
        res["health"]["latched_put"] = health.state()
    finally:
        stall.release()
    t0 = time.monotonic()
    _wait_for(lambda: not health.is_faulty() and health.inflight == 0, 30,
              "drive readmitted")
    res["readmit_s"].append(time.monotonic() - t0)
    res["health"]["readmitted"] = health.state()
    checks["latched_twice_readmitted_twice"] = (
        health.latched_total == 2 and health.readmitted_total == 2)
    disks = server.object_layer.pools[0].disks
    checks["stalled_drive_missed_puts"] = all(
        current_dd(n) != _quorum_dd(disks, b, n) for n in names)

    # d: the pacer's foreground window was fed by the drive wrapper.
    p = healpace.installed()
    res["pacer_after_c"] = p.snapshot()
    checks["pacer_fed_by_wrapper"] = p.snapshot()["disk_p99_ms"] > 0
    # The admin heal of c with a foreground backlog of 2 (one PUT holding
    # the only encode slot, two queued): the window starts afresh, so
    # the backlog is the pacer's only input.
    p = healpace.reconfigure(healpace.PaceConfig())
    g = admission.reconfigure(admission.AdmissionConfig(
        slots=1, per_client_cap=1, max_queue=8, deadline_s=60.0))
    held = [f"pace/held-{i}" for i in range(3)]
    hpayloads = {n: rng.bytes(size) for n in held}
    hresults: dict = {}
    gate = threading.Event()
    at = min(4 << 20, size // 2)
    backlog = {}

    def heal_under_backlog():
        threads = _gated_puts(hot, ADMISSION_BUCKET, held, hpayloads, gate,
                              at, hresults)
        try:
            _wait_for(lambda: g.backlog() == 2, 60, "foreground backlog")
            backlog["at_start"] = g.backlog()
            state = _heal_bucket(hot, b)
            backlog["at_end"] = g.backlog()
        finally:
            gate.set()
            _join(threads)
        return state

    state = phase("heal_under_backlog", heal_under_backlog)
    snap = p.snapshot()
    res["heal_state"] = state.get("Summary")
    res["pacer_under_backlog"] = snap
    res["backlog"] = backlog
    cfg = p.cfg
    checks["backlog_held"] = backlog.get("at_end", 0) >= cfg.queue_high
    checks["heal_yielded"] = snap["yields_total"] > 0
    checks["heals_granted_by_max_wait"] = (
        snap["grants_total"] >= len(names)
        and snap["throttle_seconds_total"] <= snap["grants_total"] * (
            cfg.max_wait_s + 2 * cfg.yield_s + 0.25))
    checks["backlog_puts_ok"] = all(r[0] == 200 for r in hresults.values())
    healed_sha = {n: _drive_part_sha(root, b, n, ADMISSION_STALLED,
                                     current_dd(n)) for n in names}
    res["healed_part_sha256"] = healed_sha
    checks["healed_parts_equal_healthy"] = healed_sha == healthy_sha
    checks["healed_data_dir_is_quorum"] = all(
        current_dd(n) == _quorum_dd(disks, b, n) for n in names)
    # With no backlog (and a fresh window), a heal is granted at once.
    p = healpace.reconfigure(healpace.PaceConfig())
    phase("heal_no_backlog", lambda: server.object_layer.heal_object(
        b, names[0]))
    snap = p.snapshot()
    res["pacer_no_backlog"] = snap
    checks["heal_no_backlog_at_once"] = (
        snap["grants_total"] == 1 and snap["yields_total"] == 0
        and snap["deadline_grants_total"] == 0)
    res["governor"] = g.snapshot()
    checks["pace_conserved"] = _conserved(res["governor"])
    res["stalled_ops"] = stall.stalled
    out["hung_drive"] = res


def _quorum_dd(disks, bucket: str, name: str) -> str:
    """The data dir that most drives' xl.meta name for the object's
    newest version, read from the raw drives."""
    seen: dict = {}
    for d in disks:
        try:
            dd = unwrap(d).read_version(bucket, name).data_dir
        except StorageError:
            continue
        seen[dd] = seen.get(dd, 0) + 1
    return max(seen, key=seen.get) if seen else ""


OBS_BUCKET = "obs"
OBS_OBJECT, OBS_SSE_OBJECT = "plain/obj.bin", "sse/obj.bin"
OBS_FIFTH = 1  # the drive index (d2) taken away too in step 6
OBS_PROBES = ("live", "ready", "cluster")


@contextlib.contextmanager
def env_vars(**values):
    """Environment variables set (a value) or unset (None) for the
    block, restored after."""
    old = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _object_sizes(root: Path, bucket: str, name: str) -> dict:
    """{drive index: {"part": part-file bytes, "meta": xl.meta bytes}} of
    the object on the 16 drives."""
    out = {}
    for i in range(16):
        d = root / f"d{i + 1}" / bucket / name
        meta = d / "xl.meta"
        out[i] = {"part": sum(p.stat().st_size for p in d.glob("*/part.*")),
                  "meta": meta.stat().st_size if meta.is_file() else 0}
    return out


def _ledger_delta(before: dict, after: dict) -> dict:
    """The ledger's bytes moved between two snapshots: by op class and
    direction, and by drive index (the endpoint's d{i} + 1) for each."""
    totals: dict = {}
    by_drive: dict = {}
    for (drive, op, dir_), n in after["bytes"].items():
        n -= before["bytes"].get((drive, op, dir_), 0)
        if not n:
            continue
        totals.setdefault(op, {})
        totals[op][dir_] = totals[op].get(dir_, 0) + n
        i = int(Path(drive).name[1:]) - 1
        by_drive.setdefault(f"{op}/{dir_}", {})[i] = n
    logical = {op: n - before["logical"].get(op, 0)
               for op, n in after["logical"].items()
               if n - before["logical"].get(op, 0)}
    return {"bytes": totals, "by_drive": by_drive, "logical": logical}


def _tree_summary(tree: dict) -> dict:
    """A captured span tree in brief: seconds by span kind, its span
    count, whether it reached the tree cap, whether every span's parent
    is in it, and the engines' counter deltas over the request."""
    from .observability import spans

    ids = {s["id"] for s in tree["spans"]}
    by_kind: dict = {}
    for s in tree["spans"]:
        by_kind[s["kind"]] = by_kind.get(s["kind"], 0) + s["duration_us"]
    return {"api": tree["api"], "duration_ms": tree["duration_ms"],
            "spans": len(tree["spans"]),
            "cut_short": len(tree["spans"]) >= spans.MAX_TREE_SPANS,
            "connected": all(s["parent"] == 0 or s["parent"] in ids
                             for s in tree["spans"]),
            "seconds_by_kind": {k: v / 1e6 for k, v in by_kind.items()},
            "stats": tree["stats"]}


def scrape_families(text: str) -> set:
    """The catalog names of the series of a Prometheus exposition (a
    histogram's _bucket, _sum and _count under its own name)."""
    from .observability.metrics_v2 import DESCRIPTORS

    hists = {n for n, t, _ in DESCRIPTORS if t == "histogram"}
    out = set()
    for line in text.splitlines():
        if not line.startswith("mtpu_"):
            continue
        name = re.split(r"[{ ]", line, maxsplit=1)[0][len("mtpu_"):]
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[: -len(suffix)] in hists:
                name = name[: -len(suffix)]
        out.add(name)
    return out


def observability(root, size: int, device="cuda", seed: int = 70,
                  trees_timeout_s: float = 60.0) -> dict:
    """Drive the observability plane of a Server over 16 fresh drive
    directories under `root` (one 12+4 set, its S3 plane alone), with
    spans armed and every request captured (MTPU_TRACE unset,
    MTPU_TRACE_SLOW_MS=0):

    1. /minio/health/{live,ready,cluster} with every drive up;
    2. PUT of a seeded `size`-byte object, GET exact;
    3. the object lost on drives 0, 5, 12 and 15 and those drives taken
       away: a degraded GET exact, ready still answering;
    4. the drives back, the admin heal of the bucket, every healed file
       equal by SHA-256 to the original;
    5. PUT and GET of an SSE-S3 object of the same size;
    6. drives 0, 5, 12 and 15 taken away again, then a fifth (OBS_FIFTH):
       live answers 200, ready and cluster 503; the fifth back and all
       back, 200 again;
    7. the node and cluster scrapes (every series in the catalog), and
       the admin ioflow and slow-requests answers.

    Returns each step's seconds and counter deltas, the byte-flow
    ledger's delta of each step, each step's request trees in brief
    (_tree_summary), the health codes, the scraped series and the
    checks; the ledger's bytes are held to the bytes on the drives: the
    PUT's part files and xl.meta, the twelve survivors' part files the
    degraded GET and the heal read, and the four part files and
    xl.meta the heal wrote."""
    from .observability import ioflow, spans
    from .observability.metrics_v2 import DESCRIPTORS

    dev = resolve_device(device)
    root = Path(root)
    out: dict = {"size": size, "k": 12, "m": 4, "lost": list(S3_WIPED),
                 "fifth": OBS_FIFTH, "seconds": {}, "counters": {},
                 "ledger": {}, "trees": {}, "health": {}}
    phase = _phases(dev, out)
    checks: dict = {}
    rng = np.random.default_rng(seed)
    payload, sse_payload = rng.bytes(size), rng.bytes(size)
    b = f"/{OBS_BUCKET}"
    name, sse_name = OBS_OBJECT, OBS_SSE_OBJECT
    with env_vars(MTPU_TRACE=None, MTPU_TRACE_SLOW_MS="0"), _insecure_ssec():
        server = Server([str(root / "d{1...16}")], port=0,
                        root_user=S3_ACCESS, root_password=S3_SECRET,
                        default_parity=4, device=dev)
        server.s3.start()
        raw = [unwrap(d) for d in server.object_layer.pools[0].disks]
        try:
            c = S3Client(server.endpoint, S3_ACCESS, S3_SECRET)

            def probes() -> dict:
                return {k: c.request("GET", f"/minio/health/{k}",
                                     anonymous=True)[0]
                        for k in OBS_PROBES}

            def online(drives, up: bool) -> None:
                for i in drives:
                    raw[i].set_online(up)

            def step(label: str, fn, apis=()):
                """fn as a phase, with its ledger delta and the trees of
                the `apis` it sends (a streamed GET's tree lands after
                the client has its last byte)."""
                spans.clear_slow_requests()
                before = ioflow.snapshot()
                res = phase(label, fn)
                out["ledger"][label] = _ledger_delta(before,
                                                     ioflow.snapshot())
                deadline = time.monotonic() + trees_timeout_s
                while (len(spans.slow_requests()) < len(apis)
                       and time.monotonic() < deadline):
                    time.sleep(0.01)
                trees = spans.slow_requests()
                out["trees"][label] = [_tree_summary(t) for t in trees]
                checks[f"{label}:trees"] = (
                    [t["api"] for t in trees] == list(apis)
                    and all(t["connected"] and not t["cut_short"]
                            for t in out["trees"][label]))
                return res

            out["health"]["all_up"] = probes()
            checks["make_bucket_ok"] = step(
                "make_bucket", lambda: c.request("PUT", b)[0],
                ("make_bucket",)) == 200
            status = step("put", lambda: c.put_stream(
                f"{b}/{name}", _PayloadReader(payload), size)[0],
                ("put_object",))
            checks["put_ok"] = status == 200
            sizes = _object_sizes(root, OBS_BUCKET, name)
            status, _, ok = step("get", lambda: _get_exact(
                c, f"{b}/{name}", payload), ("get_object",))
            checks["get_ok"] = status == 200 and ok

            originals = _object_files(root, OBS_BUCKET, name)
            for i in S3_WIPED:
                shutil.rmtree(root / f"d{i + 1}" / OBS_BUCKET / name)
            online(S3_WIPED, False)
            status, _, ok = step("degraded_get", lambda: _get_exact(
                c, f"{b}/{name}", payload), ("get_object",))
            checks["degraded_get_ok"] = status == 200 and ok
            out["health"]["four_away"] = probes()
            online(S3_WIPED, True)
            state = step("heal", lambda: _heal_bucket(c, OBS_BUCKET))
            out["heal"] = {k: state[k] for k in ("Summary", "NumScanned",
                                                 "NumHealed", "NumFailed")}
            checks["heal_ok"] = (state["Summary"] == "finished"
                                 and state["NumFailed"] == 0)
            checks["healed_identical"] = (
                _object_files(root, OBS_BUCKET, name) == originals)

            status, h, _ = step("sse_put", lambda: c.put_stream(
                f"{b}/{sse_name}", _PayloadReader(sse_payload), size,
                sse_put_headers("sse-s3")), ("put_object",))
            checks["sse_put_ok"] = (status == 200 and h.get(
                ssemod.HDR_SSE, h.get(ssemod.HDR_SSE.title())) == "AES256")
            status, _, ok = step("sse_get", lambda: _get_exact(
                c, f"{b}/{sse_name}", sse_payload), ("get_object",))
            checks["sse_get_ok"] = status == 200 and ok

            online(S3_WIPED, False)
            out["health"]["four_away_again"] = probes()
            online((OBS_FIFTH,), False)
            out["health"]["fifth_away"] = probes()
            online((OBS_FIFTH,), True)
            out["health"]["fifth_back"] = probes()
            online(S3_WIPED, True)
            out["health"]["all_back"] = probes()

            scrapes = {}
            for path in ("/minio/v2/metrics/node",
                         "/minio/v2/metrics/cluster"):
                status, _, body = c.request("GET", path)
                checks[f"scrape_ok:{path}"] = status == 200
                scrapes[path] = scrape_families(body.decode())
            status, _, body = c.request("GET", "/minio/admin/v3/ioflow")
            checks["admin_ioflow_ok"] = status == 200
            out["admin_ioflow"] = json.loads(body)
            status, _, body = c.request("GET",
                                        "/minio/admin/v3/slow-requests")
            checks["admin_slow_requests_ok"] = status == 200
            out["admin_slow_requests"] = {
                "threshold_ms": json.loads(body)["threshold_ms"],
                "captured": len(json.loads(body)["captured"])}
        finally:
            server.stop()

    up = dict.fromkeys(OBS_PROBES, 200)
    for state in ("all_up", "four_away", "four_away_again", "fifth_back",
                  "all_back"):
        checks[f"health:{state}"] = out["health"][state] == up
    checks["health:fifth_away"] = out["health"]["fifth_away"] == {
        "live": 200, "ready": 503, "cluster": 503}

    catalog = {n for n, _, _ in DESCRIPTORS} | {"uptime_seconds"}
    families = set().union(*scrapes.values())
    out["scrape"] = {"families": sorted(families),
                     "outside_catalog": sorted(families - catalog)}
    checks["scrape_in_catalog"] = families <= catalog

    # The ledger held to the drives: the PUT wrote every part file and
    # xl.meta once; the degraded GET read the twelve survivors' part
    # files; the heal read them too and wrote the four lost ones' part
    # files and xl.meta.
    survivors = [i for i in range(16) if i not in S3_WIPED]
    part = {i: sizes[i]["part"] for i in sizes}
    meta = {i: sizes[i]["meta"] for i in sizes}
    led = out["ledger"]
    want = {"put": {"put/write": part, "put/wmeta": meta},
            "degraded_get": {"get-degraded/read": {
                i: part[i] for i in survivors}},
            "heal": {"heal/read": {i: part[i] for i in survivors},
                     "heal/write": {i: part[i] for i in S3_WIPED},
                     "heal/wmeta": {i: meta[i] for i in S3_WIPED}}}
    for label, series in want.items():
        for key, by_drive in series.items():
            checks[f"ledger:{label}:{key}"] = (
                led[label]["by_drive"].get(key) == by_drive)
    checks["ledger:put_logical"] = led["put"]["logical"] == {"put": size}
    checks["ledger:degraded_get_logical"] = (
        led["degraded_get"]["logical"] == {"get-degraded": size})
    out["drive_bytes"] = {"part": part, "meta": meta}
    out["checks"] = checks
    return out


# ---------------------------------------------------------------------------
# The config subsystem and compression (phase 4n of chip_smoke.py)

CFG_BUCKET = "cfg"
CFG_TEXT, CFG_SSE, CFG_RANDOM, CFG_RRS = ("text/obj.log", "sse/obj.log",
                                          "random/obj.log", "rrs/obj.bin")
CFG_RANGE = 3 << 20
CFG_SETTINGS = (b"compression enable=on extensions=.log",
                b"storage_class rrs=EC:2")
CFG_THROTTLE = b"api requests_max=1 requests_deadline=1s"


def seeded_text(size: int, seed: int) -> bytes:
    """`size` bytes of seeded text: 1 MiB pieces at seeded offsets of a
    4 MiB text of seeded words (lowercase, 2 to 9 letters, lines of 12),
    so that a 64 KiB chunk compresses as prose does and none repeats
    another whole."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", dtype=np.uint8)
    words = [bytes(rng.choice(letters, int(n)))
             for n in rng.integers(2, 10, 2000)]
    idx = rng.integers(0, len(words), 800_000)
    lines = [b" ".join(words[i] for i in idx[j:j + 12])
             for j in range(0, len(idx), 12)]
    base = np.frombuffer(b"\n".join(lines), dtype=np.uint8)
    piece = 1 << 20
    starts = rng.integers(0, len(base) - piece, -(-size // piece))
    return np.concatenate([base[s:s + piece] for s in starts])[
        :size].tobytes()


def _sha_get(c: S3Client, key: str, headers=None):
    """GET `key` into a SHA-256: (status, hex digest, bytes, the
    response's headers with lower-case names)."""
    h = hashlib.sha256()
    status, got, n = c.get_stream(key, h.update, None, headers)
    return status, h.hexdigest(), n, {k.lower(): v for k, v in got.items()}


def _scraped(client: S3Client, series: str) -> float | None:
    """The value of the mtpu_`series` line of a cluster scrape."""
    text = client.request("GET", "/minio/v2/metrics/cluster")[2].decode()
    m = re.search(rf"^mtpu_{series}(?:\{{[^}}]*\}})? (\S+)$", text, re.M)
    return float(m.group(1)) if m else None


def _shape_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def config_compression(root, size: int, device="cuda", seed: int = 80,
                       range_size: int = CFG_RANGE) -> dict:
    """Drive the config subsystem and compression on a Server over 16
    fresh drive directories under `root` (one 12+4 set, its S3 plane
    alone), over HTTP:

    1. `settings`: set-config-kv `compression enable=on extensions=.log`
       and `storage_class rrs=EC:2` (each save sealed, the history one
       entry longer each);
    2. `put`: a `size`-byte .log object of seeded text (seeded_text),
       stored compressed: its stored size and ratio;
    3. `get`, `range_get`: it whole, and `range_size` bytes from its
       middle, each equal by SHA-256;
    4. `degraded_get`: the object lost on drives 0, 5, 12 and 15 and
       those drives offline, a GET equal by SHA-256;
    5. `heal`: the drives back, the admin heal of the bucket; every
       healed file equal by SHA-256 to the original;
    6. `sse_put`, `sse_get`: the same text as an SSE-S3 .log object
       (compressed, then sealed) and its GET;
    7. `random_put`: `size` // 16 seeded random bytes as a .log object,
       stored unmarked after the probe;
    8. `rrs_put`: a REDUCED_REDUNDANCY object, 14+2 in its xl.meta, and
       its GET;
    9. `throttle`: set-config-kv `api requests_max=1 requests_deadline=1s`
       (the answer asks for a restart), the server stopped and built again
       on the same drives (`restart`: the config loads), the compressed
       object read back (`get_after_restart`), and a GET while the one
       request slot is held answered 503 SlowDown (`slowdown`).

    Returns each step's seconds and counter deltas (kernel E's and F's
    launches among them), kernel A's launches by shape in each step, the
    stored sizes and the checks."""
    from .api import transforms as tfm
    from .ops import rs_cuda

    dev = resolve_device(device)
    root = Path(root)
    out: dict = {"size": size, "k": 12, "m": 4, "lost": list(S3_WIPED),
                 "seconds": {}, "counters": {}, "gf_by_shape": {},
                 "range_size": range_size}
    phase = _phases(dev, out)
    checks: dict = {}
    text = seeded_text(size, seed)
    noise = np.random.default_rng(seed + 1).bytes(size // 16)
    rrs_body = text[:size // 16]
    want = {name: hashlib.sha256(data).hexdigest()
            for name, data in ((CFG_TEXT, text), (CFG_RANDOM, noise),
                               (CFG_RRS, rrs_body))}
    b = f"/{CFG_BUCKET}"

    def step(label, fn):
        shapes = rs_cuda.LAUNCHES_BY_SHAPE.snapshot()
        res = phase(label, fn)
        out["gf_by_shape"][label] = _shape_delta(
            shapes, rs_cuda.LAUNCHES_BY_SHAPE.snapshot())
        return res

    def start():
        srv = Server([str(root / "d{1...16}")], port=0, root_user=S3_ACCESS,
                     root_password=S3_SECRET, default_parity=4, device=dev)
        srv.s3.start()
        return srv

    def meta(name: str):
        return LocalStorage(str(root / "d1"), device="cpu").read_version(
            CFG_BUCKET, name)

    server = start()
    try:
        c = S3Client(server.endpoint, S3_ACCESS, S3_SECRET)

        def history() -> int:
            return len(json.loads(c.request(
                "GET", "/minio/admin/v3/list-config-history-kv",
                [("count", "100")])[2]))

        def settings():
            answers = [c.request("PUT", "/minio/admin/v3/set-config-kv",
                                 body=body) for body in CFG_SETTINGS]
            return [(st, json.loads(raw)) for st, _, raw in answers]

        checks["make_bucket_ok"] = c.request("PUT", b)[0] == 200
        before = history()
        answers = step("settings", settings)
        checks["settings_ok"] = answers == [(200, {"restart": False})] * 2
        checks["history_grew"] = history() == before + len(CFG_SETTINGS)

        status, _, _ = step("put", lambda: c.put_stream(
            f"{b}/{CFG_TEXT}", _PayloadReader(text), size))
        fi = meta(CFG_TEXT)
        out["stored_size"] = fi.size
        out["ratio"] = size / fi.size
        checks["put_ok"] = status == 200
        checks["stored_compressed"] = (
            fi.metadata.get(tfm.META_COMPRESSION) == "s2"
            and fi.metadata.get(tfm.META_UNCOMPRESSED_SIZE) == str(size)
            and fi.size == int(fi.metadata[tfm.META_COMPRESSED_SIZE])
            and fi.size < size)
        status, digest, n, _ = step("get", lambda: _sha_get(
            c, f"{b}/{CFG_TEXT}"))
        checks["get_sha256_ok"] = (status == 200 and n == size
                                   and digest == want[CFG_TEXT])
        first = size // 2 - range_size // 2
        last = first + range_size - 1
        out["range"] = [first, range_size]
        status, digest, n, _ = step("range_get", lambda: _sha_get(
            c, f"{b}/{CFG_TEXT}", {"Range": f"bytes={first}-{last}"}))
        checks["range_get_sha256_ok"] = (
            status == 206 and n == range_size
            and digest == hashlib.sha256(text[first:last + 1]).hexdigest())

        originals = _object_files(root, CFG_BUCKET, CFG_TEXT)
        raw = [unwrap(d) for d in server.object_layer.pools[0].disks]
        for i in S3_WIPED:
            shutil.rmtree(root / f"d{i + 1}" / CFG_BUCKET / CFG_TEXT)
            raw[i].set_online(False)
        status, digest, _, _ = step("degraded_get", lambda: _sha_get(
            c, f"{b}/{CFG_TEXT}"))
        checks["degraded_get_sha256_ok"] = (status == 200
                                           and digest == want[CFG_TEXT])
        for i in S3_WIPED:
            raw[i].set_online(True)
        state = step("heal", lambda: _heal_bucket(c, CFG_BUCKET))
        out["heal"] = {k: state[k] for k in ("Summary", "NumScanned",
                                             "NumHealed", "NumFailed")}
        checks["heal_ok"] = (state["Summary"] == "finished"
                             and state["NumFailed"] == 0)
        checks["healed_identical"] = bool(originals) and _object_files(
            root, CFG_BUCKET, CFG_TEXT) == originals

        status, h, _ = step("sse_put", lambda: c.put_stream(
            f"{b}/{CFG_SSE}", _PayloadReader(text), size,
            sse_put_headers("sse-s3")))
        fi = meta(CFG_SSE)
        out["sse_stored_size"] = fi.size
        checks["sse_put_ok"] = status == 200 and h.get(
            ssemod.HDR_SSE, h.get(ssemod.HDR_SSE.title())) == "AES256"
        checks["sse_stored_compressed"] = (
            fi.metadata.get(tfm.META_COMPRESSION) == "s2"
            and fi.metadata.get(ssemod.META_ACTUAL_SIZE)
            == fi.metadata.get(tfm.META_COMPRESSED_SIZE)
            and fi.size == ssemod.encrypted_size(
                int(fi.metadata[tfm.META_COMPRESSED_SIZE])))
        status, digest, _, _ = step("sse_get", lambda: _sha_get(
            c, f"{b}/{CFG_SSE}"))
        checks["sse_get_sha256_ok"] = (status == 200
                                       and digest == want[CFG_TEXT])

        status, _, _ = step("random_put", lambda: c.put_stream(
            f"{b}/{CFG_RANDOM}", _PayloadReader(noise), len(noise)))
        fi = meta(CFG_RANDOM)
        checks["random_unmarked"] = (status == 200 and fi.size == len(noise)
                                     and tfm.META_COMPRESSION
                                     not in fi.metadata)
        checks["random_get_sha256_ok"] = _sha_get(
            c, f"{b}/{CFG_RANDOM}")[1] == want[CFG_RANDOM]

        status, _, _ = step("rrs_put", lambda: c.put_stream(
            f"{b}/{CFG_RRS}", _PayloadReader(rrs_body), len(rrs_body),
            {"x-amz-storage-class": "REDUCED_REDUNDANCY"}))
        fi = meta(CFG_RRS)
        out["rrs_geometry"] = [fi.erasure.data_blocks,
                               fi.erasure.parity_blocks]
        checks["rrs_put_ok"] = status == 200
        checks["rrs_14_2"] = out["rrs_geometry"] == [14, 2]
        checks["rrs_get_sha256_ok"] = _sha_get(
            c, f"{b}/{CFG_RRS}")[1] == want[CFG_RRS]

        st, _, raw_answer = c.request("PUT", "/minio/admin/v3/set-config-kv",
                                      body=CFG_THROTTLE)
        checks["throttle_set_ok"] = (st == 200 and json.loads(raw_answer)
                                     == {"restart": True})
    finally:
        server.stop()

    server = step("restart", start)
    try:
        c = S3Client(server.endpoint, S3_ACCESS, S3_SECRET)
        cfg = server.config_sys.config
        checks["config_survived"] = (
            cfg.get("compression")["enable"] == "on"
            and cfg.get("storage_class")["rrs"] == "EC:2"
            and server.s3._requests_sem is not None
            and server.s3._requests_deadline_s == 1.0)
        status, digest, _, _ = step("get_after_restart", lambda: _sha_get(
            c, f"{b}/{CFG_TEXT}"))
        checks["get_after_restart_sha256_ok"] = (
            status == 200 and digest == want[CFG_TEXT])
        sem = server.s3._requests_sem
        if not sem.acquire(timeout=30):
            raise AssertionError("the request slot was never free")
        try:
            t0 = time.perf_counter()
            status, _, body = step("slowdown", lambda: c.request(
                "GET", f"{b}/{CFG_RRS}"))
            out["slowdown_wait_s"] = time.perf_counter() - t0
        finally:
            sem.release()
        checks["slowdown_503"] = (status == 503
                                  and b"<Code>SlowDown</Code>" in body)
        checks["slot_free_again"] = _sha_get(
            c, f"{b}/{CFG_RRS}")[1] == want[CFG_RRS]
    finally:
        server.stop()
    out["checks"] = checks
    return out


LQL_WORM, LQL_GOV, LQL_QUOTA = "worm", "govhold", "quota"
LQL_LOGS, LQL_VERSIONS = "ilm-logs", "ilm-versions"
LQL_KEY = "locked.bin"
LQL_MP_KEY = "multipart.bin"
LQL_LOGS_KEY, LQL_KEEP_KEY, LQL_OPEN_KEY = ("logs/big.log", "keep/obj.bin",
                                            "logs/open.bin")
LQL_DOC, LQL_ORPHAN = "doc.bin", "orphan.bin"
LQL_LOCK_XML = (b"<ObjectLockConfiguration><ObjectLockEnabled>Enabled"
                b"</ObjectLockEnabled><Rule><DefaultRetention><Mode>COMPLIANCE"
                b"</Mode><Days>1</Days></DefaultRetention></Rule>"
                b"</ObjectLockConfiguration>")
LQL_LOCK_ONLY_XML = (b"<ObjectLockConfiguration><ObjectLockEnabled>Enabled"
                     b"</ObjectLockEnabled></ObjectLockConfiguration>")
LQL_LOGS_LC = (b"<LifecycleConfiguration><Rule><ID>logs</ID><Status>Enabled"
               b"</Status><Filter><Prefix>logs/</Prefix></Filter><Expiration>"
               b"<Days>1</Days></Expiration></Rule><Rule><ID>uploads</ID>"
               b"<Status>Enabled</Status><Filter><Prefix></Prefix></Filter>"
               b"<AbortIncompleteMultipartUpload><DaysAfterInitiation>1"
               b"</DaysAfterInitiation></AbortIncompleteMultipartUpload>"
               b"</Rule></LifecycleConfiguration>")
LQL_VERSIONS_LC = (b"<LifecycleConfiguration><Rule><ID>noncurrent</ID>"
                   b"<Status>Enabled</Status><Filter><Prefix></Prefix>"
                   b"</Filter><NoncurrentVersionExpiration><NoncurrentDays>1"
                   b"</NoncurrentDays><NewerNoncurrentVersions>1"
                   b"</NewerNoncurrentVersions></NoncurrentVersionExpiration>"
                   b"<Expiration><ExpiredObjectDeleteMarker>true"
                   b"</ExpiredObjectDeleteMarker></Expiration></Rule>"
                   b"</LifecycleConfiguration>")
LQL_AHEAD_NS = 2 * 86400 * 10 ** 9  # the lifecycle sweep's "now" ahead


def lock_quota_lifecycle_keys() -> list[tuple[str, bool]]:
    """(bucket/key, read degraded) of s3_lock_quota_lifecycle's objects
    whose shards on drives 0, 5, 12 and 15 are lost and rebuilt: the
    WORM key, both versions read (v1 degraded) and healed."""
    return [(f"{LQL_WORM}/{LQL_KEY}", True)]


def _drive_stat(root: Path) -> dict:
    """(size, mtime ns) of every file of the 16 drives: a write shows."""
    return {str(p.relative_to(root)): (p.stat().st_size, p.stat().st_mtime_ns)
            for i in range(1, 17) for p in (root / f"d{i}").rglob("*")
            if p.is_file()}


def _files_under(root: Path, bucket: str, name: str) -> int:
    return sum(1 for i in range(1, 17)
               for p in (root / f"d{i}" / bucket / name).rglob("*")
               if p.is_file())


def _iso_in(seconds: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ",
                         time.gmtime(time.time() + seconds))


def _retention_xml(mode: str, until: str) -> bytes:
    return (f"<Retention><Mode>{mode}</Mode><RetainUntilDate>{until}"
            "</RetainUntilDate></Retention>").encode()


def s3_lock_quota_lifecycle(root, size: int, device="cuda",
                            small_size: int = 16 << 20,
                            refused_size: int = 64 << 20,
                            quota: int = 300 << 20, seed: int = 90) -> dict:
    """Drive object lock, the hard bucket quota and lifecycle expiry on a
    Server over 16 fresh drive directories under `root` (one 12+4 set,
    its S3 plane alone), over HTTP, with seeded objects:

    1. WORM bucket (versioning, COMPLIANCE default retention of a day):
       `worm_put_v1`, `worm_put_v2` two `size`-byte versions of one key;
       `worm_delete_v1` its DELETE by version id answers 403 AccessDenied
       and no file of the key changes on any drive; `worm_delete_objects`
       a DeleteObjects naming v1 returns the key's Error;
       `worm_delete_marker` a DELETE without a version writes a marker;
       `worm_tighten` v1's retention lengthened (200) and `worm_shorten`
       shortened (403); `worm_degraded_get` with the key lost on drives 0,
       5, 12 and 15 and those drives offline, v1's GET is its exact bytes;
       `worm_heal` the drives back, each version healed (the admin heal
       walks latest versions only, and the latest is the marker), every
       part file of the key equal to its copy before the loss and every
       drive's version journal (ids, mod times, markers, data dirs,
       sizes) equal to the one before (a healed marker's entry is
       rewritten as minio_tpu rewrites it);
       `worm_multipart` two `small_size` parts, the object under the
       default retention;
    2. GOVERNANCE and legal hold (`gov_put`, `hold_put`): a version with
       lock-mode and retain-until headers, deleted 403 then 204 with the
       bypass header (`gov_delete`); one with a legal hold, deleted 403,
       the hold set OFF, deleted 204 and gone from every drive
       (`hold_delete`);
    3. quota bucket: `quota_set` a `quota`-byte hard quota through the
       admin route, read back; `quota_put` a `size`-byte PUT;
       `quota_refused_put`, `quota_refused_part` a `refused_size` PUT and
       UploadPart answered 409 QuotaExceeded from their headers, no
       drive file changed; `quota_scan` one scanner cycle, after which
       the quota reads the scanner's usage; `quota_clear` the quota
       cleared with an empty body, and `quota_put_after_clear` the
       refused PUT's size accepted;
    4. lifecycle: an unversioned bucket expiring logs/ after a day and
       aborting uploads after a day, holding a `size`-byte logs/ object,
       a keep/ object and an open upload; a versioned bucket expiring
       noncurrent versions after a day beyond the newest one, and orphan
       delete markers, holding three `small_size` versions of one key and
       an orphan marker (`ilm_setup`). `ilm_sweep` runs the scanner's
       lifecycle steps with `now` two days ahead (the expiry of each
       listed object, the versions sweep, the stale-upload abort), then
       `ilm_scan` one real scan cycle: the logs/ object gone from every
       drive, keep/ unchanged, the newest noncurrent version kept and the
       oldest gone, the marker gone, the upload's journal gone, and
       ilm_expired_total in a scrape equal to the deletions.

    Returns each step's seconds and counter deltas, kernel A's launches
    by shape in each step, the version ids, the usage the quota read, the
    size of every object the server wrote under .minio.sys (bucket
    metadata, the usage snapshot; kernels A and B encode them) and the
    checks."""
    from .ops import rs_cuda

    dev = resolve_device(device)
    root = Path(root)
    out: dict = {"size": size, "small_size": small_size,
                 "refused_size": refused_size, "quota": quota, "k": 12,
                 "m": 4, "lost": list(S3_WIPED), "seconds": {},
                 "counters": {}, "gf_by_shape": {}}
    phase = _phases(dev, out)
    checks: dict = {}
    rng = np.random.default_rng(seed)
    big = [rng.bytes(size) for _ in range(2)]
    # Two parts, the GOVERNANCE and the held object, keep/, three versions.
    small = [rng.bytes(small_size) for _ in range(8)]
    want_big = [hashlib.sha256(b).hexdigest() for b in big]

    def step(label, fn):
        shapes = rs_cuda.LAUNCHES_BY_SHAPE.snapshot()
        res = phase(label, fn)
        out["gf_by_shape"][label] = _shape_delta(
            shapes, rs_cuda.LAUNCHES_BY_SHAPE.snapshot())
        return res

    server = Server([str(root / "d{1...16}")], port=0, root_user=S3_ACCESS,
                    root_password=S3_SECRET, default_parity=4, device=dev)
    system_sizes: set = set()
    put_object = server.object_layer.put_object

    def noting_put(bucket, name, reader, size, opts=None):
        if bucket == ".minio.sys":
            system_sizes.add(size)
        return put_object(bucket, name, reader, size, opts)

    server.object_layer.put_object = noting_put
    server.s3.start()
    try:
        c = S3Client(server.endpoint, S3_ACCESS, S3_SECRET)

        def put(path: str, data: bytes, headers=None):
            return c.put_stream(path, _PayloadReader(data), len(data),
                                headers)

        # 1. The WORM bucket.
        w = f"/{LQL_WORM}"
        checks["worm_setup_ok"] = [
            c.request("PUT", w)[0],
            c.request("PUT", w, [("versioning", "")], body=ENABLED_XML)[0],
            c.request("PUT", w, [("object-lock", "")],
                      body=LQL_LOCK_XML)[0]] == [200, 200, 200]
        vids = []
        for n, label in enumerate(("worm_put_v1", "worm_put_v2")):
            status, h, _ = step(label, lambda n=n: put(f"{w}/{LQL_KEY}",
                                                       big[n]))
            vids.append(h.get("x-amz-version-id", ""))
            checks[f"{label}_ok"] = status == 200 and bool(vids[-1])
        out["version_ids"] = vids
        v1 = vids[0]
        files_before = _object_files(root, LQL_WORM, LQL_KEY)
        status, _, body = step("worm_delete_v1", lambda: c.request(
            "DELETE", f"{w}/{LQL_KEY}", [("versionId", v1)]))
        checks["worm_delete_v1_403"] = (
            status == 403 and b"<Code>AccessDenied</Code>" in body)
        checks["worm_v1_files_unchanged"] = (
            files_before == _object_files(root, LQL_WORM, LQL_KEY))
        doc = (f"<Delete><Object><Key>{LQL_KEY}</Key><VersionId>{v1}"
               "</VersionId></Object></Delete>").encode()
        status, _, body = step("worm_delete_objects", lambda: c.request(
            "POST", w, [("delete", "")], body=doc))
        checks["worm_delete_objects_error"] = (
            status == 200 and b"<Error><Key>" + LQL_KEY.encode() in body
            and b"<Code>AccessDenied</Code>" in body
            and b"<Deleted>" not in body)
        status, h, _ = step("worm_delete_marker", lambda: c.request(
            "DELETE", f"{w}/{LQL_KEY}"))
        checks["worm_delete_marker_ok"] = (
            status == 204 and h.get("x-amz-delete-marker") == "true")
        marker = h.get("x-amz-version-id", "")
        ret = f"{w}/{LQL_KEY}"
        status, _, _ = step("worm_tighten", lambda: c.request(
            "PUT", ret, [("retention", ""), ("versionId", v1)],
            body=_retention_xml("COMPLIANCE", _iso_in(2 * 86400))))
        checks["worm_tighten_200"] = status == 200
        status, _, body = step("worm_shorten", lambda: c.request(
            "PUT", ret, [("retention", ""), ("versionId", v1)],
            body=_retention_xml("COMPLIANCE", _iso_in(3600))))
        checks["worm_shorten_403"] = (
            status == 403 and b"<Code>AccessDenied</Code>" in body)
        key_dirs = [root / f"d{i + 1}" / LQL_WORM / LQL_KEY for i in range(16)]
        originals = _object_files(root, LQL_WORM, LQL_KEY)
        journals = [_journal_versions(p / "xl.meta") for p in key_dirs]
        raw = [unwrap(d) for d in server.object_layer.pools[0].disks]
        for i in S3_WIPED:
            shutil.rmtree(root / f"d{i + 1}" / LQL_WORM / LQL_KEY)
            raw[i].set_online(False)

        def degraded_get():
            h = hashlib.sha256()
            status, _, n = c.get_stream(f"{w}/{LQL_KEY}", h.update,
                                        [("versionId", v1)])
            return status, h.hexdigest(), n

        status, digest, n = step("worm_degraded_get", degraded_get)
        checks["worm_degraded_get_exact"] = (
            status == 200 and n == size and digest == want_big[0])
        for i in S3_WIPED:
            raw[i].set_online(True)
        ol = server.object_layer
        healed = step("worm_heal", lambda: [
            len(ol.heal_object(LQL_WORM, LQL_KEY, version_id=v)["healed"])
            for v in (v1, vids[1], marker)])
        out["worm_healed"] = healed
        after = _object_files(root, LQL_WORM, LQL_KEY)
        checks["worm_healed_identical"] = (
            sum("/part." in k for k in originals) == 2 * 16
            and {k: v for k, v in after.items() if "/part." in k}
            == {k: v for k, v in originals.items() if "/part." in k}
            and [_journal_versions(p / "xl.meta") for p in key_dirs]
            == journals)

        def multipart():
            mp = f"{w}/{LQL_MP_KEY}"
            _, _, body = c.request("POST", mp, [("uploads", "")])
            upload = re.search(rb"<UploadId>(.*?)</UploadId>",
                               body).group(1).decode()
            etags = []
            for n in range(2):
                _, h, _ = c.request("PUT", mp, [("partNumber", str(n + 1)),
                                                 ("uploadId", upload)],
                                     body=small[n])
                etags.append(h["ETag"])
            done = ("<CompleteMultipartUpload>" + "".join(
                f"<Part><PartNumber>{n + 1}</PartNumber><ETag>{e}</ETag>"
                "</Part>" for n, e in enumerate(etags))
                + "</CompleteMultipartUpload>").encode()
            return c.request("POST", mp, [("uploadId", upload)], body=done)

        status, _, _ = step("worm_multipart", multipart)
        _, h, _ = c.request("HEAD", f"{w}/{LQL_MP_KEY}")
        checks["worm_multipart_retained"] = (
            status == 200 and h.get("x-amz-object-lock-mode") == "COMPLIANCE"
            and bool(h.get("x-amz-object-lock-retain-until-date")))

        # 2. GOVERNANCE and legal hold.
        g = f"/{LQL_GOV}"
        checks["gov_setup_ok"] = [
            c.request("PUT", g)[0],
            c.request("PUT", g, [("versioning", "")], body=ENABLED_XML)[0],
            c.request("PUT", g, [("object-lock", "")],
                      body=LQL_LOCK_ONLY_XML)[0]] == [200, 200, 200]
        status, h, _ = step("gov_put", lambda: put(f"{g}/gov.bin", small[2], {
            "x-amz-object-lock-mode": "GOVERNANCE",
            "x-amz-object-lock-retain-until-date": _iso_in(86400)}))
        gov_vid = h.get("x-amz-version-id", "")
        checks["gov_put_ok"] = status == 200
        gov = step("gov_delete", lambda: [c.request(
            "DELETE", f"{g}/gov.bin", [("versionId", gov_vid)],
            headers=hdr)[0] for hdr in (
            None, {"x-amz-bypass-governance-retention": "true"})])
        checks["gov_delete_403_then_204"] = gov == [403, 204]
        status, h, _ = step("hold_put", lambda: put(
            f"{g}/held.bin", small[3], {"x-amz-object-lock-legal-hold": "ON"}))
        hold_vid = h.get("x-amz-version-id", "")
        checks["hold_put_ok"] = status == 200
        checks["hold_files_written"] = _files_under(root, LQL_GOV,
                                                    "held.bin") > 0

        def hold_delete():
            path, q = f"{g}/held.bin", [("versionId", hold_vid)]
            first = c.request("DELETE", path, q)[0]
            off = c.request("PUT", path, [("legal-hold", "")] + q,
                            body=b"<LegalHold><Status>OFF</Status>"
                                 b"</LegalHold>")[0]
            return [first, off, c.request("DELETE", path, q)[0]]

        checks["hold_delete_403_off_204"] = step(
            "hold_delete", hold_delete) == [403, 200, 204]
        checks["hold_files_gone"] = _files_under(root, LQL_GOV,
                                                 "held.bin") == 0

        # 3. The quota bucket.
        qb = f"/{LQL_QUOTA}"
        checks["quota_bucket_ok"] = c.request("PUT", qb)[0] == 200
        admin = "/minio/admin/v3"

        def set_quota():
            st = c.request("PUT", f"{admin}/set-bucket-quota",
                           [("bucket", LQL_QUOTA)], body=json.dumps(
                               {"quota": quota, "quotatype": "hard"}
                           ).encode())[0]
            _, _, body = c.request("GET", f"{admin}/get-bucket-quota",
                                   [("bucket", LQL_QUOTA)])
            return st, json.loads(body)

        st, got = step("quota_set", set_quota)
        checks["quota_set_read_back"] = st == 200 and got == {
            "quota": quota, "quotatype": "hard"}
        status, _, _ = step("quota_put", lambda: put(f"{qb}/big.bin",
                                                     big[1]))
        checks["quota_put_ok"] = status == 200
        time.sleep(1.1)  # past the quota's 1 s usage cache
        drives = _drive_stat(root)
        status, _, body = step("quota_refused_put", lambda: c.put_refused(
            f"{qb}/over.bin", refused_size))
        checks["quota_refused_put_409"] = (
            status == 409 and b"<Code>QuotaExceeded</Code>" in body)
        _, _, body = c.request("POST", f"{qb}/part.bin", [("uploads", "")])
        upload = re.search(rb"<UploadId>(.*?)</UploadId>",
                           body).group(1).decode()
        drives_part = _drive_stat(root)
        status, _, body = step("quota_refused_part", lambda: c.put_refused(
            f"{qb}/part.bin", refused_size,
            [("partNumber", "1"), ("uploadId", upload)]))
        checks["quota_refused_part_409"] = (
            status == 409 and b"<Code>QuotaExceeded</Code>" in body)
        checks["quota_refused_no_drive_change"] = (
            drives_part == _drive_stat(root)
            and {k: v for k, v in drives_part.items() if k in drives}
            == drives)
        c.request("DELETE", f"{qb}/part.bin", [("uploadId", upload)])
        usage = step("quota_scan", lambda: server.scanner.scan_cycle())
        stored = usage.buckets_usage[LQL_QUOTA].objects_size
        server.quota.invalidate(LQL_QUOTA)
        out["quota_usage"] = {"scanner": stored,
                              "feed": server._scanner_usage()[LQL_QUOTA],
                              "quota_read": server.quota._bucket_size(
                                  LQL_QUOTA)}
        checks["quota_reads_scanner_usage"] = (
            stored == size and out["quota_usage"]["feed"] == size
            and out["quota_usage"]["quota_read"] == size)
        status, _, _ = step("quota_clear", lambda: c.request(
            "PUT", f"{admin}/set-bucket-quota", [("bucket", LQL_QUOTA)],
            body=b""))
        checks["quota_cleared"] = status == 200 and json.loads(c.request(
            "GET", f"{admin}/get-bucket-quota",
            [("bucket", LQL_QUOTA)])[2]) == {}
        over = np.random.default_rng(seed + 1).bytes(refused_size)
        status, _, _ = step("quota_put_after_clear", lambda: put(
            f"{qb}/over.bin", over))
        checks["quota_put_after_clear_ok"] = status == 200

        # 4. Lifecycle.
        lb, vb = f"/{LQL_LOGS}", f"/{LQL_VERSIONS}"

        def ilm_setup():
            codes = [c.request("PUT", lb)[0],
                     c.request("PUT", lb, [("lifecycle", "")],
                               body=LQL_LOGS_LC)[0],
                     put(f"{lb}/{LQL_LOGS_KEY}", big[0])[0],
                     put(f"{lb}/{LQL_KEEP_KEY}", small[4])[0],
                     c.request("POST", f"{lb}/{LQL_OPEN_KEY}",
                               [("uploads", "")])[0],
                     c.request("PUT", vb)[0],
                     c.request("PUT", vb, [("versioning", "")],
                               body=ENABLED_XML)[0],
                     c.request("PUT", vb, [("lifecycle", "")],
                               body=LQL_VERSIONS_LC)[0]]
            doc_vids = []
            for n in range(3):
                st, h, _ = put(f"{vb}/{LQL_DOC}", small[5 + n])
                codes.append(st)
                doc_vids.append(h.get("x-amz-version-id", ""))
            st, h, _ = c.request("DELETE", f"{vb}/{LQL_ORPHAN}")
            codes.append(st)
            return codes, doc_vids

        codes, doc_vids = step("ilm_setup", ilm_setup)
        out["doc_version_ids"] = doc_vids
        checks["ilm_setup_ok"] = codes == [200] * 11 + [204]
        keep_before = _object_files(root, LQL_LOGS, LQL_KEEP_KEY)
        checks["ilm_logs_written"] = _files_under(root, LQL_LOGS,
                                                  LQL_LOGS_KEY) > 0
        scanner = server.scanner
        es = server.object_layer.pools[0].sets[0]
        checks["ilm_upload_open"] = any(
            (b, o) == (LQL_LOGS, LQL_OPEN_KEY)
            for (b, o, _), _ in es.list_multipart_uploads_all())

        def sweep():
            ahead = time.time_ns() + LQL_AHEAD_NS
            logs_rules = parse_lifecycle(LQL_LOGS_LC.decode())
            expired = [oi.name for oi in server.object_layer.list_objects(
                LQL_LOGS, max_keys=1000).objects
                if scanner._apply_lifecycle(LQL_LOGS, oi, logs_rules, ahead)]
            scanner._versions_sweep(
                LQL_VERSIONS, parse_lifecycle(LQL_VERSIONS_LC.decode()),
                ahead)
            scanner._cycle_uploads = None
            scanner._abort_stale_uploads(LQL_LOGS, logs_rules, ahead)
            return expired

        expired = step("ilm_sweep", sweep)
        step("ilm_scan", scanner.scan_cycle)
        left = [v.version_id for v in server.object_layer.list_object_versions(
            LQL_VERSIONS, max_keys=100).versions]
        out["ilm_expired_total"] = _scraped(c, "ilm_expired_total")
        out["ilm_left_versions"] = left
        checks["ilm_logs_expired"] = (
            expired == [LQL_LOGS_KEY]
            and _files_under(root, LQL_LOGS, LQL_LOGS_KEY) == 0)
        checks["ilm_keep_unchanged"] = (
            bool(keep_before)
            and _object_files(root, LQL_LOGS, LQL_KEEP_KEY) == keep_before)
        checks["ilm_noncurrent_swept"] = left == doc_vids[:0:-1]
        checks["ilm_orphan_marker_gone"] = _files_under(
            root, LQL_VERSIONS, LQL_ORPHAN) == 0
        checks["ilm_upload_aborted"] = not any(
            (b, o) == (LQL_LOGS, LQL_OPEN_KEY)
            for (b, o, _), _ in es.list_multipart_uploads_all())
        checks["ilm_expired_total_scraped"] = out["ilm_expired_total"] == 3
    finally:
        server.stop()
    out["system_objects"] = {f"write-{n}": size
                             for n, size in enumerate(sorted(system_sizes))}
    out["checks"] = checks
    return out


# Remote tiers (phase 4p of chip_smoke.py)

TIER_BUCKET, TIER_COLD_BUCKET = "tiered", "coldstore"
TIER_NAME, TIER_PREFIX = "COLD", "tiered"
TIER_PLAIN, TIER_SSE, TIER_TEXT = "plain.bin", "sse.bin", "text.log"
TIER_LC = (b"<LifecycleConfiguration><Rule><ID>cold</ID><Status>Enabled"
           b"</Status><Filter><Prefix></Prefix></Filter><Transition><Days>1"
           b"</Days><StorageClass>COLD</StorageClass></Transition></Rule>"
           b"</LifecycleConfiguration>")
TIER_RANGE = 3 << 20
TIER_AHEAD_NS = 2 * 86400 * 10 ** 9      # the transition sweep's "now"
TIER_EXPIRY_AHEAD_NS = 3 * 86400 * 10 ** 9  # the restore expiry's
TIER_PLAINTEXT_RUN = 64


def _part_shas(root: Path, bucket: str, name: str, drives: int) -> dict:
    """{drive: SHA-256} of every part file of the object (any data dir)."""
    return {i: hashlib.sha256(p.read_bytes()).hexdigest()
            for i in range(1, drives + 1)
            for p in sorted((root / f"d{i}" / bucket / name).glob("*/part.*"))}


def s3_tiering(root, size: int, device="cuda", text_size: int = 64 << 20,
               drives: int = 16, parity: int = 4, lost=S3_WIPED,
               range_size: int = TIER_RANGE, seed: int = 100) -> dict:
    """Drive remote tiers over HTTP: a hot Server over `drives` fresh
    drive directories under `root`/hot (one set, `parity` parity,
    compression on for .log), tiered to a cold Server over `root`/cold
    holding the bucket `coldstore`, both on `device` in this process and
    each with its S3 plane alone:

    1. `tier_settings` compression on; `tier_add` the admin add-tier of
       COLD (the cold server's coldstore under the prefix `tiered`),
       list-tiers showing it without its secret key;
    2. `tier_put_plain`, `tier_put_sse`, `tier_put_text`: a `size`-byte
       seeded object, the same bytes SSE-S3, and `text_size` bytes of
       seeded_text as an SSE-S3 .log object (compressed, then sealed);
    3. `tier_lifecycle`: a Transition after a day to COLD, stored;
    4. `tier_transition`: the scanner's lifecycle step on each object
       with `now` two days ahead: each transitioned, no part file left
       on a hot drive, every hot xl.meta keeping the version with the
       tier markers, coldstore holding three objects of the stored
       sizes, neither SSE object's remote copy holding a run of 64 bytes
       of its plaintext (at five offsets), ilm_transitioned_total 3;
    5. `tier_get`, `tier_range_get`: each object's GET exact by SHA-256
       with `x-amz-storage-class: COLD` (and its HEAD), and `range_size`
       bytes from its middle exact;
    6. `tier_degraded_get`: the plain object's remote copy lost on the
       cold drives `lost` (0, 5, 12 and 15) and those drives offline,
       its GET exact
       (kernel A rebuilds on the cold server); `tier_cold_heal` the
       drives back and the remote copy healed, its files equal to the
       originals;
    7. `tier_restore`: POST ?restore with Days 1 on the plain object,
       202, each hot drive's part file equal to its own before the
       transition; `tier_restored_get` its local GET exact with
       x-amz-restore;
    8. `tier_restore_expiry`: the scanner's step with `now` three days
       ahead drops the restored copy (no part file left),
       ilm_restored_total 1; `tier_expired_get` its GET from the tier
       exact;
    9. `tier_heal`: the plain object's xl.meta lost on hot drive 1, an
       admin heal of the bucket with remove=true: all three versions
       kept, the xl.meta back; `tier_get_after_heal` the three GETs
       exact;
    10. `tier_remove_refused`: remove-tier COLD answered InvalidArgument
        while the lifecycle names it.

    Returns each step's seconds and counter deltas, kernel A's launches
    by shape in each step, the hot TierEngine's `seconds` by part in
    each step (`tier_parts`), the stored sizes, the cold remote keys, the
    reconstructions the cold server ran (unavailable and rebuilt shards),
    the sizes of the .minio.sys objects both servers wrote, and the
    checks."""
    from . import tier as tiermod
    from .api import transforms as tfm
    from .object.metadata import hash_order
    from .ops import rs_cuda

    dev = resolve_device(device)
    root = Path(root)
    hot_root, cold_root = root / "hot", root / "cold"
    k = drives - parity
    out: dict = {"size": size, "text_size": text_size, "k": k, "m": parity,
                 "lost": list(lost), "range_size": range_size,
                 "seconds": {}, "counters": {}, "gf_by_shape": {},
                 "tier_parts": {}}
    phase = _phases(dev, out)
    checks: dict = {}
    rng = np.random.default_rng(seed)
    plain = rng.bytes(size)
    text = seeded_text(text_size, seed + 1)
    bodies = {TIER_PLAIN: plain, TIER_SSE: plain, TIER_TEXT: text}
    want = {n: hashlib.sha256(b).hexdigest() for n, b in bodies.items()}
    names = list(bodies)
    b = f"/{TIER_BUCKET}"
    admin = "/minio/admin/v3"

    def step(label, fn):
        shapes = rs_cuda.LAUNCHES_BY_SHAPE.snapshot()
        parts = dict(hot.tier_engine.seconds)
        res = phase(label, fn)
        out["gf_by_shape"][label] = _shape_delta(
            shapes, rs_cuda.LAUNCHES_BY_SHAPE.snapshot())
        spent = _shape_delta(parts, hot.tier_engine.seconds)
        if spent:
            out["tier_parts"][label] = spent
        return res

    system_sizes: set = set()

    def server(path: Path):
        srv = Server([str(path / f"d{{1...{drives}}}")], port=0,
                     root_user=S3_ACCESS, root_password=S3_SECRET,
                     default_parity=parity, device=dev)
        put_object = srv.object_layer.put_object

        def noting_put(bucket, name, reader, size, opts=None):
            if bucket == ".minio.sys":
                system_sizes.add(size)
            return put_object(bucket, name, reader, size, opts)

        srv.object_layer.put_object = noting_put
        srv.s3.start()
        return srv

    def meta(i: int, name: str):
        return LocalStorage(str(hot_root / f"d{i}"), device="cpu"
                            ).read_version(TIER_BUCKET, name)

    def parts_left(name: str) -> int:
        return len(_part_shas(hot_root, TIER_BUCKET, name, drives))

    def gets(headers_of=lambda name: None):
        return {n: _sha_get(c, f"{b}/{n}", headers_of(n))
                for n in names}

    def exact(res: dict, status: int = 200, windows=None) -> bool:
        return all(st == status and dg == (want[n] if windows is None
                                           else windows[n][1])
                   and h.get("x-amz-storage-class") == TIER_NAME
                   for n, (st, dg, _, h) in res.items())

    cold = server(cold_root)
    hot = None
    try:
        hot = server(hot_root)
        c = S3Client(hot.endpoint, S3_ACCESS, S3_SECRET)
        cc = S3Client(cold.endpoint, S3_ACCESS, S3_SECRET)
        checks["buckets_ok"] = [cc.request("PUT", f"/{TIER_COLD_BUCKET}")[0],
                                c.request("PUT", b)[0]] == [200, 200]
        st = step("tier_settings", lambda: c.request(
            "PUT", f"{admin}/set-config-kv", body=CFG_SETTINGS[0])[0])
        checks["settings_ok"] = st == 200
        spec = {"name": TIER_NAME, "endpoint": cold.endpoint,
                "access_key": S3_ACCESS, "secret_key": S3_SECRET,
                "bucket": TIER_COLD_BUCKET, "prefix": TIER_PREFIX}

        def add_tier():
            st = c.request("PUT", f"{admin}/add-tier",
                           body=json.dumps(spec).encode())[0]
            _, _, listed = c.request("GET", f"{admin}/list-tiers")
            return st, json.loads(listed)

        st, listed = step("tier_add", add_tier)
        checks["tier_added"] = st == 200 and listed == {TIER_NAME: {
            k_: v for k_, v in spec.items()
            if k_ not in ("name", "secret_key")}}

        for label, name, headers in (
                ("tier_put_plain", TIER_PLAIN, None),
                ("tier_put_sse", TIER_SSE, sse_put_headers("sse-s3")),
                ("tier_put_text", TIER_TEXT, sse_put_headers("sse-s3"))):
            body = bodies[name]
            st, _, _ = step(label, lambda: c.put_stream(
                f"{b}/{name}", _PayloadReader(body), len(body), headers))
            checks[f"{label}_ok"] = st == 200
        stored = {n: meta(1, n).size for n in names}
        out["stored_sizes"] = stored
        fi = meta(1, TIER_TEXT)
        checks["text_compressed_then_sealed"] = (
            fi.metadata.get(tfm.META_COMPRESSION) == "s2"
            and fi.metadata.get(ssemod.META_ALGORITHM) == ssemod.ALGO_SSES3)
        before = {n: _part_shas(hot_root, TIER_BUCKET, n, drives)
                  for n in names}
        checks["parts_written"] = all(len(v) == drives
                                      for v in before.values())

        st = step("tier_lifecycle", lambda: c.request(
            "PUT", b, [("lifecycle", "")], body=TIER_LC)[0])
        checks["lifecycle_stored"] = st == 200

        scanner = hot.scanner
        rules = parse_lifecycle(TIER_LC.decode())

        def sweep(ahead_ns: int):
            now = time.time_ns() + ahead_ns
            for oi in hot.object_layer.list_objects(
                    TIER_BUCKET, max_keys=1000).objects:
                scanner._apply_lifecycle(TIER_BUCKET, oi, rules, now)

        step("tier_transition", lambda: sweep(TIER_AHEAD_NS))
        metas = {n: [meta(i, n).metadata for i in range(1, drives + 1)]
                 for n in names}
        checks["transitioned"] = all(
            tiermod.is_transitioned(m) and m.get(tiermod.META_TIER_KEY)
            for ms in metas.values() for m in ms)
        checks["no_hot_parts_left"] = all(parts_left(n) == 0 for n in names)
        remote = {n: metas[n][0][tiermod.META_TIER_KEY] for n in names}
        out["remote_keys"] = remote
        listed = {o.name: o.size for o in cold.object_layer.list_objects(
            TIER_COLD_BUCKET, max_keys=1000).objects}
        checks["cold_holds_stored_sizes"] = listed == {
            remote[n]: stored[n] for n in names}
        checks["remote_keys_prefixed"] = all(
            remote[n].startswith(f"{TIER_PREFIX}/{TIER_BUCKET}/{n}/")
            for n in names)
        for n in (TIER_SSE, TIER_TEXT):
            raw = io.BytesIO()
            cold.object_layer.get_object(TIER_COLD_BUCKET, remote[n], raw)
            raw = raw.getvalue()
            body = bodies[n]
            offs = [0, len(body) // 4, len(body) // 2, 3 * len(body) // 4,
                    len(body) - TIER_PLAINTEXT_RUN]
            checks[f"{n}_remote_sealed"] = (
                len(raw) == stored[n] and not any(
                    body[o:o + TIER_PLAINTEXT_RUN] in raw for o in offs))
            del raw
        out["ilm_transitioned_total"] = _scraped(c, "ilm_transitioned_total")
        checks["ilm_transitioned_total_3"] = (
            out["ilm_transitioned_total"] == 3)

        res = step("tier_get", gets)
        heads = {n: c.request("HEAD", f"{b}/{n}")[1] for n in names}
        checks["tier_get_exact"] = exact(res)
        checks["tier_head_class"] = all(
            {k_.lower(): v for k_, v in h.items()}.get("x-amz-storage-class")
            == TIER_NAME for h in heads.values())
        ranges = {}
        for n in names:
            first = len(bodies[n]) // 2 - range_size // 2
            ranges[n] = (first, hashlib.sha256(
                bodies[n][first:first + range_size]).hexdigest())
        res = step("tier_range_get", lambda: gets(lambda n: {
            "Range": f"bytes={ranges[n][0]}-"
                     f"{ranges[n][0] + range_size - 1}"}))
        checks["tier_range_get_exact"] = exact(res, 206, ranges) and all(
            got == range_size for _, _, got, _ in res.values())

        # The plain object's remote copy lost on four cold drives.
        rkey = remote[TIER_PLAIN]
        dist = hash_order(f"{TIER_COLD_BUCKET}/{rkey}", drives)
        shards = sorted(dist[d] - 1 for d in lost)
        out["cold_reconstructions"] = [[shards, shards],
                                       [shards, [s for s in shards if s < k]]]
        cold_files = _object_files(cold_root, TIER_COLD_BUCKET, rkey)
        raw_disks = [unwrap(d) for d in cold.object_layer.pools[0].disks]
        for i in lost:
            shutil.rmtree(cold_root / f"d{i + 1}" / TIER_COLD_BUCKET / rkey)
            raw_disks[i].set_online(False)
        st, dg, _, h = step("tier_degraded_get", lambda: _sha_get(
            c, f"{b}/{TIER_PLAIN}"))
        checks["tier_degraded_get_exact"] = (st == 200
                                             and dg == want[TIER_PLAIN])
        for i in lost:
            raw_disks[i].set_online(True)
        healed = step("tier_cold_heal", lambda: cold.object_layer.heal_object(
            TIER_COLD_BUCKET, rkey))
        checks["cold_healed_identical"] = (
            len(healed["healed"]) == len(lost)
            and _object_files(cold_root, TIER_COLD_BUCKET, rkey)
            == cold_files)

        st, _, body = step("tier_restore", lambda: c.request(
            "POST", f"{b}/{TIER_PLAIN}", [("restore", "")],
            body=b"<RestoreRequest><Days>1</Days></RestoreRequest>"))
        checks["restore_202"] = st == 202
        checks["restored_parts_equal"] = (
            _part_shas(hot_root, TIER_BUCKET, TIER_PLAIN, drives)
            == before[TIER_PLAIN])
        st, dg, _, h = step("tier_restored_get", lambda: _sha_get(
            c, f"{b}/{TIER_PLAIN}"))
        checks["restored_get_exact"] = (
            st == 200 and dg == want[TIER_PLAIN]
            and 'ongoing-request="false"' in h.get("x-amz-restore", ""))

        step("tier_restore_expiry", lambda: sweep(TIER_EXPIRY_AHEAD_NS))
        checks["restore_expired"] = (
            parts_left(TIER_PLAIN) == 0
            and tiermod.META_RESTORE not in meta(1, TIER_PLAIN).metadata)
        out["ilm_restored_total"] = _scraped(c, "ilm_restored_total")
        checks["ilm_restored_total_1"] = out["ilm_restored_total"] == 1
        st, dg, _, h = step("tier_expired_get", lambda: _sha_get(
            c, f"{b}/{TIER_PLAIN}"))
        checks["expired_get_exact"] = (
            st == 200 and dg == want[TIER_PLAIN]
            and h.get("x-amz-storage-class") == TIER_NAME)

        xl = hot_root / "d1" / TIER_BUCKET / TIER_PLAIN / "xl.meta"
        xl_before = xl.read_bytes()
        xl.unlink()
        state = step("tier_heal", lambda: _heal_bucket(c, TIER_BUCKET,
                                                       remove=True))
        out["heal"] = {k_: state[k_] for k_ in ("Summary", "NumScanned",
                                                "NumHealed", "NumFailed")}
        checks["heal_ok"] = (state["Summary"] == "finished"
                             and state["NumFailed"] == 0)
        checks["heal_kept_versions"] = all(
            tiermod.is_transitioned(meta(i, n).metadata)
            for n in names for i in range(1, drives + 1))
        checks["heal_rebuilt_xl_meta"] = (xl.is_file()
                                          and xl.read_bytes() == xl_before)
        res = step("tier_get_after_heal", gets)
        checks["get_after_heal_exact"] = exact(res)

        st, _, body = step("tier_remove_refused", lambda: c.request(
            "DELETE", f"{admin}/remove-tier", [("name", TIER_NAME)]))
        checks["remove_refused"] = (
            st == 400 and b"<Code>InvalidArgument</Code>" in body
            and hot.tiers.get(TIER_NAME) is not None)
    finally:
        if hot is not None:
            hot.stop()
        cold.stop()
    out["system_objects"] = {f"write-{n}": s
                             for n, s in enumerate(sorted(system_sizes))}
    out["checks"] = checks
    return out


# --- identity: test doubles for phase 4q and the CPU tests ---------------

def _is_probable_prime(n: int, rng, rounds: int = 40) -> bool:
    """Miller-Rabin with `rounds` bases drawn from `rng`."""
    if n < 4:
        return n in (2, 3)
    if not n & 1:
        return False
    d, r = n - 1, 0
    while not d & 1:
        d >>= 1
        r += 1
    for _ in range(rounds):
        x = pow(rng.randrange(2, n - 1), d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def rsa_keypair(seed: int, bits: int = 2048, e: int = 65537) -> dict:
    """An RSA key {n, e, d} made with Python integers: two primes of
    bits/2 bits from a seeded Miller-Rabin search. A test double for an
    identity provider's signing key, never a key to keep."""
    import random

    rng = random.Random(seed)
    half = bits // 2
    while True:
        primes = []
        while len(primes) < 2:
            c = rng.getrandbits(half) | (3 << (half - 2)) | 1
            if (c - 1) % e and _is_probable_prime(c, rng):
                primes.append(c)
        p, q = primes
        n = p * q
        if p != q and n.bit_length() == bits:
            return {"n": n, "e": e, "d": pow(e, -1, (p - 1) * (q - 1))}


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def jwks_of(key: dict, kid: str) -> str:
    """The public half of `key` as a JWKS document."""
    k = (key["n"].bit_length() + 7) // 8
    return json.dumps({"keys": [{
        "kty": "RSA", "kid": kid, "alg": "RS256", "use": "sig",
        "n": _b64url(key["n"].to_bytes(k, "big")),
        "e": _b64url(key["e"].to_bytes(3, "big"))}]})


def jwt_hs256(claims: dict, secret: str) -> str:
    """An HS256 JSON web token of `claims`."""
    head = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
    body = _b64url(json.dumps(claims).encode())
    sig = hmac.new(secret.encode(), f"{head}.{body}".encode(),
                       hashlib.sha256).digest()
    return f"{head}.{body}.{_b64url(sig)}"


def jwt_rs256(claims: dict, key: dict, kid: str) -> str:
    """An RS256 JSON web token of `claims` signed with `key`
    (RSASSA-PKCS1-v1_5 with SHA-256)."""
    from .api.sts import pkcs1v15_sha256

    head = _b64url(json.dumps({"alg": "RS256", "typ": "JWT",
                               "kid": kid}).encode())
    body = _b64url(json.dumps(claims).encode())
    k = (key["n"].bit_length() + 7) // 8
    em = pkcs1v15_sha256(f"{head}.{body}".encode(), k)
    sig = pow(int.from_bytes(em, "big"), key["d"], key["n"])
    return f"{head}.{body}.{_b64url(sig.to_bytes(k, 'big'))}"


class ToyLDAPServer:
    """A directory that answers LDAPv3 simple binds against `users`
    ({dn: password}) on a localhost port: a test double for the
    identity_ldap server, one thread, one bind a connection."""

    def __init__(self, users: dict):
        import socket

        self.users = users
        self.binds = 0
        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.addr = f"127.0.0.1:{self.sock.getsockname()[1]}"
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="mtpu-toy-ldap")
        self._thread.start()

    def _serve(self) -> None:
        from .utils.ldap import LDAPError, _ber, _ber_int, _parse_tlv

        while True:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            with conn:
                try:
                    data = conn.recv(4096)
                    _, msg, _ = _parse_tlv(data, 0)
                    _, mid, off = _parse_tlv(msg, 0)
                    tag, op, _ = _parse_tlv(msg, off)
                    if tag != 0x60:
                        continue  # not a BindRequest
                    _, _ver, o2 = _parse_tlv(op, 0)
                    _, dn, o3 = _parse_tlv(op, o2)
                    _, pw, _ = _parse_tlv(op, o3)
                except (LDAPError, OSError):
                    continue
                self.binds += 1
                ok = self.users.get(dn.decode()) == pw.decode()
                body = (bytes([0x0A, 0x01, 0 if ok else 49])
                        + _ber(0x04, b"") + _ber(0x04, b""))
                try:
                    conn.sendall(_ber(0x30, _ber_int(int.from_bytes(
                        mid, "big")) + _ber(0x61, body)))
                except OSError:
                    continue

    def stop(self) -> None:
        self.sock.close()
        self._thread.join(timeout=5)


IDP_BUCKET = "idp"
IDP_OTHER_BUCKET = "idp-other"
IDP_POLICY = "idp-rw"
IDP_POLICY_DOC = json.dumps({"Version": "2012-10-17", "Statement": [{
    "Effect": "Allow",
    "Action": ["s3:PutObject", "s3:GetObject", "s3:ListBucket"],
    "Resource": [f"arn:aws:s3:::{IDP_BUCKET}",
                 f"arn:aws:s3:::{IDP_BUCKET}/*"]}]})
IDP_SESSION_POLICY = json.dumps({"Version": "2012-10-17", "Statement": [{
    "Effect": "Allow", "Action": ["s3:GetObject"],
    "Resource": [f"arn:aws:s3:::{IDP_BUCKET}/*"]}]})
IDP_ALICE, IDP_ALICE_SECRET = "alice", "alice-secret-key-0001"
IDP_LDAP_USER, IDP_LDAP_PASSWORD = "bob", "bob-directory-password"
IDP_LDAP_BASE_DN = "dc=smoke,dc=org"
IDP_HMAC_SECRET = "smoke-oidc-shared-secret"
IDP_CLIENT_ID = "smoke-app"
IDP_KID = "smoke-rsa-1"
IDP_OBJECT = "big.bin"
IDP_SSE_OBJECT = "sealed.bin"
IDP_RANGE = 3 << 20
STS_NS = "{https://sts.amazonaws.com/doc/2011-06-15/}"


def sts_credentials(body: bytes) -> dict:
    """AccessKeyId, SecretAccessKey, SessionToken and Expiration of an
    STS answer."""
    import xml.etree.ElementTree as ET

    root = ET.fromstring(body)
    return {t: root.findtext(f".//{STS_NS}{t}")
            for t in ("AccessKeyId", "SecretAccessKey", "SessionToken",
                      "Expiration")}


def _iam_files(root: Path, drives: int) -> dict:
    """SHA-256 of every file under .minio.sys/config/iam on the drives."""
    return {str(p.relative_to(root)): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for i in range(1, drives + 1)
        for p in sorted((root / f"d{i}" / ".minio.sys" / "config" /
                         "iam").rglob("*"))
        if p.is_file()}


class _OutageServer(Server):
    """A Server whose drives at the indices `offline` are down from its
    first op (the raw drive set offline under the wrapper)."""

    def __init__(self, *args, offline=(), **kwargs):
        self.offline_raw = []
        self._offline = {f"d{i + 1}" for i in offline}
        super().__init__(*args, **kwargs)

    def _wrap_disk(self, raw, ep: str):
        if Path(ep).name in self._offline:
            raw.set_online(False)
            self.offline_raw.append(raw)
        return super()._wrap_disk(raw, ep)

    def bring_back(self) -> None:
        """The offline drives back, each with its format's disk id."""
        from .object.sets import read_format

        for raw in self.offline_raw:
            raw.set_online(True)
            raw.set_disk_id(read_format(raw)["xl"]["this"])


def s3_identity(root, size: int, device="cuda", post_size: int = 16 << 20,
                drives: int = 16, parity: int = 4, lost=S3_WIPED,
                range_size: int = IDP_RANGE, seed: int = 110) -> dict:
    """Drive identity over HTTP: a Server over `drives` fresh drive
    directories under `root` (one set, `parity` parity) on `device`, its
    S3 plane alone, with identity_openid (an HS256 secret and the JWKS of
    an RSA key made from `seed`) and identity_ldap (a ToyLDAPServer in
    this process) set in the environment:

    1. the root, over the admin routes: `idp_add_policy` the canned
       policy idp-rw (PutObject, GetObject and ListBucket on the bucket
       idp), `idp_add_user` the user alice, `idp_map` idp-rw mapped to
       alice and to ldap:bob (each a .minio.sys PUT), `idp_list_users`
       alice listed with idp-rw;
    2. alice: `alice_put` a `size`-byte seeded object to idp,
       `alice_get` it exact by SHA-256, `alice_put_denied` a PUT to
       idp-other answered 403 from its headers, no drive file changed;
    3. `assume_role` by alice with a session policy of s3:GetObject
       alone: `sts_get` the temporary credential's GET exact with its
       X-Amz-Security-Token, `sts_put_denied` its PUT 403,
       `sts_get_no_token` its GET without the token 403 InvalidTokenId;
    4. `web_identity_hs256` and `web_identity_rs256`:
       AssumeRoleWithWebIdentity with each token (policy=idp-rw), the
       HS256 credential's HEAD 200 and its PUT to idp-other 403;
       `web_sse_put` the RS256 credential's SSE-S3 PUT of the same bytes,
       `web_sse_get` its GET exact;
    5. `ldap_assume` AssumeRoleWithLDAPIdentity for bob,
       `ldap_wrong_password` 403; the object lost on the drives `lost`
       and those drives offline, `ldap_degraded_get` bob's GET exact;
       the drives back;
    6. `service_account`: IAMSys.new_service_account("alice") in this
       process (no admin route makes one), `sa_range_get` its GET of
       `range_size` bytes from the object's middle exact,
       `sa_put_denied` its PUT to idp-other 403;
    7. `post_201` and `post_204`: form uploads of `post_size` bytes
       signed by alice (success_action_status 201, then the default),
       each GET exact (`post_get`), `post_refused` a form whose key
       breaks its starts-with condition 403;
    8. the IAM blobs lost on the drives `lost`, the server stopped and
       built again with those drives offline (`restart`: the IAM loads
       from the degraded blobs), `iam_reload` the store read again,
       `after_restart` alice's and the service account's keys answering
       and every STS credential gone (InvalidAccessKeyId); the drives
       back, `heal_bucket` the admin heal of idp and `heal_iam` each IAM
       blob healed through the object layer (the admin heal takes user
       buckets), every healed file equal by SHA-256 to its original.

    Returns each step's seconds and counter deltas, kernel A's launches
    by shape in each step, the sizes of the .minio.sys objects the
    servers wrote, the reconstructions the object's degraded reads and
    heal take and those of the IAM blobs (unavailable and rebuilt
    shards; a blob's with its size), and the checks."""
    from .object.metadata import hash_order
    from .ops import rs_cuda

    dev = resolve_device(device)
    root = Path(root)
    k = drives - parity
    out: dict = {"size": size, "post_size": post_size, "k": k, "m": parity,
                 "lost": list(lost), "range_size": range_size,
                 "seconds": {}, "counters": {}, "gf_by_shape": {}}
    phase = _phases(dev, out)
    checks: dict = {}
    rng = np.random.default_rng(seed)
    payload = rng.bytes(size)
    form_body = rng.bytes(post_size)
    want = hashlib.sha256(payload).hexdigest()
    key = rsa_keypair(seed)
    admin = "/minio/admin/v3"
    b, other = f"/{IDP_BUCKET}", f"/{IDP_OTHER_BUCKET}"
    system_sizes: set = set()
    iam_sizes: dict = {}

    def step(label, fn):
        shapes = rs_cuda.LAUNCHES_BY_SHAPE.snapshot()
        res = phase(label, fn)
        out["gf_by_shape"][label] = _shape_delta(
            shapes, rs_cuda.LAUNCHES_BY_SHAPE.snapshot())
        return res

    def server(offline=()):
        srv = _OutageServer([str(root / f"d{{1...{drives}}}")], port=0,
                            root_user=S3_ACCESS, root_password=S3_SECRET,
                            default_parity=parity, device=dev,
                            offline=offline)
        put_object = srv.object_layer.put_object

        def noting_put(bucket, name, reader, size_, opts=None):
            if bucket == ".minio.sys":
                system_sizes.add(size_)
                if name.startswith("config/iam/"):
                    iam_sizes[name] = size_
            return put_object(bucket, name, reader, size_, opts)

        srv.object_layer.put_object = noting_put
        srv.s3.start()
        return srv

    def tokens(claims_policy: str = IDP_POLICY) -> dict:
        claims = {"sub": "carol@idp", "aud": IDP_CLIENT_ID,
                  "exp": int(time.time()) + 3600, "policy": claims_policy}
        return {"HS256": jwt_hs256(claims, IDP_HMAC_SECRET),
                "RS256": jwt_rs256(claims, key, IDP_KID)}

    def status_code(resp) -> tuple[int, str]:
        m = re.search(rb"<Code>(.*?)</Code>", resp[2])
        return resp[0], m.group(1).decode() if m else ""

    ldap = ToyLDAPServer({f"uid={IDP_LDAP_USER},{IDP_LDAP_BASE_DN}":
                          IDP_LDAP_PASSWORD})
    env = {"MTPU_IDENTITY_OPENID_HMAC_SECRET": IDP_HMAC_SECRET,
           "MTPU_IDENTITY_OPENID_JWKS": jwks_of(key, IDP_KID),
           "MTPU_IDENTITY_OPENID_CLIENT_ID": IDP_CLIENT_ID,
           "MTPU_IDENTITY_LDAP_SERVER_ADDR": ldap.addr,
           "MTPU_IDENTITY_LDAP_USER_DN_SEARCH_BASE_DN": IDP_LDAP_BASE_DN}
    srv = None
    try:
        with env_vars(**env):
            srv = server()
            c = S3Client(srv.endpoint, S3_ACCESS, S3_SECRET)
            checks["buckets_ok"] = [c.request("PUT", b)[0],
                                    c.request("PUT", other)[0]] == [200, 200]

            # 1. The root sets up alice and the policy.
            st = step("idp_add_policy", lambda: c.request(
                "PUT", f"{admin}/add-canned-policy", [("name", IDP_POLICY)],
                body=IDP_POLICY_DOC.encode())[0])
            checks["policy_added"] = st == 200
            st = step("idp_add_user", lambda: c.request(
                "PUT", f"{admin}/add-user", [("accessKey", IDP_ALICE)],
                body=json.dumps({"secretKey": IDP_ALICE_SECRET,
                                 "status": "on"}).encode())[0])
            checks["user_added"] = st == 200
            st = step("idp_map", lambda: [c.request(
                "PUT", f"{admin}/set-user-or-group-policy",
                [("userOrGroup", who), ("policyName", IDP_POLICY),
                 ("isGroup", "false")])[0]
                for who in (IDP_ALICE, f"ldap:{IDP_LDAP_USER}")])
            checks["policy_mapped"] = st == [200, 200]
            st, _, body = step("idp_list_users", lambda: c.request(
                "GET", f"{admin}/list-users"))
            checks["alice_listed"] = st == 200 and json.loads(body) == {
                IDP_ALICE: {"status": "on", "policyName": IDP_POLICY}}

            # 2. Alice writes and reads in idp, and only there.
            alice = S3Client(srv.endpoint, IDP_ALICE, IDP_ALICE_SECRET)
            st, _, _ = step("alice_put", lambda: alice.put_stream(
                f"{b}/{IDP_OBJECT}", _PayloadReader(payload), size))
            checks["alice_put_ok"] = st == 200
            st, dg, _, _ = step("alice_get", lambda: _sha_get(
                alice, f"{b}/{IDP_OBJECT}"))
            checks["alice_get_exact"] = st == 200 and dg == want
            before = _drive_stat(root)
            resp = step("alice_put_denied", lambda: alice.put_refused(
                f"{other}/{IDP_OBJECT}", size))
            checks["alice_put_denied_403"] = (
                status_code(resp) == (403, "AccessDenied")
                and _drive_stat(root) == before)

            # 3. A temporary credential narrowed by a session policy.
            st, _, body = step("assume_role", lambda: alice.sts({
                "Action": "AssumeRole", "Version": "2011-06-15",
                "DurationSeconds": "900", "Policy": IDP_SESSION_POLICY}))
            role = sts_credentials(body) if st == 200 else {}
            checks["assume_role_ok"] = st == 200 and all(role.values())
            temp = S3Client(srv.endpoint, role.get("AccessKeyId", ""),
                            role.get("SecretAccessKey", ""),
                            session_token=role.get("SessionToken", ""))
            st, dg, _, _ = step("sts_get", lambda: _sha_get(
                temp, f"{b}/{IDP_OBJECT}"))
            checks["sts_get_exact"] = st == 200 and dg == want
            resp = step("sts_put_denied", lambda: temp.put_refused(
                f"{b}/narrowed.bin", post_size))
            checks["sts_put_denied_403"] = status_code(resp) == (
                403, "AccessDenied")
            tokenless = S3Client(srv.endpoint, temp.access_key,
                                 temp.secret_key)
            resp = step("sts_get_no_token", lambda: tokenless.request(
                "GET", f"{b}/{IDP_OBJECT}"))
            checks["sts_get_no_token_403"] = status_code(resp) == (
                403, "InvalidTokenId")

            # 4. Web identity: an HS256 and an RS256 token.
            web = {}
            for alg, token in tokens().items():
                st, _, body = step(f"web_identity_{alg.lower()}",
                                   lambda: c.sts({
                                       "Action": "AssumeRoleWithWebIdentity",
                                       "Version": "2011-06-15",
                                       "WebIdentityToken": token,
                                       "DurationSeconds": "3600"},
                                       signed=False))
                got = sts_credentials(body) if st == 200 else {}
                checks[f"web_identity_{alg.lower()}_ok"] = (
                    st == 200 and all(got.values()))
                web[alg] = S3Client(srv.endpoint,
                                    got.get("AccessKeyId", ""),
                                    got.get("SecretAccessKey", ""),
                                    session_token=got.get("SessionToken",
                                                          ""))
            checks["web_hs256_head_ok"] = web["HS256"].request(
                "HEAD", f"{b}/{IDP_OBJECT}")[0] == 200
            checks["web_hs256_put_elsewhere_403"] = status_code(
                web["HS256"].put_refused(f"{other}/x", post_size)) == (
                    403, "AccessDenied")
            st, _, _ = step("web_sse_put", lambda: web["RS256"].put_stream(
                f"{b}/{IDP_SSE_OBJECT}", _PayloadReader(payload), size,
                sse_put_headers("sse-s3")))
            checks["web_sse_put_ok"] = st == 200
            st, dg, _, h = step("web_sse_get", lambda: _sha_get(
                web["RS256"], f"{b}/{IDP_SSE_OBJECT}"))
            checks["web_sse_get_exact"] = (
                st == 200 and dg == want
                and h.get(ssemod.HDR_SSE.lower()) == "AES256")

            # 5. LDAP: bob's directory bind, then a degraded GET.
            form = {"Action": "AssumeRoleWithLDAPIdentity",
                    "Version": "2011-06-15", "LDAPUsername": IDP_LDAP_USER}
            st, _, body = step("ldap_assume", lambda: c.sts(
                dict(form, LDAPPassword=IDP_LDAP_PASSWORD), signed=False))
            got = sts_credentials(body) if st == 200 else {}
            checks["ldap_assume_ok"] = st == 200 and all(got.values())
            bob = S3Client(srv.endpoint, got.get("AccessKeyId", ""),
                           got.get("SecretAccessKey", ""),
                           session_token=got.get("SessionToken", ""))
            resp = step("ldap_wrong_password", lambda: c.sts(
                dict(form, LDAPPassword="not-" + IDP_LDAP_PASSWORD),
                signed=False))
            checks["ldap_wrong_password_403"] = status_code(resp) == (
                403, "AccessDenied")
            originals = _object_files(root, IDP_BUCKET, IDP_OBJECT)
            dist = hash_order(f"{IDP_BUCKET}/{IDP_OBJECT}", drives)
            shards = sorted(dist[d] - 1 for d in lost)
            # The heal rebuilds every lost shard, a read the data ones.
            targets = [shards, [s_ for s_ in shards if s_ < k]]
            out["object_reconstructions"] = [
                [shards, t] for i, t in enumerate(targets)
                if t not in targets[:i]]
            raw_disks = [unwrap(d) for d in srv.object_layer.pools[0].disks]
            for i in lost:
                shutil.rmtree(root / f"d{i + 1}" / IDP_BUCKET / IDP_OBJECT)
                raw_disks[i].set_online(False)
            st, dg, _, _ = step("ldap_degraded_get", lambda: _sha_get(
                bob, f"{b}/{IDP_OBJECT}"))
            checks["ldap_degraded_get_exact"] = st == 200 and dg == want
            for i in lost:
                raw_disks[i].set_online(True)

            # 6. A service account of alice's, made in this process.
            sa = step("service_account",
                      lambda: srv.iam.new_service_account(IDP_ALICE))
            sac = S3Client(srv.endpoint, sa.access_key, sa.secret_key)
            first = size // 2 - range_size // 2
            st, dg, n, _ = step("sa_range_get", lambda: _sha_get(
                sac, f"{b}/{IDP_OBJECT}", {
                    "Range": f"bytes={first}-{first + range_size - 1}"}))
            checks["sa_range_get_exact"] = (
                st == 206 and n == range_size and dg == hashlib.sha256(
                    payload[first:first + range_size]).hexdigest())
            resp = step("sa_put_denied", lambda: sac.put_refused(
                f"{other}/x", post_size))
            checks["sa_put_denied_403"] = status_code(resp) == (
                403, "AccessDenied")

            # 7. Browser form uploads signed by alice.
            conds = [["starts-with", "$key", "forms/"],
                     ["content-length-range", 1, post_size],
                     ["eq", "$success_action_status", "201"]]
            fields = alice.post_policy_fields(IDP_BUCKET, conds)
            fields.update(key="forms/${filename}",
                          success_action_status="201")
            st, _, body = step("post_201", lambda: alice.post_form(
                IDP_BUCKET, fields, form_body, "form-201.bin"))
            checks["post_201"] = (st == 201 and
                                  b"<Key>forms/form-201.bin</Key>" in body)
            fields = alice.post_policy_fields(IDP_BUCKET, conds[:2])
            fields["key"] = "forms/${filename}"
            st, _, _ = step("post_204", lambda: alice.post_form(
                IDP_BUCKET, fields, form_body, "form-204.bin"))
            checks["post_204"] = st == 204
            form_want = hashlib.sha256(form_body).hexdigest()
            res = step("post_get", lambda: [
                _sha_get(alice, f"{b}/forms/{n}")[:2]
                for n in ("form-201.bin", "form-204.bin")])
            checks["post_get_exact"] = res == [(200, form_want)] * 2
            fields = alice.post_policy_fields(IDP_BUCKET, conds[:2])
            fields["key"] = "elsewhere/${filename}"
            before = _drive_stat(root)
            resp = step("post_refused", lambda: alice.post_form(
                IDP_BUCKET, fields, form_body[:1 << 20], "refused.bin"))
            checks["post_refused_403"] = (
                status_code(resp) == (403, "AccessDenied")
                and _drive_stat(root) == before)

            # 8. The IAM blobs lost on four drives; a restart with those
            # drives offline loads the IAM from the rest.
            sts_clients = [temp, bob, web["HS256"], web["RS256"]]
            iam_before = _iam_files(root, drives)

            def persisted(iam) -> tuple:
                return (sorted(iam.users), {
                    k_: v for k_, v in iam.user_policy.items()
                    if k_ not in iam.sts}, IDP_POLICY in iam.policies)

            state_before = persisted(srv.iam)
            srv.stop()
            srv = None
            for i in lost:
                shutil.rmtree(root / f"d{i + 1}" / ".minio.sys" / "config"
                              / "iam")
            srv = step("restart", lambda: server(offline=lost))
            c = S3Client(srv.endpoint, S3_ACCESS, S3_SECRET)
            checks["iam_loaded_degraded"] = (
                persisted(srv.iam) == state_before and not srv.iam.sts)
            step("iam_reload", srv.iam.reload)
            checks["iam_reloaded_degraded"] = (
                persisted(srv.iam) == state_before)

            def after_restart():
                alice_again = S3Client(srv.endpoint, IDP_ALICE,
                                       IDP_ALICE_SECRET)
                sa_again = S3Client(srv.endpoint, sa.access_key,
                                    sa.secret_key)
                heads = [cl.request("HEAD", f"{b}/{IDP_OBJECT}")[0]
                         for cl in (alice_again, sa_again)]
                gone = [status_code(S3Client(
                    srv.endpoint, cl.access_key, cl.secret_key,
                    session_token=cl.session_token).request(
                        "GET", f"{b}/{IDP_OBJECT}")) for cl in sts_clients]
                return heads, gone

            heads, gone = step("after_restart", after_restart)
            checks["keys_answer_after_restart"] = heads == [200, 200]
            checks["sts_gone_after_restart"] = gone == [
                (403, "InvalidAccessKeyId")] * len(sts_clients)
            srv.bring_back()
            state = step("heal_bucket", lambda: _heal_bucket(c, IDP_BUCKET))
            checks["heal_bucket_ok"] = (state["Summary"] == "finished"
                                        and state["NumFailed"] == 0)
            checks["object_healed_identical"] = (
                _object_files(root, IDP_BUCKET, IDP_OBJECT) == originals)
            # The admin heal takes user buckets only: the IAM blobs heal
            # through the object layer, as the MRF drain heals them.
            healed = step("heal_iam", lambda: [
                srv.object_layer.heal_object(".minio.sys", name)
                for name in sorted(iam_sizes)])
            checks["heal_iam_ok"] = all(
                len(h["healed"]) == len(lost) for h in healed)
            checks["iam_healed_identical"] = (
                _iam_files(root, drives) == iam_before)
    finally:
        if srv is not None:
            srv.stop()
        ldap.stop()
    out["system_objects"] = {f"write-{n}": s
                             for n, s in enumerate(sorted(system_sizes))}
    recon = set()
    for name, s in iam_sizes.items():
        dist = hash_order(f".minio.sys/{name}", drives)
        shards = tuple(sorted(dist[d] - 1 for d in lost))
        recon.add((shards, shards, s))
        recon.add((shards, tuple(x for x in shards if x < k), s))
    out["iam_reconstructions"] = [[list(u), list(t), s]
                                  for u, t, s in sorted(recon)]
    out["iam_blobs"] = dict(sorted(iam_sizes.items()))
    out["checks"] = checks
    return out
