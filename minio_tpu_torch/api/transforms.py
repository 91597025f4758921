"""Request and response transforms, the port's copy of minio_tpu's
api/transforms.py (MinIO's newS2CompressReader, cmd/object-api-utils.go:925,
the DARE reader stack in cmd/encryption-v1.go and NewGetObjectReader,
cmd/object-api-utils.go:595-870): a PUT wraps the request body in reader
stages (md5-verify -> compress -> encrypt), a GET wraps the response sink
in writer stages (decrypt -> decompress -> range window), and no stage
ever holds the object whole.

Compression is minio_tpu's S2-style framed snappy (ops/s2.py), gated by
the `compression` config subsystem (extensions, MIME types) and decided
by a test compression of the first 64 KiB: CompressReader compresses
batches of up to 128 chunks of 64 KiB with one launch of kernel E each,
DecompressWriter decodes batches of whole frames with one launch of
kernel F (the plain codec on the CPU). Objects minio_tpu stored with its
legacy zlib codec are read through the standard library.

The SSE packages are minio_tpu's: 64 KiB of plaintext each, stored as
nonce (12) || ciphertext || tag (16), the sequence number as the
little-endian u64 AAD. EncryptReader gathers whole packages and seals a
batch in one launch of kernel C; DecryptWriter opens batches with
kernel D (the plain version on the CPU). The stored bytes do not depend
on the batch depth: every package has its own nonce, drawn from
os.urandom in package order as minio_tpu draws them.

The contract with the object layer: put_object snapshots
opts.user_defined AFTER it has read the reader to its end, so the EOF
hooks below record the sizes into that dict as the stream ends.
"""

from __future__ import annotations

import collections
import fnmatch
import hashlib
import os
import struct
import tempfile
import zlib

import torch

from ..crypto import sse as ssemod
from ..crypto.aead import AESGCM
from ..ops import s2
from .errors import S3Error

META_COMPRESSION = "x-mtpu-internal-compression"
META_COMPRESSED_SIZE = "x-mtpu-internal-compressed-size"
META_UNCOMPRESSED_SIZE = "x-mtpu-internal-uncompressed-size"
# The codec the port writes, and the one it reads besides (objects of
# minio_tpu's older builds).
CODEC = "s2"
LEGACY_CODECS = ("zlib",)

_EXCLUDED_EXTS = (".gz", ".bz2", ".rar", ".zip", ".7z", ".xz", ".mp4",
                  ".mkv", ".mov", ".jpg", ".png", ".gif")

_STREAM_CHUNK = 1 << 20
_PSIZE = ssemod.PACKAGE_SIZE + ssemod.PACKAGE_OVERHEAD  # 65,564 B stored


def packages_per_launch(device) -> int:
    """Packages a seal or open launch takes: 127 on the card (a batch's
    staged bytes, 65,612 a package at most, fit the 8 MiB pinned block
    the caching host allocator rounds them up to; kernels C and D spread
    each package over a cluster of blocks, so a launch of 127 still
    fills the card), 16 on the CPU, where the plain version's
    intermediates grow with the batch."""
    return 127 if torch.device(device).type == "cuda" else 16


def should_compress(config, object_name: str, content_type: str) -> bool:
    """The config's compressibility filter (isCompressible,
    cmd/object-api-utils.go:445): compression on, the name not of an
    already compressed format, and its extension or MIME type listed
    (everything, when neither list has an entry)."""
    if config is None:
        return False
    kvs = config.get("compression")
    if kvs.get("enable") != "on":
        return False
    name = object_name.lower()
    if any(name.endswith(e) for e in _EXCLUDED_EXTS):
        return False
    exts = [e.strip() for e in kvs.get("extensions", "").split(",")
            if e.strip()]
    mimes = [m.strip() for m in kvs.get("mime_types", "").split(",")
             if m.strip()]
    if not exts and not mimes:
        return True
    if exts and any(name.endswith(e.lower()) for e in exts):
        return True
    return bool(mimes and content_type and any(
        fnmatch.fnmatchcase(content_type, m) for m in mimes))


def transforms_active(headers: dict, config=None,
                      object_name: str = "") -> bool:
    """True when the PUT body needs the transform chain."""
    if ssemod.parse_ssec_key(headers) is not None:
        return True
    if ssemod.wants_sse_s3(headers) or ssemod.wants_sse_kms(headers):
        return True
    return should_compress(config, object_name,
                           headers.get("content-type", ""))


def is_transformed(meta: dict) -> bool:
    return bool(meta.get(META_COMPRESSION)) or ssemod.is_encrypted(meta)


class Md5VerifyReader:
    """Passthrough reader that checks the PLAINTEXT md5 at EOF: the
    inline hash.Reader check for transformed bodies (Content-MD5
    declares the bytes before the transform)."""

    def __init__(self, src, want_hex: str):
        self._src = src
        self._md5 = hashlib.md5()
        self._want = want_hex
        self._checked = False

    def read(self, n: int = -1) -> bytes:
        buf = self._src.read(n)
        if buf:
            self._md5.update(buf)
        elif not self._checked:
            self._checked = True
            if self._md5.hexdigest() != self._want:
                raise S3Error("BadDigest")
        return buf


class _Ready:
    """Output bytes waiting for a read, as a queue of buffers; a read
    copies out only the bytes it returns."""

    def __init__(self):
        self._q = collections.deque()
        self.nbytes = 0

    def put(self, buf) -> None:
        if len(buf):
            self._q.append(buf)
            self.nbytes += len(buf)

    def take(self, n: int) -> bytes:
        """Up to n (all: n < 0) bytes, in order."""
        parts = []
        left = self.nbytes if n < 0 else min(n, self.nbytes)
        self.nbytes -= left
        while left:
            head = self._q[0]
            if len(head) <= left:
                parts.append(self._q.popleft())
            else:
                parts.append(head[:left])
                self._q[0] = head[left:]
            left -= len(parts[-1])
        return b"".join(parts)


class CompressReader:
    """Streaming S2-framed snappy compressor. The config's filters chose
    the object; whether it compresses is decided by a test compression of
    the first 64 KiB (one launch of kernel E): a block of at least 99% of
    the probe's length passes the whole stream through unmarked, as
    minio_tpu does (the frames' own escape still stores an incompressible
    chunk raw). Chunks of 64 KiB are compressed in batches of up to
    BATCH_CHUNKS a launch. The stored size is unknown until EOF, when
    the codec and both sizes land in `meta_sink`."""

    _PROBE_BYTES = 64 << 10

    def __init__(self, src, meta_sink: dict, device="cuda"):
        self._src = src
        self._codec = s2.S2Batch(device)
        self._ready = _Ready()
        self._pending = bytearray()
        self._eof = False
        self._plain = 0
        self._out = 0
        self._meta = meta_sink
        self._mode = ""  # "" undecided | "s2" | "raw"

    def _decide(self, first_chunk) -> None:
        probe_src = memoryview(first_chunk)[:self._PROBE_BYTES]
        _, blocks = self._codec.compress_chunks(probe_src, [len(probe_src)])
        if len(blocks[0]) >= int(len(probe_src) * 0.99):
            self._mode = "raw"
        else:
            self._mode = "s2"
            self._emit(s2.STREAM_ID)

    def _emit(self, buf) -> None:
        self._ready.put(buf)
        self._out += len(buf)

    def _compress(self, nbytes: int) -> None:
        """Frame the first `nbytes` of the pending bytes, in batches."""
        step = s2.BATCH_CHUNKS * s2.CHUNK
        done = 0
        while done < nbytes:
            piece = memoryview(self._pending)[done:min(nbytes, done + step)]
            sizes = [min(s2.CHUNK, len(piece) - o)
                     for o in range(0, len(piece), s2.CHUNK)]
            crcs, blocks = self._codec.compress_chunks(piece, sizes)
            self._emit(s2.frames_of(piece, sizes, crcs, blocks))
            done += len(piece)
            del piece
        del self._pending[:nbytes]

    def read(self, n: int = -1) -> bytes:
        batch = s2.BATCH_CHUNKS * s2.CHUNK
        while (n < 0 or self._ready.nbytes < n) and not self._eof:
            chunk = self._src.read(_STREAM_CHUNK)
            if chunk and not self._mode:
                self._decide(chunk)
            if not chunk:
                self._eof = True
                if self._mode == "s2":
                    self._compress(len(self._pending))
                    self._meta[META_COMPRESSION] = CODEC
                    self._meta[META_UNCOMPRESSED_SIZE] = str(self._plain)
                    self._meta[META_COMPRESSED_SIZE] = str(self._out)
                break
            self._plain += len(chunk)
            if self._mode == "raw":
                self._emit(chunk)
                continue
            self._pending += chunk
            if len(self._pending) >= batch:
                self._compress(len(self._pending) // batch * batch)
        return self._ready.take(n)


class EncryptReader:
    """Streaming package encryptor: 64 KiB plaintext packages ->
    nonce || ciphertext || tag, the sequence number as the AAD, sealed
    in batches of whole packages. Records the size before encryption
    into `meta_sink` at EOF. The sealed batches wait as the AEAD's
    memoryviews; a read copies out only the bytes it returns."""

    def __init__(self, src, object_key: bytes, meta_sink: dict,
                 device="cuda"):
        self._src = src
        self._aes = AESGCM(object_key, device)
        self._batch = packages_per_launch(device)
        self._ready = _Ready()  # sealed, not yet read
        self._pending = bytearray()
        self._eof = False
        self._seq = 0
        self._plain = 0
        self._meta = meta_sink
        self._emitted_any = False

    def _emit(self, sizes: list[int]):
        """Seal the first len(sizes) packages of the pending plaintext."""
        nbytes = sum(sizes)
        nonces = [os.urandom(12) for _ in sizes]
        aads = [struct.pack("<Q", self._seq + i) for i in range(len(sizes))]
        sealed = self._aes.seal_packages(memoryview(self._pending)[:nbytes],
                                         sizes, nonces, aads)
        del self._pending[:nbytes]
        self._ready.put(sealed)
        self._seq += len(sizes)
        self._emitted_any = True

    def read(self, n: int = -1) -> bytes:
        psize = ssemod.PACKAGE_SIZE
        while (n < 0 or self._ready.nbytes < n) and not self._eof:
            chunk = self._src.read(_STREAM_CHUNK)
            if chunk:
                self._plain += len(chunk)
                self._pending += chunk
                while len(self._pending) >= self._batch * psize:
                    self._emit([psize] * self._batch)
                continue
            self._eof = True
            full = len(self._pending) // psize
            while full:
                k = min(full, self._batch)
                self._emit([psize] * k)
                full -= k
            if self._pending or not self._emitted_any:
                # The short last package, or one of 0 B for an empty
                # object; none after an exact multiple of 64 KiB.
                self._emit([len(self._pending)])
            self._meta[ssemod.META_ACTUAL_SIZE] = str(self._plain)
        return self._ready.take(n)


def _sse_s3error(exc: "ssemod.SSEError", default_code: str) -> S3Error:
    return S3Error(
        exc.code if exc.code in ("AccessDenied", "NotImplemented")
        else default_code,
        str(exc),
    )


def build_put_stream(headers: dict, config, sse_config, bucket: str,
                     object_: str, reader, user_defined: dict,
                     want_md5_hex: str = "", device="cuda"):
    """Wrap `reader` in the streaming transform chain, in minio_tpu's
    order: md5-verify, compress (when the config's filters take the
    object), encrypt. `device` runs the codec (and the AEAD, with the SSE
    config's own device).

    Returns (reader, -1, response_headers). The static metadata (the SSE
    algorithm and sealed key) goes into `user_defined` now; the size
    metadata is recorded there by the EOF hooks while the object layer
    drains the stream (before it snapshots the metadata). The stored
    size is always unknown: a consumer that read exactly a precomputed
    size would never pull the source's EOF, and the EOF hooks (the size
    metadata, the Content-MD5 verdict) would not run. With
    compress-then-encrypt the SSE actual size records the compressed
    length; the compression marker gives the logical size."""
    if want_md5_hex:
        reader = Md5VerifyReader(reader, want_md5_hex)
    if should_compress(config, object_, headers.get("content-type", "")):
        reader = CompressReader(reader, user_defined, device)
    try:
        object_key, sse_meta, resp = ssemod.setup_encryption(
            headers, bucket, object_, sse_config
        )
    except ssemod.SSEError as exc:
        raise _sse_s3error(exc, "InvalidArgument") from exc
    if object_key is not None:
        user_defined.update(sse_meta)
        reader = EncryptReader(reader, object_key, user_defined,
                               device=sse_config.device
                               if sse_config is not None else "cuda")
    return reader, -1, resp


class DecryptWriter:
    """Streaming package decryptor: buffers stored bytes and opens whole
    packages in batches, writing their plaintext through. At least one
    byte stays buffered until close(): the last package may be short,
    and only close() knows the stream ended. On a package whose tag
    fails, the plaintext of the packages before it is written, then
    AccessDenied is raised, as minio_tpu does one package at a time."""

    def __init__(self, dst, object_key: bytes, device="cuda"):
        self._dst = dst
        self._aes = AESGCM(object_key, device)
        self._batch = packages_per_launch(device)
        self._buf = bytearray()
        self._seq = 0

    def _open(self, full: int, tail: int = 0):
        """Open `full` whole packages from the buffer's start, then a
        last one of `tail` stored bytes (0: none)."""
        sizes = [ssemod.PACKAGE_SIZE] * full
        if tail:
            sizes.append(tail - ssemod.PACKAGE_OVERHEAD)
        nbytes = full * _PSIZE + tail
        aads = [struct.pack("<Q", self._seq + i) for i in range(len(sizes))]
        plain, ok = self._aes.open_packages(memoryview(self._buf)[:nbytes],
                                            sizes, aads)
        good = ok.index(False) if False in ok else len(ok)
        if good:
            self._dst.write(plain[:sum(sizes[:good])])
        if good < len(ok):
            raise S3Error("AccessDenied",
                          f"SSE package {self._seq + good} auth failure")
        self._seq += len(sizes)
        del self._buf[:nbytes]

    def write(self, data) -> int:
        self._buf += data
        while len(self._buf) > self._batch * _PSIZE:
            self._open(self._batch)
        return len(data)

    def close(self):
        if not self._buf:
            return
        full = (len(self._buf) - 1) // _PSIZE
        while full:
            k = min(full, self._batch)
            self._open(k)
            full -= k
        if len(self._buf) < ssemod.PACKAGE_OVERHEAD:
            raise S3Error("InvalidRequest", "truncated SSE stream")
        self._open(0, len(self._buf))


class RangeWriter:
    """Pass only the [offset, offset+length) window of the logical stream
    through to dst (a ranged GET of a transformed object decodes the
    stream on the server and ships only the window)."""

    def __init__(self, dst, offset: int, length: int):
        self._dst = dst
        self._skip = offset
        self._left = length

    def write(self, data) -> int:
        n = len(data)
        data = memoryview(data)
        if self._skip:
            drop = min(self._skip, len(data))
            self._skip -= drop
            data = data[drop:]
        if self._left > 0 and len(data):
            take = data[:self._left]
            self._dst.write(take)
            self._left -= len(take)
        return n


class DecompressWriter:
    """Streaming inflater for the stored codec: S2-framed snappy (frames
    parsed on the host, whole frames decoded by kernel F a batch at a
    time, at most about 8 MiB of frames buffered) or minio_tpu's legacy
    zlib."""

    def __init__(self, dst, codec: str = CODEC, device="cuda"):
        self._dst = dst
        self._codec = codec
        if codec == "zlib":
            self._d = zlib.decompressobj()
        else:
            self._d = s2.FrameDecoder(device)

    def write(self, data) -> int:
        if self._codec == "zlib":
            self._dst.write(self._d.decompress(bytes(data)))
            return len(data)
        try:
            self._d.feed(data)
        except ValueError as exc:
            raise S3Error("InternalError", str(exc)) from exc
        out = self._d.decoded()
        if out:
            self._dst.write(out)
        return len(data)

    def close(self):
        if self._codec == "zlib":
            tail = self._d.flush()
        else:
            try:
                tail = self._d.finish()
            except ValueError as exc:
                raise S3Error("InternalError", str(exc)) from exc
        if tail:
            self._dst.write(tail)


def build_get_chain(stored_meta: dict, headers: dict, sse_config,
                    bucket: str, object_: str, dst,
                    offset: int = 0, length: int = -1, device="cuda"):
    """The decrypt -> decompress -> range writer chain onto `dst`
    (`device` runs the codec; the AEAD runs on the SSE config's).

    Returns (writer, closers, response_headers); the closers close in
    order. Every key check happens HERE, before a byte streams, so an
    auth failure is a proper error response and not an aborted
    stream."""
    closers = []
    if length >= 0:
        dst = RangeWriter(dst, offset, length)
    if stored_meta.get(META_COMPRESSION):
        codec = stored_meta[META_COMPRESSION]
        if codec != CODEC and codec not in LEGACY_CODECS:
            raise S3Error("InternalError", f"unknown codec {codec!r}")
        dst = DecompressWriter(dst, codec, device)
        closers.append(dst)
    try:
        object_key, resp = ssemod.resolve_decryption_key(
            stored_meta, headers, bucket, object_, sse_config
        )
    except ssemod.SSEError as exc:
        raise _sse_s3error(exc, "InvalidRequest") from exc
    if object_key is not None:
        dst = DecryptWriter(dst, object_key, device=sse_config.device
                            if sse_config is not None else "cuda")
        closers.insert(0, dst)
    return dst, closers, resp


def decode_to_spool(ol, bucket: str, object_: str, opts, stored_meta: dict,
                    headers: dict, sse_config, max_memory: int = 8 << 20,
                    device="cuda"):
    """An object's LOGICAL stream in a SpooledTemporaryFile (on disk past
    `max_memory`): the decode step of a copy. Returns the spool at
    position 0; the caller closes it. Plain objects stream straight
    through."""
    spool = tempfile.SpooledTemporaryFile(max_size=max_memory)
    try:
        if is_transformed(stored_meta):
            chain, closers, _ = build_get_chain(
                stored_meta, headers, sse_config, bucket, object_, spool,
                device=device)
            ol.get_object(bucket, object_, chain, opts=opts)
            for c in closers:
                c.close()
        else:
            ol.get_object(bucket, object_, spool, opts=opts)
    except BaseException:
        spool.close()
        raise
    spool.seek(0)
    return spool


def stored_prefix(meta: dict, stored_size: int, offset: int,
                  length: int) -> int:
    """The stored bytes a ranged GET of [offset, offset + length) decodes:
    from the start through the package that holds the window's last
    byte (the rest would be decrypted only to be dropped). A compressed
    object's range is in logical bytes, which no stored prefix bounds:
    it decodes its whole stored stream, as minio_tpu's does."""
    if (not ssemod.is_encrypted(meta) or meta.get(META_COMPRESSION)
            or length <= 0):
        return stored_size
    last = (offset + length - 1) // ssemod.PACKAGE_SIZE
    return min(stored_size, (last + 1) * _PSIZE)


def actual_object_size(meta: dict, stored_size: int) -> int:
    """The logical (client-visible) size of a transformed object. With
    compress-then-encrypt the SSE actual size records the COMPRESSED
    length, so the compression marker wins."""
    if meta.get(META_COMPRESSION):
        return int(meta.get(META_UNCOMPRESSED_SIZE, stored_size))
    if ssemod.is_encrypted(meta):
        return int(meta.get(ssemod.META_ACTUAL_SIZE, stored_size))
    return stored_size
