"""FileInfo / ErasureInfo / part metadata: the per-disk descriptors of
one object version that the object layer and the drive storage exchange.
The port's copy of minio_tpu/storage/fileinfo.py (MinIO's FileInfo,
cmd/storage-datatypes.go, and ErasureInfo/ChecksumInfo,
cmd/erasure-metadata.go), with the same `to_dict` keys, so xl.meta
written by either package reads in the other.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass, field

from ..erasure import registry
from ..erasure.bitrot import BitrotAlgorithm
from ..utils import ceil_frac
from ..utils.errors import ErrInvalidArgument

ERASURE_ALGORITHM = "rs-vandermonde"  # erasureAlgorithm


@dataclass
class ObjectPartInfo:
    """One part of an object (ObjectPartInfo)."""

    number: int
    size: int
    actual_size: int  # size before compression or encryption

    def to_dict(self) -> dict:
        return {"n": self.number, "s": self.size, "as": self.actual_size}

    @classmethod
    def from_dict(cls, d: dict) -> "ObjectPartInfo":
        return cls(number=d["n"], size=d["s"], actual_size=d["as"])


@dataclass
class ChecksumInfo:
    """Bitrot checksum of one part (ChecksumInfo). Streaming algorithms
    interleave their digests in the shard file, so `hash` stays empty."""

    part_number: int
    algorithm: str  # a BitrotAlgorithm value
    hash: bytes = b""

    def to_dict(self) -> dict:
        return {"p": self.part_number, "a": self.algorithm, "h": self.hash}

    @classmethod
    def from_dict(cls, d: dict) -> "ChecksumInfo":
        return cls(part_number=d["p"], algorithm=d["a"], hash=d["h"])


@dataclass
class ErasureInfo:
    """Erasure geometry and this disk's shard index (ErasureInfo).

    `codec` is the codec id that made the parity bytes. "" on disk means
    metadata from before codec ids, which is dense Vandermonde when the
    wire algorithm is rs-vandermonde; from_dict resolves it, and refuses
    a codec the port does not have rather than decode with the wrong
    matrices. Shard sizes round up to the codec's sub-packetization, as
    the codec layer's do (erasure/codec.Erasure.chunk_size): otherwise
    check_parts and verify_file would find every part of a sub-packetized
    object the wrong size."""

    algorithm: str = ERASURE_ALGORITHM
    data_blocks: int = 0
    parity_blocks: int = 0
    block_size: int = 0
    index: int = 0  # 1-based position of this disk in `distribution`
    distribution: list[int] = field(default_factory=list)
    checksums: list[ChecksumInfo] = field(default_factory=list)
    codec: str = ""

    def _chunk_size(self, block_len: int) -> int:
        size = ceil_frac(block_len, self.data_blocks)
        a = registry.get(self.codec).alpha(
            self.data_blocks, self.parity_blocks) if self.codec else 1
        return ceil_frac(size, a) * a if a > 1 else size

    def shard_size(self) -> int:
        return self._chunk_size(self.block_size)

    def shard_file_size(self, total_length: int) -> int:
        if total_length == 0:
            return 0
        if total_length == -1:
            return -1
        num = total_length // self.block_size
        return num * self.shard_size() + self._chunk_size(
            total_length % self.block_size)

    def get_checksum_info(self, part_number: int) -> ChecksumInfo:
        for c in self.checksums:
            if c.part_number == part_number:
                return c
        return ChecksumInfo(part_number=part_number,
                            algorithm=BitrotAlgorithm.default().value)

    def to_dict(self) -> dict:
        d = {
            "algo": self.algorithm,
            "k": self.data_blocks,
            "m": self.parity_blocks,
            "bs": self.block_size,
            "idx": self.index,
            "dist": list(self.distribution),
            "cs": [c.to_dict() for c in self.checksums],
        }
        # "cid" only when the codec is known, as minio_tpu writes it.
        if self.codec:
            d["cid"] = self.codec
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ErasureInfo":
        algorithm = d["algo"]
        codec = d.get("cid", "")
        if codec:
            try:
                wire = registry.get(codec).wire_algorithm
            except KeyError as exc:
                raise ValueError(
                    f"xl.meta names erasure codec {codec!r}, which the port "
                    "does not have; refusing to decode with the wrong "
                    "matrices") from exc
            if algorithm != wire:
                raise ValueError(
                    f"xl.meta codec {codec!r} / algorithm {algorithm!r} "
                    f"mismatch (expected {wire!r})")
        elif algorithm == ERASURE_ALGORITHM:
            codec = registry.DEFAULT_CODEC
        else:
            raise ValueError(
                f"xl.meta has no codec id and a non-legacy erasure "
                f"algorithm {algorithm!r}; refusing to guess")
        return cls(
            algorithm=algorithm,
            data_blocks=d["k"],
            parity_blocks=d["m"],
            block_size=d["bs"],
            index=d["idx"],
            distribution=list(d["dist"]),
            checksums=[ChecksumInfo.from_dict(c) for c in d["cs"]],
            codec=codec,
        )


@dataclass
class FileInfo:
    """One version of one object on one disk (FileInfo)."""

    volume: str = ""
    name: str = ""
    version_id: str = ""  # "" == null version
    is_latest: bool = True
    deleted: bool = False  # delete marker
    data_dir: str = ""  # uuid directory holding this version's part files
    mod_time_ns: int = 0
    size: int = 0
    metadata: dict = field(default_factory=dict)  # user + system metadata
    parts: list[ObjectPartInfo] = field(default_factory=list)
    erasure: ErasureInfo = field(default_factory=ErasureInfo)
    # Inline small-object data: this disk's framed shard bytes by part
    # number, kept inside xl.meta instead of a part file.
    data: dict[int, bytes] = field(default_factory=dict)
    num_versions: int = 0

    def add_part(self, number: int, size: int, actual_size: int):
        """Replace or append a part, kept sorted (AddObjectPart)."""
        info = ObjectPartInfo(number, size, actual_size)
        for i, p in enumerate(self.parts):
            if p.number == number:
                self.parts[i] = info
                break
        else:
            self.parts.append(info)
        self.parts.sort(key=lambda p: p.number)

    def to_object_part_index(self, offset: int) -> tuple[int, int]:
        """(part index, offset within the part) of an object offset
        (ObjectToPartOffset)."""
        if offset == 0:
            return 0, 0
        remaining = offset
        for i, part in enumerate(self.parts):
            if remaining < part.size:
                return i, remaining
            remaining -= part.size
        raise ErrInvalidArgument(f"offset {offset} beyond object size")

    def to_dict(self) -> dict:
        return {
            "v": self.volume,
            "n": self.name,
            "vid": self.version_id,
            "lat": self.is_latest,
            "del": self.deleted,
            "dd": self.data_dir,
            "mt": self.mod_time_ns,
            "sz": self.size,
            "meta": dict(self.metadata),
            "parts": [p.to_dict() for p in self.parts],
            "er": self.erasure.to_dict(),
            # str keys, as minio_tpu writes them
            "data": {str(k): bytes(v) for k, v in self.data.items()},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FileInfo":
        return cls(
            volume=d["v"],
            name=d["n"],
            version_id=d["vid"],
            is_latest=d["lat"],
            deleted=d["del"],
            data_dir=d["dd"],
            mod_time_ns=d["mt"],
            size=d["sz"],
            metadata=dict(d["meta"]),
            parts=[ObjectPartInfo.from_dict(p) for p in d["parts"]],
            erasure=ErasureInfo.from_dict(d["er"]),
            data={int(k): bytes(v) for k, v in d.get("data", {}).items()},
        )


def new_uuid() -> str:
    return str(uuid.uuid4())
