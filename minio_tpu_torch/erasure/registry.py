"""Codec registry of the port, the counterpart of
minio_tpu/erasure/registry.py: the dense GF(2^8) Reed-Solomon codec, the
Cauchy codec and the regenerating `msr-pm` codec.

The codec id is persisted per object (xl.meta "cid") and the wire
algorithm string beside it, so both match minio_tpu's registry exactly.
Every codec's matrices go through the port's one engine, kernel A on the
card (or its plain version when a caller asks for the CPU), so there is
no engine ranking and no host realisation here.

`select_codec` picks the codec a write stamps, in minio_tpu's order: the
per-request id (the x-mtpu-codec header), then MTPU_CODEC, then
auto-selection under MTPU_CODEC_PROFILE ("throughput" ranks by a
measured parity apply, "heal-heavy" by the declared bytes read per byte
healed), the dense incumbent kept unless a challenger beats it by
AUTO_HYSTERESIS.
"""

from __future__ import annotations

import functools
import os
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..ops import cauchy, gf, regen, rs
from ..utils.device import resolve_device

# Stable per-object codec identities, persisted in xl.meta.
DENSE_GF8 = "dense-gf8"
CAUCHY_XOR = "cauchy-xor"
MSR_PM = "msr-pm"

# What an absent "cid" means, and the auto-selection incumbent.
DEFAULT_CODEC = DENSE_GF8

# A challenger must beat the incumbent by this factor to win
# auto-selection (minio_tpu's AUTO_HYSTERESIS).
AUTO_HYSTERESIS = 1.25


@dataclass(frozen=True)
class CodecEntry:
    """One codec: identity plus its matrix constructors, which return the
    (k+m, k) full, (m, k) parity and (targets, k) reconstruct byte
    matrices, expanded x alpha for a sub-packetized codec."""

    codec_id: str
    wire_algorithm: str
    coding_matrix: Callable[[int, int], np.ndarray]
    parity_matrix: Callable[[int, int], np.ndarray]
    reconstruct_matrix: Callable[[int, int, list, list], np.ndarray]
    max_shards: int = gf.MAX_SHARDS
    # Sub-packetization alpha(k, m): shard lengths are multiples of it and
    # the matrices address sub-shards. None means 1.
    subshards: Callable[[int, int], int] | None = None
    # (k, m, target) -> regen.RepairPlan, or None for a target with no
    # bandwidth-optimal plan.
    repair_plan: Callable[[int, int, int], object] | None = None
    # Declared mean bytes read per byte healed for a one-shard repair
    # (dense RS reads k): what heal-heavy auto-selection ranks by.
    repair_read_fraction: Callable[[int, int], float] | None = None
    # Construction constraints beyond the max_shards envelope.
    geometry: Callable[[int, int], bool] | None = None

    def geometry_ok(self, data_blocks: int, parity_blocks: int) -> bool:
        if not (data_blocks > 0 and parity_blocks > 0
                and data_blocks + parity_blocks <= self.max_shards):
            return False
        if self.geometry is not None:
            return bool(self.geometry(data_blocks, parity_blocks))
        return True

    def alpha(self, data_blocks: int, parity_blocks: int) -> int:
        if self.subshards is None:
            return 1
        return int(self.subshards(data_blocks, parity_blocks))

    def declared_repair_fraction(self, data_blocks: int,
                                 parity_blocks: int) -> float:
        """Bytes read per byte healed for a one-shard repair: the dense
        k-survivor cost unless the codec declares better."""
        if self.repair_read_fraction is None:
            return float(data_blocks)
        return float(self.repair_read_fraction(data_blocks, parity_blocks))


_REGISTRY = {
    DENSE_GF8: CodecEntry(
        codec_id=DENSE_GF8,
        wire_algorithm="rs-vandermonde",
        coding_matrix=gf.rs_matrix,
        parity_matrix=gf.parity_matrix,
        reconstruct_matrix=gf.reconstruct_matrix,
    ),
    CAUCHY_XOR: CodecEntry(
        codec_id=CAUCHY_XOR,
        wire_algorithm="rs-cauchy-xor",
        coding_matrix=cauchy.cauchy_matrix,
        parity_matrix=cauchy.cauchy_parity_matrix,
        reconstruct_matrix=cauchy.cauchy_reconstruct_matrix,
    ),
    MSR_PM: CodecEntry(
        codec_id=MSR_PM,
        wire_algorithm="rs-msr-pm",
        coding_matrix=regen.coding_matrix,
        parity_matrix=regen.parity_matrix,
        reconstruct_matrix=regen.reconstruct_matrix,
        subshards=regen.subshards,
        repair_plan=regen.repair_plan,
        repair_read_fraction=regen.repair_read_fraction,
        geometry=regen.geometry_ok,
    ),
}


def codec_ids() -> tuple[str, ...]:
    return tuple(_REGISTRY)


def get(codec_id: str) -> CodecEntry:
    """Resolve a codec id, loud on unknown ids: an object stamped with a
    codec this build does not know must never silently decode dense."""
    entry = _REGISTRY.get(codec_id)
    if entry is None:
        raise KeyError(
            f"unknown erasure codec {codec_id!r} "
            f"(registered: {', '.join(_REGISTRY)})"
        )
    return entry


def wire_algorithm_to_codec(algorithm: str) -> str | None:
    """Codec id for a wire `algo` string, or None when no codec claims
    it."""
    for entry in _REGISTRY.values():
        if entry.wire_algorithm == algorithm:
            return entry.codec_id
    return None


# --- the throughput probe ---------------------------------------------

_PROBE_SHARD = 16384
_PROBE_RUNS = 3


def _measure(fn, nbytes: int, device: torch.device) -> float:
    """Best-of-3 GB/s of one call, after a warm-up call; on the card each
    call ends in a device sync."""
    def run():
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    run()
    best = float("inf")
    for _ in range(_PROBE_RUNS):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return nbytes / best / 1e9 if best > 0 else 0.0


@functools.lru_cache(maxsize=64)
def probe_geometry_gbps(codec_id: str, data_blocks: int, parity_blocks: int,
                        device: torch.device) -> float:
    """Measured parity apply of one codec at one geometry on `device`
    (kernel A on the card, its plain version on the CPU): two blocks of
    16 KiB shards, in the sub-shard view of a sub-packetized codec. What
    throughput auto-selection compares, as minio_tpu's probe does on its
    host engine; measured once a process."""
    entry = get(codec_id)
    alpha = entry.alpha(data_blocks, parity_blocks)
    bits = gf.to_device_bitmat(
        gf.bit_matrix_for(entry.parity_matrix(data_blocks, parity_blocks)),
        device)
    rng = np.random.default_rng(0x5EED)
    blocks = torch.from_numpy(rng.integers(
        0, 256, size=(2, data_blocks * alpha, _PROBE_SHARD // alpha),
        dtype=np.uint8)).to(device)
    return _measure(lambda: rs.apply_gf_matrix(bits, blocks),
                    blocks.numel(), device)


# --- codec selection ---------------------------------------------------

_CODEC_PROFILES = ("throughput", "heal-heavy")


def _codec_profile() -> str:
    """MTPU_CODEC_PROFILE: "throughput" (default) or "heal-heavy", read
    at each selection."""
    prof = os.environ.get("MTPU_CODEC_PROFILE", "throughput")
    return prof if prof in _CODEC_PROFILES else "throughput"


def select_codec(data_blocks: int, parity_blocks: int, forced: str = "",
                 device="cuda") -> str:
    """Codec id a write stamps for this geometry. Precedence: `forced`
    (per request, the x-mtpu-codec header) > MTPU_CODEC (a codec id, or
    "auto", the default) > auto-selection. "auto" as `forced` turns
    auto-selection back on over MTPU_CODEC. Unknown ids raise KeyError;
    a codec that does not fit the geometry raises ValueError. `device`
    runs the throughput probe."""
    want = forced or os.environ.get("MTPU_CODEC", "auto")
    if want and want != "auto":
        entry = get(want)
        if not entry.geometry_ok(data_blocks, parity_blocks):
            raise ValueError(
                f"codec {want!r} does not support geometry "
                f"{data_blocks}+{parity_blocks}"
            )
        return entry.codec_id
    return _auto_codec(data_blocks, parity_blocks, _codec_profile(),
                       resolve_device(device))


@functools.lru_cache(maxsize=64)
def _auto_codec(data_blocks: int, parity_blocks: int, profile: str,
                device: torch.device) -> str:
    incumbent = DEFAULT_CODEC
    if not get(incumbent).geometry_ok(data_blocks, parity_blocks):
        for cid, entry in _REGISTRY.items():
            if entry.geometry_ok(data_blocks, parity_blocks):
                return cid
        return incumbent
    if profile == "heal-heavy":
        return _auto_codec_heal_heavy(data_blocks, parity_blocks, device)
    best, best_gbps = incumbent, probe_geometry_gbps(
        incumbent, data_blocks, parity_blocks, device)
    floor = best_gbps * AUTO_HYSTERESIS
    for cid, entry in _REGISTRY.items():
        if cid == incumbent or not entry.geometry_ok(data_blocks,
                                                     parity_blocks):
            continue
        gbps = probe_geometry_gbps(cid, data_blocks, parity_blocks, device)
        if gbps > floor and gbps > best_gbps:
            best, best_gbps = cid, gbps
    return best


def _auto_codec_heal_heavy(data_blocks: int, parity_blocks: int,
                           device: torch.device) -> str:
    """A challenger displaces the incumbent only when its declared
    repair-read fraction beats the incumbent's by AUTO_HYSTERESIS (the
    fractions are exact per geometry, so the pick cannot flap); the
    measured parity apply breaks ties."""
    best = DEFAULT_CODEC
    best_frac = get(best).declared_repair_fraction(data_blocks,
                                                   parity_blocks)
    ceiling = best_frac / AUTO_HYSTERESIS
    for cid, entry in _REGISTRY.items():
        if cid == DEFAULT_CODEC or not entry.geometry_ok(data_blocks,
                                                         parity_blocks):
            continue
        frac = entry.declared_repair_fraction(data_blocks, parity_blocks)
        if frac >= ceiling:
            continue
        if frac < best_frac or (
            frac == best_frac
            and probe_geometry_gbps(cid, data_blocks, parity_blocks, device)
            > probe_geometry_gbps(best, data_blocks, parity_blocks, device)
        ):
            best, best_frac = cid, frac
    return best
