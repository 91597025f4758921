"""Time kernels A and B on the card across shapes, one shape changed at a
time around the 12+4 main shape, to show what a kernel's time follows.

    python -m minio_tpu_torch.kernel_sweep

Kernel A (the GF apply) over output rows R, shards K, batch B and shard
length S, each output checked exact against the plain version; kernel B
(HighwayHash-256) over the number of 87,382-byte chunks, cold (inputs
cycled past the 50 MB L2) and warm (one input). Times are a launch's
own, from CUDA-graph replay. The SM clock is measured before and after
the sweep, so times can be read as cycles. Prints one line a shape,
then one JSON object with all of them. Exits non-zero without a CUDA
card.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

from .ops import gf, highwayhash_torch as hh, rs, rs_cuda
from .utils.timing import time_calls, time_graph

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SHARD = 87_382  # a 1 MiB block over 12 data shards
GF_SHAPES = [  # (B, K, R, S)
    (8, 12, 4, SHARD), (16, 12, 4, SHARD), (1, 12, 4, SHARD),
    (8, 12, 1, SHARD), (8, 12, 2, SHARD), (8, 12, 8, SHARD),
    (8, 4, 4, SHARD), (8, 12, 4, SHARD // 2),
    (8, 40, 40, SHARD // 8), (2, 128, 128, 4096),
]
HASH_SHAPES = [(128, SHARD), (32, SHARD), (16, SHARD), (8, SHARD),
               (8, 4096 + 22)]
L2_BYTES = 50 << 20


def sm_clock_ghz() -> float:
    """The SM clock while a kernel runs: torch.cuda._sleep spins for a
    given number of SM clock cycles; cycles over its event-timed span."""
    cycles = 20_000_000

    def spin(_):
        torch.cuda._sleep(cycles)

    return cycles / time_calls(spin, [None], 5) / 1e6


def _inputs(shape, rng) -> list[torch.Tensor]:
    """Enough random uint8 inputs of `shape` to exceed the L2 together."""
    n = 2 + L2_BYTES // int(np.prod(shape))
    return [torch.from_numpy(rng.integers(0, 256, size=shape, dtype=np.uint8))
            .cuda() for _ in range(n)]


def sweep_gf(rng) -> list[dict]:
    rows = []
    for b, k, r, s in GF_SHAPES:
        bitmat = gf.to_device_bitmat(
            gf.bit_matrix(gf.parity_matrix(k, r)), "cuda").contiguous()
        xs = _inputs((b, k, s), rng)

        def apply(x, bitmat=bitmat):
            return rs_cuda.apply_gf_matrix_cuda(bitmat, x)

        if not torch.equal(apply(xs[0]), rs._apply_bits_plain(bitmat, xs[0])):
            raise AssertionError(f"kernel A differs at {(b, k, r, s)}")
        ms = time_graph(apply, xs, 100)
        bound_ms = 1e3 * b * (k + r) * s / HBM_BYTES_PER_S
        rows.append({"kernel": "gf_apply", "B": b, "K": k, "R": r, "S": s,
                     "us": 1e3 * ms, "bound_us": 1e3 * bound_ms})
        print(f"gf_apply [{b}, {k}, {s}] -> {r} rows: {1e3 * ms:.2f} us, "
              f"byte bound {1e3 * bound_ms:.2f} us", flush=True)
    return rows


def sweep_hash(rng) -> list[dict]:
    rows = []

    def digest(x):
        return hh._hash256_cuda(x, hh.MAGIC_KEY)

    for n, length in HASH_SHAPES:
        xs = _inputs((n, length), rng)
        cold = time_graph(digest, xs, 24)
        warm = time_graph(digest, xs[:1], 50)
        packets = length // 32
        rows.append({"kernel": "highwayhash256", "n": n, "L": length,
                     "cold_us": 1e3 * cold, "warm_us": 1e3 * warm,
                     "cold_ns_per_packet": 1e6 * cold / packets,
                     "warm_ns_per_packet": 1e6 * warm / packets})
        print(f"highwayhash256 [{n}, {length}]: cold {1e3 * cold:.1f} us "
              f"({1e6 * cold / packets:.1f} ns/packet), warm "
              f"{1e3 * warm:.1f} us ({1e6 * warm / packets:.1f} ns/packet)",
              flush=True)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # plain GF matmul exact
    rng = np.random.default_rng(0)
    clock_before = sm_clock_ghz()
    print(f"SM clock {clock_before:.3f} GHz", flush=True)
    rows = sweep_gf(rng) + sweep_hash(rng)
    clock_after = sm_clock_ghz()
    print(f"SM clock {clock_after:.3f} GHz", flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "sm_clock_ghz": [clock_before, clock_after],
                      "sweep": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
