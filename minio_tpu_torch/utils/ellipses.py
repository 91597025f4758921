"""Ellipses endpoint patterns, the port's copy of
minio_tpu/utils/ellipses.py (MinIO's pkg/ellipses and
cmd/endpoint-ellipses.go): `/data{1...16}` expands to the endpoint list,
and the erasure set size is chosen by GCD.
"""

from __future__ import annotations

import itertools
import re

_PATTERN = re.compile(r"\{(\d+)\.\.\.(\d+)\}")

# Valid erasure set sizes, preferred largest first
# (ref cmd/endpoint-ellipses.go setSizes: 4..16).
SET_SIZES = list(range(4, 17))


def has_ellipses(*args: str) -> bool:
    return any(_PATTERN.search(a) for a in args)


def expand(pattern: str) -> list[str]:
    """Expand every {a...b} range in the pattern (cartesian product,
    left-to-right major order like the reference)."""
    spans = list(_PATTERN.finditer(pattern))
    if not spans:
        return [pattern]
    ranges = []
    for m in spans:
        lo, hi = int(m.group(1)), int(m.group(2))
        if hi < lo:
            raise ValueError(f"invalid range {m.group(0)}")
        width = len(m.group(1)) if m.group(1).startswith("0") else 0
        ranges.append([str(i).zfill(width) for i in range(lo, hi + 1)])
    out = []
    for combo in itertools.product(*ranges):
        s = pattern
        for m, val in zip(spans, combo):
            s = s.replace(m.group(0), val, 1)
        out.append(s)
    return out


def greatest_common_divisor(values: list[int]) -> int:
    import math

    g = values[0]
    for v in values[1:]:
        g = math.gcd(g, v)
    return g


def choose_set_drive_count(total_drives: int,
                           custom: int | None = None) -> int:
    """Pick the erasure set size: the largest valid divisor of the drive
    count (ref possibleSetCountsWithSymmetry + commonSetDriveCount)."""
    if custom is not None:
        if custom not in SET_SIZES or total_drives % custom != 0:
            raise ValueError(
                f"set drive count {custom} incompatible with "
                f"{total_drives} drives"
            )
        return custom
    for size in sorted(SET_SIZES, reverse=True):
        if total_drives % size == 0:
            return size
    raise ValueError(
        f"no valid erasure set size divides {total_drives} drives "
        f"(need a multiple of one of {SET_SIZES})"
    )


def parse_server_endpoints(args: list[str],
                           set_drive_count: int | None = None) -> dict:
    """args (each possibly with ellipses) -> layout dict:
    {pools: [[endpoint,...]], set_drive_count: N}.

    Each ellipses arg is one pool (the reference treats each ellipses arg
    set as a pool, cmd/endpoint-ellipses.go CreateServerEndpoints). Plain
    args without ellipses form a SINGLE pool together — the reference's
    legacy path (`minio server /d1 /d2 /d3 /d4` is one 4-drive set,
    cmd/endpoint-ellipses.go:30-49 GetAllSets when ellipses absent)."""
    if not has_ellipses(*args):
        pools = [list(args)]
    else:
        pools = [expand(arg) for arg in args]
    counts = [len(p) for p in pools]
    if set_drive_count is not None:
        # Custom size must divide EVERY pool, not just the first.
        for i, c in enumerate(counts):
            if c % set_drive_count != 0:
                raise ValueError(
                    f"pool {i + 1} has {c} drives, not a multiple of "
                    f"--set-drive-count {set_drive_count}"
                )
        sdc = choose_set_drive_count(
            greatest_common_divisor(counts), set_drive_count
        )
    elif len(set(counts)) > 1:
        # heterogeneous pools: size by GCD across pools
        sdc = choose_set_drive_count(greatest_common_divisor(counts))
    else:
        sdc = (
            choose_set_drive_count(counts[0])
            if counts[0] >= 4 else counts[0]
        )
    return {"pools": pools, "set_drive_count": sdc}
