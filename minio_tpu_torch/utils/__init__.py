"""Shared helpers of the port."""

from __future__ import annotations


def parse_duration_s(text: str, default: float | None = None) -> float | None:
    """'10s', '100ms', '1m', '1h' or bare seconds -> seconds; `default`
    when unparseable (the Go-duration subset minio_tpu's config keys
    use)."""
    t = (text or "").strip().lower()
    mult = 1.0
    for suffix, m in (("ms", 0.001), ("s", 1.0), ("m", 60.0),
                      ("h", 3600.0)):
        if t.endswith(suffix):
            t = t[: -len(suffix)]
            mult = m
            break
    try:
        return float(t) * mult
    except ValueError:
        return default


def ceil_frac(numerator: int, denominator: int) -> int:
    """Ceiling division matching the reference's ceilFrac (cmd/utils.go)."""
    if denominator == 0:
        return 0
    neg = (numerator < 0) != (denominator < 0)
    numerator, denominator = abs(numerator), abs(denominator)
    out = (numerator + denominator - 1) // denominator
    return -out if neg else out
