"""S3 Object Lock, the port's copy of minio_tpu/bucket/objectlock.py
(MinIO's cmd/bucket-object-lock.go and pkg/bucket/object/lock/lock.go):
WORM retention and legal hold.

At the bucket level an ObjectLockConfiguration XML (stored as
`object_lock_xml` in the bucket metadata) may carry a default retention
rule (Mode and Days or Years) that new writes take. At the object level
the retention mode, the retain-until date and the legal hold live in the
version's user metadata under the standard `x-amz-object-lock-*` keys,
and every delete path enforces them: COMPLIANCE is never deleted before
its date, GOVERNANCE only with the bypass header (and, on the port, the
caller's s3:BypassGovernanceRetention), and a legal hold blocks a delete
whatever the retention.
"""

from __future__ import annotations

import calendar
import time
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from datetime import datetime

META_MODE = "x-amz-object-lock-mode"
META_RETAIN_UNTIL = "x-amz-object-lock-retain-until-date"
META_LEGAL_HOLD = "x-amz-object-lock-legal-hold"
LOCK_META_KEYS = (META_MODE, META_RETAIN_UNTIL, META_LEGAL_HOLD)

HDR_BYPASS_GOVERNANCE = "x-amz-bypass-governance-retention"

MODE_GOVERNANCE = "GOVERNANCE"
MODE_COMPLIANCE = "COMPLIANCE"

_NS = "{http://s3.amazonaws.com/doc/2006-03-01/}"


def _find_text(el, tag: str) -> str:
    child = el.find(f"{_NS}{tag}")
    if child is None:
        child = el.find(tag)
    return (child.text or "").strip() if child is not None else ""


def _iter_tag(root, tag: str):
    for el in root.iter():
        if el.tag.endswith(tag):
            yield el


@dataclass
class LockConfig:
    """A parsed bucket ObjectLockConfiguration."""

    enabled: bool = False
    mode: str = ""  # the default rule's mode, "" without a rule
    days: int = 0
    years: int = 0

    @classmethod
    def parse(cls, xml_text: str) -> "LockConfig":
        if not xml_text:
            return cls()
        root = ET.fromstring(xml_text)
        cfg = cls(enabled=_find_text(root, "ObjectLockEnabled") == "Enabled")
        for rule in _iter_tag(root, "DefaultRetention"):
            cfg.mode = _find_text(rule, "Mode").upper()
            days = _find_text(rule, "Days")
            years = _find_text(rule, "Years")
            cfg.days = int(days) if days.isdigit() else 0
            cfg.years = int(years) if years.isdigit() else 0
            if cfg.mode not in (MODE_GOVERNANCE, MODE_COMPLIANCE):
                raise ValueError(f"unknown default retention mode {cfg.mode}")
            if bool(cfg.days) == bool(cfg.years):
                raise ValueError("default retention needs Days xor Years")
        return cfg

    def default_retention_meta(self, now_ns: int | None = None) -> dict:
        """The metadata of a new write under the default rule ({} when
        there is none)."""
        if not (self.enabled and self.mode):
            return {}
        now = (now_ns or time.time_ns()) / 1e9
        seconds = self.days * 86400 + self.years * 365 * 86400
        return {META_MODE: self.mode,
                META_RETAIN_UNTIL: iso8601_utc(now + seconds)}


def iso8601_utc(epoch_s: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(epoch_s))


def parse_iso8601(s: str) -> float:
    """A retain-until date (Z or an offset) in epoch seconds."""
    s = s.strip()
    for fmt in ("%Y-%m-%dT%H:%M:%SZ", "%Y-%m-%dT%H:%M:%S.%fZ"):
        try:
            return calendar.timegm(time.strptime(s, fmt))
        except ValueError:
            continue
    # The offset form, e.g. 2026-01-01T00:00:00+00:00.
    return datetime.fromisoformat(s).timestamp()


def extract_lock_headers(headers: dict) -> dict:
    """The x-amz-object-lock-* request headers, checked, as metadata
    (objectlock.ParseObjectLockHeaders)."""
    mode = headers.get(META_MODE, "").upper()
    until = headers.get(META_RETAIN_UNTIL, "")
    hold = headers.get(META_LEGAL_HOLD, "").upper()
    out: dict = {}
    if bool(mode) != bool(until):
        raise ValueError(
            "x-amz-object-lock-mode and retain-until-date must both be set")
    if mode:
        if mode not in (MODE_GOVERNANCE, MODE_COMPLIANCE):
            raise ValueError(f"invalid object lock mode {mode!r}")
        try:
            until_s = parse_iso8601(until)
        except Exception as exc:  # noqa: BLE001
            raise ValueError(f"invalid retain until date {until!r}") from exc
        if until_s <= time.time():
            raise ValueError("retain until date must be in the future")
        out[META_MODE] = mode
        out[META_RETAIN_UNTIL] = iso8601_utc(until_s)
    if hold:
        if hold not in ("ON", "OFF"):
            raise ValueError(f"invalid legal hold {hold!r}")
        out[META_LEGAL_HOLD] = hold
    return out


def retention_state(user_defined: dict) -> tuple[str, float]:
    """(mode, retain-until in epoch seconds) of a version; ("", 0) when
    it is not retained."""
    mode = (user_defined.get(META_MODE) or "").upper()
    until = user_defined.get(META_RETAIN_UNTIL) or ""
    if mode not in (MODE_GOVERNANCE, MODE_COMPLIANCE) or not until:
        return "", 0.0
    try:
        return mode, parse_iso8601(until)
    except Exception:  # noqa: BLE001 - a corrupt date is not enforceable
        return "", 0.0


def legal_hold_on(user_defined: dict) -> bool:
    return (user_defined.get(META_LEGAL_HOLD) or "").upper() == "ON"


def check_deletable(user_defined: dict, bypass_governance: bool) -> str | None:
    """None when the version may be deleted, else the reason
    (enforceRetentionBypassForDelete, cmd/bucket-object-lock.go:85)."""
    if legal_hold_on(user_defined):
        return "object is under legal hold"
    mode, until = retention_state(user_defined)
    if not mode or until <= time.time():
        return None
    if mode == MODE_COMPLIANCE:
        return "object is locked in COMPLIANCE mode until " + iso8601_utc(until)
    if bypass_governance:
        return None
    return "object is locked in GOVERNANCE mode until " + iso8601_utc(until)


def retention_xml(mode: str, until_iso: str) -> bytes:
    root = ET.Element("Retention",
                      xmlns="http://s3.amazonaws.com/doc/2006-03-01/")
    ET.SubElement(root, "Mode").text = mode
    ET.SubElement(root, "RetainUntilDate").text = until_iso
    return ET.tostring(root, xml_declaration=True, encoding="UTF-8")


def legal_hold_xml(status: str) -> bytes:
    root = ET.Element("LegalHold",
                      xmlns="http://s3.amazonaws.com/doc/2006-03-01/")
    ET.SubElement(root, "Status").text = status
    return ET.tostring(root, xml_declaration=True, encoding="UTF-8")


def parse_retention_body(body: bytes) -> tuple[str, str]:
    """A PUT ?retention body as (mode, until_iso); ValueError if bad."""
    root = ET.fromstring(body)
    mode = ""
    until = ""
    for el in _iter_tag(root, "Mode"):
        mode = (el.text or "").strip().upper()
    for el in _iter_tag(root, "RetainUntilDate"):
        until = (el.text or "").strip()
    if mode not in (MODE_GOVERNANCE, MODE_COMPLIANCE):
        raise ValueError(f"invalid retention mode {mode!r}")
    until_s = parse_iso8601(until)
    if until_s <= time.time():
        raise ValueError("retain until date must be in the future")
    return mode, iso8601_utc(until_s)


def parse_legal_hold_body(body: bytes) -> str:
    root = ET.fromstring(body)
    status = ""
    for el in _iter_tag(root, "Status"):
        status = (el.text or "").strip().upper()
    if status not in ("ON", "OFF"):
        raise ValueError(f"invalid legal hold status {status!r}")
    return status
