"""Bucket lifecycle (ILM) rules, the port's copy of
minio_tpu/bucket/lifecycle.py (MinIO's pkg/bucket/lifecycle: lifecycle.go,
rule.go, filter.go, expiration.go, transition.go, noncurrentversion.go):
expiration and transition by Days or Date, Prefix, Tag and And filters,
ExpiredObjectDeleteMarker, NoncurrentDays with NewerNoncurrentVersions,
and AbortIncompleteMultipartUpload, validated as PutBucketLifecycle
validates them.

The scanner reads the rules through the decision surface at the bottom
(`expire_current`, `noncurrent_policy`, `wants_delete_marker_cleanup`,
`abort_mpu_after_days`). The port has no remote tiers: a Transition is
parsed and validated, `transition_tier_due` answers for it, and the S3
handlers refuse a document that holds one.
"""

from __future__ import annotations

import datetime
import urllib.parse
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field

DAY_S = 86400.0

# The metadata key of an object's tags (api/handlers.py TAGS_META_KEY),
# which Tag filters read.
TAGS_META_KEY = "x-mtpu-internal-tags"


class LifecycleError(ValueError):
    """An invalid lifecycle document (MalformedXML or InvalidArgument at
    the API)."""


def _parse_iso_date(text: str) -> float:
    """An ISO 8601 date in epoch seconds; it must be midnight UTC
    (expiration.go:42-58 refuses any other time)."""
    t = text.strip().replace("Z", "+00:00")
    try:
        dt = datetime.datetime.fromisoformat(t)
    except ValueError as exc:
        raise LifecycleError(f"bad lifecycle date {text!r}") from exc
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=datetime.timezone.utc)
    if (dt.hour, dt.minute, dt.second, dt.microsecond) != (0, 0, 0, 0):
        raise LifecycleError(
            "lifecycle date must be midnight UTC (ref expiration.go)"
        )
    return dt.timestamp()


@dataclass
class RuleFilter:
    """Filter and Filter>And: a prefix and exact-match tags (filter.go,
    and.go)."""

    prefix: str = ""
    tags: dict = field(default_factory=dict)

    def matches(self, name: str, obj_tags: dict) -> bool:
        if self.prefix and not name.startswith(self.prefix):
            return False
        for k, v in self.tags.items():
            if obj_tags.get(k) != v:
                return False
        return True


@dataclass
class Rule:
    rule_id: str = ""
    enabled: bool = True
    filter: RuleFilter = field(default_factory=RuleFilter)
    # Expiration
    expire_days: int | None = None
    expire_date: float | None = None  # epoch seconds, midnight UTC
    expired_object_delete_marker: bool = False
    # Transition
    transition_days: int | None = None
    transition_date: float | None = None
    transition_tier: str = ""
    # NoncurrentVersionExpiration
    noncurrent_days: int | None = None
    newer_noncurrent_versions: int | None = None
    # AbortIncompleteMultipartUpload
    abort_mpu_days: int | None = None

    def has_action(self) -> bool:
        return any((
            self.expire_days is not None, self.expire_date is not None,
            self.expired_object_delete_marker,
            self.transition_days is not None,
            self.transition_date is not None,
            self.noncurrent_days is not None,
            self.newer_noncurrent_versions is not None,
            self.abort_mpu_days is not None,
        ))

    def validate(self):
        if self.expire_days is not None and self.expire_date is not None:
            raise LifecycleError(
                "Expiration Days and Date are mutually exclusive"
            )
        if (self.transition_days is not None
                and self.transition_date is not None):
            raise LifecycleError(
                "Transition Days and Date are mutually exclusive"
            )
        if self.expire_days is not None and self.expire_days <= 0:
            raise LifecycleError("Expiration Days must be positive")
        if self.transition_days is not None and self.transition_days < 0:
            raise LifecycleError("Transition Days must be >= 0")
        if ((self.transition_days is not None
             or self.transition_date is not None)
                and not self.transition_tier):
            raise LifecycleError("Transition requires StorageClass")
        if (self.newer_noncurrent_versions is not None
                and self.noncurrent_days is None):
            raise LifecycleError(
                "NewerNoncurrentVersions requires NoncurrentDays"
            )
        if self.noncurrent_days is not None and self.noncurrent_days <= 0:
            # noncurrentversion.go: zero or less would expire every
            # noncurrent version on sight.
            raise LifecycleError("NoncurrentDays must be positive")
        if (self.newer_noncurrent_versions is not None
                and self.newer_noncurrent_versions <= 0):
            raise LifecycleError("NewerNoncurrentVersions must be positive")
        if self.abort_mpu_days is not None and self.abort_mpu_days <= 0:
            raise LifecycleError("DaysAfterInitiation must be positive")
        if self.expired_object_delete_marker and self.filter.tags:
            # lifecycle.go Validate: markers carry no tags, so their
            # cleanup cannot be tag-filtered.
            raise LifecycleError(
                "ExpiredObjectDeleteMarker cannot be used with Tag filters"
            )
        if not self.has_action():
            raise LifecycleError(
                f"rule {self.rule_id or '(unnamed)'} has no action"
            )


def _expiry_due(days: int | None, date: float | None,
                mod_time_ns: int, now_s: float) -> bool:
    """A Days rule fires at the first UTC midnight after mod_time + days
    (ExpectedExpiryTime); a Date rule once `now` passes the date."""
    if date is not None:
        return now_s >= date
    if days is None:
        return False
    due = (mod_time_ns / 1e9) + days * DAY_S
    # Rounded up to the next UTC midnight.
    due = (int(due // DAY_S) + (1 if due % DAY_S else 0)) * DAY_S
    return now_s >= due


def object_tags(user_defined: dict) -> dict:
    """The tag set stored in an object's metadata."""
    raw = (user_defined or {}).get(TAGS_META_KEY, "")
    return dict(urllib.parse.parse_qsl(raw, keep_blank_values=True))


def _int_field(raw: str | None, what: str) -> int | None:
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError as exc:
        raise LifecycleError(f"{what} must be an integer, got "
                             f"{raw!r}") from exc


class Lifecycle:
    """A parsed rule set and the scanner's decision surface. `rules`
    keeps every parsed rule (validate() checks the Disabled ones too);
    the decisions walk only the Enabled ones."""

    def __init__(self, rules: list[Rule]):
        self.rules = rules
        self.active = [r for r in rules if r.enabled]

    def __bool__(self) -> bool:
        return bool(self.active)

    # --- parsing (lifecycle.go ParseLifecycleConfig) ---

    @classmethod
    def parse(cls, xml_text: str, best_effort: bool = False) -> "Lifecycle":
        """Strict by default (PutBucketLifecycle). With `best_effort`
        (the scanner reading stored XML, which an older or looser write
        path may have accepted) each rule that fails to parse is dropped
        alone, so one bad rule cannot turn off the bucket's others."""
        if not xml_text:
            return cls([])
        try:
            root = ET.fromstring(xml_text)
        except ET.ParseError as exc:
            raise LifecycleError(f"malformed lifecycle XML: {exc}") from exc
        ns = ""
        if root.tag.startswith("{"):
            ns = root.tag[: root.tag.index("}") + 1]
        rules = []
        for rel in root.iter(f"{ns}Rule"):
            try:
                rules.append(cls._parse_rule(rel, ns))
            except LifecycleError:
                if not best_effort:
                    raise
        if len(rules) > 1000:
            raise LifecycleError("more than 1000 lifecycle rules")
        return cls(rules)

    @classmethod
    def _parse_rule(cls, rel, ns) -> Rule:
        def text(el, path, default=None):
            qualified = "/".join(f"{ns}{seg}" for seg in path.split("/"))
            v = el.findtext(qualified)
            return v if v is not None else default

        r = Rule(
            rule_id=text(rel, "ID", "") or "",
            enabled=(text(rel, "Status", "") == "Enabled"),
            filter=cls._parse_filter(rel, ns),
        )
        date = text(rel, "Expiration/Date")
        r.expire_days = _int_field(text(rel, "Expiration/Days"),
                                   "Expiration Days")
        r.expire_date = _parse_iso_date(date) if date else None
        r.expired_object_delete_marker = (
            (text(rel, "Expiration/ExpiredObjectDeleteMarker", "")
             or "").strip().lower() == "true"
        )
        date = text(rel, "Transition/Date")
        r.transition_days = _int_field(text(rel, "Transition/Days"),
                                       "Transition Days")
        r.transition_date = _parse_iso_date(date) if date else None
        r.transition_tier = text(rel, "Transition/StorageClass", "") or ""
        r.noncurrent_days = _int_field(
            text(rel, "NoncurrentVersionExpiration/NoncurrentDays"),
            "NoncurrentDays",
        )
        r.newer_noncurrent_versions = _int_field(
            text(rel,
                 "NoncurrentVersionExpiration/NewerNoncurrentVersions"),
            "NewerNoncurrentVersions",
        )
        r.abort_mpu_days = _int_field(
            text(rel, "AbortIncompleteMultipartUpload/DaysAfterInitiation"),
            "DaysAfterInitiation",
        )
        return r

    @staticmethod
    def _parse_filter(rel, ns) -> RuleFilter:
        f = RuleFilter()
        fel = rel.find(f"{ns}Filter")
        if fel is None:
            # The legacy top-level <Prefix> (rule.go).
            f.prefix = rel.findtext(f"{ns}Prefix") or ""
            return f
        and_el = fel.find(f"{ns}And")
        direct_prefix = fel.findtext(f"{ns}Prefix")
        direct_tag = fel.find(f"{ns}Tag")
        if and_el is not None:
            if direct_prefix is not None or direct_tag is not None:
                raise LifecycleError(
                    "Filter must hold exactly one of Prefix, Tag, And"
                )
            f.prefix = and_el.findtext(f"{ns}Prefix") or ""
            for tag in and_el.findall(f"{ns}Tag"):
                k = tag.findtext(f"{ns}Key") or ""
                if not k:
                    raise LifecycleError("Tag filter requires Key")
                if k in f.tags:
                    raise LifecycleError(f"duplicate Tag key {k!r} in And")
                f.tags[k] = tag.findtext(f"{ns}Value") or ""
        elif direct_tag is not None:
            if direct_prefix is not None:
                raise LifecycleError(
                    "Filter must hold exactly one of Prefix, Tag, And"
                )
            k = direct_tag.findtext(f"{ns}Key") or ""
            if not k:
                raise LifecycleError("Tag filter requires Key")
            f.tags[k] = direct_tag.findtext(f"{ns}Value") or ""
        else:
            f.prefix = direct_prefix or ""
        return f

    def validate(self):
        """The validation of PutBucketLifecycle (lifecycle.go Validate):
        every rule valid, no rule ID twice."""
        if not self.rules:
            raise LifecycleError("lifecycle must have at least one rule")
        seen = set()
        for r in self.rules:
            r.validate()
            if r.rule_id:
                if r.rule_id in seen:
                    raise LifecycleError(f"duplicate rule ID {r.rule_id!r}")
                seen.add(r.rule_id)

    # --- the decision surface (ComputeAction) ---

    def _matching(self, name: str, tags: dict):
        return (r for r in self.active if r.filter.matches(name, tags))

    def expire_current(self, name: str, user_defined: dict,
                       mod_time_ns: int, now_s: float) -> bool:
        """Whether the current version expires (Days or Date rules)."""
        tags = object_tags(user_defined)
        return any(
            _expiry_due(r.expire_days, r.expire_date, mod_time_ns, now_s)
            for r in self._matching(name, tags)
        )

    def transition_tier_due(self, name: str, user_defined: dict,
                            mod_time_ns: int, now_s: float) -> str | None:
        """The tier of a transition rule that is due, else None."""
        tags = object_tags(user_defined)
        for r in self._matching(name, tags):
            if r.transition_tier and _expiry_due(
                r.transition_days, r.transition_date, mod_time_ns, now_s
            ):
                return r.transition_tier
        return None

    def noncurrent_policy(self, name: str) -> tuple[int | None, int]:
        """(noncurrent_days, newer noncurrent versions to keep): the
        tightest matching NoncurrentVersionExpiration. A noncurrent
        version is seen through the latest, so tag filters do not apply
        (lifecycle.go NoncurrentVersionsExpirationLimit)."""
        days: int | None = None
        keep = 0
        for r in self.active:
            if r.filter.prefix and not name.startswith(r.filter.prefix):
                continue
            if r.filter.tags:
                continue  # a tag-filtered rule misses noncurrent versions
            if r.noncurrent_days is None and \
                    r.newer_noncurrent_versions is None:
                continue
            if r.noncurrent_days is not None:
                days = r.noncurrent_days if days is None else \
                    min(days, r.noncurrent_days)
            if r.newer_noncurrent_versions is not None:
                keep = max(keep, r.newer_noncurrent_versions)
        return days, keep

    def wants_delete_marker_cleanup(self, name: str) -> bool:
        return any(
            r.expired_object_delete_marker for r in self.active
            if not r.filter.tags
            and (not r.filter.prefix or name.startswith(r.filter.prefix))
        )

    def any_noncurrent_or_marker_rules(self) -> bool:
        return any(
            r.noncurrent_days is not None
            or r.newer_noncurrent_versions is not None
            or r.expired_object_delete_marker
            for r in self.active
        )

    def abort_mpu_after_days(self, name: str) -> int | None:
        """The smallest matching DaysAfterInitiation, else None."""
        best: int | None = None
        for r in self.active:
            if r.abort_mpu_days is None:
                continue
            if r.filter.prefix and not name.startswith(r.filter.prefix):
                continue
            best = r.abort_mpu_days if best is None else \
                min(best, r.abort_mpu_days)
        return best

    def any_abort_mpu_rules(self) -> bool:
        return any(r.abort_mpu_days is not None for r in self.active)
