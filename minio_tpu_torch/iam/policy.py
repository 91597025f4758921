"""The policy engine, the port's copy of minio_tpu/iam/policy.py
(MinIO's pkg/iam/policy and pkg/bucket/policy): statements of Effect,
Action, Resource and a subset of Condition operators, parsed from the
AWS policy JSON and evaluated with explicit Deny over any Allow over an
implicit deny; and the canned policies. It needs only the standard
library.
"""

from __future__ import annotations

import fnmatch
import json
from dataclasses import dataclass, field

# S3 actions this server understands (subset of pkg/iam/policy/action.go).
ALL_ACTIONS = "s3:*"

ADMIN_ACTION_PREFIX = "admin:"


def _as_list(v) -> list:
    if v is None:
        return []
    if isinstance(v, list):
        return v
    return [v]


def match_wildcard(pattern: str, value: str) -> bool:
    """AWS-style wildcard match: '*' any run, '?' one char."""
    return fnmatch.fnmatchcase(value, pattern)


@dataclass
class Args:
    """Evaluation inputs (ref pkg/iam/policy/policy.go Args)."""

    account: str = ""
    action: str = ""
    bucket: str = ""
    object: str = ""
    conditions: dict = field(default_factory=dict)  # key -> [values]
    is_owner: bool = False
    groups: list = field(default_factory=list)


class ConditionFunc:
    """One condition operator block, e.g. StringEquals: {key: [vals]}."""

    _OPS = {
        "StringEquals", "StringNotEquals", "StringLike", "StringNotLike",
        "StringEqualsIgnoreCase", "StringNotEqualsIgnoreCase",
        "NumericEquals", "NumericNotEquals", "NumericLessThan",
        "NumericGreaterThan", "Bool",
    }

    def __init__(self, op: str, kv: dict):
        if op not in self._OPS:
            raise ValueError(f"unsupported condition operator {op!r}")
        self.op = op
        self.kv = {k: [str(x) for x in _as_list(v)] for k, v in kv.items()}

    def evaluate(self, ctx: dict) -> bool:
        for key, want in self.kv.items():
            have = [str(x) for x in _as_list(ctx.get(key))]
            ok = self._eval_one(want, have)
            if not ok:
                return False
        return True

    def _eval_one(self, want: list[str], have: list[str]) -> bool:
        op = self.op
        if op in ("StringEquals", "StringEqualsIgnoreCase"):
            fold = op.endswith("IgnoreCase")
            hs = {h.lower() for h in have} if fold else set(have)
            ws = {w.lower() for w in want} if fold else set(want)
            return bool(hs) and hs <= ws
        if op in ("StringNotEquals", "StringNotEqualsIgnoreCase"):
            fold = op.endswith("IgnoreCase")
            hs = {h.lower() for h in have} if fold else set(have)
            ws = {w.lower() for w in want} if fold else set(want)
            return not (hs & ws)
        if op == "StringLike":
            return any(match_wildcard(w, h) for w in want for h in have)
        if op == "StringNotLike":
            return not any(match_wildcard(w, h) for w in want for h in have)
        if op == "Bool":
            return have and have[0].lower() in [w.lower() for w in want]
        try:
            hv = float(have[0]) if have else None
            wv = float(want[0]) if want else None
        except ValueError:
            return False
        if hv is None or wv is None:
            return False
        if op == "NumericEquals":
            return hv == wv
        if op == "NumericNotEquals":
            return hv != wv
        if op == "NumericLessThan":
            return hv < wv
        if op == "NumericGreaterThan":
            return hv > wv
        return False


@dataclass
class Statement:
    effect: str  # "Allow" | "Deny"
    actions: list[str]
    resources: list[str]
    conditions: list[ConditionFunc] = field(default_factory=list)
    sid: str = ""

    @classmethod
    def parse(cls, d: dict) -> "Statement":
        effect = d.get("Effect", "")
        if effect not in ("Allow", "Deny"):
            raise ValueError(f"invalid Effect {effect!r}")
        actions = [str(a) for a in _as_list(d.get("Action"))]
        if not actions:
            raise ValueError("statement missing Action")
        resources = [
            r[len("arn:aws:s3:::"):] if r.startswith("arn:aws:s3:::") else r
            for r in (str(x) for x in _as_list(d.get("Resource")))
        ]
        conds = [
            ConditionFunc(op, kv)
            for op, kv in (d.get("Condition") or {}).items()
        ]
        return cls(effect, actions, resources, conds, d.get("Sid", ""))

    def _match_action(self, action: str) -> bool:
        return any(
            match_wildcard(a, action) or a == "*" for a in self.actions
        )

    def _match_resource(self, bucket: str, object_: str) -> bool:
        if not self.resources:
            # Admin-action statements carry no S3 resource.
            return True
        if object_:
            # Object-level request: only object ARNs (bucket/key patterns)
            # may match. A bare-bucket Resource must NOT grant object
            # actions (AWS + ref pkg/iam/policy resource-set semantics).
            res = f"{bucket}/{object_}"
            return any(match_wildcard(r, res) for r in self.resources)
        return any(match_wildcard(r, bucket) for r in self.resources)

    def is_allowed(self, args: Args) -> bool | None:
        """None = no match; True/False = Allow/Deny verdict."""
        if not self._match_action(args.action):
            return None
        if not self._match_resource(args.bucket, args.object):
            return None
        for c in self.conditions:
            if not c.evaluate(args.conditions):
                return None
        return self.effect == "Allow"


@dataclass
class Policy:
    statements: list[Statement] = field(default_factory=list)
    version: str = "2012-10-17"
    id: str = ""

    @classmethod
    def parse(cls, raw: str | bytes | dict) -> "Policy":
        d = raw if isinstance(raw, dict) else json.loads(raw)
        stmts = [Statement.parse(s) for s in _as_list(d.get("Statement"))]
        return cls(stmts, d.get("Version", "2012-10-17"), d.get("Id", ""))

    def to_dict(self) -> dict:
        return {
            "Version": self.version,
            "Statement": [
                {
                    "Effect": s.effect,
                    "Action": s.actions,
                    "Resource": [f"arn:aws:s3:::{r}" for r in s.resources],
                    **(
                        {"Condition": {c.op: c.kv for c in s.conditions}}
                        if s.conditions else {}
                    ),
                }
                for s in self.statements
            ],
        }

    def is_allowed(self, args: Args) -> bool:
        """Explicit Deny wins; else any Allow; else implicit deny."""
        allowed = False
        for s in self.statements:
            v = s.is_allowed(args)
            if v is False:
                return False
            if v is True:
                allowed = True
        return allowed

    def merge(self, other: "Policy") -> "Policy":
        return Policy(self.statements + other.statements)


def _canned(name: str, statements: list[dict]) -> Policy:
    p = Policy.parse({"Statement": statements})
    p.id = name
    return p


# Canned policies (ref pkg/iam/policy/{admin-,}*.go built-ins).
CANNED_POLICIES: dict[str, Policy] = {
    "readonly": _canned("readonly", [{
        "Effect": "Allow",
        "Action": ["s3:GetBucketLocation", "s3:GetObject"],
        "Resource": ["arn:aws:s3:::*"],
    }]),
    "writeonly": _canned("writeonly", [{
        "Effect": "Allow",
        "Action": ["s3:PutObject"],
        "Resource": ["arn:aws:s3:::*"],
    }]),
    "readwrite": _canned("readwrite", [{
        "Effect": "Allow",
        "Action": ["s3:*"],
        "Resource": ["arn:aws:s3:::*"],
    }]),
    "diagnostics": _canned("diagnostics", [{
        "Effect": "Allow",
        "Action": [
            "admin:ServerInfo", "admin:ServerTrace", "admin:Profiling",
            "admin:Prometheus", "admin:TopLocksInfo", "admin:DataUsageInfo",
            "admin:OBDInfo",
        ],
        "Resource": ["arn:aws:s3:::*"],
    }]),
    "consoleAdmin": _canned("consoleAdmin", [{
        "Effect": "Allow",
        "Action": ["admin:*"],
    }, {
        "Effect": "Allow",
        "Action": ["s3:*"],
        "Resource": ["arn:aws:s3:::*"],
    }]),
}
