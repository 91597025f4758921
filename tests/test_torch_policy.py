"""The port's policy engine (minio_tpu_torch/iam/policy.py) against
minio_tpu's (minio_tpu/iam/policy.py): the same verdict for seeded
policies and requests (wildcards in actions and resources, explicit Deny
over Allow, the condition operators, object against bucket resources),
the same documents back from to_dict, the same canned policies, and the
same exception class for each malformed document.
"""

import json
import random

import pytest

from minio_tpu.iam import policy as jax_policy
from minio_tpu_torch.iam import policy

ACTIONS = ["s3:GetObject", "s3:PutObject", "s3:DeleteObject",
           "s3:ListBucket", "s3:GetBucketPolicy", "s3:PutObjectTagging",
           "s3:ListBucketVersions", "admin:Heal"]
ACTION_PATTERNS = ACTIONS + ["s3:*", "*", "s3:Get*", "s3:*Object",
                             "s3:?etObject", "admin:*"]
BUCKETS = ["photos", "logs", "ver", "dst"]
KEYS = ["", "a.jpg", "public/x", "public/deep/y", "private/z", "a?b", "*"]
RESOURCES = ["photos", "photos/*", "*", "logs/public/*", "dst/public/*",
             "ver/a.jpg", "ver", "*/public/*", "dst/?ublic/x",
             "arn:aws:s3:::photos/*"]
CONDITIONS = [
    ("StringEquals", {"aws:username": ["alice"]}),
    ("StringNotEquals", {"aws:username": "bob"}),
    ("StringLike", {"s3:prefix": ["public/*", "home/?"]}),
    ("StringNotLike", {"s3:prefix": "private/*"}),
    ("StringEqualsIgnoreCase", {"aws:username": "ALICE"}),
    ("StringNotEqualsIgnoreCase", {"aws:username": ["Bob"]}),
    ("NumericEquals", {"s3:max-keys": "10"}),
    ("NumericNotEquals", {"s3:max-keys": 10}),
    ("NumericLessThan", {"s3:max-keys": "100"}),
    ("NumericGreaterThan", {"s3:max-keys": "5"}),
    ("Bool", {"aws:SecureTransport": "true"}),
]
CONTEXTS = [{}, {"aws:username": ["alice"]}, {"aws:username": "bob"},
            {"s3:prefix": ["public/a"]}, {"s3:prefix": "home/x"},
            {"s3:prefix": ["private/q"]}, {"s3:max-keys": ["10"]},
            {"s3:max-keys": "7"}, {"s3:max-keys": "abc"},
            {"aws:SecureTransport": ["true"]},
            {"aws:SecureTransport": "false", "aws:username": "ALICE"}]


def _statement(rng: random.Random) -> dict:
    st = {"Effect": rng.choice(["Allow", "Allow", "Deny"]),
          "Action": rng.sample(ACTION_PATTERNS, rng.randint(1, 3))}
    if rng.random() < 0.5:
        st["Action"] = st["Action"][0]  # a bare string
    if rng.random() < 0.9:
        res = [f"arn:aws:s3:::{r}" if not r.startswith("arn:") else r
               for r in rng.sample(RESOURCES, rng.randint(1, 3))]
        st["Resource"] = res[0] if rng.random() < 0.3 else res
    if rng.random() < 0.4:
        st["Condition"] = dict(rng.sample(CONDITIONS, rng.randint(1, 2)))
    if rng.random() < 0.3:
        st["Sid"] = f"s{rng.randint(0, 99)}"
    return st


def _document(rng: random.Random) -> dict:
    stmts = [_statement(rng) for _ in range(rng.randint(1, 4))]
    doc = {"Version": "2012-10-17",
           "Statement": stmts[0] if len(stmts) == 1 and rng.random() < 0.5
           else stmts}
    if rng.random() < 0.3:
        doc["Id"] = "seeded"
    return doc


def _args(mod, rng: random.Random):
    return mod.Args(account=rng.choice(["", "alice"]),
                    action=rng.choice(ACTIONS), bucket=rng.choice(BUCKETS),
                    object=rng.choice(KEYS),
                    conditions=rng.choice(CONTEXTS))


@pytest.mark.parametrize("seed", range(8))
def test_seeded_policies_give_the_same_verdicts(seed):
    rng = random.Random(seed)
    for _ in range(40):
        doc = _document(rng)
        raw = json.dumps(doc) if rng.random() < 0.5 else doc
        mine, ref = policy.Policy.parse(raw), jax_policy.Policy.parse(raw)
        assert mine.to_dict() == ref.to_dict()
        for _ in range(30):
            state = rng.getstate()
            got = mine.is_allowed(_args(policy, rng))
            rng.setstate(state)
            want = ref.is_allowed(_args(jax_policy, rng))
            assert got == want, (doc, rng.getstate()[1][0])


def test_deny_wins_and_wildcards():
    doc = {"Statement": [
        {"Effect": "Allow", "Action": "s3:*", "Resource": "arn:aws:s3:::b/*"},
        {"Effect": "Deny", "Action": "s3:Delete*",
         "Resource": "arn:aws:s3:::b/keep/*"}]}
    for mod in (policy, jax_policy):
        p = mod.Policy.parse(doc)
        allowed = [p.is_allowed(mod.Args(action=a, bucket="b", object=o))
                   for a, o in (("s3:GetObject", "x"),
                                ("s3:DeleteObject", "x"),
                                ("s3:DeleteObject", "keep/x"),
                                ("s3:ListBucket", ""))]
        # An object resource grants no bucket-level action.
        assert allowed == [True, True, False, False], mod.__name__
    assert policy.match_wildcard("a*c?", "abbbcd") and \
        not policy.match_wildcard("a*c?", "abc")


def test_canned_policies_are_minio_tpus():
    assert sorted(policy.CANNED_POLICIES) == \
        sorted(jax_policy.CANNED_POLICIES)
    for name, p in policy.CANNED_POLICIES.items():
        ref = jax_policy.CANNED_POLICIES[name]
        assert (p.id, p.to_dict()) == (ref.id, ref.to_dict())


@pytest.mark.parametrize("raw", [
    "{not json", "", "[]", "null", '"text"',
    '{"Statement": [{"Effect": "Maybe", "Action": "s3:*"}]}',
    '{"Statement": [{"Effect": "Allow"}]}',
    '{"Statement": [{"Effect": "Allow", "Action": []}]}',
    '{"Statement": [{"Effect": "Allow", "Action": "s3:*", '
    '"Condition": {"DateEquals": {"k": "v"}}}]}',
    '{"Statement": ["not a statement"]}',
    b'{"Statement": {"Effect": "Deny", "Action": "s3:*"}}',
])
def test_malformed_documents_raise_the_same_class(raw):
    def outcome(mod):
        try:
            return "parsed", mod.Policy.parse(raw).to_dict()
        except Exception as exc:  # noqa: BLE001 - its class is compared
            return "raised", type(exc).__name__

    assert outcome(policy) == outcome(jax_policy)
