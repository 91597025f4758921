"""The admin heal route, the port's copy of AdminHandlers.heal of
minio_tpu/api/admin.py (MinIO's /minio/admin/v3/heal,
cmd/admin-heal-ops.go). The rest of the admin API is not ported: its
routes answer NotImplemented.
"""

from __future__ import annotations

import json

from ..background.healseq import (
    AllHealState,
    HealAlreadyRunning,
    HealNoSuchSequence,
    HealOverlap,
    make_io_gate,
)
from ..iam.policy import Args
from .errors import S3Error
from .handlers import Response

ADMIN_PREFIX = "/minio/admin/v3"

# minio_tpu's heal settings with no heal configuration: a sequence waits
# (up to 1 s an object) while HEAL_MAX_IO requests are in flight, and
# pauses after each object it heals (max_sleep 1 s, of which a sequence
# takes 1/100).
HEAL_MAX_IO = 10
HEAL_MAX_SLEEP_S = 0.01


class AdminHandlers:
    """`inflight` returns the S3 requests in flight, which a heal
    sequence yields to."""

    def __init__(self, object_layer, iam, inflight):
        self.ol = object_layer
        self.iam = iam
        self.inflight = inflight
        self.heal_state = AllHealState()

    def route(self, ctx) -> str:
        rest = ctx.path[len(ADMIN_PREFIX):].strip("/")
        if ctx.method == "POST" and rest.split("/", 1)[0] == "heal":
            return "heal"
        raise S3Error("NotImplemented", f"admin {ctx.method} /{rest}")

    def authorize(self, auth_result) -> None:
        if auth_result.is_anonymous:
            raise S3Error("AccessDenied", "admin API requires signature")
        if not self.iam.is_allowed(Args(account=auth_result.access_key,
                                        action="admin:Heal")):
            raise S3Error("AccessDenied",
                          f"{auth_result.access_key} admin:Heal")

    @staticmethod
    def _json(obj, status: int = 200) -> Response:
        return Response(status, {"Content-Type": "application/json"},
                        json.dumps(obj).encode())

    def heal(self, ctx) -> Response:
        """POST /minio/admin/v3/heal/<bucket>/<prefix>:

        - no clientToken: start a sequence and return its token at once;
        - clientToken=<t>: poll its status, taking the buffered items;
        - forceStop=true: stop every sequence under the path;
        - forceStart=true: replace a running sequence on the path.
        With no bucket it rewrites format.json on every disk."""
        rest = ctx.path[len(ADMIN_PREFIX) + len("/heal"):].strip("/")
        bucket, _, prefix = rest.partition("/")
        if not bucket:
            return self._json({"healSequence": "format",
                               "result": self.ol.heal_format()})
        if ctx.qdict.get("forceStop", "") == "true":
            return self._json({"stopped": self.heal_state.stop(bucket,
                                                                prefix)})
        token = ctx.qdict.get("clientToken", "")
        if token:
            try:
                return self._json(self.heal_state.status(bucket, prefix,
                                                         token))
            except HealNoSuchSequence:
                raise S3Error(
                    "InvalidArgument",
                    f"no heal sequence for {bucket}/{prefix} "
                    f"with that token") from None
        # A bucket that does not exist is a 404 now, not a sequence that
        # fails where no one looks.
        try:
            self.ol.get_bucket_info(bucket)
        except Exception as exc:  # noqa: BLE001 - any failure is a 404
            raise S3Error("NoSuchBucket", f"{bucket}: {exc}") from exc
        try:
            seq = self.heal_state.launch(
                self.ol, bucket, prefix,
                force_start=ctx.qdict.get("forceStart", "") == "true",
                remove_dangling=ctx.qdict.get("remove", "") == "true",
                dry_run=ctx.qdict.get("dryRun", "") == "true",
                io_gate=make_io_gate(self.inflight, HEAL_MAX_IO),
                max_sleep_s=HEAL_MAX_SLEEP_S,
            )
        except (HealAlreadyRunning, HealOverlap) as exc:
            raise S3Error("InvalidArgument", str(exc)) from exc
        return self._json({"clientToken": seq.token, "clientAddress": "",
                           "startTime": seq.start_time})
