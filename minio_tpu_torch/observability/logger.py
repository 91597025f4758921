"""The server's logger, the port's copy of minio_tpu's Logger
(observability/trace.py; MinIO's cmd/logger LogIf and logonce.go, and
the console ring of cmd/consolelogger.go): JSON lines on a stream, each
(error type, context) at most once an interval, and the last RING
entries kept for a reader."""

from __future__ import annotations

import json
import sys
import threading
import time
from collections import deque


class Logger:
    RING = 512

    def __init__(self, stream=None):
        self._stream = stream or sys.stderr
        self._mu = threading.Lock()
        self._seen: dict[str, float] = {}  # guarded-by: _mu
        self._ring: deque = deque(maxlen=self.RING)  # guarded-by: _mu

    def log(self, level: str, message: str, **fields) -> None:
        entry = {"level": level,
                 "time": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
                 "message": message}
        entry.update(fields)
        # One lock over the ring and the write: interleaved writes would
        # tear the JSON lines.
        with self._mu:
            self._ring.append(entry)
            try:
                self._stream.write(json.dumps(entry) + "\n")
            except ValueError:
                pass  # the stream is closed (teardown); the ring keeps it

    def recent(self, n: int = 100) -> list[dict]:
        with self._mu:
            return list(self._ring)[-n:]

    def info(self, message: str, **fields) -> None:
        self.log("INFO", message, **fields)

    def error(self, message: str, **fields) -> None:
        self.log("ERROR", message, **fields)

    def log_once_if(self, err: Exception | None, context: str = "",
                    interval_s: float = 30.0) -> None:
        """Log `err` at most once an interval for its (type, context)."""
        if err is None:
            return
        key = f"{type(err).__name__}:{context}"
        now = time.time()
        with self._mu:
            if now - self._seen.get(key, 0.0) < interval_s:
                return
            self._seen[key] = now
        self.error(str(err), context=context, error=type(err).__name__)
