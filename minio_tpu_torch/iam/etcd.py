"""The etcd back end of the IAM store, the port's copy of
minio_tpu/iam/etcd.py (MinIO's cmd/etcd.go and cmd/iam-etcd-store.go):
each IAM blob is one etcd key under `<path_prefix>config/iam/`, and a
watch on that prefix reloads the in-memory IAM of every server the
moment any server writes (MinIO's iamWatch loop over
clientv3.WatchChan).

The client speaks etcd v3's JSON gateway, the HTTP API every etcd
serves on its client port, over the standard library's http.client:

    POST /v3/kv/put          {"key": b64, "value": b64}
    POST /v3/kv/range        {"key": b64, "range_end": b64, ...}
    POST /v3/kv/deleterange  {"key": b64, "range_end": b64}
    POST /v3/watch           {"create_request": {"key": b64, ...}}
                             -> streamed JSON results

This module is host code and reaches no kernel.
"""

from __future__ import annotations

import base64
import http.client
import json
import threading
import urllib.parse

from .store import IAMStore


class EtcdError(RuntimeError):
    pass


def _b64(s: bytes) -> str:
    return base64.b64encode(s).decode()


def _unb64(s: str) -> bytes:
    return base64.b64decode(s)


def _prefix_range_end(key: bytes) -> bytes:
    """etcd prefix query: range_end = key with last byte + 1
    (clientv3.GetPrefixRangeEnd)."""
    for i in range(len(key) - 1, -1, -1):
        if key[i] < 0xFF:
            return key[:i] + bytes([key[i] + 1])
    return b"\x00"


class EtcdKV:
    """Minimal etcd v3 KV+watch client over the JSON gateway."""

    def __init__(self, endpoints: list[str], timeout: float = 10.0):
        if not endpoints:
            raise EtcdError("missing etcd endpoints")
        self.endpoints = [
            ep if "://" in ep else f"http://{ep}"
            for ep in (e.strip() for e in endpoints) if ep
        ]
        self.timeout = timeout

    def _post(self, path: str, obj: dict) -> dict:
        body = json.dumps(obj).encode()
        last: Exception | None = None
        for ep in self.endpoints:
            u = urllib.parse.urlsplit(ep)
            cls = (http.client.HTTPSConnection if u.scheme == "https"
                   else http.client.HTTPConnection)
            try:
                conn = cls(u.netloc, timeout=self.timeout)
                conn.request("POST", path, body=body,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
                conn.close()
            except (OSError, http.client.HTTPException) as exc:
                last = exc
                continue
            if resp.status // 100 != 2:
                raise EtcdError(
                    f"etcd {path}: {resp.status} "
                    f"{data.decode('utf-8', 'replace')[:200]}"
                )
            return json.loads(data or b"{}")
        raise EtcdError(f"no etcd endpoint reachable: {last}")

    # --- KV ---

    def put(self, key: bytes, value: bytes):
        self._post("/v3/kv/put", {"key": _b64(key), "value": _b64(value)})

    def get(self, key: bytes) -> bytes | None:
        resp = self._post("/v3/kv/range", {"key": _b64(key)})
        kvs = resp.get("kvs") or []
        return _unb64(kvs[0]["value"]) if kvs else None

    def get_prefix(self, prefix: bytes) -> dict[bytes, bytes]:
        resp = self._post("/v3/kv/range", {
            "key": _b64(prefix),
            "range_end": _b64(_prefix_range_end(prefix)),
        })
        return {
            _unb64(kv["key"]): _unb64(kv.get("value", ""))
            for kv in resp.get("kvs") or []
        }

    def delete(self, key: bytes):
        self._post("/v3/kv/deleterange", {"key": _b64(key)})

    def delete_prefix(self, prefix: bytes):
        self._post("/v3/kv/deleterange", {
            "key": _b64(prefix),
            "range_end": _b64(_prefix_range_end(prefix)),
        })

    # --- watch (streaming) ---

    def watch_prefix(self, prefix: bytes, on_event, stop_event) -> None:
        """Blocking watch loop: call `on_event(type, key, value)` per
        change under prefix until stop_event is set. Reconnects on
        stream errors (MinIO's watch loop does the same,
        iam-etcd-store.go watch retry), rotating through the endpoint
        list across attempts so watch-driven IAM invalidation fails
        over like the KV path — pinned to endpoints[0], a single dead
        node would silently stop invalidation cluster-wide while
        reads/writes kept working."""
        attempt = 0
        while not stop_event.is_set():
            try:
                self._watch_once(prefix, on_event, stop_event,
                                 self.endpoints[attempt % len(self.endpoints)])
            except (OSError, http.client.HTTPException, EtcdError,
                    ValueError):
                attempt += 1
                if stop_event.wait(0.2):
                    return
            else:
                # Clean stream close (server-side rotation): retry the
                # SAME endpoint first — it answered fine until now.
                continue

    def _watch_once(self, prefix: bytes, on_event, stop_event,
                    ep: str | None = None):
        ep = ep or self.endpoints[0]
        u = urllib.parse.urlsplit(ep)
        cls = (http.client.HTTPSConnection if u.scheme == "https"
               else http.client.HTTPConnection)
        conn = cls(u.netloc, timeout=1.0)
        try:
            req = json.dumps({"create_request": {
                "key": _b64(prefix),
                "range_end": _b64(_prefix_range_end(prefix)),
            }}).encode()
            conn.request("POST", "/v3/watch", body=req,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            buf = b""
            while not stop_event.is_set():
                try:
                    chunk = resp.read1(65536)
                except TimeoutError:
                    continue  # idle stream: poll the stop flag
                if not chunk:
                    return  # stream closed: reconnect
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    if not line.strip():
                        continue
                    msg = json.loads(line)
                    result = msg.get("result") or {}
                    for ev in result.get("events") or []:
                        kv = ev.get("kv") or {}
                        on_event(
                            ev.get("type", "PUT"),
                            _unb64(kv.get("key", "")),
                            _unb64(kv.get("value", "")),
                        )
        finally:
            conn.close()


class EtcdIAMBackend(IAMStore):
    """IAMStore over etcd keys `<path_prefix>config/iam/<path>`
    (iam-etcd-store.go's iamConfigPrefix layout)."""

    def __init__(self, kv: EtcdKV, path_prefix: str = ""):
        super().__init__()
        self.kv = kv
        self.prefix = (path_prefix.strip("/") + "/" if path_prefix.strip("/")
                       else "") + "config/iam/"

    def _key(self, path: str) -> bytes:
        return (self.prefix + path).encode()

    def save(self, path: str, data: bytes):
        self.kv.put(self._key(path), data)

    def load(self, path: str) -> bytes | None:
        return self.kv.get(self._key(path))

    def delete(self, path: str):
        self.kv.delete(self._key(path))

    def list(self, prefix: str) -> list[str]:
        plen = len(self.prefix)
        return sorted(
            k.decode()[plen:]
            for k in self.kv.get_prefix(self._key(prefix))
        )

    # --- watch-driven invalidation ---

    def start_watch(self, on_change) -> "EtcdIAMWatcher":
        """Spawn the invalidation watcher: `on_change()` fires after any
        IAM key changes (debounced per event batch)."""
        return EtcdIAMWatcher(self, on_change).start()


class EtcdIAMWatcher:
    """Watch thread + a debouncing reload thread: a burst of N events
    (bulk user provisioning, a delete's two writes) coalesces into ONE
    on_change() — each reload is a full O(entities) backend re-read
    under the IAM lock, so per-event reloads would stall auth."""

    DEBOUNCE_S = 0.05

    def __init__(self, backend: EtcdIAMBackend, on_change):
        self.backend = backend
        self.on_change = on_change
        self._stop = threading.Event()
        self._dirty = threading.Event()
        self._threads: list[threading.Thread] = []

    def start(self) -> "EtcdIAMWatcher":
        def watch_loop():
            self.backend.kv.watch_prefix(
                self.backend.prefix.encode(),
                lambda _t, _k, _v: self._dirty.set(),
                self._stop,
            )

        def reload_loop():
            while not self._stop.is_set():
                if not self._dirty.wait(timeout=0.5):
                    continue
                # Let the burst finish landing, then reload once.
                self._stop.wait(self.DEBOUNCE_S)
                self._dirty.clear()
                if self._stop.is_set():
                    return
                try:
                    self.on_change()
                except Exception:  # noqa: BLE001 — keep watching
                    pass

        for name, fn in (("mtpu-iam-etcd-watch", watch_loop),
                         ("mtpu-iam-etcd-reload", reload_loop)):
            t = threading.Thread(target=fn, name=name, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self):
        self._stop.set()
        self._dirty.set()
        for t in self._threads:
            t.join(timeout=3)
