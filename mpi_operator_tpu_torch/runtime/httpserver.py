"""HTTP frontend over the in-memory apiserver — the envtest analog (the
port's copy of ``mpi_operator_tpu/runtime/httpserver.py``; pure Python,
no torch).

Serves the Kubernetes REST API (core/v1, batch/v1, coordination.k8s.io,
scheduling.x-k8s.io, and the kubeflow.org TPUJob CRD, GPU variant) over
real HTTP on localhost, backed by :class:`InMemoryAPIServer`. This is
what lets the
*real-cluster* REST backend (:mod:`.kube`) — request signing, path
mapping, chunked watch streaming, 410 resume — be exercised end to end
with no cluster, the same discipline as the reference's envtest tier
(the upstream mpi-operator's v2/test/integration/main_test.go:42-59: a
real apiserver, no kubelet).

Faithful bits:
- list responses carry the collection ``metadata.resourceVersion``;
- watches honor ``resourceVersion=`` by replaying from a bounded event
  history (the apiserver's watch cache), stream newline-delimited JSON
  in chunked encoding, honor ``timeoutSeconds``, and send BOOKMARK
  events;
- a watch from a compacted resourceVersion gets ``410 Gone`` — set
  ``history_limit`` low (or call ``compact()``) to test client resume;
- errors come back as ``Status`` objects with the apiserver's
  code/reason vocabulary;
- optional bearer-token auth (401 without it), so client auth headers
  are actually exercised.
"""

from __future__ import annotations

import base64
import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlsplit

from .apiserver import (
    RESOURCES,
    ApiError,
    InMemoryAPIServer,
    WatchEvent,
)

# /api/v1/... (core) and /apis/{group}/{version}/... (everything else),
# optionally namespaced, optionally named, optional status subresource.
_CORE = re.compile(
    r"^/api/v1(?:/namespaces/(?P<ns>[^/]+))?/(?P<plural>[a-z]+)"
    r"(?:/(?P<name>[^/]+))?(?:/(?P<sub>status))?$"
)
_GROUP = re.compile(
    r"^/apis/(?P<gv>[^/]+/[^/]+)(?:/namespaces/(?P<ns>[^/]+))?"
    r"/(?P<plural>[a-z]+)(?:/(?P<name>[^/]+))?(?:/(?P<sub>status))?$"
)


class APIServerFrontend:
    """Runs the HTTP server; owns the watch-cache history."""

    def __init__(self, api: InMemoryAPIServer, *, host: str = "127.0.0.1",
                 port: int = 0, token: Optional[str] = None,
                 history_limit: int = 4096):
        self.api = api
        self.token = token
        self.history_limit = history_limit
        # Fault/behavior knobs for client-hardening tests:
        # throttle_429 > 0: the next N non-watch requests get 429 with a
        # Retry-After header (apiserver priority-and-fairness shedding).
        self.throttle_429 = 0
        self.throttle_hits = 0
        # expire_continue: every list continuation token 410s (etcd
        # compacted the snapshot) — clients must restart the list.
        self.expire_continue = False
        self._knob_lock = threading.Lock()
        # Watch cache: rv-ordered (rv, WatchEvent) history per resource,
        # fed by one persistent watch per resource. ``_compacted`` is
        # the continuity watermark: the rv of the newest event ever
        # DROPPED from the history (by the ring limit or compact()).
        # A watch rv below it must 410 even when the history is empty —
        # an empty cache means "cannot prove continuity", not "nothing
        # happened". (Conflating the two left a reconnecting idle watch
        # silently stale forever; found by the JAX package's watch
        # losslessness property test.)
        self._history: dict[str, list[tuple[int, WatchEvent]]] = {
            plural: [] for plural in RESOURCES
        }
        self._compacted: dict[str, int] = {plural: 0 for plural in RESOURCES}
        self._hist_lock = threading.Condition()
        self._recorders = [api.watch(plural) for plural in RESOURCES]
        self._recorder_thread = threading.Thread(
            target=self._record_loop, daemon=True, name="watchcache"
        )
        self._stopped = False

        handler = type("Handler", (_Handler,), {"frontend": self})
        self.server = ThreadingHTTPServer((host, port), handler)
        self.server.daemon_threads = True
        self._serve_thread = threading.Thread(
            target=self.server.serve_forever, daemon=True, name="apiserver-http"
        )

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "APIServerFrontend":
        self._recorder_thread.start()
        self._serve_thread.start()
        return self

    @property
    def url(self) -> str:
        host, port = self.server.server_address[:2]
        return f"http://{host}:{port}"

    def stop(self) -> None:
        self._stopped = True
        for w in self._recorders:
            w.stop()
        with self._hist_lock:
            self._hist_lock.notify_all()
        self.server.shutdown()
        self.server.server_close()

    # -- watch cache -----------------------------------------------------

    def _record_loop(self) -> None:
        while not self._stopped:
            got = False
            for w in self._recorders:
                for event in w.drain():
                    got = True
                    rv = int(event.object["metadata"]["resourceVersion"])
                    with self._hist_lock:
                        hist = self._history[event.resource]
                        hist.append((rv, event))
                        if len(hist) > self.history_limit:
                            drop = len(hist) - self.history_limit
                            self._compacted[event.resource] = max(
                                self._compacted[event.resource],
                                hist[drop - 1][0],
                            )
                            del hist[:drop]
                        self._hist_lock.notify_all()
            if not got:
                time.sleep(0.005)

    def compact(self) -> None:
        """Drop all history — every watch resume from an old rv now 410s
        (simulates etcd compaction for resume tests)."""
        with self._hist_lock:
            for plural, hist in self._history.items():
                if hist:
                    self._compacted[plural] = max(
                        self._compacted[plural], hist[-1][0]
                    )
                hist.clear()

    def oldest_rv(self, resource: str) -> Optional[int]:
        with self._hist_lock:
            hist = self._history[resource]
            return hist[0][0] if hist else None

    def events_since(self, resource: str, rv: int,
                     timeout: float) -> Optional[list[tuple[int, WatchEvent]]]:
        """History entries with event-rv > rv; blocks up to ``timeout``
        for the first one. None signals 410 (rv is before the retained
        window)."""
        deadline = time.monotonic() + timeout
        with self._hist_lock:
            while True:
                hist = self._history[resource]
                # Re-checked every wakeup: an event arriving *while we
                # block* can evict the window our rv needs. The
                # watermark is exact — the newest rv ever dropped from
                # this resource's history — and covers the
                # empty-history case (compaction with an idle stream
                # must still 410, or the client waits forever on a
                # provably stale rv). No adjacency heuristic: rvs come
                # from one global counter, so per-resource gaps are
                # normal, not evidence of loss.
                if rv < self._compacted[resource]:
                    return None
                out = [(erv, e) for erv, e in hist if erv > rv]
                if out or self._stopped:
                    return out
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return []
                self._hist_lock.wait(min(remaining, 0.25))


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    frontend: APIServerFrontend = None

    # -- plumbing --------------------------------------------------------

    def log_message(self, *args):  # quiet
        pass

    def _send_json(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_status_error(self, code: int, reason: str, message: str) -> None:
        self._send_json(code, {
            "apiVersion": "v1", "kind": "Status", "status": "Failure",
            "code": code, "reason": reason, "message": message,
        })

    def _send_api_error(self, err: ApiError) -> None:
        self._send_status_error(err.code, err.reason, str(err))

    def _throttled(self) -> bool:
        """429 shedding knob: consume one slot if armed (watches exempt —
        the real server's APF treats long-running requests separately)."""
        fe = self.frontend
        with fe._knob_lock:
            if fe.throttle_429 <= 0:
                return False
            fe.throttle_429 -= 1
            fe.throttle_hits += 1
        self.send_response(429)
        body = json.dumps({
            "apiVersion": "v1", "kind": "Status", "status": "Failure",
            "code": 429, "reason": "TooManyRequests",
            "message": "the server is currently unable to handle the "
                       "request — try again later",
        }).encode()
        self.send_header("Content-Type", "application/json")
        self.send_header("Retry-After", "0")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
        return True

    def _authorized(self) -> bool:
        token = self.frontend.token
        if token is None:
            return True
        got = self.headers.get("Authorization", "")
        if got == f"Bearer {token}":
            return True
        self._send_status_error(401, "Unauthorized", "bad or missing token")
        return False

    def _route(self):
        """Parse path -> (resource, ns, name, sub, query) or None (404)."""
        parts = urlsplit(self.path)
        m = _CORE.match(parts.path) or _GROUP.match(parts.path)
        if not m:
            return None
        plural = m.group("plural")
        rt = RESOURCES.get(plural)
        if rt is None:
            return None
        gv = m.groupdict().get("gv")
        expect = "v1" if gv is None else gv
        if rt.api_version != expect:
            return None
        query = {k: v[0] for k, v in parse_qs(parts.query).items()}
        return plural, m.group("ns"), m.group("name"), m.group("sub"), query

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(length) if length else b""
        return json.loads(raw) if raw else {}

    @staticmethod
    def _parse_selector(q: dict) -> Optional[dict]:
        sel = q.get("labelSelector")
        if not sel:
            return None
        out = {}
        for term in sel.split(","):
            k, _, v = term.partition("=")
            out[k] = v
        return out

    # -- verbs -----------------------------------------------------------

    def do_GET(self):  # noqa: N802
        if not self._authorized():
            return
        route = self._route()
        if route is None:
            self._send_status_error(404, "NotFound", f"path {self.path}")
            return
        plural, ns, name, _sub, query = route
        api = self.frontend.api
        try:
            if query.get("watch") == "true" and not name:
                self._watch(plural, ns, query)
                return
            if self._throttled():
                return
            if name:
                self._send_json(200, api.get(plural, ns or "default", name))
            else:
                self._list(plural, ns, query)
        except ApiError as e:
            self._send_api_error(e)

    def _list(self, plural: str, ns: Optional[str], query: dict) -> None:
        """List with ``limit``/``continue`` chunking (apiserver
        pagination). The continue token encodes the last-returned key;
        ``expire_continue`` makes every continuation 410 to exercise the
        client's restart path."""
        items = self.frontend.api.list(plural, ns, self._parse_selector(query))
        items.sort(key=lambda o: (o["metadata"].get("namespace", ""),
                                  o["metadata"]["name"]))
        cont = query.get("continue")
        if cont:
            if self.frontend.expire_continue:
                self._send_status_error(
                    410, "Expired",
                    "the provided continue parameter is too old",
                )
                return
            try:
                after = tuple(json.loads(base64.b64decode(cont)))
            except (ValueError, TypeError):
                after = None
            if (after is None or len(after) != 2
                    or not all(isinstance(p, str) for p in after)):
                self._send_status_error(
                    400, "BadRequest", "malformed continue token"
                )
                return
            items = [
                o for o in items
                if (o["metadata"].get("namespace", ""),
                    o["metadata"]["name"]) > after
            ]
        rt = RESOURCES[plural]
        # Collection rv: the newest rv across the store (next()-1
        # would race writers; max over items is the same contract
        # the real watch cache provides — "at least this fresh").
        rv = max(
            (int(o["metadata"]["resourceVersion"]) for o in items),
            default=self._newest_known_rv(),
        )
        meta: dict = {"resourceVersion": str(rv)}
        try:
            limit = int(query.get("limit") or 0)
        except ValueError:
            limit = 0
        if limit and len(items) > limit:
            last = items[limit - 1]
            meta["remainingItemCount"] = len(items) - limit
            items = items[:limit]
            meta["continue"] = base64.b64encode(json.dumps([
                last["metadata"].get("namespace", ""),
                last["metadata"]["name"],
            ]).encode()).decode()
        self._send_json(200, {
            "apiVersion": rt.api_version,
            "kind": rt.kind + "List",
            "metadata": meta,
            "items": items,
        })

    def _newest_known_rv(self) -> int:
        # The compaction watermark counts as "known": a list served
        # right after a compaction must not hand out a collection rv
        # below it, or the client's follow-up watch 410s, relists to the
        # same stale rv, and livelocks (410 -> relist -> 410 ...).
        newest = 0
        with self.frontend._hist_lock:
            for hist in self.frontend._history.values():
                if hist:
                    newest = max(newest, hist[-1][0])
            newest = max(newest, *self.frontend._compacted.values())
        return newest

    def do_POST(self):  # noqa: N802
        if not self._authorized() or self._throttled():
            return
        route = self._route()
        if route is None:
            self._send_status_error(404, "NotFound", f"path {self.path}")
            return
        plural, ns, name, _sub, _query = route
        if name:
            self._send_status_error(405, "MethodNotAllowed", "POST to object")
            return
        try:
            obj = self._read_body()
            if ns:
                obj.setdefault("metadata", {}).setdefault("namespace", ns)
            self._send_json(201, self.frontend.api.create(plural, obj))
        except ApiError as e:
            self._send_api_error(e)
        except ValueError as e:
            self._send_status_error(400, "BadRequest", str(e))

    def do_PUT(self):  # noqa: N802
        if not self._authorized() or self._throttled():
            return
        route = self._route()
        if route is None or not route[2]:
            self._send_status_error(404, "NotFound", f"path {self.path}")
            return
        plural, ns, name, sub, _query = route
        try:
            obj = self._read_body()
            meta = obj.setdefault("metadata", {})
            if ns:
                meta.setdefault("namespace", ns)
            meta.setdefault("name", name)
            api = self.frontend.api
            if sub == "status":
                self._send_json(200, api.update_status(plural, obj))
            else:
                self._send_json(200, api.update(plural, obj))
        except ApiError as e:
            self._send_api_error(e)
        except ValueError as e:
            self._send_status_error(400, "BadRequest", str(e))

    def do_DELETE(self):  # noqa: N802
        if not self._authorized() or self._throttled():
            return
        route = self._route()
        if route is None or not route[2]:
            self._send_status_error(404, "NotFound", f"path {self.path}")
            return
        plural, ns, name, _sub, _query = route
        try:
            self._read_body()  # DeleteOptions, accepted and ignored
            self.frontend.api.delete(plural, ns or "default", name)
            self._send_json(200, {
                "apiVersion": "v1", "kind": "Status", "status": "Success",
            })
        except ApiError as e:
            self._send_api_error(e)

    # -- watch streaming -------------------------------------------------

    def _watch(self, plural: str, ns: Optional[str], query: dict) -> None:
        try:
            rv = int(query.get("resourceVersion") or 0)
        except ValueError:
            self._send_status_error(400, "BadRequest", "bad resourceVersion")
            return
        timeout = min(float(query.get("timeoutSeconds") or 300), 3600.0)
        bookmarks = query.get("allowWatchBookmarks") == "true"

        first = self.frontend.events_since(plural, rv, timeout=0)
        if first is None:
            self._send_status_error(
                410, "Expired",
                f"resourceVersion {rv} is too old (compacted)",
            )
            return

        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

        deadline = time.monotonic() + timeout
        last_bookmark = time.monotonic()
        try:
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                batch = self.frontend.events_since(
                    plural, rv, timeout=min(remaining, 1.0)
                )
                if batch is None:
                    self._write_chunk(json.dumps({
                        "type": "ERROR",
                        "object": {
                            "apiVersion": "v1", "kind": "Status",
                            "status": "Failure", "code": 410,
                            "reason": "Expired",
                            "message": f"resourceVersion {rv} compacted",
                        },
                    }))
                    break
                for erv, event in batch:
                    obj = event.object
                    if ns and obj["metadata"].get("namespace", "") != ns:
                        rv = erv
                        continue
                    self._write_chunk(json.dumps(
                        {"type": event.type, "object": obj}
                    ))
                    rv = erv
                if bookmarks and time.monotonic() - last_bookmark > 5.0:
                    rt = RESOURCES[plural]
                    self._write_chunk(json.dumps({
                        "type": "BOOKMARK",
                        "object": {
                            "apiVersion": rt.api_version, "kind": rt.kind,
                            "metadata": {"resourceVersion": str(rv)},
                        },
                    }))
                    last_bookmark = time.monotonic()
            self.wfile.write(b"0\r\n\r\n")  # end chunked stream
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away

    def _write_chunk(self, line: str) -> None:
        data = (line + "\n").encode()
        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()
