"""Real-cluster Kubernetes REST backend (the port's copy of
``mpi_operator_tpu/runtime/kube.py``).

The peer of :class:`~mpi_operator_tpu_torch.runtime.apiserver.InMemoryAPIServer`
that speaks HTTP to an actual kube-apiserver. Same duck-typed surface
(``create/get/list/update/update_status/delete/watch``), same error
types, so the controller, informers, leader elector, and clients run
unchanged against a live cluster. Pure Python: it imports no torch.

Reference analogs (the upstream mpi-operator's v2 tree):
- config loading (kubeconfig / in-cluster):
  cmd/mpi-operator/app/server.go:103-109
- the four clientsets this replaces:
  cmd/mpi-operator/app/server.go:262-285
- informer watches against the cluster:
  pkg/controller/mpi_job_controller.go:249-347

Implementation notes (stdlib only — no kubernetes pip package):

- One short-lived ``http.client`` connection per CRUD call; a long-lived
  streaming connection per watch.
- Watches keep a private mirror of the collection. The stream starts at
  the mirror's list resourceVersion, so ``watch()`` + a later ``list()``
  can never lose an update (the informer's watch-then-list discipline,
  informer.py:117-149). On ``410 Gone`` (resourceVersion compacted) the
  watch re-lists and emits synthetic ADDED/MODIFIED/DELETED events from
  the diff against its mirror — transparent resume, the client-go
  Reflector's relist behavior.
- Errors map from the apiserver's ``Status`` body by reason first, HTTP
  code second, onto the same exception types the in-memory server
  raises.
"""

from __future__ import annotations

import base64
import json
import os
import random
import socket
import ssl
import tempfile
import threading
import time
import urllib.parse
from dataclasses import dataclass, field
from typing import Optional

from .apiserver import (
    ADDED,
    DELETED,
    MODIFIED,
    RESOURCES,
    AlreadyExistsError,
    ApiError,
    ConflictError,
    InvalidError,
    NotFoundError,
    WatchEvent,
)
from ..utils.logging import get_logger
from ..version import VERSION

log = get_logger("kube")

BOOKMARK = "BOOKMARK"
ERROR = "ERROR"

SERVICE_ACCOUNT_ROOT = "/var/run/secrets/kubernetes.io/serviceaccount"

# The port's own user agent: an apiserver's audit log tells the GPU
# operator from the TPU one.
USER_AGENT = f"tpu-operator-gpu/{VERSION}"


class ForbiddenError(ApiError):
    code = 403
    reason = "Forbidden"


class UnauthorizedError(ApiError):
    code = 401
    reason = "Unauthorized"


class ServerError(ApiError):
    """5xx / transport-level failure talking to the apiserver."""

    code = 500
    reason = "InternalError"


class TooManyRequestsError(ApiError):
    """429 after the client's retry budget is exhausted."""

    code = 429
    reason = "TooManyRequests"


_ERRORS_BY_REASON = {
    "NotFound": NotFoundError,
    "AlreadyExists": AlreadyExistsError,
    "Conflict": ConflictError,
    "Invalid": InvalidError,
    "Forbidden": ForbiddenError,
    "Unauthorized": UnauthorizedError,
}
_ERRORS_BY_CODE = {
    404: NotFoundError,
    409: ConflictError,
    422: InvalidError,
    403: ForbiddenError,
    401: UnauthorizedError,
    429: TooManyRequestsError,
}


class _TokenBucket:
    """Client-side flow control (client-go's TokenBucketRateLimiter analog,
    rest.Config QPS/Burst — reference options.go:69-70). ``qps <= 0``
    disables throttling. Callers over the rate queue fairly: the bucket
    balance goes negative and each further caller's wait grows by 1/qps."""

    def __init__(self, qps: float, burst: int):
        self.qps = float(qps)
        self.burst = max(1, int(burst))
        self._balance = float(self.burst)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def acquire(self) -> float:
        """Take one token, sleeping until it is due; returns the wait."""
        if self.qps <= 0:
            return 0.0
        with self._lock:
            now = time.monotonic()
            self._balance = min(
                float(self.burst),
                self._balance + (now - self._last) * self.qps,
            )
            self._last = now
            self._balance -= 1.0
            wait = 0.0 if self._balance >= 0 else -self._balance / self.qps
        if wait > 0:
            time.sleep(wait)
        return wait


# ---------------------------------------------------------------------------
# Config loading (kubeconfig + in-cluster)
# ---------------------------------------------------------------------------


@dataclass
class RestConfig:
    """Connection config for one apiserver (client-go rest.Config analog)."""

    host: str  # e.g. https://10.0.0.1:6443 or http://127.0.0.1:8001
    token: Optional[str] = None
    ca_file: Optional[str] = None
    client_cert_file: Optional[str] = None
    client_key_file: Optional[str] = None
    verify_tls: bool = True
    namespace: str = "default"  # default namespace from context / SA
    # Rotating credentials (exec plugins, projected SA tokens): called to
    # re-acquire the bearer token when ``token_expiry`` (epoch seconds)
    # passes or a request gets 401 — client-go's refresh behavior.
    token_refresher: Optional[object] = field(default=None, repr=False)
    token_expiry: Optional[float] = None
    # Files this config wrote itself (inline *-data fields); kept so the
    # tempfiles outlive the config object, and removed at process exit
    # (they can hold private keys).
    _owned_files: list = field(default_factory=list, repr=False)

    def refresh_token(self) -> bool:
        """Re-acquire the bearer token; returns True if it changed."""
        if self.token_refresher is None:
            return False
        old = self.token
        self.token, self.token_expiry = self.token_refresher()
        return self.token != old

    def current_token(self) -> Optional[str]:
        if (self.token_refresher is not None
                and self.token_expiry is not None
                and time.time() > self.token_expiry - 60):
            self.refresh_token()
        return self.token

    def ssl_context(self) -> Optional[ssl.SSLContext]:
        if not self.host.startswith("https"):
            return None
        if self.verify_tls:
            ctx = ssl.create_default_context(cafile=self.ca_file)
        else:
            ctx = ssl._create_unverified_context()  # noqa: S323
        if self.client_cert_file:
            ctx.load_cert_chain(self.client_cert_file, self.client_key_file)
        return ctx


def _materialize(data_b64: Optional[str], path: Optional[str],
                 owned: list) -> Optional[str]:
    """kubeconfig fields come as either a file path or inline base64 data;
    ssl wants paths, so inline data lands in a 0600 tempfile that is
    removed at process exit (it can hold a private key)."""
    if path:
        return path
    if not data_b64:
        return None
    # NamedTemporaryFile creates 0600 by default.
    f = tempfile.NamedTemporaryFile(mode="wb", suffix=".pem", delete=False)
    f.write(base64.b64decode(data_b64))
    f.close()
    owned.append(f.name)
    _cleanup_at_exit(f.name)
    return f.name


def _cleanup_at_exit(path: str) -> None:
    import atexit

    def rm():
        try:
            os.unlink(path)
        except OSError:
            pass

    atexit.register(rm)


def load_kubeconfig(path: Optional[str] = None,
                    context: Optional[str] = None) -> RestConfig:
    """Parse a kubeconfig file (server.go:103-109 BuildConfigFromFlags
    analog). ``path`` defaults to ``$KUBECONFIG`` then ``~/.kube/config``."""
    import yaml

    path = path or os.environ.get("KUBECONFIG") or os.path.expanduser(
        "~/.kube/config"
    )
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}

    contexts = {e["name"]: e["context"] for e in cfg.get("contexts") or []}
    clusters = {e["name"]: e["cluster"] for e in cfg.get("clusters") or []}
    users = {e["name"]: e["user"] for e in cfg.get("users") or []}

    ctx_name = context or cfg.get("current-context")
    if not ctx_name or ctx_name not in contexts:
        raise ValueError(
            f"kubeconfig {path}: no usable context {ctx_name!r} "
            f"(have {sorted(contexts)})"
        )
    ctx = contexts[ctx_name]
    cluster = clusters.get(ctx.get("cluster", ""))
    if cluster is None or "server" not in cluster:
        raise ValueError(f"kubeconfig {path}: context {ctx_name!r} names "
                         f"unknown cluster {ctx.get('cluster')!r}")
    user = users.get(ctx.get("user", ""), {})

    owned: list = []
    refresher = None
    expiry = None
    token = user.get("token")
    if not token and user.get("tokenFile"):
        token_file = user["tokenFile"]
        with open(token_file) as f:
            token = f.read().strip()

        def _reread(tf=token_file):
            with open(tf) as f:
                # Re-check in 5 min (projected SA tokens rotate on disk).
                return f.read().strip(), time.time() + 300

        refresher, expiry = _reread, time.time() + 300
    exec_cert = exec_key = None
    if not token and "exec" in user:
        token, exec_cert, exec_key, expiry = _run_exec_credential(
            user["exec"], owned
        )

        def _reexec(spec=user["exec"], o=owned):
            t, _c, _k, exp = _run_exec_credential(spec, o)
            return t, exp

        if token:
            refresher = _reexec
    if (not token and "auth-provider" in user
            and not user.get("client-certificate")
            and not user.get("client-certificate-data")):
        raise ValueError(
            f"kubeconfig {path}: user {ctx.get('user')!r} uses the legacy "
            "auth-provider mechanism, which is not supported — use a "
            "token, client certificate, or exec credential plugin"
        )
    rc = RestConfig(
        host=cluster["server"].rstrip("/"),
        token=token,
        ca_file=_materialize(
            cluster.get("certificate-authority-data"),
            cluster.get("certificate-authority"), owned,
        ),
        client_cert_file=exec_cert or _materialize(
            user.get("client-certificate-data"),
            user.get("client-certificate"), owned,
        ),
        client_key_file=exec_key or _materialize(
            user.get("client-key-data"), user.get("client-key"), owned,
        ),
        verify_tls=not cluster.get("insecure-skip-tls-verify", False),
        namespace=ctx.get("namespace", "default"),
        token_refresher=refresher,
        token_expiry=expiry,
    )
    rc._owned_files = owned
    return rc


def _run_exec_credential(spec: dict, owned: list):
    """client.authentication.k8s.io exec plugin (the mechanism GKE's
    gke-gcloud-auth-plugin and EKS's aws-iam-authenticator use): run the
    command, parse the ExecCredential JSON it prints, return
    (token, cert_file, key_file, expiry_epoch)."""
    import subprocess

    argv = [spec["command"], *(spec.get("args") or [])]
    env = dict(os.environ)
    for e in spec.get("env") or []:
        env[e["name"]] = e["value"]
    env["KUBERNETES_EXEC_INFO"] = json.dumps({
        "apiVersion": spec.get("apiVersion",
                               "client.authentication.k8s.io/v1"),
        "kind": "ExecCredential",
        "spec": {"interactive": False},
    })
    try:
        out = subprocess.run(
            argv, env=env, capture_output=True, text=True, timeout=60,
            check=True,
        ).stdout
        cred = json.loads(out)
    except (OSError, subprocess.SubprocessError, ValueError) as e:
        raise ValueError(
            f"exec credential plugin {argv[0]!r} failed: {e}"
        ) from e
    status = cred.get("status") or {}
    token = status.get("token")
    cert = key = None
    cert_data = status.get("clientCertificateData")
    key_data = status.get("clientKeyData")
    if cert_data and not key_data:
        raise ValueError(
            f"exec credential plugin {argv[0]!r} returned "
            "clientCertificateData without clientKeyData"
        )
    if cert_data:
        cert = _materialize(
            base64.b64encode(cert_data.encode()).decode(), None, owned
        )
        key = _materialize(
            base64.b64encode(key_data.encode()).decode(), None, owned
        )
    if not token and not cert:
        raise ValueError(
            f"exec credential plugin {argv[0]!r} returned neither a token "
            "nor a client certificate"
        )
    expiry = None
    ts = status.get("expirationTimestamp")
    if ts:
        try:
            from datetime import datetime

            expiry = datetime.fromisoformat(
                ts.replace("Z", "+00:00")
            ).timestamp()
        except ValueError:
            log.warning("exec plugin %s: bad expirationTimestamp %r",
                        argv[0], ts)
    return token, cert, key, expiry


def load_incluster_config(root: str = SERVICE_ACCOUNT_ROOT) -> RestConfig:
    """In-cluster config: serviceaccount token + CA + env-provided host
    (client-go rest.InClusterConfig analog)."""
    host = os.environ.get("KUBERNETES_SERVICE_HOST")
    port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
    token_file = os.path.join(root, "token")
    if not host or not os.path.exists(token_file):
        raise RuntimeError(
            "not running in-cluster: KUBERNETES_SERVICE_HOST unset or "
            f"{token_file} missing"
        )
    with open(token_file) as f:
        token = f.read().strip()
    ns = "default"
    ns_file = os.path.join(root, "namespace")
    if os.path.exists(ns_file):
        with open(ns_file) as f:
            ns = f.read().strip() or "default"
    ca = os.path.join(root, "ca.crt")

    def _reread(tf=token_file):
        # Projected SA tokens rotate on disk; kubelet refreshes the file.
        with open(tf) as f:
            return f.read().strip(), time.time() + 300

    return RestConfig(
        host=f"https://{host}:{port}",
        token=token,
        ca_file=ca if os.path.exists(ca) else None,
        namespace=ns,
        token_refresher=_reread,
        token_expiry=time.time() + 300,
    )


def load_config(kubeconfig: Optional[str] = None,
                context: Optional[str] = None) -> RestConfig:
    """kubeconfig if present, else in-cluster — the standard resolution
    order (server.go:103-109)."""
    explicit = kubeconfig or os.environ.get("KUBECONFIG")
    default_path = os.path.expanduser("~/.kube/config")
    if explicit or os.path.exists(default_path):
        return load_kubeconfig(explicit, context)
    return load_incluster_config()


# ---------------------------------------------------------------------------
# REST path mapping
# ---------------------------------------------------------------------------


def resource_path(resource: str, namespace: Optional[str] = None,
                  name: Optional[str] = None,
                  subresource: Optional[str] = None) -> str:
    """Map a resource plural to its apiserver path.

    core/v1 lives under ``/api/v1``; every group under
    ``/apis/{group}/{version}`` — the same split client-go's RESTMapper
    performs.
    """
    rt = RESOURCES.get(resource)
    if rt is None:
        raise NotFoundError("resources", resource, "unknown resource type")
    if rt.api_version == "v1":
        prefix = "/api/v1"
    else:
        prefix = f"/apis/{rt.api_version}"
    parts = [prefix]
    if namespace:
        parts += ["namespaces", namespace]
    parts.append(resource)
    if name:
        parts.append(name)
    if subresource:
        parts.append(subresource)
    return "/".join(parts)


def _selector_query(label_selector: Optional[dict]) -> Optional[str]:
    if not label_selector:
        return None
    return ",".join(f"{k}={v}" for k, v in sorted(label_selector.items()))


# ---------------------------------------------------------------------------
# The REST client
# ---------------------------------------------------------------------------


class KubeAPIServer:
    """``InMemoryAPIServer``-surface client for a real kube-apiserver."""

    def __init__(self, config: RestConfig, *, user_agent: str = USER_AGENT,
                 request_timeout: float = 30.0, qps: float = 0.0,
                 burst: int = 10, page_limit: int = 500,
                 max_retries: int = 5):
        self.config = config
        self.user_agent = user_agent
        self.request_timeout = request_timeout
        # Client-side throttle (off by default; the operator CLI wires
        # --kube-api-qps/--kube-api-burst, reference defaults 5/10).
        self._limiter = _TokenBucket(qps, burst)
        # Lists arrive in pages of this many items (0 = unpaginated) —
        # the Reflector's WatchListPageSize discipline.
        self.page_limit = page_limit
        self.max_retries = max_retries
        # Total time one logical request may spend across retry sleeps —
        # keeps a Retry-After storm from silently stretching a single
        # call past lease-renewal deadlines (leader election calls sit
        # on this same client).
        self.max_retry_duration = 30.0
        # Observability for tests: requests that were retried/throttled.
        self.retry_count = 0
        self.throttle_wait = 0.0
        parsed = urllib.parse.urlsplit(config.host)
        if parsed.scheme not in ("http", "https"):
            raise ValueError(f"unsupported apiserver scheme {parsed.scheme!r}")
        self._scheme = parsed.scheme
        self._netloc = parsed.netloc
        self._base_path = parsed.path.rstrip("/")
        self._ssl = config.ssl_context()
        self._watches: list[KubeWatch] = []
        self._lock = threading.Lock()

    # -- plumbing --------------------------------------------------------

    def _connect(self, timeout: Optional[float] = None):
        import http.client

        if self._scheme == "https":
            return http.client.HTTPSConnection(
                self._netloc, context=self._ssl,
                timeout=timeout or self.request_timeout,
            )
        return http.client.HTTPConnection(
            self._netloc, timeout=timeout or self.request_timeout
        )

    def _headers(self) -> dict:
        h = {
            "Accept": "application/json",
            "User-Agent": self.user_agent,
        }
        token = self.config.current_token()
        if token:
            h["Authorization"] = f"Bearer {token}"
        return h

    def _error_from_response(self, resource: str, name: str, code: int,
                             body: bytes) -> ApiError:
        reason, detail = "", ""
        try:
            status = json.loads(body)
            reason = status.get("reason", "")
            detail = status.get("message", "")
        except (ValueError, AttributeError):
            detail = body.decode(errors="replace")[:500]
        cls = _ERRORS_BY_REASON.get(reason) or _ERRORS_BY_CODE.get(code)
        if cls is None:
            cls = ServerError
        err = cls(resource, name, detail)
        err.code = code
        return err

    def _retry_delay(self, attempt: int,
                     retry_after: Optional[str]) -> float:
        """Server-directed Retry-After wins; else jittered exponential
        backoff (0.25s·2^n, capped, 50-100% jitter so a fleet of clients
        does not re-stampede in lockstep)."""
        if retry_after:
            try:
                return max(0.0, min(float(retry_after), 30.0))
            except ValueError:
                pass
        base = min(0.25 * (2 ** attempt), 8.0)
        return base * (0.5 + random.random() / 2)

    def _request(self, method: str, path: str, *, resource: str = "",
                 name: str = "", query: Optional[dict] = None,
                 body: Optional[dict] = None,
                 _retry_auth: bool = True) -> dict:
        url = self._base_path + path
        if query:
            url += "?" + urllib.parse.urlencode(
                {k: v for k, v in query.items() if v is not None}
            )
        payload = None
        if body is not None:
            payload = json.dumps(body).encode()
        attempt = 0
        retry_deadline = time.monotonic() + self.max_retry_duration
        while True:
            self.throttle_wait += self._limiter.acquire()
            headers = self._headers()
            if payload is not None:
                headers["Content-Type"] = "application/json"
            conn = self._connect()
            try:
                conn.request(method, url, body=payload, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                if resp.status == 401 and _retry_auth:
                    # Expired rotating credential: re-acquire, retry once
                    # (does not consume the transient-failure budget).
                    if self.config.refresh_token():
                        _retry_auth = False
                        continue
                if resp.status < 300:
                    return json.loads(data) if data else {}
                # 429 means the server never processed the request, so
                # every verb retries; transient gateway 5xx retry only
                # for GET (the idempotent verb — a replayed PUT/POST
                # could double-apply behind a flaky LB).
                transient = (
                    resp.status == 429
                    or (method == "GET"
                        and resp.status in (500, 502, 503, 504))
                )
                if transient and attempt < self.max_retries:
                    delay = self._retry_delay(
                        attempt, resp.getheader("Retry-After")
                    )
                    if time.monotonic() + delay <= retry_deadline:
                        attempt += 1
                        self.retry_count += 1
                        time.sleep(delay)
                        continue
                raise self._error_from_response(
                    resource, name, resp.status, data
                )
            except ApiError:
                raise
            except (OSError, ValueError) as e:
                if method == "GET" and attempt < self.max_retries:
                    delay = self._retry_delay(attempt, None)
                    if time.monotonic() + delay <= retry_deadline:
                        attempt += 1
                        self.retry_count += 1
                        time.sleep(delay)
                        continue
                raise ServerError(
                    resource, name, f"{method} {url}: {e}"
                ) from e
            finally:
                conn.close()

    @staticmethod
    def _ns_name(obj: dict) -> tuple[str, str]:
        meta = obj.get("metadata") or {}
        return meta.get("namespace") or "default", meta.get("name", "")

    def _stamp(self, resource: str, obj: dict) -> dict:
        """List items arrive without apiVersion/kind; callers (and the
        informer cache) expect them present, matching the in-memory
        server's behavior."""
        rt = RESOURCES[resource]
        obj.setdefault("apiVersion", rt.api_version)
        obj.setdefault("kind", rt.kind)
        return obj

    # -- surface ---------------------------------------------------------

    def create(self, resource: str, obj: dict) -> dict:
        ns, name = self._ns_name(obj)
        rt = RESOURCES[resource]
        obj = dict(obj)
        obj.setdefault("apiVersion", rt.api_version)
        obj.setdefault("kind", rt.kind)
        return self._request(
            "POST", resource_path(resource, ns),
            resource=resource, name=name, body=obj,
        )

    def get(self, resource: str, namespace: str, name: str) -> dict:
        return self._request(
            "GET", resource_path(resource, namespace or "default", name),
            resource=resource, name=f"{namespace}/{name}",
        )

    def list(self, resource: str, namespace: Optional[str] = None,
             label_selector: Optional[dict] = None) -> list[dict]:
        return self.list_with_rv(resource, namespace, label_selector)[0]

    def list_with_rv(
        self, resource: str, namespace: Optional[str] = None,
        label_selector: Optional[dict] = None,
    ) -> tuple[list[dict], str]:
        """List plus the collection resourceVersion (watch baseline).

        Pages through the collection ``page_limit`` items at a time
        (``limit``/``continue``, the Reflector's chunked-list
        discipline) so a large cluster never forces one giant response.
        An expired continue token (410 mid-pagination) restarts the
        whole list — pages from different snapshots must not be mixed —
        and the restart is UNPAGINATED (client-go's ListPager fallback:
        a plain list has no continuation to expire, so one retry always
        suffices even against a server compacting every snapshot).
        """
        sel = _selector_query(label_selector)
        path = resource_path(resource, namespace)
        use_limit = bool(self.page_limit)
        for _restart in range(4):
            items: list[dict] = []
            rv = ""
            cont: Optional[str] = None
            while True:
                query = {
                    "labelSelector": sel,
                    "limit": str(self.page_limit) if use_limit else None,
                    "continue": cont,
                }
                try:
                    result = self._request(
                        "GET", path, resource=resource, query=query,
                    )
                except ApiError as e:
                    if cont is not None and getattr(e, "code", 0) == 410:
                        use_limit = False  # token expired: restart
                        break              # from page one, unpaginated
                    raise
                items += [
                    self._stamp(resource, o)
                    for o in result.get("items") or []
                ]
                meta = result.get("metadata") or {}
                # Every page is served from the same snapshot; the first
                # page's rv is the collection rv.
                rv = rv or meta.get("resourceVersion", "")
                cont = meta.get("continue") or None
                if cont is None:
                    items.sort(
                        key=lambda o: (o["metadata"].get("namespace", ""),
                                       o["metadata"]["name"])
                    )
                    return items, rv
        raise ServerError(
            resource, "", "list pagination restarted 4x on expired "
            "continue tokens without completing",
        )

    def update(self, resource: str, obj: dict) -> dict:
        ns, name = self._ns_name(obj)
        rt = RESOURCES[resource]
        obj = dict(obj)
        obj.setdefault("apiVersion", rt.api_version)
        obj.setdefault("kind", rt.kind)
        return self._request(
            "PUT", resource_path(resource, ns, name),
            resource=resource, name=name, body=obj,
        )

    def update_status(self, resource: str, obj: dict) -> dict:
        ns, name = self._ns_name(obj)
        rt = RESOURCES[resource]
        obj = dict(obj)
        obj.setdefault("apiVersion", rt.api_version)
        obj.setdefault("kind", rt.kind)
        return self._request(
            "PUT", resource_path(resource, ns, name, subresource="status"),
            resource=resource, name=name, body=obj,
        )

    def delete(self, resource: str, namespace: str, name: str) -> None:
        # Background propagation: the cluster's GC cascades along
        # ownerReferences (the in-memory server's _garbage_collect analog).
        self._request(
            "DELETE", resource_path(resource, namespace or "default", name),
            resource=resource, name=f"{namespace}/{name}",
            body={"apiVersion": "v1", "kind": "DeleteOptions",
                  "propagationPolicy": "Background"},
        )

    def watch(self, resource: str,
              namespace: Optional[str] = None) -> "KubeWatch":
        w = KubeWatch(self, resource, namespace)
        w._open()  # synchronous: stream established before watch() returns
        with self._lock:
            self._watches.append(w)
        return w

    def _remove_watch(self, watch: "KubeWatch") -> None:
        with self._lock:
            if watch in self._watches:
                self._watches.remove(watch)

    def close(self) -> None:
        with self._lock:
            watches = list(self._watches)
        for w in watches:
            w.stop()


class KubeWatch:
    """One streaming watch with transparent reconnect and 410 resume.

    Exposes the same queue interface as the in-memory ``Watch``
    (``drain`` / ``next`` / ``stop``).  Maintains a mirror of the
    watched collection — **resourceVersions only, not objects**, so a
    watch costs O(collection) keys rather than a full copy of every
    object at cluster scale. A compaction (410 Gone) resumes by
    re-listing and emitting the *diff* as synthetic events; ADDED and
    MODIFIED carry the fresh objects from that list, while DELETED
    carries a metadata-only tombstone (namespace/name/resourceVersion)
    — the informer on top delivers the full last-known object from its
    own cache, client-go's DeletedFinalStateUnknown discipline.
    """

    def __init__(self, server: KubeAPIServer, resource: str,
                 namespace: Optional[str]):
        self._server = server
        self.resource = resource
        self.namespace = namespace
        self._events: list[WatchEvent] = []
        self._cond = threading.Condition()
        self._stopped = False
        self._rv = ""
        # key -> object resourceVersion (see class docstring).
        self._mirror: dict[tuple[str, str], str] = {}
        self._conn = None
        self._thread: Optional[threading.Thread] = None
        # Surfaced for tests/debugging: how many relists (410s) happened.
        self.relist_count = 0

    def baseline(self) -> list[dict]:
        """The objects from the opening LIST (informers reuse this as
        their initial cache instead of listing again). Snapshotted before
        the reader thread starts, so it is safe to read afterwards."""
        return self._baseline_snapshot

    # -- queue interface (apiserver.Watch parity) ------------------------

    def _deliver(self, event: WatchEvent) -> None:
        with self._cond:
            if self._stopped:
                return
            self._events.append(event)
            self._cond.notify_all()

    def drain(self) -> list[WatchEvent]:
        with self._cond:
            events, self._events = self._events, []
            return events

    def next(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._events and not self._stopped:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return None
                self._cond.wait(remaining)
            if self._events:
                return self._events.pop(0)
            return None

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        conn = self._conn
        if conn is not None:
            # close() alone waits for the reader thread's readline to give
            # up the stream's buffer lock, which it holds until the next
            # event or BOOKMARK arrives (seconds here, a minute on a real
            # apiserver); shutting the socket down first wakes it at once.
            sock = conn.sock
            if sock is not None:
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            try:
                conn.close()
            except OSError:
                pass
        self._server._remove_watch(self)

    # -- streaming -------------------------------------------------------

    @staticmethod
    def _key(obj: dict) -> tuple[str, str]:
        meta = obj.get("metadata") or {}
        return meta.get("namespace", ""), meta.get("name", "")

    def _tombstone(self, key: tuple[str, str], old_rv: str) -> dict:
        ns, name = key
        rt = RESOURCES[self.resource]
        return {
            "apiVersion": rt.api_version,
            "kind": rt.kind,
            "metadata": {
                "namespace": ns, "name": name, "resourceVersion": old_rv,
            },
        }

    def _baseline(self, emit_diff: bool) -> list[dict]:
        """Full (paginated) list into the rv mirror; on resume
        (``emit_diff``) the diff against the previous mirror becomes
        synthetic events. Returns the listed objects (the caller's
        baseline snapshot) — they are not retained here."""
        items, rv = self._server.list_with_rv(self.resource, self.namespace)
        fresh = {
            self._key(o): o["metadata"].get("resourceVersion", "")
            for o in items
        }
        if emit_diff:
            for obj in items:
                old_rv = self._mirror.get(self._key(obj))
                if old_rv is None:
                    self._deliver(WatchEvent(ADDED, self.resource, obj))
                elif old_rv != obj["metadata"].get("resourceVersion"):
                    self._deliver(WatchEvent(MODIFIED, self.resource, obj))
            for key, old_rv in self._mirror.items():
                if key not in fresh:
                    self._deliver(WatchEvent(
                        DELETED, self.resource,
                        self._tombstone(key, old_rv),
                    ))
        self._mirror = fresh
        self._rv = rv
        return items

    def _open_stream(self):
        """Open the chunked watch request; returns (conn, resp)."""
        query = {
            "watch": "true",
            "resourceVersion": self._rv,
            "allowWatchBookmarks": "true",
            "timeoutSeconds": "300",
        }
        url = (self._server._base_path
               + resource_path(self.resource, self.namespace)
               + "?" + urllib.parse.urlencode(query))
        # Watch opens ride the same client-side throttle as CRUD calls
        # (a relist storm must not bypass --kube-api-qps).
        self._server.throttle_wait += self._server._limiter.acquire()
        conn = self._server._connect(timeout=330.0)
        conn.request("GET", url, headers=self._server._headers())
        resp = conn.getresponse()
        if resp.status == 401 and self._server.config.refresh_token():
            resp.read()
            conn.close()
            conn = self._server._connect(timeout=330.0)
            conn.request("GET", url, headers=self._server._headers())
            resp = conn.getresponse()
        if resp.status == 410:
            resp.read()
            conn.close()
            raise _Gone()
        if resp.status >= 300:
            body = resp.read()
            conn.close()
            raise self._server._error_from_response(
                self.resource, "", resp.status, body
            )
        return conn, resp

    def _open(self) -> None:
        """Baseline list + first stream, synchronously, then the reader
        thread takes over. Guarantees the stream covers everything after
        the caller's next ``list()``."""
        items = self._baseline(emit_diff=False)
        try:
            self._conn, resp = self._open_stream()
        except _Gone:
            # Pathological but possible: compaction between list and watch.
            self.relist_count += 1
            items = self._baseline(emit_diff=True)
            self._conn, resp = self._open_stream()
        # After this point only the reader thread touches the mirror.
        self._baseline_snapshot = items
        self._thread = threading.Thread(
            target=self._run, args=(resp,),
            name=f"kubewatch-{self.resource}", daemon=True,
        )
        self._thread.start()

    def _run(self, resp) -> None:
        while not self._stopped:
            if resp is not None:
                try:
                    self._consume(resp)
                except _Gone:
                    self.relist_count += 1
                    self._rv = ""
                except (OSError, ValueError, AttributeError) as e:
                    # AttributeError: http.client raises it when the
                    # response is closed under a blocked readline
                    # (stop() racing us).
                    if self._stopped:
                        return
                    log.debug("watch %s stream error: %s", self.resource, e)
                    time.sleep(0.2)
                resp = None
                conn, self._conn = self._conn, None
                if conn is not None:
                    try:
                        conn.close()
                    except OSError:
                        pass
            if self._stopped:
                return
            # Reconnect (timeout rollover, network blip, or 410 resume).
            try:
                if not self._rv:
                    self._baseline(emit_diff=True)
                self._conn, resp = self._open_stream()
            except _Gone:
                self.relist_count += 1
                self._rv = ""  # next iteration relists, resp stays None
            except (ApiError, OSError, ValueError) as e:
                if self._stopped:
                    return
                log.warning("watch %s reopen failed: %s", self.resource, e)
                time.sleep(1.0)

    def _consume(self, resp) -> None:
        """Read newline-delimited watch events until the stream ends."""
        if resp is None:
            raise OSError("no stream")
        for raw in iter(resp.readline, b""):
            if self._stopped:
                return
            raw = raw.strip()
            if not raw:
                continue
            event = json.loads(raw)
            etype = event.get("type", "")
            obj = event.get("object") or {}
            if etype == ERROR:
                if obj.get("code") == 410:
                    raise _Gone()
                log.warning("watch %s server error: %s", self.resource,
                            obj.get("message", obj))
                raise _Gone()  # safest recovery path is a relist
            rv = (obj.get("metadata") or {}).get("resourceVersion")
            if rv:
                self._rv = rv
            if etype == BOOKMARK:
                continue
            self._server._stamp(self.resource, obj)
            key = self._key(obj)
            if etype == DELETED:
                self._mirror.pop(key, None)
            else:
                self._mirror[key] = (obj.get("metadata") or {}).get(
                    "resourceVersion", ""
                )
            self._deliver(WatchEvent(etype, self.resource, obj))
        # Clean EOF: server closed (timeoutSeconds rollover); reconnect
        # from the last seen rv.


class _Gone(Exception):
    """410: the requested resourceVersion is compacted away."""
