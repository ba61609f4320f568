"""The operator process (the port's ``mpi_operator_tpu/cmd/operator.py``,
for GPU jobs).

Reference analog: /root/reference/v2/cmd/mpi-operator/ — flags
(app/options/options.go:45-71), CRD preflight (server.go:287-299), leader
election (server.go:210-257), /healthz (:192-208), Prometheus /metrics
(main.go:29-40), then the controller run loop.

Backends:
- ``--backend memory`` boots the in-memory API server with the
  LocalPodRunner kubelet sim (a self-contained "cluster in a process"):
  jobs are admitted, their one-GPU worker pods rendered, bound (by the
  runner, or with ``--enable-scheduler`` by the gang scheduler onto the
  ``--node-inventory`` of 8-GPU nodes) and run as local processes on the
  machine's GPUs. With ``--enable-queue`` a job that names a LocalQueue
  starts suspended and is admitted against its ClusterQueue's GPU quota
  (``queue/``; ``--cluster-queue name:h100=<gpus>`` bootstraps one);
- ``--backend kube`` talks to a real kube-apiserver over REST
  (``runtime/kube.py``; kubeconfig / in-cluster config, server.go:103-109
  analog) — the cluster's kubelet and GC do what LocalPodRunner simulates
  locally, and its scheduler and queue are the cluster's own. The cluster
  must serve the port's CRD (``mpi_operator_tpu_torch/deploy/crd.yaml``,
  which admits ``h100-<gpus>``); ``deploy/gpu-operator.yaml`` next to it
  installs the operator.

This process imports no torch; the workers do.

Run:  python -m mpi_operator_tpu_torch.cmd.operator --help
      python -m mpi_operator_tpu_torch.cmd.operator --backend memory \
          --apply mpi_operator_tpu_torch/examples/pi.yaml --exit-on-completion
      python -m mpi_operator_tpu_torch.cmd.operator --backend memory \
          --enable-queue --cluster-queue gpus:h100=2 --enable-scheduler \
          --apply job-a.yaml --apply job-b.yaml --exit-on-completion
      python -m mpi_operator_tpu_torch.cmd.operator --backend kube \
          --kubeconfig ~/.kube/config --namespace training
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..api.v2beta1 import constants
from ..controller.tpu_job_controller import TPUJobController
from ..runtime import locktrace
from ..runtime.apiserver import InMemoryAPIServer, NotFoundError
from ..runtime.leaderelection import LeaderElectionConfig, LeaderElector
from ..runtime.podrunner import LocalPodRunner
from ..utils import devstats, flightrecorder, goodput, metrics, profiling, stepstats, trace
from ..utils import logging as logutil
from ..version import version_string

# The CRD this operator needs: the port's, whose acceleratorType pattern
# admits h100-<gpus> (the JAX package's crd/ admits only TPU types).
CRD_MANIFEST = "mpi_operator_tpu_torch/deploy/crd.yaml"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-operator",
        description="GPU job operator (TPUJob kubeflow.org/v2beta1, "
                    "acceleratorType h100-<gpus>)",
    )
    # options.go:45-71 analogs.
    p.add_argument(
        "--namespace",
        default=os.environ.get(constants.ENV_KUBEFLOW_NAMESPACE, ""),
        help="namespace to watch (empty = all namespaces)",
    )
    p.add_argument("--threadiness", type=int, default=2, help="worker goroutine count")
    p.add_argument("--monitoring-port", type=int, default=0,
                   help="port for /metrics + /healthz (0 = disabled)")
    p.add_argument("--monitoring-address", default="127.0.0.1",
                   help="bind address for monitoring (0.0.0.0 in-cluster so "
                        "kubelet probes can reach /healthz)")
    p.add_argument("--gang-scheduling", default="",
                   help="gang scheduler name (e.g. volcano); empty disables")
    p.add_argument("--enable-scheduler", action="store_true",
                   help="run the in-process gang scheduler (memory backend "
                        "only): pods start Pending and are bound "
                        "all-or-nothing per gang; off = pods auto-bind on "
                        "creation (pre-scheduler behaviour)")
    p.add_argument("--node-inventory", default="h100-8:2",
                   help="GPU node inventory for the scheduler, "
                        "'accelType[/topology][:count],...' "
                        "(e.g. 'h100-8:2,h100-16'); one Node per 8-GPU "
                        "server. A gang whose generation matches no node "
                        "stays Unschedulable until the inventory does")
    p.add_argument("--enable-queue", action="store_true",
                   help="run the in-process admission queue (memory backend "
                        "only): TPUJobs naming a LocalQueue via "
                        "runPolicy.schedulingPolicy.queue start suspended "
                        "and are admitted against ClusterQueue GPU quotas "
                        "(nvidia.com/gpu per generation, h100); off = "
                        "suspend is user-driven (pre-queue behaviour)")
    p.add_argument("--cluster-queue", action="append", default=[],
                   help="bootstrap ClusterQueue(s), "
                        "'name[@cohort]:h100=gpus' (e.g. "
                        "'team-a@research:h100=16'); also creates a "
                        "same-named LocalQueue in the watched namespace "
                        "(or 'default'). Repeatable; existing queues are "
                        "left untouched")
    p.add_argument("--log-level", default="info",
                   choices=["debug", "info", "warning", "error"],
                   help="structured-log severity threshold")
    p.add_argument("--log-format", default="text",
                   choices=[logutil.FORMAT_TEXT, logutil.FORMAT_JSON],
                   help="structured-log output format: text = klog-style "
                        "lines, json = one JSON object per line")
    p.add_argument("--leader-elect", action="store_true",
                   help="enable leader election for HA deployments")
    p.add_argument("--lock-namespace", default="default",
                   help="namespace of the leader-election Lease")
    p.add_argument("--backend", choices=["memory", "kube"], default="memory",
                   help="cluster backend: memory = in-process apiserver + "
                        "kubelet sim; kube = real cluster over REST")
    p.add_argument("--kubeconfig", default="",
                   help="path to kubeconfig (default: $KUBECONFIG, then "
                        "~/.kube/config, then in-cluster config)")
    p.add_argument("--kube-context", default="",
                   help="kubeconfig context to use (default: current-context)")
    p.add_argument("--kube-api-qps", type=float, default=5.0,
                   help="maximum sustained QPS to the apiserver from this "
                        "client (0 disables throttling)")
    p.add_argument("--kube-api-burst", type=int, default=10,
                   help="maximum burst for apiserver client throttle")
    p.add_argument("--apply", action="append", default=[],
                   help="TPUJob YAML file(s) to apply at startup")
    p.add_argument("--lock-trace", action="store_true",
                   help="arm the runtime lock-order race detector "
                        "(runtime/locktrace.py); equivalent to "
                        f"{locktrace.ENV_FLAG}=1")
    p.add_argument("--exit-on-completion", action="store_true",
                   help="exit once every applied TPUJob is finished")
    p.add_argument("--version", action="version", version=version_string())
    return p


def _parse_timeline_query(query: str) -> tuple[Optional[str], Optional[int]]:
    """``?limit=N&kind=K`` for the timeline endpoint; raises ValueError
    (the endpoint's 400) on malformed values so large timelines stay
    bounded over HTTP without silently serving the wrong slice."""
    from urllib.parse import parse_qs

    params = parse_qs(query, keep_blank_values=True)
    kind: Optional[str] = None
    limit: Optional[int] = None
    if "kind" in params:
        kind = params["kind"][-1]
        if kind not in flightrecorder.KINDS:
            raise ValueError(
                f"kind must be one of {', '.join(flightrecorder.KINDS)}; "
                f"got {kind!r}"
            )
    if "limit" in params:
        raw = params["limit"][-1]
        try:
            limit = int(raw)
        except ValueError:
            raise ValueError(f"limit must be an integer; got {raw!r}")
        if limit < 1:
            raise ValueError(f"limit must be >= 1; got {limit}")
    return kind, limit


class _MonitoringHandler(BaseHTTPRequestHandler):
    registry: metrics.Registry = None
    tracer: trace.Tracer = None
    flight_recorder: Optional[flightrecorder.FlightRecorder] = None
    goodput_ledger: Optional[goodput.GoodputLedger] = None
    step_matrix: Optional[stepstats.StepMatrix] = None
    memory_matrix: Optional[devstats.MemoryMatrix] = None
    profiler: Optional[profiling.PhaseProfiler] = None
    workqueues: tuple = ()
    health_fn = staticmethod(lambda: True)

    # The per-job debug leaves this server can dispatch; the unknown-leaf
    # 404 body enumerates them so a typo'd URL is self-diagnosing.
    KNOWN_JOB_SUBRESOURCES = ("goodput", "memory", "steps", "timeline")

    def _debug_jobs_index(self) -> tuple[int, str, bytes]:
        """The ``/debug/jobs`` index: every job the flight recorder
        remembers, with the debug subresources that currently have data
        for it — the entry point that makes the per-job pages
        discoverable without knowing a job name in advance."""
        import json

        if self.flight_recorder is None:
            return 404, "text/plain", b"not found"
        jobs = []
        for namespace, name in sorted(self.flight_recorder.jobs()):
            subresources = ["timeline"]
            if (
                self.goodput_ledger is not None
                and self.goodput_ledger.job_snapshot(namespace, name)
                is not None
            ):
                subresources.append("goodput")
            if (
                self.step_matrix is not None
                and self.step_matrix.job_snapshot(namespace, name)
                is not None
            ):
                subresources.append("steps")
            if (
                self.memory_matrix is not None
                and self.memory_matrix.job_snapshot(namespace, name)
                is not None
            ):
                subresources.append("memory")
            jobs.append({
                "namespace": namespace,
                "name": name,
                "subresources": sorted(subresources),
            })
        body = json.dumps(
            {"jobs": jobs, "known_subresources": list(
                self.KNOWN_JOB_SUBRESOURCES
            )},
            indent=2, sort_keys=True,
        ) + "\n"
        return 200, "application/json", body.encode()

    def _debug_jobs_response(self) -> tuple[int, str, bytes]:
        """(status, content-type, body) for the per-job debug pages:
        /debug/jobs/<ns>/<name>/timeline (with ?limit=N / ?kind=K
        filters; 400 on malformed values),
        /debug/jobs/<ns>/<name>/goodput (the ledger's phase
        decomposition), /debug/jobs/<ns>/<name>/steps (the step-skew
        matrix), and /debug/jobs/<ns>/<name>/memory (the device-memory
        matrix) — plus the bare /debug/jobs index listing recorded jobs.
        404 when the page, the backing component, or the job itself is
        unknown; an unknown *leaf* on a well-formed path gets a JSON
        body listing the known subresources."""
        import json
        from urllib.parse import urlsplit

        split = urlsplit(self.path)
        parts = split.path.split("/")
        if parts[:3] != ["", "debug", "jobs"]:
            return 404, "text/plain", b"not found"
        # /debug/jobs or /debug/jobs/ → the index.
        if len(parts) == 3 or (len(parts) == 4 and parts[3] == ""):
            return self._debug_jobs_index()
        # ['', 'debug', 'jobs', ns, name, leaf]
        if len(parts) != 6:
            return 404, "text/plain", b"not found"
        if parts[5] not in self.KNOWN_JOB_SUBRESOURCES:
            body = json.dumps(
                {
                    "error": f"unknown subresource {parts[5]!r}",
                    "known_subresources": list(self.KNOWN_JOB_SUBRESOURCES),
                },
                indent=2, sort_keys=True,
            ) + "\n"
            return 404, "application/json", body.encode()
        namespace, name, leaf = parts[3], parts[4], parts[5]
        if leaf == "timeline":
            if self.flight_recorder is None:
                return 404, "text/plain", b"not found"
            try:
                kind, limit = _parse_timeline_query(split.query)
            except ValueError as exc:
                return 400, "text/plain", f"bad request: {exc}".encode()
            timeline = self.flight_recorder.to_json(
                namespace, name, kind=kind, limit=limit
            )
            if timeline is None:
                return 404, "text/plain", b"not found"
            return 200, "application/json", timeline.encode()
        if leaf == "steps":
            if self.step_matrix is None:
                return 404, "text/plain", b"not found"
            snap = self.step_matrix.job_snapshot(namespace, name)
            if snap is None:
                return 404, "text/plain", b"not found"
            return 200, "application/json", (
                json.dumps(snap, indent=2, sort_keys=True) + "\n"
            ).encode()
        if leaf == "memory":
            if self.memory_matrix is None:
                return 404, "text/plain", b"not found"
            snap = self.memory_matrix.job_snapshot(namespace, name)
            if snap is None:
                return 404, "text/plain", b"not found"
            return 200, "application/json", (
                json.dumps(snap, indent=2, sort_keys=True) + "\n"
            ).encode()
        if self.goodput_ledger is None:
            return 404, "text/plain", b"not found"
        snap = self.goodput_ledger.job_snapshot(namespace, name)
        if snap is None:
            return 404, "text/plain", b"not found"
        return 200, "application/json", (
            json.dumps(snap, indent=2, sort_keys=True) + "\n"
        ).encode()

    def do_GET(self):  # noqa: N802
        if self.path == "/metrics":
            body = self.registry.expose().encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
        elif self.path.split("?", 1)[0].rstrip("/") == "/debug/jobs" or (
            self.path.startswith("/debug/jobs/")
        ):
            status, content_type, body = self._debug_jobs_response()
            self.send_response(status)
            self.send_header("Content-Type", content_type)
        elif self.path == "/debug/goodput":
            # Fleet goodput rollup: aggregate ratio, per-phase totals,
            # and the per-job table (see docs/observability.md).
            import json

            if self.goodput_ledger is None:
                body = b"not found"
                self.send_response(404)
                self.send_header("Content-Type", "text/plain")
            else:
                doc = self.goodput_ledger.fleet_snapshot()
                body = (
                    json.dumps(doc, indent=2, sort_keys=True) + "\n"
                ).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
        elif self.path == "/healthz":
            ok = self.health_fn()
            body = b"ok" if ok else b"unhealthy"
            self.send_response(200 if ok else 500)
            self.send_header("Content-Type", "text/plain")
        elif self.path == "/debug/profile":
            # Phase-level performance snapshot: where reconcile time goes
            # (exclusive per-phase shares), watch→reconcile propagation
            # quantiles, cache-scan volume, and workqueue health.
            import json

            doc = {
                "profile": (
                    self.profiler.snapshot() if self.profiler is not None else {}
                ),
                "workqueues": {q.name: q.stats() for q in self.workqueues},
            }
            body = (json.dumps(doc, indent=2, sort_keys=True) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
        elif self.path == "/debug/trace":
            # The span ring buffer as JSONL, oldest span first: one
            # reconcile cycle reads as a reconcile line followed by its
            # builders.* children (same trace_id).
            jsonl = self.tracer.to_jsonl()
            body = (jsonl + "\n").encode() if jsonl else b""
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
        else:
            body = b"not found"
            self.send_response(404)
            self.send_header("Content-Type", "text/plain")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):  # quiet
        pass


def start_monitoring(port: int, registry: metrics.Registry, health_fn,
                     address: str = "127.0.0.1",
                     tracer: Optional[trace.Tracer] = None,
                     flight_recorder: Optional[
                         flightrecorder.FlightRecorder] = None,
                     goodput_ledger: Optional[goodput.GoodputLedger] = None,
                     step_matrix: Optional[stepstats.StepMatrix] = None,
                     memory_matrix: Optional[devstats.MemoryMatrix] = None,
                     profiler: Optional[profiling.PhaseProfiler] = None,
                     workqueues=()):
    """startMonitoring (main.go:29-40) + healthz server (:192-208) analog,
    plus the ``/debug/trace`` span dump, per-job
    ``/debug/jobs/<ns>/<name>/timeline`` flight-recorder endpoint (with
    ``?limit=``/``?kind=`` filters), the goodput pages
    (``/debug/jobs/<ns>/<name>/goodput`` + fleet ``/debug/goodput``),
    the step-skew matrix (``/debug/jobs/<ns>/<name>/steps``), the
    device-memory matrix (``/debug/jobs/<ns>/<name>/memory``), the
    ``/debug/jobs`` index, and the ``/debug/profile`` phase-profile
    snapshot (``profiler`` plus the ``workqueues`` whose health it
    reports)."""
    handler = type(
        "Handler",
        (_MonitoringHandler,),
        {
            "registry": registry,
            # "is None", not "or": an empty Tracer is falsy (__len__).
            "tracer": trace.DEFAULT_TRACER if tracer is None else tracer,
            "flight_recorder": flight_recorder,
            "goodput_ledger": goodput_ledger,
            "step_matrix": step_matrix,
            "memory_matrix": memory_matrix,
            "profiler": profiler,
            "workqueues": tuple(workqueues),
            "health_fn": staticmethod(health_fn),
        },
    )
    server = ThreadingHTTPServer((address, port), handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server


def check_crd_exists(api, namespace: str = "") -> None:
    """CRD preflight (server.go:287-299 analog): fail fast, with a clear
    diagnostic, on any of the common startup failures — CRD missing,
    apiserver unreachable, bad credentials, RBAC denial. Lists in the
    watched namespace so namespace-scoped RBAC passes the preflight."""
    from ..runtime.apiserver import ApiError

    try:
        api.list("tpujobs", namespace or None)
    except NotFoundError:
        print(
            "CRD tpujobs.kubeflow.org not served; install the GPU CRD "
            f"first (kubectl apply -f {CRD_MANIFEST})",
            file=sys.stderr,
        )
        raise SystemExit(1)
    except ApiError as e:
        print(f"cannot reach the cluster backend: {e}", file=sys.stderr)
        raise SystemExit(1)


def build_backend(args):
    """Returns (api, runner): the cluster backend plus, for the memory
    backend only, the in-process kubelet sim, which runs the pods on this
    machine's GPUs (a real cluster brings its own kubelet and garbage
    collector)."""
    if args.backend == "kube":
        from ..runtime.kube import KubeAPIServer, load_config

        config = load_config(args.kubeconfig or None,
                             args.kube_context or None)
        print(f"connecting to apiserver {config.host}")
        return KubeAPIServer(
            config, qps=args.kube_api_qps, burst=args.kube_api_burst,
        ), None
    api = InMemoryAPIServer()
    # With the in-process scheduler on, the kubelet sim stops playing
    # scheduler: it only launches pods something has bound.
    return api, LocalPodRunner(api, auto_bind=not args.enable_scheduler)


def _emit_lock_trace_report() -> None:
    """On shutdown, summarize the lock-order graph when tracing is armed
    (via --lock-trace or the environment flag)."""
    t = locktrace.tracer()
    if t is None:
        return
    report = t.report()
    print(
        f"lock-trace: {report['acquisitions']} acquisitions across "
        f"{len(report['locks'])} locks, "
        f"{len(report['inversions'])} inversion(s), "
        f"{len(report['long_holds'])} long hold(s)",
        file=sys.stderr,
    )
    for inv in report["inversions"]:
        print(
            f"lock-trace inversion: {inv['forward']} vs {inv['reverse']}",
            file=sys.stderr,
        )


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logutil.configure(
        level=logutil.parse_level(args.log_level), format=args.log_format
    )
    if args.lock_trace and not locktrace.enabled():
        # Before any backend/controller construction: locks created while
        # tracing is off stay plain forever.
        locktrace.enable()
    if args.enable_scheduler and args.backend != "memory":
        print(
            "--enable-scheduler requires --backend memory (a real cluster "
            "brings its own scheduler)",
            file=sys.stderr,
        )
        return 1
    if args.enable_queue and args.backend != "memory":
        print(
            "--enable-queue requires --backend memory (point a real cluster "
            "at sigs.k8s.io/kueue instead)",
            file=sys.stderr,
        )
        return 1
    if args.cluster_queue and not args.enable_queue:
        print("--cluster-queue requires --enable-queue", file=sys.stderr)
        return 1

    api, runner = build_backend(args)
    check_crd_exists(api, args.namespace)
    registry = metrics.Registry()
    # One flight recorder shared by every component that can contribute a
    # timeline entry: controller, scheduler, pod runner, monitoring.
    recorder = flightrecorder.FlightRecorder()
    if runner is not None:
        runner.flight_recorder = recorder
    # The step-skew observatory rides the recorder too (its pruning is
    # bounded by the recorder's LRU); built before the ledger so the
    # ledger can carve skew_wait out of productive.
    matrix = stepstats.StepMatrix(recorder, registry=registry)
    # The device-memory observatory rides the recorder with the same
    # LRU-bounded pruning contract.
    mem_matrix = devstats.MemoryMatrix(recorder, registry=registry)
    # The goodput ledger rides the recorder: per-job phase attribution,
    # scrape-time goodput metrics, and the /debug/goodput rollup.
    ledger = goodput.GoodputLedger(
        recorder, registry=registry, skew_provider=matrix.skew_wait_seconds
    )
    is_leader = metrics.new_gauge(
        "tpu_operator_is_leader", "1 if this replica is the leader", (), registry
    )
    if hasattr(api, "retry_count"):
        # REST-client flow control observability (client-go's
        # rest_client_* metrics analog): monotonic totals mirrored from
        # the client at scrape time.
        rest_retries = metrics.new_counter(
            "tpu_operator_rest_client_retries_total",
            "requests retried after 429/transient failures",
            registry=registry,
        )
        rest_throttle = metrics.new_counter(
            "tpu_operator_rest_client_throttle_seconds_total",
            "seconds spent waiting on the client-side QPS limiter",
            registry=registry,
        )
        registry.on_scrape(lambda: (
            rest_retries.mirror_total(api.retry_count),
            rest_throttle.mirror_total(round(api.throttle_wait, 3)),
        ))
    scheduler = None
    if args.enable_scheduler:
        from ..scheduler import DEFAULT_SCHEDULER_NAME, GangScheduler, register_nodes

        nodes = register_nodes(api, args.node_inventory)
        print(
            f"scheduler: registered {len(nodes)} GPU node(s) from "
            f"inventory {args.node_inventory!r}"
        )
        scheduler = GangScheduler(api, registry=registry, flight_recorder=recorder)
        # Workers must carry the gang annotation + schedulerName for
        # all-or-nothing admission; default it when the user didn't pick
        # an external gang scheduler explicitly.
        if not args.gang_scheduling:
            args.gang_scheduling = DEFAULT_SCHEDULER_NAME
    queue_manager = None
    if args.enable_queue:
        from ..queue import QueueManager, bootstrap_queues

        try:
            bootstrap_queues(api, args.cluster_queue, args.namespace)
        except ValueError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 1
        for spec in args.cluster_queue:
            print(f"queue: bootstrapped ClusterQueue {spec.split(':')[0]!r}")
        queue_manager = QueueManager(
            api, registry=registry, flight_recorder=recorder
        )
    controller = TPUJobController(
        api,
        namespace=args.namespace,
        gang_scheduler_name=args.gang_scheduling,
        registry=registry,
        flight_recorder=recorder,
        step_matrix=matrix,
        memory_matrix=mem_matrix,
    )
    # Controller metrics share the exposed registry.
    if runner is not None:
        runner.start()
    if scheduler is not None:
        scheduler.start()

    applied: list[tuple[str, str]] = []
    import yaml

    for path in args.apply:
        with open(path) as f:
            for doc in yaml.safe_load_all(f):
                if not doc:
                    continue
                meta = doc.setdefault("metadata", {})
                meta.setdefault("namespace", args.namespace or "default")
                if args.namespace and meta["namespace"] != args.namespace:
                    # A scoped controller would never reconcile it and
                    # --exit-on-completion would hang; refuse loudly.
                    print(
                        f"error: {path}: TPUJob namespace "
                        f"{meta['namespace']!r} is outside the watched "
                        f"namespace {args.namespace!r}",
                        file=sys.stderr,
                    )
                    return 1
                from ..runtime.apiserver import AlreadyExistsError, InvalidError

                try:
                    created = api.create("tpujobs", doc)
                    verb = "applied"
                except InvalidError as exc:
                    # Schema admission (CRD analog) rejected the manifest.
                    print(f"error: {path}: {exc}", file=sys.stderr)
                    return 1
                except AlreadyExistsError:
                    # The same job applied twice, or cluster state that
                    # outlives the operator run: adopt the existing job.
                    created = api.get(
                        "tpujobs", meta["namespace"], meta["name"]
                    )
                    verb = "adopted existing"
                applied.append(
                    (created["metadata"]["namespace"], created["metadata"]["name"])
                )
                print(f"{verb} TPUJob {applied[-1][0]}/{applied[-1][1]}")

    stop = threading.Event()

    def lead(lost: threading.Event) -> None:
        # LeaderElector.run sets `lost` both on renew failure and when the
        # process-level stop fires, so it doubles as the term's stop event.
        is_leader.set(1)
        controller.run(threadiness=args.threadiness, stop=lost)

    threads = []
    if queue_manager is not None:
        # Like the in-process scheduler, admission is not leadership-gated:
        # the memory backend is single-process, so there is exactly one
        # suspend writer either way.
        threads.append(
            threading.Thread(
                target=lambda: queue_manager.run(1, stop), daemon=True
            )
        )
    elector = None
    if args.leader_elect:
        elector = LeaderElector(
            api,
            LeaderElectionConfig(
                lock_namespace=args.lock_namespace,
                identity=f"{socket.gethostname()}_{uuid.uuid4().hex[:8]}",
            ),
            on_started_leading=lead,
            on_stopped_leading=lambda: is_leader.set(0),
        )
        threads.append(threading.Thread(target=elector.run, args=(stop,), daemon=True))
    else:
        is_leader.set(1)
        threads.append(
            threading.Thread(
                target=lambda: controller.run(args.threadiness, stop), daemon=True
            )
        )

    # Monitoring starts after the elector exists so /healthz can never race
    # against a half-initialized process.
    if args.monitoring_port:
        health = elector.healthy if elector is not None else (lambda: True)
        queues = [controller.queue]
        if queue_manager is not None:
            queues.append(queue_manager.queue)
        start_monitoring(
            args.monitoring_port, registry, health,
            address=args.monitoring_address, flight_recorder=recorder,
            goodput_ledger=ledger, step_matrix=matrix,
            memory_matrix=mem_matrix,
            profiler=profiling.profiler_for(registry), workqueues=queues,
        )
        print(
            f"monitoring on http://{args.monitoring_address}:"
            f"{args.monitoring_port}/metrics"
        )

    for t in threads:
        t.start()

    # The memory backend is free to poll fast; against a real apiserver
    # every poll is an HTTP GET per applied job, so back off.
    poll_interval = 0.2 if args.backend == "memory" else 2.0
    try:
        while not stop.is_set():
            if args.exit_on_completion and applied:
                finals = []
                for ns, name in applied:
                    try:
                        job = api.get("tpujobs", ns, name)
                    except NotFoundError:
                        # Deleted out from under us: terminal, counts as failed.
                        finals.append(
                            (ns, name, {"type": "Failed", "reason": "Deleted"})
                        )
                        continue
                    terminal = [
                        c
                        for c in (job.get("status") or {}).get("conditions") or []
                        if c["status"] == "True" and c["type"] in ("Succeeded", "Failed")
                    ]
                    finals.append((ns, name, terminal[-1] if terminal else None))
                if all(final is not None for _, _, final in finals):
                    for ns, name, final in finals:
                        print(
                            f"TPUJob {ns}/{name}: {final['type']} ({final.get('reason', '')})"
                        )
                    stop.set()
                    if scheduler is not None:
                        scheduler.stop()
                    if runner is not None:
                        runner.stop()
                    _emit_lock_trace_report()
                    return 0 if all(f["type"] == "Succeeded" for _, _, f in finals) else 1
            time.sleep(poll_interval)
    except KeyboardInterrupt:
        stop.set()
    if scheduler is not None:
        scheduler.stop()
    if runner is not None:
        runner.stop()
    _emit_lock_trace_report()
    return 0


def main() -> int:
    return run()


if __name__ == "__main__":
    sys.exit(main())
