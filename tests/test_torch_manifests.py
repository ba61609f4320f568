"""The GPU operator's CRD and single-file installer
(``mpi_operator_tpu_torch/deploy/``, written by
``python -m mpi_operator_tpu_torch.cmd.gen_manifests``).

The committed files equal the generator's output; the CRD's schema is the
port's, so ``acceleratorType`` admits ``h100-<gpus>`` (the shipped
``examples/pi.yaml`` validates against it) and refuses the TPU form; and
the installer's ClusterRole grants every resource and verb the port's
operator calls, recorded from the controller scenarios of
``tests/test_torch_controller.py``, the leader elector and the CLI's
``--apply`` path.
"""

from __future__ import annotations

import pathlib
import re
import subprocess
import sys
import threading

import pytest
import yaml

from mpi_operator_tpu_torch.api.schema import validate_schema
from mpi_operator_tpu_torch.cmd import gen_manifests
from mpi_operator_tpu_torch.runtime import apiserver as port_apiserver
from mpi_operator_tpu_torch.runtime.leaderelection import (
    LeaderElectionConfig, LeaderElector)

pytestmark = pytest.mark.kernel

ROOT = pathlib.Path(__file__).resolve().parent.parent
DEPLOY = ROOT / "mpi_operator_tpu_torch" / "deploy"


def load_all(path: pathlib.Path) -> list[dict]:
    return [d for d in yaml.safe_load_all(path.read_text()) if d]


def crd_schema() -> dict:
    (crd,) = load_all(DEPLOY / "crd.yaml")
    (version,) = crd["spec"]["versions"]
    return version["schema"]["openAPIV3Schema"]


def test_generated_manifests_are_fresh():
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_operator_tpu_torch.cmd.gen_manifests",
         "--verify"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_crd_is_the_gpu_variant_of_tpujobs():
    (crd,) = load_all(DEPLOY / "crd.yaml")
    # The same name as the JAX package's CRD: a cluster serves one of them.
    assert crd["metadata"]["name"] == "tpujobs.kubeflow.org"
    assert crd["spec"]["names"]["kind"] == "TPUJob"
    (version,) = crd["spec"]["versions"]
    assert version["name"] == "v2beta1" and version["subresources"] == {
        "status": {}}
    text = yaml.safe_dump(crd)
    assert "nvidia.com/gpu" in text and "google.com/tpu" not in text


@pytest.mark.parametrize("accel,ok", [
    ("h100-2", True), ("h100-8", True), ("h100-16", True),
    ("v5e-16", False), ("v5p-8", False), ("h100", False), ("H100-2", False)])
def test_crd_accelerator_type_pattern(accel, ok):
    pattern = crd_schema()["properties"]["spec"]["properties"]["tpu"][
        "properties"]["acceleratorType"]["pattern"]
    assert bool(re.search(pattern, accel)) == ok


def test_shipped_pi_validates_against_the_crd_and_tpu_form_does_not():
    (doc,) = load_all(ROOT / "mpi_operator_tpu_torch" / "examples" / "pi.yaml")
    assert doc["spec"]["tpu"]["acceleratorType"] == "h100-2"
    assert validate_schema(doc, crd_schema()) == []
    doc["spec"]["tpu"]["acceleratorType"] = "v5e-16"
    errors = validate_schema(doc, crd_schema())
    assert errors and "acceleratorType" in errors[0]


def test_installer_objects_and_namespace():
    docs = load_all(DEPLOY / "gpu-operator.yaml")
    assert [d["kind"] for d in docs] == [
        "Namespace", "CustomResourceDefinition", "ServiceAccount",
        "ClusterRole", "ClusterRoleBinding", "ConfigMap", "Deployment"]
    assert docs[1] == load_all(DEPLOY / "crd.yaml")[0]
    ns = docs[0]["metadata"]["name"]
    by_kind = {d["kind"]: d for d in docs}
    for kind in ("ServiceAccount", "ConfigMap", "Deployment"):
        assert by_kind[kind]["metadata"]["namespace"] == ns
    (subject,) = by_kind["ClusterRoleBinding"]["subjects"]
    assert subject == {"kind": "ServiceAccount", "namespace": ns,
                       "name": by_kind["ServiceAccount"]["metadata"]["name"]}
    pod = by_kind["Deployment"]["spec"]["template"]["spec"]
    assert pod["serviceAccountName"] == subject["name"]
    (container,) = pod["containers"]
    assert container["command"][-1] == "mpi_operator_tpu_torch.cmd.operator"
    # The operator talks REST to the cluster it runs in.
    assert "--backend=kube" in container["args"]
    assert by_kind["ConfigMap"]["data"]["lock-namespace"] == ns


class Recording(port_apiserver.InMemoryAPIServer):
    """Records (resource, verb) for every call made from the port's code
    (not from the test driving it)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.calls: set[tuple[str, str]] = set()

    def _note(self, resource: str, verb: str) -> None:
        frame = sys._getframe(2)
        while frame is not None:
            if frame.f_globals.get("__name__", "").startswith(
                    "mpi_operator_tpu_torch."):
                self.calls.add((resource, verb))
                return
            frame = frame.f_back

    def get(self, resource, namespace, name):
        self._note(resource, "get")
        return super().get(resource, namespace, name)

    def list(self, resource, namespace=None, label_selector=None):
        self._note(resource, "list")
        return super().list(resource, namespace, label_selector)

    def watch(self, resource, namespace=None):
        self._note(resource, "watch")
        return super().watch(resource, namespace)

    def create(self, resource, obj):
        self._note(resource, "create")
        return super().create(resource, obj)

    def update(self, resource, obj):
        self._note(resource, "update")
        return super().update(resource, obj)

    def update_status(self, resource, obj):
        self._note(f"{resource}/status", "update")
        return super().update_status(resource, obj)

    def delete(self, resource, namespace, name):
        self._note(resource, "delete")
        return super().delete(resource, namespace, name)


def _operator_calls(monkeypatch) -> set[tuple[str, str]]:
    from mpi_operator_tpu_torch.cmd import operator as operator_cmd
    from tests import test_torch_controller as tc

    monkeypatch.setattr(port_apiserver, "InMemoryAPIServer", Recording)
    calls: set[tuple[str, str]] = set()
    for name, (scenario, gang) in sorted(tc.SCENARIOS.items()):
        f = tc.Fixture(tc.PORT, "h100-4", 4, gang)
        scenario(f)
        calls |= f.api.calls
    # The CLI: the CRD preflight (its --apply creates TPUJobs, then gets
    # them, and --exit-on-completion's poll gets them: added below).
    api = Recording()
    operator_cmd.check_crd_exists(api, "")
    calls |= api.calls
    api.calls.clear()
    # One leader-election term: acquire (create), renew (get + update).
    stop = threading.Event()
    ticks = []

    def sleep(_):
        ticks.append(1)
        if len(ticks) >= 3:
            stop.set()

    LeaderElector(api, LeaderElectionConfig(identity="a"),
                  on_started_leading=lambda lost: lost.wait(),
                  sleep=sleep).run(stop)
    calls |= api.calls
    return calls | {("tpujobs", "create"), ("tpujobs", "get")}


def _allowed(rules: list[dict], resource: str, verb: str) -> bool:
    plural = resource.split("/")[0]
    version = port_apiserver.RESOURCES[plural].api_version
    group = "" if version == "v1" else version.split("/")[0]
    return any(
        group in rule["apiGroups"] and resource in rule["resources"]
        and (verb in rule["verbs"] or "*" in rule["verbs"])
        for rule in rules)


def test_cluster_role_covers_every_call_of_the_operator(monkeypatch):
    calls = _operator_calls(monkeypatch)
    # The recording saw the operator at work on every kind it owns.
    for want in [("pods", "create"), ("pods", "delete"), ("pods", "watch"),
                 ("services", "create"), ("configmaps", "update"),
                 ("jobs", "create"), ("podgroups", "create"),
                 ("events", "create"), ("tpujobs/status", "update"),
                 ("leases", "create"), ("leases", "update")]:
        assert want in calls, want
    docs = load_all(DEPLOY / "gpu-operator.yaml")
    (role,) = [d for d in docs if d["kind"] == "ClusterRole"]
    missing = sorted(c for c in calls if not _allowed(role["rules"], *c))
    assert not missing, f"ClusterRole lacks {missing}"
    assert role["rules"] == gen_manifests.RULES


def test_jax_cluster_role_lacks_the_event_aggregation_verbs(monkeypatch):
    """Why the port keeps its own rules: the JAX package's ClusterRole
    grants events only create and patch, and the recorder's aggregation
    of a repeated event takes get and update."""
    (jax_role,) = load_all(ROOT / "manifests" / "base" / "cluster-role.yaml")
    calls = _operator_calls(monkeypatch)
    missing = sorted(c for c in calls if not _allowed(jax_role["rules"], *c))
    assert missing == [("events", "get"), ("events", "update")]

