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

The Helm chart (``deploy/helm/gpu-operator/``, generated too) holds the
CRD file in ``crds/`` and renders the installer's objects; the images'
Dockerfiles (``mpi_operator_tpu_torch/build/``) are held as text, as
``tests/test_manifests.py`` holds the JAX package's: the operator image
without torch or CUDA, the worker image with both and its kernels built,
the pi image on the worker image.
"""

from __future__ import annotations

import copy
import json
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



# -- the Helm chart (deploy/helm/gpu-operator/, generated) and the images

CHART = DEPLOY / "helm" / gen_manifests.NAME
BUILD = ROOT / "mpi_operator_tpu_torch" / "build"
TEMPLATE_EXPR = re.compile(
    r"(?P<lead>\s*)\{\{(?P<l>-?)\s*(?P<e>.*?)\s*(?P<r>-?)\}\}(?P<trail>\s*)",
    re.S)


def chart_values() -> dict:
    return yaml.safe_load((CHART / "values.yaml").read_text())


def render_chart(values: dict, release: str = "rel",
                 release_ns: str = "ns") -> list[dict]:
    """The chart's templates rendered as Helm renders them, for the few
    expressions the generator writes (any other fails): the helpers'
    name, namespace and labels, ``.Values`` lookups and ``toYaml``,
    each with its ``nindent`` and ``{{-``/``-}}`` trimming."""
    (chart,) = load_all(CHART / "Chart.yaml")
    name = chart["name"]
    helpers = {
        "name": name,
        "namespace": values["namespace"] or release_ns,
        "labels": {"app": name, "app.kubernetes.io/name": name,
                   "app.kubernetes.io/instance": release,
                   "app.kubernetes.io/managed-by": "Helm"},
    }

    def lookup(path: str):
        obj = values
        for key in path.removeprefix(".Values.").split("."):
            obj = obj[key]
        return obj

    def value(expr: str) -> str:
        expr, _, indent = expr.partition(" | nindent ")
        include = re.fullmatch(rf'include "{name}\.(\w+)" \.', expr)
        if include:
            got = helpers[include[1]]
        elif expr.startswith("toYaml "):
            got = lookup(expr.removeprefix("toYaml "))
        else:
            assert re.fullmatch(r"\.Values(\.\w+)+", expr), expr
            got = lookup(expr)
        if not indent:
            assert not isinstance(got, (dict, list)), expr
            return str(got)
        pad = " " * int(indent)
        text = yaml.safe_dump(got, sort_keys=False).rstrip("\n")
        return "".join("\n" + pad + line for line in text.splitlines())

    def sub(m) -> str:
        return ("" if m["l"] else m["lead"]) + value(m["e"]) + (
            "" if m["r"] else m["trail"])

    docs = []
    for path in sorted((CHART / "templates").glob("*.yaml")):
        docs.extend(load_text(TEMPLATE_EXPR.sub(sub, path.read_text())))
    return docs


def load_text(text: str) -> list[dict]:
    return [d for d in yaml.safe_load_all(text) if d]


def test_chart_structure_and_crd():
    (meta,) = load_all(CHART / "Chart.yaml")
    assert meta["name"] == gen_manifests.NAME and meta["apiVersion"] == "v2"
    # crds/ holds deploy/crd.yaml byte for byte; no template is a CRD
    # (a templated copy would make helm conflict with its own crds/).
    assert (CHART / "crds" / "kubeflow.org_tpujobs.yaml").read_bytes() == (
        DEPLOY / "crd.yaml").read_bytes()
    assert [p.name for p in (CHART / "crds").iterdir()] == [
        "kubeflow.org_tpujobs.yaml"]
    templates = {p.name for p in (CHART / "templates").iterdir()}
    assert templates == {
        "_helpers.tpl", "deployment.yaml", "serviceaccount.yaml",
        "clusterrole.yaml", "clusterrolebinding.yaml", "configmap.yaml"}
    for name in templates - {"_helpers.tpl"}:
        assert "CustomResourceDefinition" not in (
            CHART / "templates" / name).read_text()


def test_chart_cluster_role_rules_are_the_installers():
    text = (CHART / "templates" / "clusterrole.yaml").read_text()
    head, _, rules = text.partition("\nrules:\n")
    assert "{{" not in rules, "the rules block must stay plain YAML"
    assert yaml.safe_load("rules:\n" + rules)["rules"] == gen_manifests.RULES
    installer = load_all(DEPLOY / "gpu-operator.yaml")
    (role,) = [d for d in installer if d["kind"] == "ClusterRole"]
    assert role["rules"] == gen_manifests.RULES


def test_chart_values_image_is_the_installers():
    values = chart_values()
    docs = load_all(DEPLOY / "gpu-operator.yaml")
    (dep,) = [d for d in docs if d["kind"] == "Deployment"]
    (container,) = dep["spec"]["template"]["spec"]["containers"]
    image = f"{values['image']['repository']}:{values['image']['tag']}"
    assert image == container["image"] == gen_manifests.IMAGE
    assert values["namespace"] == gen_manifests.NAMESPACE
    assert values["args"] == container["args"]
    assert "--backend=kube" in values["args"]


def _unlabelled(doc: dict) -> dict:
    doc = copy.deepcopy(doc)
    doc["metadata"].pop("labels", None)
    doc.get("spec", {}).get("template", {}).get("metadata", {}).pop(
        "labels", None)
    return doc


@pytest.mark.parametrize("release_ns", ["gpu-operator", "other"])
def test_chart_renders_the_installers_objects(release_ns):
    """With its default values the chart renders the installer's objects
    but the Namespace and the CRD (Helm takes those from the release and
    crds/), whatever the release's namespace: values' namespace wins.
    Every object carries the chart's labels, whose app label is the
    installer's selector."""
    installer = {d["kind"]: d for d in load_all(DEPLOY / "gpu-operator.yaml")
                 if d["kind"] not in ("Namespace", "CustomResourceDefinition")}
    rendered = {d["kind"]: d
                for d in render_chart(chart_values(), release_ns=release_ns)}
    assert rendered.keys() == installer.keys()
    for kind, want in installer.items():
        assert _unlabelled(rendered[kind]) == _unlabelled(want), kind
        assert rendered[kind]["metadata"]["labels"]["app"] == (
            gen_manifests.NAME)
    dep = rendered["Deployment"]["spec"]
    assert dep["selector"]["matchLabels"].items() <= dep["template"][
        "metadata"]["labels"].items()


def test_chart_namespace_defaults_to_the_release():
    values = chart_values()
    values["namespace"] = ""
    rendered = {d["kind"]: d for d in render_chart(values, release_ns="ns")}
    assert rendered["Deployment"]["metadata"]["namespace"] == "ns"
    assert rendered["ConfigMap"]["data"]["lock-namespace"] == "ns"
    (subject,) = rendered["ClusterRoleBinding"]["subjects"]
    assert subject["namespace"] == "ns"


def instructions(path: pathlib.Path) -> list[str]:
    """A Dockerfile's lines that are not comments, continuations joined."""
    text = re.sub(r"\\\n", " ", path.read_text())
    return [line.strip() for line in text.splitlines()
            if line.strip() and not line.strip().startswith("#")]


def words(lines: list[str]) -> set[str]:
    return {w.lower() for line in lines for w in re.findall(r"\b\w+\b", line)}


def test_operator_image_is_the_control_plane_alone():
    lines = instructions(BUILD / "operator" / "Dockerfile")
    # Word match: the package's own name mpi_operator_tpu_torch is one word.
    assert not words(lines) & {"torch", "cuda", "nvidia", "jax", "libtpu"}
    assert lines[0].startswith("FROM python:3.12")
    assert "COPY mpi_operator_tpu_torch ./mpi_operator_tpu_torch" in lines
    assert any(line.startswith("USER ") and not line.startswith("USER 0")
               for line in lines)
    entry = [line for line in lines if line.startswith(("ENTRYPOINT", "CMD"))]
    assert entry == ['ENTRYPOINT ["python", "-m", '
                     '"mpi_operator_tpu_torch.cmd.operator"]']


def test_worker_image_builds_the_kernels_and_runs_the_healthcheck():
    lines = instructions(BUILD / "worker" / "Dockerfile")
    assert re.fullmatch(r"FROM nvidia/cuda:12\.[\d.]+-devel-ubuntu24\.04",
                        lines[0]), lines[0]
    found = words(lines)
    assert "torch" in found and "numpy" in found
    assert not found & {"jax", "libtpu", "openssh", "sshd", "mpirun",
                        "openmpi"}
    assert "COPY mpi_operator_tpu_torch ./mpi_operator_tpu_torch" in lines
    assert "COPY native ./native" in lines
    assert any(line.startswith("RUN make -C native") for line in lines)
    # The kernels are built at image build time, by the port's own build.
    assert 'RUN ["python", "-c", "from mpi_operator_tpu_torch.ops import ' \
           '_build; _build.build()"]' in lines
    assert lines[-1] == ('CMD ["python", "-m", '
                         '"mpi_operator_tpu_torch.launcher.healthcheck"]')


def test_pi_image_builds_from_the_worker_image():
    lines = instructions(BUILD / "pi" / "Dockerfile")
    assert lines[0] == "FROM tpu-job-operator/gpu-worker:latest"
    assert lines[-1] == ('CMD ["python", "-m", '
                         '"mpi_operator_tpu_torch.examples.pi"]')
    (doc,) = load_all(ROOT / "mpi_operator_tpu_torch" / "examples" / "pi.yaml")
    (container,) = doc["spec"]["tpuReplicaSpecs"]["Worker"]["template"][
        "spec"]["containers"]
    assert container["command"] == json.loads(lines[-1].removeprefix("CMD "))
