"""Generate the GPU operator's CRD, single-file installer and Helm chart
(the port's ``hack/gen_manifests.py``).

controller-gen analog: the TPUJob CRD's structural OpenAPI v3 schema comes
from the port's own types (``api/v2beta1/types.py``) and schema
(``api/v2beta1/openapi.py:tpujob_schema``), whose ``acceleratorType``
admits ``h100-<gpus>``. The installer is the JAX package's
``deploy/v2beta1/tpu-operator.yaml`` counterpart: Namespace, CRD,
ServiceAccount, ClusterRole, ClusterRoleBinding, ConfigMap and
Deployment. The RBAC rules and the Deployment are kept here, not read from
the JAX package's kustomize base.

The Helm chart (``deploy/helm/gpu-operator/``, the counterpart of the JAX
package's ``hack/helm/tpu-operator/``) is made from the same objects: its
``crds/`` holds the CRD file byte for byte, and each template is the
installer's object with its names, namespace, labels, image, replica
count, arguments and resources turned into Helm expressions over
``values.yaml``. The ClusterRole's ``rules:`` stay plain YAML from
``RULES``.

The CRD keeps the name ``tpujobs.kubeflow.org``: a cluster serves either
the TPU variant (``crd/kubeflow.org_tpujobs.yaml``) or this GPU one,
never both.

Run from the repo root:  python -m mpi_operator_tpu_torch.cmd.gen_manifests
Verify (CI):             python -m mpi_operator_tpu_torch.cmd.gen_manifests --verify
"""

from __future__ import annotations

import argparse
import copy
import io
import pathlib
import re
import sys

import yaml

from ..api.v2beta1 import types
from ..api.v2beta1.openapi import tpujob_schema

DEPLOY = pathlib.Path(__file__).resolve().parent.parent / "deploy"
CRD_FILE = DEPLOY / "crd.yaml"
INSTALLER_FILE = DEPLOY / "gpu-operator.yaml"
NAMESPACE = "gpu-operator"
NAME = "gpu-operator"
CHART_DIR = DEPLOY / "helm" / NAME
# Built by mpi_operator_tpu_torch/build/operator/Dockerfile.
IMAGE = "tpu-job-operator/gpu-operator:latest"

HEADER = (
    "# Generated by mpi_operator_tpu_torch/cmd/gen_manifests.py from "
    "mpi_operator_tpu_torch/api/v2beta1/types.py — DO NOT EDIT.\n"
)

# Every verb the operator's controller, event recorder, leader elector and
# CLI (--apply, the CRD preflight, --exit-on-completion) call, by resource;
# tests/test_torch_manifests.py records the calls and holds this list to
# them. Against the JAX package's rules: events also take get and update
# (the recorder aggregates a repeated event into its count).
RULES = [
    {"apiGroups": [""], "resources": ["configmaps", "services"],
     "verbs": ["create", "list", "watch", "update", "get"]},
    {"apiGroups": [""], "resources": ["pods"],
     "verbs": ["create", "get", "list", "watch", "delete"]},
    {"apiGroups": [""], "resources": ["events"],
     "verbs": ["create", "get", "update", "patch"]},
    {"apiGroups": ["coordination.k8s.io"], "resources": ["leases"],
     "verbs": ["create", "get", "update"]},
    {"apiGroups": ["batch"], "resources": ["jobs"],
     "verbs": ["create", "list", "update", "watch", "get", "delete"]},
    {"apiGroups": [types.GROUP_NAME],
     "resources": [types.PLURAL, f"{types.PLURAL}/finalizers",
                   f"{types.PLURAL}/status"],
     "verbs": ["*"]},
    {"apiGroups": ["scheduling.volcano.sh"], "resources": ["podgroups"],
     "verbs": ["*"]},
    {"apiGroups": ["scheduling.x-k8s.io"], "resources": ["podgroups"],
     "verbs": ["*"]},
]


def build_crd() -> dict:
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {
            "name": f"{types.PLURAL}.{types.GROUP_NAME}",
            "annotations": {
                "api-approved.kubernetes.io": "unapproved, experimental"},
        },
        "spec": {
            "group": types.GROUP_NAME,
            "scope": "Namespaced",
            "names": {
                "kind": types.KIND,
                "listKind": f"{types.KIND}List",
                "plural": types.PLURAL,
                "singular": types.KIND.lower(),
                "shortNames": ["tj"],
            },
            "versions": [
                {
                    "name": types.GROUP_VERSION,
                    "served": True,
                    "storage": True,
                    "subresources": {"status": {}},
                    "additionalPrinterColumns": [
                        {"name": "Accelerator", "type": "string",
                         "jsonPath": ".spec.tpu.acceleratorType"},
                        {"name": "State", "type": "string",
                         "jsonPath": ".status.conditions[-1:].type"},
                        {"name": "Age", "type": "date",
                         "jsonPath": ".metadata.creationTimestamp"},
                    ],
                    "schema": {"openAPIV3Schema": tpujob_schema()},
                }
            ],
        },
    }


def _labels() -> dict:
    return {"app": NAME}


def operator_objects() -> list[dict]:
    """ServiceAccount, ClusterRole, ClusterRoleBinding, ConfigMap and
    Deployment, in the installer's namespace."""
    def meta() -> dict:
        return {"name": NAME, "namespace": NAMESPACE, "labels": _labels()}

    deployment = {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": meta(),
        "spec": {
            # One replica by default; scale up with --leader-elect for HA.
            "replicas": 1,
            "selector": {"matchLabels": _labels()},
            "template": {
                "metadata": {"labels": _labels()},
                "spec": {
                    "serviceAccountName": NAME,
                    "containers": [{
                        "name": NAME,
                        "image": IMAGE,
                        "command": ["python", "-m",
                                    "mpi_operator_tpu_torch.cmd.operator"],
                        # In the cluster the operator talks REST to its
                        # apiserver (in-cluster config from the service
                        # account); the operator process imports no torch.
                        "args": [
                            "--backend=kube",
                            "--monitoring-port=9090",
                            "--monitoring-address=0.0.0.0",
                            "--lock-namespace=$(lock-namespace)",
                        ],
                        "env": [{
                            "name": "lock-namespace",
                            "valueFrom": {"configMapKeyRef": {
                                "name": f"{NAME}-config",
                                "key": "lock-namespace"}},
                        }],
                        "ports": [{"name": "monitoring",
                                   "containerPort": 9090}],
                        "readinessProbe": {
                            "httpGet": {"path": "/healthz",
                                        "port": "monitoring"},
                            "initialDelaySeconds": 5,
                        },
                        "resources": {"requests": {"cpu": "100m",
                                                   "memory": "128Mi"}},
                    }],
                },
            },
        },
    }
    return [
        {"apiVersion": "v1", "kind": "ServiceAccount", "metadata": meta()},
        {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "ClusterRole",
            "metadata": {"name": NAME, "labels": _labels()},
            "rules": RULES,
        },
        {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "ClusterRoleBinding",
            "metadata": {"name": NAME, "labels": _labels()},
            "roleRef": {"apiGroup": "rbac.authorization.k8s.io",
                        "kind": "ClusterRole", "name": NAME},
            "subjects": [{"kind": "ServiceAccount", "name": NAME,
                          "namespace": NAMESPACE}],
        },
        {
            "apiVersion": "v1",
            "kind": "ConfigMap",
            "metadata": {"name": f"{NAME}-config", "namespace": NAMESPACE},
            "data": {"lock-namespace": NAMESPACE},
        },
        deployment,
    ]


def dump(doc) -> str:
    return yaml.safe_dump(doc, sort_keys=False, width=88)


# The chart's helpers: the objects' name (the chart's), their namespace
# (values' ``namespace``, else the release's) and their labels.
HELPERS = f"""{{{{- define "{NAME}.name" -}}}}
{{{{- .Chart.Name -}}}}
{{{{- end -}}}}

{{{{- define "{NAME}.namespace" -}}}}
{{{{- default .Release.Namespace .Values.namespace -}}}}
{{{{- end -}}}}

{{{{- define "{NAME}.labels" -}}}}
app: {{{{ include "{NAME}.name" . }}}}
app.kubernetes.io/name: {{{{ include "{NAME}.name" . }}}}
app.kubernetes.io/instance: {{{{ .Release.Name }}}}
app.kubernetes.io/managed-by: {{{{ .Release.Service }}}}
{{{{- end -}}}}
"""

CHART_README = f"""# {NAME} Helm chart

Generated by `python -m mpi_operator_tpu_torch.cmd.gen_manifests` from
the objects of the single-file installer (`../../gpu-operator.yaml`);
do not edit. Installs the GPU operator (`TPUJob`, `kubeflow.org/v2beta1`,
`h100-<gpus>` accelerator types, one worker pod a GPU):

```sh
helm install {NAME} mpi_operator_tpu_torch/deploy/helm/{NAME} \\
  --namespace {NAMESPACE} --create-namespace
```

The CRD ships in `crds/` (the same file as `../../crd.yaml`); Helm
installs it first (`--skip-crds` when it is managed out of band). A
cluster serves either this CRD or the TPU one, never both.

Values: `image.repository` and `image.tag` (the image
`mpi_operator_tpu_torch/build/operator/Dockerfile` builds), `namespace`
(empty: the release's), `replicas` (add `--leader-elect` to `args` for
more than one), `args` (the operator's flags; `--backend=kube` talks to
the cluster it runs in), `resources`.
"""

# Placeholders set into copies of the installer's objects, and the Helm
# expression each becomes in the template text. A block placeholder is a
# key's whole value: its line becomes the key and an expression that
# indents the value under it.
_SCALARS = {
    "__NAME__": f'{{{{ include "{NAME}.name" . }}}}',
    "__NAMESPACE__": f'{{{{ include "{NAME}.namespace" . }}}}',
    "__IMAGE__": '"{{ .Values.image.repository }}:{{ .Values.image.tag }}"',
    "__REPLICAS__": "{{ .Values.replicas }}",
}
_BLOCKS = {
    "__LABELS__": f'include "{NAME}.labels" .',
    "__ARGS__": "toYaml .Values.args",
    "__RESOURCES__": "toYaml .Values.resources",
}


def _template(obj: dict) -> str:
    text = dump(obj)
    for token, expr in _BLOCKS.items():
        text = re.sub(
            rf"^( *)([\w.-]+): {token}$",
            lambda m, e=expr: (f"{m[1]}{m[2]}:\n{m[1]}  {{{{- {e} | nindent "
                               f"{len(m[1]) + 2} }}}}"),
            text, flags=re.M)
    for token, expr in _SCALARS.items():
        text = text.replace(token, expr)
    return HEADER + text


def chart_values() -> dict:
    """``values.yaml``: the installer's image, namespace, replica count,
    operator arguments and resources."""
    deployment = operator_objects()[-1]
    (container,) = deployment["spec"]["template"]["spec"]["containers"]
    repository, _, tag = IMAGE.rpartition(":")
    return {
        # Empty: the release's namespace.
        "namespace": NAMESPACE,
        "image": {"repository": repository, "tag": tag},
        "replicas": deployment["spec"]["replicas"],
        "args": container["args"],
        "resources": container["resources"],
    }


def chart_files() -> dict[str, str]:
    """The Helm chart's files by path under ``CHART_DIR``."""
    objs = copy.deepcopy(operator_objects())
    by_kind = {o["kind"]: o for o in objs}
    for obj in objs:
        obj["metadata"]["name"] = "__NAME__"
        obj["metadata"]["labels"] = "__LABELS__"
        if "namespace" in obj["metadata"]:
            obj["metadata"]["namespace"] = "__NAMESPACE__"
    by_kind["ClusterRoleBinding"]["roleRef"]["name"] = "__NAME__"
    (subject,) = by_kind["ClusterRoleBinding"]["subjects"]
    subject.update(name="__NAME__", namespace="__NAMESPACE__")
    by_kind["ConfigMap"]["metadata"]["name"] = "__NAME__-config"
    by_kind["ConfigMap"]["data"]["lock-namespace"] = "__NAMESPACE__"
    spec = by_kind["Deployment"]["spec"]
    spec["replicas"] = "__REPLICAS__"
    spec["selector"]["matchLabels"]["app"] = "__NAME__"
    spec["template"]["metadata"]["labels"] = "__LABELS__"
    pod = spec["template"]["spec"]
    pod["serviceAccountName"] = "__NAME__"
    (container,) = pod["containers"]
    container.update(image="__IMAGE__", args="__ARGS__",
                     resources="__RESOURCES__")
    container["env"][0]["valueFrom"]["configMapKeyRef"]["name"] = (
        "__NAME__-config")
    chart = {
        "apiVersion": "v2",
        "name": NAME,
        "description": "GPU gang-orchestration operator for TPUJob "
                       "resources (h100-<gpus>, one worker pod a GPU)",
        "type": "application",
        "version": "0.1.0",
        "appVersion": types.GROUP_VERSION,
        "keywords": ["gpu", "pytorch", "kubeflow", "distributed-training"],
    }
    files = {
        "README.md": CHART_README,
        "Chart.yaml": HEADER + dump(chart),
        "values.yaml": HEADER + dump(chart_values()),
        "crds/kubeflow.org_tpujobs.yaml": HEADER + dump(build_crd()),
        "templates/_helpers.tpl": HEADER + HELPERS,
    }
    for kind, obj in by_kind.items():
        files[f"templates/{kind.lower()}.yaml"] = _template(obj)
    return files


def render() -> dict[pathlib.Path, str]:
    """The generated files and their text."""
    crd = build_crd()
    out = io.StringIO()
    out.write(HEADER)
    out.write("# Single-file installer: kubectl apply -f "
              "mpi_operator_tpu_torch/deploy/gpu-operator.yaml\n")
    namespace = {"apiVersion": "v1", "kind": "Namespace",
                 "metadata": {"name": NAMESPACE}}
    for doc in [namespace, crd, *operator_objects()]:
        out.write("---\n")
        out.write(dump(doc))
    files = {CRD_FILE: HEADER + dump(crd), INSTALLER_FILE: out.getvalue()}
    files.update((CHART_DIR / rel, text) for rel, text in chart_files().items())
    return files


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mpi_operator_tpu_torch.cmd.gen_manifests")
    parser.add_argument("--verify", action="store_true",
                        help="fail if checked-in files differ from generated")
    args = parser.parse_args(argv)
    stale = []
    files = render()
    for path, text in files.items():
        if args.verify:
            if not path.exists() or path.read_text() != text:
                stale.append(str(path.relative_to(DEPLOY)))
        else:
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(text)
            print(f"wrote {path}")
    # A chart file the generator no longer writes would still ship.
    for path in sorted(CHART_DIR.rglob("*")):
        if path.is_file() and path not in files:
            if args.verify:
                stale.append(str(path.relative_to(DEPLOY)))
            else:
                path.unlink()
                print(f"removed {path}")
    if stale:
        print(f"stale generated manifests: {stale}; run python -m "
              "mpi_operator_tpu_torch.cmd.gen_manifests")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
