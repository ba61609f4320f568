"""Generate the GPU operator's CRD and single-file installer (the port's
``hack/gen_manifests.py``).

controller-gen analog: the TPUJob CRD's structural OpenAPI v3 schema comes
from the port's own types (``api/v2beta1/types.py``) and schema
(``api/v2beta1/openapi.py:tpujob_schema``), whose ``acceleratorType``
admits ``h100-<gpus>``. The installer is the JAX package's
``deploy/v2beta1/tpu-operator.yaml`` counterpart: Namespace, CRD,
ServiceAccount, ClusterRole, ClusterRoleBinding, ConfigMap and
Deployment. The RBAC rules and the Deployment are kept here, not read from
the JAX package's kustomize base.

The CRD keeps the name ``tpujobs.kubeflow.org``: a cluster serves either
the TPU variant (``crd/kubeflow.org_tpujobs.yaml``) or this GPU one,
never both.

Run from the repo root:  python -m mpi_operator_tpu_torch.cmd.gen_manifests
Verify (CI):             python -m mpi_operator_tpu_torch.cmd.gen_manifests --verify
"""

from __future__ import annotations

import argparse
import io
import pathlib
import sys

import yaml

from ..api.v2beta1 import types
from ..api.v2beta1.openapi import tpujob_schema

DEPLOY = pathlib.Path(__file__).resolve().parent.parent / "deploy"
CRD_FILE = DEPLOY / "crd.yaml"
INSTALLER_FILE = DEPLOY / "gpu-operator.yaml"
NAMESPACE = "gpu-operator"
NAME = "gpu-operator"
# Not built yet: the port has no Dockerfile (ROADMAP item 19's remainder).
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
    return {CRD_FILE: HEADER + dump(crd), INSTALLER_FILE: out.getvalue()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m mpi_operator_tpu_torch.cmd.gen_manifests")
    parser.add_argument("--verify", action="store_true",
                        help="fail if checked-in files differ from generated")
    args = parser.parse_args(argv)
    stale = []
    for path, text in render().items():
        if args.verify:
            if not path.exists() or path.read_text() != text:
                stale.append(path.name)
        else:
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(text)
            print(f"wrote {path}")
    if stale:
        print(f"stale generated manifests: {stale}; run python -m "
              "mpi_operator_tpu_torch.cmd.gen_manifests")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
