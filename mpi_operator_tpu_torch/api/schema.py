"""Structural OpenAPI v3 schema enforcement — the apiserver admission
analog.

A real Kubernetes apiserver enforces a CRD's structural schema on every
write: type/required/enum/bounds violations are rejected (422 Invalid),
and unknown fields are *pruned* (silently dropped) unless the schema
marks the subtree ``x-kubernetes-preserve-unknown-fields: true``
(reference counterpart: the apiserver behavior the reference relies on
for v2/crd/kubeflow.org_mpijobs.yaml's embedded pod schema).

The in-memory apiserver applies the same contract to TPUJobs via
``validate_tpujob_object`` so malformed pod templates fail at create
time, matching what the generated CRD would do on a live cluster.

Supported schema subset (everything api/v2beta1/openapi.py emits):
object/array/string/integer/number/boolean types, properties, required,
additionalProperties (schema form), items, enum, minimum/maximum,
minItems, pattern, x-kubernetes-preserve-unknown-fields,
x-kubernetes-int-or-string.
"""

from __future__ import annotations

import re
from typing import Any, List


def validate_schema(obj: Any, schema: dict, path: str = "$") -> List[str]:
    """Return schema violations (empty list = valid). Unknown fields are
    not violations — they are pruning candidates, see ``prune``."""
    errs: List[str] = []
    if schema.get("x-kubernetes-int-or-string"):
        if not isinstance(obj, (int, str)) or isinstance(obj, bool):
            errs.append(f"{path}: expected integer or string")
        return errs
    t = schema.get("type")
    if t == "object":
        if not isinstance(obj, dict):
            return [f"{path}: expected object, got {type(obj).__name__}"]
        for req in schema.get("required", []):
            if req not in obj:
                errs.append(f"{path}: missing required field {req!r}")
        props = schema.get("properties", {})
        addl = schema.get("additionalProperties")
        for key, val in obj.items():
            if key in props:
                errs += validate_schema(val, props[key], f"{path}.{key}")
            elif isinstance(addl, dict):
                errs += validate_schema(val, addl, f"{path}.{key}")
            # unknown field: pruned, not rejected (k8s structural semantics)
    elif t == "array":
        if not isinstance(obj, list):
            return [f"{path}: expected array, got {type(obj).__name__}"]
        if "minItems" in schema and len(obj) < schema["minItems"]:
            errs.append(
                f"{path}: needs at least {schema['minItems']} item(s), got {len(obj)}"
            )
        item_schema = schema.get("items")
        if item_schema:
            for i, item in enumerate(obj):
                errs += validate_schema(item, item_schema, f"{path}[{i}]")
    elif t == "integer":
        if not isinstance(obj, int) or isinstance(obj, bool):
            return [f"{path}: expected integer, got {type(obj).__name__}"]
        if "minimum" in schema and obj < schema["minimum"]:
            errs.append(f"{path}: {obj} below minimum {schema['minimum']}")
        if "maximum" in schema and obj > schema["maximum"]:
            errs.append(f"{path}: {obj} above maximum {schema['maximum']}")
    elif t == "number":
        if not isinstance(obj, (int, float)) or isinstance(obj, bool):
            return [f"{path}: expected number, got {type(obj).__name__}"]
    elif t == "boolean":
        if not isinstance(obj, bool):
            return [f"{path}: expected boolean, got {type(obj).__name__}"]
    elif t == "string":
        if not isinstance(obj, str):
            return [f"{path}: expected string, got {type(obj).__name__}"]
        if "enum" in schema and obj not in schema["enum"]:
            errs.append(f"{path}: {obj!r} not one of {schema['enum']}")
        if "pattern" in schema and not re.search(schema["pattern"], obj):
            errs.append(f"{path}: {obj!r} does not match {schema['pattern']!r}")
    return errs


def prune(obj: Any, schema: dict) -> Any:
    """Drop fields the schema does not know about (k8s structural-schema
    pruning), except under ``x-kubernetes-preserve-unknown-fields``
    subtrees. Returns a new object; the input is not mutated."""
    if schema.get("x-kubernetes-preserve-unknown-fields"):
        # Still recurse into *declared* properties (k8s does: preserve
        # applies to unknown siblings, not to typed children).
        if isinstance(obj, dict) and schema.get("properties"):
            return {
                k: (prune(v, schema["properties"][k])
                    if k in schema["properties"] else v)
                for k, v in obj.items()
            }
        return obj
    t = schema.get("type")
    if t == "object" and isinstance(obj, dict):
        props = schema.get("properties", {})
        addl = schema.get("additionalProperties")
        out = {}
        for key, val in obj.items():
            if key in props:
                out[key] = prune(val, props[key])
            elif isinstance(addl, dict):
                out[key] = prune(val, addl)
            elif addl is True or not props:
                # untyped open object ({"type": "object"} with no
                # properties): nothing to prune against
                out[key] = val
        return out
    if t == "array" and isinstance(obj, list) and schema.get("items"):
        return [prune(item, schema["items"]) for item in obj]
    return obj


_TPUJOB_SCHEMA: dict = {}
_CLUSTER_QUEUE_SCHEMA: dict = {}
_LOCAL_QUEUE_SCHEMA: dict = {}


def tpujob_openapi_schema() -> dict:
    global _TPUJOB_SCHEMA
    if not _TPUJOB_SCHEMA:
        from .v2beta1 import openapi

        _TPUJOB_SCHEMA = openapi.tpujob_schema()
    return _TPUJOB_SCHEMA


def clusterqueue_openapi_schema() -> dict:
    global _CLUSTER_QUEUE_SCHEMA
    if not _CLUSTER_QUEUE_SCHEMA:
        from .v2beta1 import openapi

        _CLUSTER_QUEUE_SCHEMA = openapi.clusterqueue_schema()
    return _CLUSTER_QUEUE_SCHEMA


def localqueue_openapi_schema() -> dict:
    global _LOCAL_QUEUE_SCHEMA
    if not _LOCAL_QUEUE_SCHEMA:
        from .v2beta1 import openapi

        _LOCAL_QUEUE_SCHEMA = openapi.localqueue_schema()
    return _LOCAL_QUEUE_SCHEMA


def admission_schema_for(resource: str):
    """(schema, admission path) for a CRD-backed resource plural, or None
    for builtins the in-memory apiserver stores schema-free."""
    if resource == "tpujobs":
        return tpujob_openapi_schema(), "tpujob"
    if resource == "clusterqueues":
        return clusterqueue_openapi_schema(), "clusterqueue"
    if resource == "localqueues":
        return localqueue_openapi_schema(), "localqueue"
    return None


def validate_tpujob_object(obj: dict) -> List[str]:
    """Admission check for a TPUJob dict against the generated CRD
    schema. Returns violations; empty list = admitted."""
    return validate_schema(obj, tpujob_openapi_schema(), path="tpujob")
