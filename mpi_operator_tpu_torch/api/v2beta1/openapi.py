"""Structural OpenAPI v3 schema for the TPUJob CRD (the port's copy of
``mpi_operator_tpu/api/v2beta1/openapi.py``). The one change:
``spec.tpu.acceleratorType`` takes the GPU form, ``h100-<gpus>``
(``api/topology.py``), and its description says so; and a ClusterQueue
quota's ``generation`` is a GPU generation of ``api/topology.py``
(``h100``), its ``nominalQuota`` and ``borrowingLimit`` counted in GPUs
(``nvidia.com/gpu``), the units the queue (``queue/``) charges.

controller-gen analog: the reference generates its CRD schema from Go
types (`make crd` → v2/crd/kubeflow.org_mpijobs.yaml, Makefile:148-150),
including the full core/v1 PodTemplateSpec schema (~488 KB). Here the
schema is built from these Python dicts: `hack/gen_manifests.py` wraps
them in the CRD envelope, and the in-memory apiserver enforces them at
admission (api/schema.py) the way a real apiserver enforces the CRD —
malformed pod templates are rejected at create time, not at pod-creation
time.

The pod template schema is a *structural* subset of core/v1: every
field the operator's builders consume plus the common pod surface —
containers (env valueFrom/envFrom, probes, lifecycle, securityContext),
volumes with their typed source union, affinity/topology-spread
scheduling. Only genuinely unbounded maps (volumeAttributes,
nodeSelector, labels) stay as additionalProperties string maps; nothing
under ``containers`` is ``x-kubernetes-preserve-unknown-fields``
anymore — malformed probes and volume sources are rejected at
admission, matching the reference's full controller-gen schema
(v2/crd/kubeflow.org_mpijobs.yaml).
"""

from __future__ import annotations

from .. import topology
from . import types

# DNS-1123 label (container/port/volume names).
DNS1123 = r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$"
# A ClusterQueue quota's generation: one that api/topology.py parses from
# ``<generation>-<gpus>`` (the JAX package's pattern, ^v[0-9]+[a-z]*$,
# names TPU generations and refused every GPU quota).
GPU_GENERATION_PATTERN = "^(" + "|".join(sorted(topology.GENERATIONS)) + ")$"


def _str(desc: str = "", **kw) -> dict:
    d = {"type": "string"}
    if desc:
        d["description"] = desc
    d.update(kw)
    return d


def _int(desc: str = "", minimum=None, maximum=None) -> dict:
    d: dict = {"type": "integer", "format": "int32"}
    if desc:
        d["description"] = desc
    if minimum is not None:
        d["minimum"] = minimum
    if maximum is not None:
        d["maximum"] = maximum
    return d


def _bool(desc: str = "") -> dict:
    d = {"type": "boolean"}
    if desc:
        d["description"] = desc
    return d


def _str_array() -> dict:
    return {"type": "array", "items": {"type": "string"}}


def _string_map(desc: str = "") -> dict:
    d = {"type": "object", "additionalProperties": {"type": "string"}}
    if desc:
        d["description"] = desc
    return d


def quantity_map(desc: str = "") -> dict:
    """resources.limits / resources.requests: quantities are int-or-string
    (\"2\", \"500m\", \"1Gi\", 4)."""
    d = {
        "type": "object",
        "additionalProperties": {"x-kubernetes-int-or-string": True},
    }
    if desc:
        d["description"] = desc
    return d


def _int_or_string(desc: str = "") -> dict:
    d: dict = {"x-kubernetes-int-or-string": True}
    if desc:
        d["description"] = desc
    return d


def _int64(desc: str = "", minimum=None) -> dict:
    d: dict = {"type": "integer", "format": "int64"}
    if desc:
        d["description"] = desc
    if minimum is not None:
        d["minimum"] = minimum
    return d


def _name_optional_ref(desc: str = "") -> dict:
    """LocalObjectReference + optional (configMapRef/secretRef shape)."""
    d = {
        "type": "object",
        "properties": {"name": _str(), "optional": _bool()},
    }
    if desc:
        d["description"] = desc
    return d


def _key_selector(desc: str) -> dict:
    """configMapKeyRef / secretKeyRef: one key of a named object."""
    return {
        "type": "object",
        "description": desc,
        "required": ["key"],
        "properties": {
            "key": _str(),
            "name": _str(),
            "optional": _bool(),
        },
    }


def env_value_from_schema() -> dict:
    return {
        "type": "object",
        "description": "Source for the env var's value (exactly one).",
        "properties": {
            "fieldRef": {
                "type": "object",
                "required": ["fieldPath"],
                "properties": {
                    "apiVersion": _str(),
                    "fieldPath": _str("Pod field path, e.g. status.podIP."),
                },
            },
            "resourceFieldRef": {
                "type": "object",
                "required": ["resource"],
                "properties": {
                    "containerName": _str(),
                    "divisor": _int_or_string(),
                    "resource": _str(),
                },
            },
            "configMapKeyRef": _key_selector("A key of a ConfigMap."),
            "secretKeyRef": _key_selector("A key of a Secret."),
        },
    }


def env_from_source_schema() -> dict:
    return {
        "type": "object",
        "description": "Bulk env import from a ConfigMap or Secret.",
        "properties": {
            "prefix": _str("Prepended to every imported key."),
            "configMapRef": _name_optional_ref(),
            "secretRef": _name_optional_ref(),
        },
    }


def _probe_handler_properties() -> dict:
    """The action union shared by probes and lifecycle hooks."""
    return {
        "exec": {
            "type": "object",
            "properties": {"command": _str_array()},
        },
        "httpGet": {
            "type": "object",
            "required": ["port"],
            "properties": {
                "host": _str(),
                "httpHeaders": {
                    "type": "array",
                    "items": {
                        "type": "object",
                        "required": ["name", "value"],
                        "properties": {
                            "name": _str(),
                            "value": _str(),
                        },
                    },
                },
                "path": _str(),
                "port": _int_or_string(),
                "scheme": _str(enum=["HTTP", "HTTPS"]),
            },
        },
        "tcpSocket": {
            "type": "object",
            "required": ["port"],
            "properties": {
                "host": _str(),
                "port": _int_or_string(),
            },
        },
    }


def probe_schema(desc: str) -> dict:
    return {
        "type": "object",
        "description": desc,
        "properties": {
            **_probe_handler_properties(),
            "grpc": {
                "type": "object",
                "required": ["port"],
                "properties": {
                    "port": _int(minimum=1, maximum=65535),
                    "service": _str(),
                },
            },
            "initialDelaySeconds": _int(),
            "periodSeconds": _int(),
            "timeoutSeconds": _int(),
            "successThreshold": _int(),
            "failureThreshold": _int(),
            "terminationGracePeriodSeconds": _int64(minimum=1),
        },
    }


def lifecycle_schema() -> dict:
    handler = {
        "type": "object",
        "properties": {
            **_probe_handler_properties(),
            "sleep": {
                "type": "object",
                "required": ["seconds"],
                "properties": {"seconds": _int64()},
            },
        },
    }
    return {
        "type": "object",
        "description": "postStart/preStop hooks.",
        "properties": {"postStart": handler, "preStop": handler},
    }


def _se_linux_options() -> dict:
    return {
        "type": "object",
        "properties": {
            "level": _str(), "role": _str(),
            "type": _str(), "user": _str(),
        },
    }


def _typed_profile() -> dict:
    """seccompProfile and appArmorProfile share this exact shape."""
    return {
        "type": "object",
        "required": ["type"],
        "properties": {
            "localhostProfile": _str(),
            "type": _str(enum=["Localhost", "RuntimeDefault",
                               "Unconfined"]),
        },
    }


_seccomp_profile = _typed_profile
_app_armor_profile = _typed_profile


def _windows_options() -> dict:
    return {
        "type": "object",
        "properties": {
            "gmsaCredentialSpec": _str(),
            "gmsaCredentialSpecName": _str(),
            "hostProcess": _bool(),
            "runAsUserName": _str(),
        },
    }


def container_security_context_schema() -> dict:
    return {
        "type": "object",
        "description": "Container-level security attributes.",
        "properties": {
            "allowPrivilegeEscalation": _bool(),
            "appArmorProfile": _app_armor_profile(),
            "capabilities": {
                "type": "object",
                "properties": {
                    "add": _str_array(),
                    "drop": _str_array(),
                },
            },
            "privileged": _bool(),
            "procMount": _str(),
            "readOnlyRootFilesystem": _bool(),
            "runAsGroup": _int64(),
            "runAsNonRoot": _bool(),
            "runAsUser": _int64(),
            "seLinuxOptions": _se_linux_options(),
            "seccompProfile": _seccomp_profile(),
            "windowsOptions": _windows_options(),
        },
    }


def pod_security_context_schema() -> dict:
    return {
        "type": "object",
        "description": "Pod-level security attributes.",
        "properties": {
            "appArmorProfile": _app_armor_profile(),
            "fsGroup": _int64(),
            "fsGroupChangePolicy": _str(
                enum=["Always", "OnRootMismatch"]
            ),
            "runAsGroup": _int64(),
            "runAsNonRoot": _bool(),
            "runAsUser": _int64(),
            "seLinuxOptions": _se_linux_options(),
            "seccompProfile": _seccomp_profile(),
            "supplementalGroups": {
                "type": "array",
                "items": _int64(),
            },
            "sysctls": {
                "type": "array",
                "items": {
                    "type": "object",
                    "required": ["name", "value"],
                    "properties": {"name": _str(), "value": _str()},
                },
            },
            "windowsOptions": _windows_options(),
        },
    }


def label_selector_schema() -> dict:
    return {
        "type": "object",
        "properties": {
            "matchLabels": _string_map(),
            "matchExpressions": {
                "type": "array",
                "items": {
                    "type": "object",
                    "required": ["key", "operator"],
                    "properties": {
                        "key": _str(),
                        "operator": _str(
                            enum=["In", "NotIn", "Exists", "DoesNotExist"]
                        ),
                        "values": _str_array(),
                    },
                },
            },
        },
    }


def _node_selector_term() -> dict:
    requirement = {
        "type": "object",
        "required": ["key", "operator"],
        "properties": {
            "key": _str(),
            "operator": _str(
                enum=["In", "NotIn", "Exists", "DoesNotExist", "Gt", "Lt"]
            ),
            "values": _str_array(),
        },
    }
    return {
        "type": "object",
        "properties": {
            "matchExpressions": {"type": "array", "items": requirement},
            "matchFields": {"type": "array", "items": requirement},
        },
    }


def _pod_affinity_term() -> dict:
    return {
        "type": "object",
        "required": ["topologyKey"],
        "properties": {
            "labelSelector": label_selector_schema(),
            "matchLabelKeys": _str_array(),
            "mismatchLabelKeys": _str_array(),
            "namespaceSelector": label_selector_schema(),
            "namespaces": _str_array(),
            "topologyKey": _str(),
        },
    }


def _pod_affinity_group() -> dict:
    """podAffinity / podAntiAffinity share this shape."""
    return {
        "type": "object",
        "properties": {
            "requiredDuringSchedulingIgnoredDuringExecution": {
                "type": "array",
                "items": _pod_affinity_term(),
            },
            "preferredDuringSchedulingIgnoredDuringExecution": {
                "type": "array",
                "items": {
                    "type": "object",
                    "required": ["podAffinityTerm", "weight"],
                    "properties": {
                        "podAffinityTerm": _pod_affinity_term(),
                        "weight": _int(minimum=1, maximum=100),
                    },
                },
            },
        },
    }


def affinity_schema() -> dict:
    return {
        "type": "object",
        "description": "node/pod (anti-)affinity scheduling constraints.",
        "properties": {
            "nodeAffinity": {
                "type": "object",
                "properties": {
                    "requiredDuringSchedulingIgnoredDuringExecution": {
                        "type": "object",
                        "required": ["nodeSelectorTerms"],
                        "properties": {
                            "nodeSelectorTerms": {
                                "type": "array",
                                "items": _node_selector_term(),
                            },
                        },
                    },
                    "preferredDuringSchedulingIgnoredDuringExecution": {
                        "type": "array",
                        "items": {
                            "type": "object",
                            "required": ["preference", "weight"],
                            "properties": {
                                "preference": _node_selector_term(),
                                "weight": _int(minimum=1, maximum=100),
                            },
                        },
                    },
                },
            },
            "podAffinity": _pod_affinity_group(),
            "podAntiAffinity": _pod_affinity_group(),
        },
    }


def topology_spread_constraint_schema() -> dict:
    return {
        "type": "object",
        "required": ["maxSkew", "topologyKey", "whenUnsatisfiable"],
        "properties": {
            "labelSelector": label_selector_schema(),
            "matchLabelKeys": _str_array(),
            "maxSkew": _int(minimum=1),
            "minDomains": _int(minimum=0),
            "nodeAffinityPolicy": _str(enum=["Honor", "Ignore"]),
            "nodeTaintsPolicy": _str(enum=["Honor", "Ignore"]),
            "topologyKey": _str(),
            "whenUnsatisfiable": _str(
                enum=["DoNotSchedule", "ScheduleAnyway"]
            ),
        },
    }


def _key_path_items() -> dict:
    """configMap/secret volume item projections."""
    return {
        "type": "array",
        "items": {
            "type": "object",
            "required": ["key", "path"],
            "properties": {
                "key": _str(),
                "mode": _int(),
                "path": _str(),
            },
        },
    }


def _downward_api_items() -> dict:
    return {
        "type": "array",
        "items": {
            "type": "object",
            "required": ["path"],
            "properties": {
                "fieldRef": {
                    "type": "object",
                    "required": ["fieldPath"],
                    "properties": {
                        "apiVersion": _str(),
                        "fieldPath": _str(),
                    },
                },
                "mode": _int(),
                "path": _str(),
                "resourceFieldRef": {
                    "type": "object",
                    "required": ["resource"],
                    "properties": {
                        "containerName": _str(),
                        "divisor": _int_or_string(),
                        "resource": _str(),
                    },
                },
            },
        },
    }


def _obj(required=None, **props) -> dict:
    """Compact object-schema builder for the legacy volume sources."""
    d: dict = {"type": "object", "properties": props}
    if required:
        d["required"] = list(required)
    return d


def _secret_ref() -> dict:
    return _obj(name=_str())


def _legacy_volume_sources() -> dict:
    """The remaining core/v1 volume sources. Mostly superseded by CSI,
    but prune semantics mean an OMITTED source would be silently
    stripped from stored objects (not rejected) — so every core/v1
    member must stay representable, like the reference's full
    controller-gen schema."""
    return {
        "awsElasticBlockStore": _obj(
            ["volumeID"], fsType=_str(), partition=_int(),
            readOnly=_bool(), volumeID=_str(),
        ),
        "azureDisk": _obj(
            ["diskName", "diskURI"], cachingMode=_str(), diskName=_str(),
            diskURI=_str(), fsType=_str(), kind=_str(), readOnly=_bool(),
        ),
        "azureFile": _obj(
            ["secretName", "shareName"], readOnly=_bool(),
            secretName=_str(), shareName=_str(),
        ),
        "cephfs": _obj(
            ["monitors"], monitors=_str_array(), path=_str(),
            readOnly=_bool(), secretFile=_str(), secretRef=_secret_ref(),
            user=_str(),
        ),
        "cinder": _obj(
            ["volumeID"], fsType=_str(), readOnly=_bool(),
            secretRef=_secret_ref(), volumeID=_str(),
        ),
        "fc": _obj(
            None, fsType=_str(), lun=_int(), readOnly=_bool(),
            targetWWNs=_str_array(), wwids=_str_array(),
        ),
        "flexVolume": _obj(
            ["driver"], driver=_str(), fsType=_str(),
            options=_string_map(), readOnly=_bool(),
            secretRef=_secret_ref(),
        ),
        "flocker": _obj(None, datasetName=_str(), datasetUUID=_str()),
        "gcePersistentDisk": _obj(
            ["pdName"], fsType=_str(), partition=_int(), pdName=_str(),
            readOnly=_bool(),
        ),
        "gitRepo": _obj(
            ["repository"], directory=_str(), repository=_str(),
            revision=_str(),
        ),
        "glusterfs": _obj(
            ["endpoints", "path"], endpoints=_str(), path=_str(),
            readOnly=_bool(),
        ),
        "image": _obj(None, pullPolicy=_str(), reference=_str()),
        "iscsi": _obj(
            ["iqn", "lun", "targetPortal"], chapAuthDiscovery=_bool(),
            chapAuthSession=_bool(), fsType=_str(), initiatorName=_str(),
            iqn=_str(), iscsiInterface=_str(), lun=_int(),
            portals=_str_array(), readOnly=_bool(),
            secretRef=_secret_ref(), targetPortal=_str(),
        ),
        "photonPersistentDisk": _obj(["pdID"], fsType=_str(), pdID=_str()),
        "portworxVolume": _obj(
            ["volumeID"], fsType=_str(), readOnly=_bool(), volumeID=_str(),
        ),
        "quobyte": _obj(
            ["registry", "volume"], group=_str(), readOnly=_bool(),
            registry=_str(), tenant=_str(), user=_str(), volume=_str(),
        ),
        "rbd": _obj(
            ["image", "monitors"], fsType=_str(), image=_str(),
            keyring=_str(), monitors=_str_array(), pool=_str(),
            readOnly=_bool(), secretRef=_secret_ref(), user=_str(),
        ),
        "scaleIO": _obj(
            ["gateway", "secretRef", "system"], fsType=_str(),
            gateway=_str(), protectionDomain=_str(), readOnly=_bool(),
            secretRef=_secret_ref(), sslEnabled=_bool(),
            storageMode=_str(), storagePool=_str(), system=_str(),
            volumeName=_str(),
        ),
        "storageos": _obj(
            None, fsType=_str(), readOnly=_bool(), secretRef=_secret_ref(),
            volumeName=_str(), volumeNamespace=_str(),
        ),
        "vsphereVolume": _obj(
            ["volumePath"], fsType=_str(), storagePolicyID=_str(),
            storagePolicyName=_str(), volumePath=_str(),
        ),
    }


def volume_schema() -> dict:
    """The complete core/v1 volume-source union, typed. The common TPU
    sources (datasets, checkpoints, tokens, scratch) are spelled out
    first; the legacy pre-CSI sources follow so that nothing a user's
    template legally carries gets pruned away."""
    return {
        "type": "object",
        "required": ["name"],
        "properties": {
            "name": _str(pattern=DNS1123),
            "configMap": {
                "type": "object",
                "properties": {
                    "defaultMode": _int(),
                    "items": _key_path_items(),
                    "name": _str(),
                    "optional": _bool(),
                },
            },
            "secret": {
                "type": "object",
                "properties": {
                    "defaultMode": _int(),
                    "items": _key_path_items(),
                    "optional": _bool(),
                    "secretName": _str(),
                },
            },
            "emptyDir": {
                "type": "object",
                "properties": {
                    "medium": _str(),
                    "sizeLimit": _int_or_string(),
                },
            },
            "hostPath": {
                "type": "object",
                "required": ["path"],
                "properties": {
                    "path": _str(),
                    "type": _str(),
                },
            },
            "persistentVolumeClaim": {
                "type": "object",
                "required": ["claimName"],
                "properties": {
                    "claimName": _str(),
                    "readOnly": _bool(),
                },
            },
            "nfs": {
                "type": "object",
                "required": ["path", "server"],
                "properties": {
                    "path": _str(),
                    "readOnly": _bool(),
                    "server": _str(),
                },
            },
            "csi": {
                "type": "object",
                "required": ["driver"],
                "properties": {
                    "driver": _str(),
                    "fsType": _str(),
                    "nodePublishSecretRef": {
                        "type": "object",
                        "properties": {"name": _str()},
                    },
                    "readOnly": _bool(),
                    # Driver-defined: a genuinely unbounded string map.
                    "volumeAttributes": _string_map(),
                },
            },
            "downwardAPI": {
                "type": "object",
                "properties": {
                    "defaultMode": _int(),
                    "items": _downward_api_items(),
                },
            },
            "projected": {
                "type": "object",
                "properties": {
                    "defaultMode": _int(),
                    "sources": {
                        "type": "array",
                        "items": {
                            "type": "object",
                            "properties": {
                                "configMap": {
                                    "type": "object",
                                    "properties": {
                                        "items": _key_path_items(),
                                        "name": _str(),
                                        "optional": _bool(),
                                    },
                                },
                                "downwardAPI": {
                                    "type": "object",
                                    "properties": {
                                        "items": _downward_api_items(),
                                    },
                                },
                                "secret": {
                                    "type": "object",
                                    "properties": {
                                        "items": _key_path_items(),
                                        "name": _str(),
                                        "optional": _bool(),
                                    },
                                },
                                "serviceAccountToken": {
                                    "type": "object",
                                    "required": ["path"],
                                    "properties": {
                                        "audience": _str(),
                                        "expirationSeconds": _int64(
                                            minimum=600
                                        ),
                                        "path": _str(),
                                    },
                                },
                            },
                        },
                    },
                },
            },
            "ephemeral": {
                "type": "object",
                "properties": {
                    "volumeClaimTemplate": {
                        "type": "object",
                        "required": ["spec"],
                        "properties": {
                            "metadata": {
                                "type": "object",
                                "properties": {
                                    "labels": _string_map(),
                                    "annotations": _string_map(),
                                },
                            },
                            "spec": {
                                "type": "object",
                                "properties": {
                                    "accessModes": _str_array(),
                                    "dataSource": _obj(
                                        ["kind", "name"],
                                        apiGroup=_str(), kind=_str(),
                                        name=_str(),
                                    ),
                                    "dataSourceRef": _obj(
                                        ["kind", "name"],
                                        apiGroup=_str(), kind=_str(),
                                        name=_str(), namespace=_str(),
                                    ),
                                    "resources": {
                                        "type": "object",
                                        "properties": {
                                            "limits": quantity_map(),
                                            "requests": quantity_map(),
                                        },
                                    },
                                    "selector": label_selector_schema(),
                                    "storageClassName": _str(),
                                    "volumeAttributesClassName": _str(),
                                    "volumeMode": _str(
                                        enum=["Block", "Filesystem"]
                                    ),
                                    "volumeName": _str(),
                                },
                            },
                        },
                    },
                },
            },
            **_legacy_volume_sources(),
        },
    }


def container_schema() -> dict:
    return {
        "type": "object",
        "required": ["name"],
        "properties": {
            "name": _str("Container name (DNS label).", pattern=DNS1123),
            "image": _str("Container image."),
            "command": _str_array(),
            "args": _str_array(),
            "workingDir": _str(),
            "imagePullPolicy": _str(
                enum=["Always", "IfNotPresent", "Never"]
            ),
            "env": {
                "type": "array",
                "items": {
                    "type": "object",
                    "required": ["name"],
                    "properties": {
                        "name": _str("Environment variable name."),
                        "value": _str(),
                        "valueFrom": env_value_from_schema(),
                    },
                },
            },
            "envFrom": {
                "type": "array",
                "items": env_from_source_schema(),
            },
            "ports": {
                "type": "array",
                "items": {
                    "type": "object",
                    "required": ["containerPort"],
                    "properties": {
                        "name": _str(pattern=DNS1123),
                        "containerPort": _int(minimum=1, maximum=65535),
                        "hostPort": _int(minimum=1, maximum=65535),
                        "protocol": _str(enum=["TCP", "UDP", "SCTP"]),
                    },
                },
            },
            "resources": {
                "type": "object",
                "description": (
                    "Compute resources; nvidia.com/gpu limits are injected "
                    "by the operator when absent."
                ),
                "properties": {
                    "limits": quantity_map(),
                    "requests": quantity_map(),
                },
            },
            "volumeMounts": {
                "type": "array",
                "items": {
                    "type": "object",
                    "required": ["name", "mountPath"],
                    "properties": {
                        "name": _str(),
                        "mountPath": _str(),
                        "subPath": _str(),
                        "readOnly": _bool(),
                    },
                },
            },
            "securityContext": container_security_context_schema(),
            "lifecycle": lifecycle_schema(),
            "livenessProbe": probe_schema("Container liveness probe."),
            "readinessProbe": probe_schema("Container readiness probe."),
            "startupProbe": probe_schema("Container startup probe."),
            "terminationMessagePath": _str(),
            "terminationMessagePolicy": _str(
                enum=["File", "FallbackToLogsOnError"]
            ),
            "stdin": _bool(),
            "tty": _bool(),
        },
    }


def pod_template_schema() -> dict:
    """Trimmed core/v1 PodTemplateSpec (reference embeds the full schema,
    v2/crd/kubeflow.org_mpijobs.yaml; this keeps the fields that matter
    structural and leaves exotic subtrees open)."""
    return {
        "type": "object",
        "description": "core/v1 PodTemplateSpec for the replica pods.",
        "properties": {
            "metadata": {
                "type": "object",
                "properties": {
                    "labels": _string_map(),
                    "annotations": _string_map(),
                    "name": _str(),
                    "namespace": _str(),
                },
            },
            "spec": {
                "type": "object",
                "required": ["containers"],
                "properties": {
                    "containers": {
                        "type": "array",
                        "minItems": 1,
                        "items": container_schema(),
                    },
                    "initContainers": {
                        "type": "array",
                        "items": container_schema(),
                    },
                    "volumes": {
                        "type": "array",
                        "items": volume_schema(),
                    },
                    "nodeSelector": _string_map(),
                    "tolerations": {
                        "type": "array",
                        "items": {
                            "type": "object",
                            "properties": {
                                "key": _str(),
                                "operator": _str(enum=["Exists", "Equal"]),
                                "value": _str(),
                                "effect": _str(
                                    enum=[
                                        "NoSchedule",
                                        "PreferNoSchedule",
                                        "NoExecute",
                                    ]
                                ),
                                "tolerationSeconds": {
                                    "type": "integer",
                                    "format": "int64",
                                },
                            },
                        },
                    },
                    "affinity": affinity_schema(),
                    "topologySpreadConstraints": {
                        "type": "array",
                        "items": topology_spread_constraint_schema(),
                    },
                    "schedulerName": _str(),
                    "priorityClassName": _str(),
                    "serviceAccountName": _str(),
                    "automountServiceAccountToken": _bool(),
                    "restartPolicy": _str(
                        "Pod-level restart policy; the operator derives it "
                        "from the ReplicaSpec when unset.",
                        enum=["Always", "OnFailure", "Never"],
                    ),
                    "terminationGracePeriodSeconds": {
                        "type": "integer",
                        "format": "int64",
                        "minimum": 0,
                    },
                    "activeDeadlineSeconds": {
                        "type": "integer",
                        "format": "int64",
                        "minimum": 1,
                    },
                    "hostNetwork": _bool(),
                    "hostPID": _bool(),
                    "hostIPC": _bool(),
                    "dnsPolicy": _str(
                        enum=[
                            "ClusterFirst",
                            "ClusterFirstWithHostNet",
                            "Default",
                            "None",
                        ]
                    ),
                    "securityContext": pod_security_context_schema(),
                    "imagePullSecrets": {
                        "type": "array",
                        "items": {
                            "type": "object",
                            "properties": {"name": _str()},
                        },
                    },
                    "subdomain": _str(),
                    "hostname": _str(),
                },
            },
        },
    }


def replica_spec_schema(role: str) -> dict:
    return {
        "type": "object",
        "description": f"{role} replica group.",
        "properties": {
            "replicas": _int(
                "Number of replicas. For Worker this is normally derived "
                "from spec.tpu and may be omitted.",
                minimum=0,
            ),
            "restartPolicy": _str(
                "Restart policy for replica pods.",
                enum=[types.RESTART_POLICY_NEVER, types.RESTART_POLICY_ON_FAILURE],
            ),
            "template": pod_template_schema(),
        },
    }


def pod_failure_policy_schema() -> dict:
    """batch/v1 PodFailurePolicy analog: ordered rules classifying worker
    failures by container exit code or pod condition/reason."""
    return {
        "type": "object",
        "required": ["rules"],
        "description": (
            "Ordered failure-classification rules; the first rule matching "
            "a failed worker pod decides its fate. Ignore replaces the pod "
            "without charging backoffLimit, Restart replaces and charges, "
            "FailJob fails the job with reason PodFailurePolicy."
        ),
        "properties": {
            "rules": {
                "type": "array",
                "items": {
                    "type": "object",
                    "required": ["action"],
                    "properties": {
                        "action": _str(
                            "What to do with a matching failed pod.",
                            enum=[
                                types.POD_FAILURE_POLICY_ACTION_IGNORE,
                                types.POD_FAILURE_POLICY_ACTION_RESTART,
                                types.POD_FAILURE_POLICY_ACTION_FAIL_JOB,
                            ],
                        ),
                        "onExitCodes": {
                            "type": "object",
                            "required": ["operator", "values"],
                            "properties": {
                                "containerName": _str(
                                    "Restrict matching to this container."
                                ),
                                "operator": _str(
                                    enum=[
                                        types.POD_FAILURE_POLICY_OP_IN,
                                        types.POD_FAILURE_POLICY_OP_NOT_IN,
                                    ]
                                ),
                                "values": {
                                    "type": "array",
                                    "items": _int(minimum=0, maximum=255),
                                },
                            },
                        },
                        "onPodConditions": {
                            "type": "array",
                            "items": {
                                "type": "object",
                                "properties": {
                                    "type": _str("Pod condition type to match."),
                                    "status": _str(
                                        enum=["True", "False", "Unknown"]
                                    ),
                                    "reason": _str(
                                        "Match pod status.reason (e.g. Evicted, "
                                        "NodeLost) — TPU extension."
                                    ),
                                },
                            },
                        },
                    },
                },
            },
        },
    }


def job_spec_schema() -> dict:
    return {
        "type": "object",
        "required": ["tpuReplicaSpecs"],
        "properties": {
            "tpu": {
                "type": "object",
                "description": (
                    "The GPUs this job trains on. Worker count (one pod per "
                    "GPU) is derived from acceleratorType/topology."
                ),
                "properties": {
                    "acceleratorType": _str(
                        "GPU type, <generation>-<gpus>, e.g. h100-8.",
                        pattern=r"^h[0-9]+-[0-9]+$",
                    ),
                    "topology": _str(
                        "Optional explicit topology, <nodes>x<gpus a node>, "
                        "e.g. 2x8.",
                        pattern=r"^[0-9]+(x[0-9]+)*$",
                    ),
                    "numSlices": _int(
                        "Number of pod slices; must be 1 on GPUs.",
                        minimum=1,
                    ),
                    "runtimeVersion": _str("TPU VM runtime version label."),
                    "hotSpares": _int(
                        "Standby workers kept warm (scheduled, "
                        "bootstrapped, parked before the barrier) for "
                        "fast promotion when a worker death is "
                        "restart-eligible.",
                        minimum=0,
                    ),
                },
            },
            "jaxDistribution": {
                "type": "object",
                "description": (
                    "Rendezvous wiring for jax.distributed.initialize. "
                    "Replaces the reference operator's SSH bootstrap: the only "
                    "shared state is worker-0's coordinator address."
                ),
                "properties": {
                    "coordinatorPort": _int(
                        "Coordinator port on worker 0.", minimum=1, maximum=65535
                    ),
                    "heartbeatTimeoutSeconds": _int(
                        "jax.distributed heartbeat timeout.", minimum=1
                    ),
                },
            },
            "runPolicy": {
                "type": "object",
                "description": "Policies for job lifetime and cleanup.",
                "properties": {
                    "cleanPodPolicy": _str(
                        "Which worker pods to delete once the job finishes.",
                        enum=[
                            types.CLEAN_POD_POLICY_NONE,
                            types.CLEAN_POD_POLICY_RUNNING,
                            types.CLEAN_POD_POLICY_ALL,
                        ],
                    ),
                    "ttlSecondsAfterFinished": _int(minimum=0),
                    "activeDeadlineSeconds": _int(minimum=0),
                    "backoffLimit": _int(minimum=0),
                    "suspend": {
                        "type": "boolean",
                        "description": "Suspend gates worker/launcher creation.",
                    },
                    "schedulingPolicy": {
                        "type": "object",
                        "properties": {
                            "minAvailable": _int(minimum=0),
                            "queue": _str(),
                            "priorityClass": _str(),
                        },
                    },
                    "podFailurePolicy": pod_failure_policy_schema(),
                },
            },
            "tpuReplicaSpecs": {
                "type": "object",
                "required": [types.REPLICA_TYPE_WORKER],
                "properties": {
                    types.REPLICA_TYPE_LAUNCHER: replica_spec_schema("Launcher"),
                    types.REPLICA_TYPE_WORKER: replica_spec_schema("Worker"),
                },
            },
        },
    }


def job_status_schema() -> dict:
    return {
        "type": "object",
        "properties": {
            "conditions": {
                "type": "array",
                "items": {
                    "type": "object",
                    "required": ["type", "status"],
                    "properties": {
                        "type": _str(
                            enum=[
                                types.JOB_CREATED,
                                types.JOB_SCHEDULED,
                                types.JOB_RUNNING,
                                types.JOB_RESTARTING,
                                types.JOB_SUSPENDED,
                                types.JOB_SUCCEEDED,
                                types.JOB_FAILED,
                                types.JOB_QUOTA_RESERVED,
                                types.JOB_QUEUE_NOT_FOUND,
                            ]
                        ),
                        "status": _str(enum=["True", "False", "Unknown"]),
                        "reason": _str(),
                        "message": _str(),
                        "lastUpdateTime": {"type": "number"},
                        "lastTransitionTime": {"type": "number"},
                    },
                },
            },
            "replicaStatuses": {
                "type": "object",
                "additionalProperties": {
                    "type": "object",
                    "properties": {
                        "active": _int(minimum=0),
                        "succeeded": _int(minimum=0),
                        "failed": _int(minimum=0),
                        "restarts": _int(minimum=0),
                    },
                },
            },
            "startTime": {"type": "number"},
            "completionTime": {"type": "number"},
            "lastReconcileTime": {"type": "number"},
        },
    }


def tpujob_schema() -> dict:
    """The complete openAPIV3Schema for the TPUJob CRD version entry."""
    return {
        "type": "object",
        "properties": {
            "apiVersion": _str(),
            "kind": _str(),
            "metadata": {"type": "object"},
            "spec": job_spec_schema(),
            "status": job_status_schema(),
        },
    }


def clusterqueue_schema() -> dict:
    """openAPIV3Schema for the ClusterQueue CRD (Kueue analog, GPU-only)."""
    return {
        "type": "object",
        "properties": {
            "apiVersion": _str(),
            "kind": _str(),
            "metadata": {"type": "object"},
            "spec": {
                "type": "object",
                "required": ["quotas"],
                "properties": {
                    "cohort": _str(
                        "Cohort name; member queues lend unused quota to "
                        "each other.",
                        pattern=DNS1123,
                    ),
                    "quotas": {
                        "type": "array",
                        "minItems": 1,
                        "items": {
                            "type": "object",
                            "required": ["generation", "nominalQuota"],
                            "properties": {
                                "generation": _str(
                                    "GPU generation, the <generation> of "
                                    "an h100-<gpus> acceleratorType, "
                                    "e.g. h100.",
                                    pattern=GPU_GENERATION_PATTERN,
                                ),
                                "nominalQuota": _int(
                                    "GPUs (nvidia.com/gpu) this queue "
                                    "owns outright.",
                                    minimum=0,
                                ),
                                "borrowingLimit": _int(
                                    "Max GPUs borrowable from the cohort "
                                    "on top of nominalQuota (unset = "
                                    "unbounded).",
                                    minimum=0,
                                ),
                            },
                        },
                    },
                    "preemption": {
                        "type": "object",
                        "properties": {
                            "reclaimWithinCohort": _str(
                                "Whether lent quota is reclaimed by "
                                "evicting cohort borrowers.",
                                enum=["Never", "Any"],
                            ),
                        },
                    },
                },
            },
            "status": {
                "type": "object",
                "properties": {
                    "pendingWorkloads": _int(minimum=0),
                    "admittedWorkloads": _int(minimum=0),
                    "usage": {
                        "type": "object",
                        "description": "generation -> admitted chips.",
                        "additionalProperties": {
                            "type": "integer",
                            "format": "int32",
                        },
                    },
                },
            },
        },
    }


def localqueue_schema() -> dict:
    """openAPIV3Schema for the LocalQueue CRD (namespace -> ClusterQueue)."""
    return {
        "type": "object",
        "properties": {
            "apiVersion": _str(),
            "kind": _str(),
            "metadata": {"type": "object"},
            "spec": {
                "type": "object",
                "required": ["clusterQueue"],
                "properties": {
                    "clusterQueue": _str(
                        "Name of the ClusterQueue this LocalQueue admits "
                        "into.",
                        pattern=DNS1123,
                    ),
                },
            },
        },
    }
