"""Carry Llama and ResNet weights between the JAX package's Flax trees
and the port.

The port never sees ``jax``: these functions take and give plain numpy
arrays (the caller does ``np.asarray`` on the JAX side). The Flax leaf
``a/b/c/kernel`` is the port's ``a.b.c.weight``, transposed
(``kernel [in, out]`` -> ``weight [out, in]``); ``embed/embedding`` is
``embed.weight`` as it is; RMSNorm ``scale`` keeps its name. Values are
copied bit for bit.

ResNet: a conv ``kernel [kh, kw, in, out]`` is ``weight [out, in, kh,
kw]``, the head's ``kernel [in, out]`` is ``weight [out, in]``; BN
``scale``/``bias`` keep their names and the ``batch_stats`` ``mean``/
``var`` are the BN modules' buffers of those names. Flax names a block's
norms ``BatchNorm_k`` under ``bn_impl="xla"`` and ``TpuBatchNorm_k``
under ``"pallas"``; the port names them ``BatchNorm_k`` on both routes.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: tuple = ()):
    for key, value in tree.items():
        path = (*prefix, str(key))
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, value


def llama_params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flax Llama param tree (numpy leaves) -> the port's ``state_dict``."""
    state = {}
    for path, leaf in _flatten(tree):
        arr = np.asarray(leaf)
        *modules, leaf_name = path
        if leaf_name == "kernel":
            name, arr = "weight", arr.T
        elif leaf_name == "embedding":
            name = "weight"
        elif leaf_name == "scale":
            name = "scale"
        else:
            raise KeyError(f"unexpected Flax leaf {'/'.join(path)!r}")
        state[".".join((*modules, name))] = torch.tensor(arr)  # a copy
    return state


def llama_params_to_jax(state: Mapping[str, torch.Tensor]) -> dict:
    """The inverse: the port's ``state_dict`` (or any name -> tensor map
    of the same names, e.g. gradients) -> a nested Flax-shaped tree of
    numpy arrays."""
    tree: dict = {}
    for key, tensor in state.items():
        *modules, name = key.split(".")
        arr = tensor.detach().cpu().numpy()
        if name == "scale":
            leaf = "scale"
        elif modules == ["embed"]:
            leaf = "embedding"
        elif name == "weight":
            leaf, arr = "kernel", arr.T
        else:
            raise KeyError(f"unexpected port parameter {key!r}")
        node = tree
        for m in modules:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return tree


_TPU_BN = re.compile(r"^TpuBatchNorm_(\d+)$")
_PORT_BN = re.compile(r"^BatchNorm_(\d+)$")


def resnet_params_from_jax(params: Mapping, batch_stats: Mapping = None
                           ) -> dict[str, torch.Tensor]:
    """Flax ResNet ``params`` and ``batch_stats`` trees (numpy leaves, from
    either BN route) -> the port's ``state_dict``."""
    state = {}
    leaves = [*_flatten(params)] + [*_flatten(batch_stats or {})]
    for path, leaf in leaves:
        arr = np.asarray(leaf)
        *modules, leaf_name = path
        modules = [_TPU_BN.sub(r"BatchNorm_\1", m) for m in modules]
        if leaf_name == "kernel":
            name = "weight"
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
        elif leaf_name in ("scale", "bias", "mean", "var"):
            name = leaf_name
        else:
            raise KeyError(f"unexpected Flax leaf {'/'.join(path)!r}")
        state[".".join((*modules, name))] = torch.tensor(arr)  # a copy
    return state


def resnet_params_to_jax(state: Mapping[str, torch.Tensor],
                         bn_impl: str = "xla") -> tuple[dict, dict]:
    """The inverse: the port's ``state_dict`` (or any name -> tensor map of
    the same names, e.g. gradients) -> ``(params, batch_stats)`` nested
    Flax-shaped trees of numpy arrays, with the block norms spelled as
    Flax spells them under ``bn_impl``."""
    params: dict = {}
    stats: dict = {}
    for key, tensor in state.items():
        *modules, name = key.split(".")
        if bn_impl == "pallas":
            modules = [_PORT_BN.sub(r"TpuBatchNorm_\1", m) for m in modules]
        arr = tensor.detach().cpu().numpy()
        tree, leaf = params, name
        if name == "weight":
            leaf = "kernel"
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        elif name in ("mean", "var"):
            tree = stats
        elif name not in ("scale", "bias"):
            raise KeyError(f"unexpected port tensor {key!r}")
        node = tree
        for m in modules:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr)
    return params, stats
