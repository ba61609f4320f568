"""Carry Llama, BERT, ViT, seq2seq and ResNet weights between the JAX
package's Flax trees and the port.

The port never sees ``jax``: these functions take and give plain numpy
arrays (the caller does ``np.asarray`` on the JAX side). The Flax leaf
``a/b/c/kernel`` is the port's ``a.b.c.weight``, transposed
(``kernel [in, out]`` -> ``weight [out, in]``); an ``embedding`` is the
embedding module's ``weight`` as it is; norm ``scale`` and ``bias`` and
Dense ``bias`` keep their names. Values are copied bit for bit.

Llama MoE: ``layer_i/moe/{router,expert_wg,expert_wu,expert_wd}`` keep
their names and the Flax layout (router [D, E], experts [E, D, F] and
[E, F, D]) in the port's ``layer_i.moe``.

ViT's ``cls``, ``pos_embed`` and ``head`` are parameters of the model
itself, stored as in Flax (``head`` [dim, classes] is not transposed).

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


def _from_flax(tree: Mapping, plain: tuple) -> dict[str, torch.Tensor]:
    state = {}
    for path, leaf in _flatten(tree):
        arr = np.asarray(leaf)
        *modules, leaf_name = path
        if leaf_name == "kernel":
            name, arr = "weight", arr.T
        elif leaf_name == "embedding":
            name = "weight"
        elif leaf_name in plain:
            name = leaf_name
        else:
            raise KeyError(f"unexpected Flax leaf {'/'.join(path)!r}")
        state[".".join((*modules, name))] = torch.tensor(arr)  # a copy
    return state


def _to_flax(state: Mapping[str, torch.Tensor], plain: tuple,
             is_embedding) -> dict:
    tree: dict = {}
    for key, tensor in state.items():
        *modules, name = key.split(".")
        arr = tensor.detach().cpu().numpy()
        if name in plain:
            leaf = name
        elif is_embedding(modules):
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


_LLAMA_PLAIN = ("scale", "router", "expert_wg", "expert_wu", "expert_wd")


def llama_params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flax Llama param tree (numpy leaves, dense or MoE) -> the port's
    ``state_dict``."""
    return _from_flax(tree, _LLAMA_PLAIN)


def llama_params_to_jax(state: Mapping[str, torch.Tensor]) -> dict:
    """The inverse: the port's ``state_dict`` (or any name -> tensor map
    of the same names, e.g. gradients) -> a nested Flax-shaped tree of
    numpy arrays."""
    return _to_flax(state, _LLAMA_PLAIN,
                    lambda modules: modules == ["embed"])


def bert_params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flax BERT param tree (numpy leaves) -> the port's parameters by
    name. A tree made without ``token_types`` has no ``type_embed``: load
    it with ``load_state_dict(..., strict=False)``, which leaves the
    port's ``type_embed`` as it was."""
    return _from_flax(tree, ("scale", "bias"))


def bert_params_to_jax(state: Mapping[str, torch.Tensor]) -> dict:
    """The inverse: the port's ``state_dict`` (or any name -> tensor map
    of the same names, e.g. gradients) -> a nested Flax-shaped tree of
    numpy arrays. Drop ``type_embed.weight`` from ``state`` for the tree
    of a model that never saw token types."""
    return _to_flax(state, ("scale", "bias"),
                    lambda modules: modules[-1].endswith("_embed"))


_VIT_PLAIN = ("scale", "bias", "cls", "pos_embed", "head")


def vit_params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flax ViT param tree (numpy leaves) -> the port's ``state_dict``."""
    return _from_flax(tree, _VIT_PLAIN)


def vit_params_to_jax(state: Mapping[str, torch.Tensor]) -> dict:
    """The inverse: the port's ``state_dict`` (or any name -> tensor map
    of the same names, e.g. gradients) -> a nested Flax-shaped tree of
    numpy arrays."""
    return _to_flax(state, _VIT_PLAIN, lambda modules: False)


def seq2seq_params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flax seq2seq param tree (numpy leaves) -> the port's
    ``state_dict``."""
    return _from_flax(tree, ("scale", "bias"))


def seq2seq_params_to_jax(state: Mapping[str, torch.Tensor]) -> dict:
    """The inverse: the port's ``state_dict`` (or any name -> tensor map
    of the same names, e.g. gradients) -> a nested Flax-shaped tree of
    numpy arrays."""
    return _to_flax(state, ("scale", "bias"),
                    lambda modules: modules in (["embed"], ["pos_embed"]))


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
