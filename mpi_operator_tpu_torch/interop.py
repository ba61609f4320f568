"""Carry Llama weights between the JAX package's Flax tree and the port.

The port never sees ``jax``: these functions take and give plain numpy
arrays (the caller does ``np.asarray`` on the JAX side). The Flax leaf
``a/b/c/kernel`` is the port's ``a.b.c.weight``, transposed
(``kernel [in, out]`` -> ``weight [out, in]``); ``embed/embedding`` is
``embed.weight`` as it is; RMSNorm ``scale`` keeps its name. Values are
copied bit for bit.
"""

from __future__ import annotations

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
