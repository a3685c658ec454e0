"""Weight bridge between the JAX param tree and the port's modules,
counterpart of accflow_tpu/convert/torch_weights.py and convert/store.py.

A JAX tree is nested dicts of arrays whose paths mirror the reference's
torch module names. Per layer:
- conv {w (kh, kw, I, O), b}        <-> Conv2d weight (O, I, kh, kw), bias;
- ZeroConv2d {w, b, scale (C,)}     <-> conv.weight, conv.bias, scale (1, C, 1, 1);
- BatchNorm {scale, bias, mean, var} <-> weight, bias, running_mean, running_var.
The downsample norm exists once, under `downsample.1`, in both.

Both directions walk the module tree by layer type, so every parameter and
every tree leaf is accounted for: a leaf or parameter left over raises.
This module needs numpy and torch only.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn

from accflow_tpu_torch.nn.layers import BatchNorm2d, Conv2d, ZeroConv2d

Tree = Dict[str, Any]


def _layers(module: nn.Module):
    """(dotted path, layer) for every parameterised layer; the conv inside
    a ZeroConv2d belongs to it."""
    owned = set()
    for path, sub in module.named_modules():
        if isinstance(sub, ZeroConv2d):
            owned.add(f"{path}.conv" if path else "conv")
            yield path, sub
        elif isinstance(sub, (Conv2d, BatchNorm2d)) and path not in owned:
            yield path, sub


def _leaves(layer: nn.Module) -> Dict[str, tuple]:
    """JAX leaf name -> (tensor, JAX array -> torch layout, torch layout -> JAX array)."""
    same = (lambda a: a, lambda a: a)
    hwio = (lambda a: a.transpose(3, 2, 0, 1), lambda a: a.transpose(2, 3, 1, 0))
    if isinstance(layer, ZeroConv2d):
        return {"w": (layer.conv.weight, *hwio), "b": (layer.conv.bias, *same),
                "scale": (layer.scale, lambda a: a.reshape(1, -1, 1, 1),
                          lambda a: a.reshape(-1))}
    if isinstance(layer, BatchNorm2d):
        return {"scale": (layer.weight, *same), "bias": (layer.bias, *same),
                "mean": (layer.running_mean, *same), "var": (layer.running_var, *same)}
    out = {"w": (layer.weight, *hwio)}
    if layer.bias is not None:
        out["b"] = (layer.bias, *same)
    return out


def to_jax_params(module: nn.Module) -> Tree:
    """The module's weights as a JAX-layout param tree of numpy arrays."""
    tree: Tree = {}
    for path, layer in _layers(module):
        node = tree
        for part in path.split(".")[:-1]:
            node = node.setdefault(part, {})
        node[path.split(".")[-1]] = {
            leaf: np.array(to_jax(t.detach().cpu().numpy()), order="C")  # a copy
            for leaf, (t, _, to_jax) in _leaves(layer).items()
        }
    return tree


@torch.no_grad()
def load_jax_params(module: nn.Module, tree: Tree) -> nn.Module:
    """Copy a JAX-layout param tree into `module` in place (any device).
    Raises on a missing or unconsumed leaf or a shape mismatch."""
    used = set()
    for path, layer in _layers(module):
        node = tree
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                raise KeyError(f"JAX tree has no subtree for layer {path!r}")
            node = node[part]
        targets = _leaves(layer)
        if set(node) != set(targets):
            raise KeyError(f"{path}: JAX leaves {sorted(node)} vs layer {sorted(targets)}")
        for leaf, (dst, to_torch, _) in targets.items():
            src = np.array(to_torch(np.asarray(node[leaf], dtype=np.float32)), order="C")
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{path}.{leaf}: shape {src.shape} vs {tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(src))
            used.add(f"{path}/{leaf}")
    leftover = set(_flatten(tree)) - {k.replace(".", "/") for k in used}
    if leftover:
        raise ValueError(f"unconsumed JAX leaves: {sorted(leftover)[:10]}")
    return module


def _flatten(tree: Tree, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def load_npz_tree(path: str) -> Tree:
    """Read a param tree saved by accflow_tpu.convert.store.save_params
    (one .npz of slash-joined leaf paths) as nested dicts of numpy arrays."""
    tree: Tree = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = tree
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = np.array(data[key])
    return tree
