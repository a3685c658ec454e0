"""Weight bridge between the JAX param tree and the port's modules,
counterpart of accflow_tpu/convert/torch_weights.py and convert/store.py.

A JAX tree is nested dicts of arrays whose paths mirror the reference's
torch module names. Per layer:
- conv {w (kh, kw, I, O), b}        <-> Conv2d weight (O, I, kh, kw), bias;
- ZeroConv2d {w, b, scale (C,)}     <-> conv.weight, conv.bias, scale (1, C, 1, 1);
- BatchNorm {scale, bias, mean, var} <-> weight, bias, running_mean, running_var;
- GroupNorm {scale, bias}           <-> weight, bias;
- Embedding {emb (num, dim)}        <-> weight (GMA's RelPosEmb tables);
- a bare parameter (GMA's Aggregate `gamma`) is a leaf of its module's
  subtree under its own name.
The downsample norm exists once, under `downsample.1`, in both.

Both directions walk the module tree by layer type, so every parameter and
every tree leaf is accounted for: a leaf or parameter left over raises.

Reference checkpoints (.pth, accflow_tpu/convert/torch_weights.py): the
port's modules carry the reference's state_dict names, so a checkpoint loads
onto them directly once the `module.` prefix of nn.DataParallel is stripped,
AccFlow's frozen OFE (`ofe.*`) is split off, and the reference's second name
for the downsample norm (`norm3` in ResidualBlock, `norm4` in
BottleneckBlock, the same tensors as `downsample.1`) and
`num_batches_tracked` and GMA's `rel_ind` buffer (RelPosEmb's index matrix,
no weights) are dropped. Any other key left over, or missing, raises. A
.npz param tree (accflow_tpu.convert.store) loads through
`load_jax_params`. This module needs numpy and torch only.
"""

from __future__ import annotations

import os.path as osp
from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from accflow_tpu_torch.nn.layers import BatchNorm2d, Conv2d, Embedding, GroupNorm2d, ZeroConv2d

_LAYERS = (Conv2d, BatchNorm2d, GroupNorm2d, Embedding)

Tree = Dict[str, Any]


def _layers(module: nn.Module):
    """(dotted path, layer) for every parameterised layer, and for every
    other module that holds a parameter of its own (a bare leaf); the conv
    inside a ZeroConv2d belongs to it."""
    owned = set()
    for path, sub in module.named_modules():
        if isinstance(sub, ZeroConv2d):
            owned.add(f"{path}.conv" if path else "conv")
            yield path, sub
        elif isinstance(sub, _LAYERS):
            if path not in owned:
                yield path, sub
        elif any(True for _ in sub.parameters(recurse=False)):
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
    if isinstance(layer, GroupNorm2d):
        return {"scale": (layer.weight, *same), "bias": (layer.bias, *same)}
    if isinstance(layer, Embedding):
        return {"emb": (layer.weight, *same)}
    if not isinstance(layer, Conv2d):  # bare parameters
        return {name: (p, *same) for name, p in layer.named_parameters(recurse=False)}
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
        node.setdefault(path.split(".")[-1], {}).update({
            leaf: np.array(to_jax(t.detach().float().cpu().numpy()), order="C")  # a copy
            for leaf, (t, _, to_jax) in _leaves(layer).items()
        })
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
        missing = set(targets) - set(node)
        if missing:
            raise KeyError(f"{path}: JAX tree lacks leaves {sorted(missing)}")
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


def save_npz_tree(path: str, tree: Tree) -> None:
    """Write a param tree as accflow_tpu.convert.store.save_params does
    (one .npz of slash-joined leaf paths), for load_npz_tree and the
    checkpoint loaders of both packages."""
    np.savez(path, **_flatten(tree))


def strip_module_prefix(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    return {k.removeprefix("module."): v for k, v in state_dict.items()}


def split_accflow_state(state_dict: Mapping[str, Any]):
    """Split an AccFlow checkpoint into (ofe_state, acc_state)."""
    ofe, acc = {}, {}
    for k, v in state_dict.items():
        if k.startswith("ofe."):
            ofe[k[len("ofe."):]] = v
        else:
            acc[k] = v
    return ofe, acc


def _alias_of(key: str, own) -> bool:
    """True for the reference's norm3/norm4 name of a downsample norm whose
    `downsample.1` twin the module has."""
    stem, _, leaf = key.rpartition(".")
    prefix, _, norm = stem.rpartition(".")
    if norm not in ("norm3", "norm4"):
        return False
    return (f"{prefix}.downsample.1.{leaf}" if prefix else f"downsample.1.{leaf}") in own


@torch.no_grad()
def load_reference_state_dict(module: nn.Module, state_dict: Mapping[str, Any]) -> nn.Module:
    """Copy a reference state_dict (prefixes already stripped) into
    `module` in place. Raises on a missing key, a key left over (beyond
    the norm3/norm4 aliases and num_batches_tracked) or a shape mismatch."""
    own = module.state_dict()
    missing = sorted(set(own) - set(state_dict))
    if missing:
        raise KeyError(f"missing torch keys: {missing[:10]}")
    leftover = sorted(k for k in state_dict if k not in own
                      and not k.endswith(("num_batches_tracked", "rel_ind"))
                      and not _alias_of(k, own))
    if leftover:
        raise ValueError(f"unconsumed torch keys: {leftover[:10]}")
    for k, dst in own.items():
        src = torch.as_tensor(state_dict[k])
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{k}: shape {tuple(src.shape)} vs {tuple(dst.shape)}")
    module.load_state_dict({k: torch.as_tensor(state_dict[k]) for k in own}, strict=True)
    return module


def load_torch_file(path: str) -> Dict[str, Any]:
    """A .pth state_dict (optionally wrapped under "state_dict") as tensors,
    through torch.load with weights_only=True."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return dict(sd)


def load_flow_estimator_checkpoint(path: str, model: nn.Module) -> nn.Module:
    """Load a raft-* or gma-* checkpoint into the port's RAFT or GMA
    `model` in place: a reference .pth or a .npz param tree."""
    if path.endswith(".npz"):
        return load_jax_params(model, load_npz_tree(path))
    return load_reference_state_dict(model, strip_module_prefix(load_torch_file(path)))


def load_accflow_checkpoint(path: str, acc: nn.Module, ofe: nn.Module):
    """Load an acc+raft-* or acc+gma-* checkpoint into the port's AccFlow
    `acc` and its RAFT or GMA `ofe` in place: a reference .pth (both under
    one state_dict, the OFE under `ofe.`), or the .npz pair <stem>.acc.npz +
    <stem>.ofe.npz (pass the stem or either file). Returns (acc, ofe)."""
    if path.endswith(".npz") or not osp.exists(path):
        stem = path
        for suffix in (".acc.npz", ".ofe.npz", ".npz"):
            stem = stem.removesuffix(suffix)
        acc_path, ofe_path = stem + ".acc.npz", stem + ".ofe.npz"
        if not (osp.exists(acc_path) and osp.exists(ofe_path)):
            raise FileNotFoundError(
                f"acc checkpoint {path!r} not found: expected a .pth file or the .npz "
                f"pair ({acc_path} + {ofe_path})")
        return (load_jax_params(acc, load_npz_tree(acc_path)),
                load_jax_params(ofe, load_npz_tree(ofe_path)))
    ofe_sd, acc_sd = split_accflow_state(strip_module_prefix(load_torch_file(path)))
    return load_reference_state_dict(acc, acc_sd), load_reference_state_dict(ofe, ofe_sd)
