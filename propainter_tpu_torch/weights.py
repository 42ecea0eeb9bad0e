"""Weights for the port's modules: from the JAX package's parameter trees,
and seeded random initialisation.

`state_dict_from_flax` inverts the JAX package's checkpoint converters
(`convert_raft_state_dict`, `convert_flowcomp_state_dict`,
`convert_inpaint_state_dict`): for every key of a module's `state_dict()` it
finds the flax leaf the converter would have produced and undoes the layout
change (flax Conv HWIO -> OIHW, Conv3d DHWIO -> OIDHW, Dense (in, out) ->
(out, in), norm 'scale' -> 'weight', FrozenBatchNorm mean/var -> running
stats). Model-specific renames are copies of the converters' rules.
"""

from __future__ import annotations

import math
import re
from typing import Mapping

import numpy as np
import torch

# (pattern, replacement) on torch keys, applied in order — as the converters
# apply them before splitting a key into a flax path
RAFT_RENAMES = (
    (r"^update_block\.mask\.0\.", "mask_0."),
    (r"^update_block\.mask\.2\.", "mask_2."),
    (r"^update_block\.", "scanned.update_block."),
)
FLOWCOMP_RENAMES = (
    (r"feat_prop_module\.(deform_align|backbone)\.(backward_|forward_)\.",
     r"feat_prop_module.\2.\1."),
)
INPAINT_RENAMES = (
    (r"feat_prop_module\.(deform_align|backbone)\.(backward_1|forward_1)\.",
     r"feat_prop_module.\2.\1."),
)
# torch keys that alias another key (RAFT's ResidualBlock registers norm3 a
# second time as downsample.1; the converter keeps the downsample copy)
ALIASES = ((r"\.norm3\.", ".downsample.1."),)
# torch buffers with no flax counterpart: kept as the module has them
MODULE_OWNED = (r"num_batches_tracked$", r"valid_ind_rolled$")

_BN_LEAVES = {"weight": "scale", "bias": "bias", "running_mean": "mean",
              "running_var": "var"}


def _flax_path(key: str) -> list[str]:
    """'layer1.0.conv1' -> ['layer1_0', 'conv1'] (the converter's rule)."""
    out: list[str] = []
    for p in key.split(".") if key else ():
        if p.isdigit() and out:
            out[-1] = f"{out[-1]}_{p}"
        else:
            out.append(p)
    return out


def _leaf(tree: Mapping, path: list[str]):
    node = tree
    for p in path:
        if p not in node:
            raise KeyError(f"no flax leaf {'/'.join(path)}")
        node = node[p]
    return np.asarray(node)


def state_dict_from_flax(module: torch.nn.Module, tree: Mapping,
                         renames=()) -> dict[str, torch.Tensor]:
    """A state dict for `module` holding the values of the flax params
    `tree` (no 'params' wrapper). Load it with `strict=True`."""
    template = module.state_dict()
    bn_prefixes = {k[:-len(".running_mean")] for k in template
                   if k.endswith(".running_mean")}
    out = {}
    for key, ref in template.items():
        if any(re.search(p, key) for p in MODULE_OWNED):
            out[key] = ref.clone()
            continue
        src = key
        for pat, repl in ALIASES:
            src = re.sub(pat, repl, src)
        prefix, _, leaf = src.rpartition(".")
        renamed = src
        for pat, repl in renames:
            renamed = re.sub(pat, repl, renamed)
        new_prefix = renamed.rpartition(".")[0]
        if prefix in bn_prefixes:
            arr = _leaf(tree, _flax_path(new_prefix) + [_BN_LEAVES[leaf]])
        elif leaf == "weight" and ref.ndim in (2, 4, 5):
            arr = _leaf(tree, _flax_path(new_prefix) + ["kernel"])
            perm = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}[ref.ndim]
            arr = arr.transpose(perm)
        elif leaf == "weight":
            arr = _leaf(tree, _flax_path(new_prefix) + ["scale"])
        else:
            arr = _leaf(tree, _flax_path(new_prefix) + [leaf])
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: flax shape {arr.shape} != "
                             f"{tuple(ref.shape)}")
        out[key] = torch.tensor(arr, dtype=ref.dtype)
    return out


@torch.no_grad()
def seeded_init_(module: torch.nn.Module, seed: int,
                 fan_in_scaled: bool = False) -> torch.nn.Module:
    """Random weights from a seed, in place: every float tensor of the
    state dict ~ N(0, 0.02^2), except batch-norm running variances
    ~ U(0.5, 1.5) (a variance near 0 would blow up RAFT's context encoder).
    Small random weights rather than zeros keep every layer doing work.

    fan_in_scaled: weights of rank >= 2 ~ N(0, 1 / fan_in) (fan_in = every
    dim but the output one) and the other float tensors ~ N(0, 0.1^2), so
    activations stay O(1) through the layers and the output varies with
    the input (with 0.02 the generator's output is nearly constant)."""
    gen = torch.Generator().manual_seed(seed)
    for key, t in module.state_dict().items():
        if not t.is_floating_point():
            continue
        if key.endswith("running_var"):
            vals = torch.rand(t.shape, generator=gen) + 0.5
        elif fan_in_scaled and t.dim() >= 2:
            vals = (torch.randn(t.shape, generator=gen)
                    / math.sqrt(t[0].numel()))
        elif fan_in_scaled:
            vals = torch.randn(t.shape, generator=gen) * 0.1
        else:
            vals = torch.randn(t.shape, generator=gen) * 0.02
        t.copy_(vals.to(t.dtype))
    return module
