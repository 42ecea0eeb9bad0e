"""Weights for the port's modules: from the JAX package's parameter trees,
and seeded random initialisation.

`state_dict_from_flax` inverts the JAX package's checkpoint converters
(`convert_raft_state_dict`, `convert_flowcomp_state_dict`,
`convert_inpaint_state_dict`): for every key of a module's `state_dict()` it
finds the flax leaf the converter would have produced and undoes the layout
change (flax Conv HWIO -> OIHW, Conv3d DHWIO -> OIDHW, Dense (in, out) ->
(out, in), norm 'scale' -> 'weight', FrozenBatchNorm mean/var -> running
stats). Model-specific renames are copies of the converters' rules. SAM
and the training modules have their own: `sam_state_dict_from_flax`,
`discriminator_state_dict_from_flax` (with the spectral-norm stats),
`vgg_state_dict_from_flax`, `lpips_state_dict_from_flax` and
`cutie_state_dict_from_flax`.
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


def _tensor(arr, ref: torch.Tensor, key: str) -> torch.Tensor:
    if tuple(arr.shape) != tuple(ref.shape):
        raise ValueError(f"{key}: flax shape {arr.shape} != "
                         f"{tuple(ref.shape)}")
    return torch.tensor(np.ascontiguousarray(arr), dtype=ref.dtype)


def state_dict_from_flax(module: torch.nn.Module, tree: Mapping,
                         renames=()) -> dict[str, torch.Tensor]:
    """A state dict for `module` holding the values of the flax params
    `tree` (no 'params' wrapper). Load it with `strict=True`."""
    template = module.state_dict()
    bn_prefixes = {k[:-len(".running_mean")] for k in template
                   if k.endswith(".running_mean")}
    return {key: _from_flax(key, ref, tree, renames, bn_prefixes)
            for key, ref in template.items()}


def _from_flax(key: str, ref: torch.Tensor, tree: Mapping, renames,
               bn_prefixes=frozenset(), aliases=ALIASES) -> torch.Tensor:
    """The value of `key` (template `ref`) from the flax tree, as the
    generic converter's rules place it."""
    if any(re.search(p, key) for p in MODULE_OWNED):
        return ref.clone()
    src = key
    for pat, repl in aliases:
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
    return _tensor(arr, ref, key)


# SAM (`convert_sam_state_dict`): the Sequential indices and the LayerNorm2d
# `ln` submodule, renamed as the converter renames them
SAM_RENAMES = (
    (r"\.patch_embed\.proj\.", r".patch_embed_proj."),
    (r"\.neck\.(\d+)\.", r".neck_\1."),
    (r"\.mask_downscaling\.(\d+)\.", r".mask_downscaling_\1."),
    (r"\.output_upscaling\.(\d+)\.", r".output_upscaling_\1."),
    (r"\.output_hypernetworks_mlps\.(\d+)\.",
     r".output_hypernetworks_mlps_\1."),
    (r"\.(neck_1|neck_3|mask_downscaling_1|mask_downscaling_4|"
     r"output_upscaling_1)\.(weight|bias)$", r".\1.ln.\2"),
)
# released SAM keys the converter stores as flat leaves, unchanged
SAM_FLAT = {
    "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix":
        ("prompt_encoder", "pe_layer_positional_encoding_gaussian_matrix"),
    "prompt_encoder.not_a_point_embed.weight":
        ("prompt_encoder", "pe_not_a_point"),
    "prompt_encoder.no_mask_embed.weight": ("prompt_encoder",
                                            "no_mask_embed"),
    "mask_decoder.iou_token.weight": ("mask_decoder", "iou_token"),
    "mask_decoder.mask_tokens.weight": ("mask_decoder", "mask_tokens"),
}


def sam_state_dict_from_flax(module: torch.nn.Module,
                             tree: Mapping) -> dict[str, torch.Tensor]:
    """A state dict for the port's `Sam` from the JAX `Sam`'s params;
    inverts `convert_sam_state_dict`: the prompt embeddings and output
    tokens are flat leaves (`pe_points_i`, `pe_not_a_point`, ...), the
    output upscaling's transposed-conv kernels (kh, kw, I, O) -> (I, O,
    kh, kw); every other key by the generic rules and `SAM_RENAMES`."""
    out = {}
    for key, ref in module.state_dict().items():
        point = re.fullmatch(r"prompt_encoder\.point_embeddings\.(\d+)"
                             r"\.weight", key)
        if key in SAM_FLAT:
            arr = _leaf(tree, list(SAM_FLAT[key]))
        elif point:
            arr = _leaf(tree, ["prompt_encoder", f"pe_points_{point[1]}"])
        elif ".output_upscaling." in key and ref.ndim == 4:
            path = _flax_path(re.sub(r"\.output_upscaling\.(\d+)\.",
                                     r".output_upscaling_\1.", key))
            arr = _leaf(tree, path[:-1] + ["kernel"]).transpose(2, 3, 0, 1)
        else:
            out[key] = _from_flax(key, ref, tree, SAM_RENAMES, aliases=())
            continue
        out[key] = _tensor(arr, ref, key)
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


def discriminator_state_dict_from_flax(module: torch.nn.Module,
                                       params: Mapping,
                                       batch_stats: Mapping
                                       ) -> dict[str, torch.Tensor]:
    """A state dict for the port's `Discriminator` from the JAX module's
    params and spectral-norm stats (`SpectralNorm_j` / `conv_i/kernel/u`):
    kernels DHWIO -> OIDHW, each `u` (1, out) as `weight_u`, and as
    `weight_v` the v of the next power step from that u (the port's
    step does not read it). Inverts `convert_discriminator_state_dict`,
    which drops u."""
    u_of = {name.split("/")[0]: np.asarray(v).reshape(-1)
            for block in batch_stats.values() for name, v in block.items()
            if name.endswith("/u")}
    out = {}
    for key, ref in module.state_dict().items():
        prefix, _, leaf = key.rpartition(".")
        name = _flax_path(prefix)[0]
        if leaf in ("weight_orig", "weight"):
            arr = np.asarray(params[name]["kernel"]).transpose(4, 3, 0, 1, 2)
        elif leaf == "bias":
            arr = np.asarray(params[name]["bias"])
        elif leaf == "weight_u":
            arr = u_of[name]
        else:   # weight_v, after weight_orig and weight_u
            wm = out[f"{prefix}.weight_orig"].flatten(1).double()
            v = wm.t() @ out[f"{prefix}.weight_u"].double()
            arr = (v / torch.sqrt(torch.sum(v * v) + 1e-12)).numpy()
        out[key] = _tensor(arr, ref, key)
    return out


def vgg_state_dict_from_flax(module: torch.nn.Module,
                             tree: Mapping) -> dict[str, torch.Tensor]:
    """A state dict for the port's `VGGFeatureExtractor` from the JAX
    module's params ({conv name: {kernel HWIO, bias}}); inverts
    `convert_vgg_state_dict`."""
    template = module.state_dict()
    out = {}
    for i, name in enumerate(module.names):
        if name.startswith("conv"):
            for leaf, arr in (
                    ("weight", np.asarray(tree[name]["kernel"]).transpose(
                        3, 2, 0, 1)),
                    ("bias", np.asarray(tree[name]["bias"]))):
                key = f"features.{i}.{leaf}"
                out[key] = _tensor(arr, template[key], key)
    return out


def lpips_state_dict_from_flax(module: torch.nn.Module,
                               tree: Mapping) -> dict[str, torch.Tensor]:
    """A state dict for the port's `LPIPSVgg` from the JAX module's params
    ({'net': VGG16 params, 'lin{i}': (C,)}); inverts
    `convert_lpips_state_dict`."""
    out = {f"net.{k}": v for k, v in
           vgg_state_dict_from_flax(module.net, tree["net"]).items()}
    template = module.state_dict()
    for i in range(len(module.TAPS)):
        key = f"lin{i}.model.1.weight"
        out[key] = _tensor(np.asarray(tree[f"lin{i}"]).reshape(1, -1, 1, 1),
                           template[key], key)
    return out


# Cutie (`convert_cutie_state_dict`): its renames, on the released keys
CUTIE_RENAMES = (
    (r"^(pixel_encoder|mask_encoder)\.(conv1|bn1|res2|layer1|layer2|layer3)"
     r"\.", r"\1.trunk.\2."),
    (r"\.feature_pred\.0\.", r".feature_pred_0."),
    (r"\.feature_pred\.2\.", r".feature_pred_2."),
    (r"\.weights_pred\.0\.", r".weights_pred_0."),
    (r"\.weights_pred\.2\.", r".weights_pred_2."),
    (r"\.mask_pred\.(\d+)\.1\.", r".mask_pred_\1."),
    (r"\.decoder_feat_proc\.transforms\.(\d+)\.", r".decoder_feat_proc_\1."),
    (r"\.distributor\.x_transform\.", r".distributor_x_transform."),
    (r"\.distributor\.g_transform\.", r".distributor_g_transform."),
    (r"\.downsample\.0\.", r".downsample_0."),
    (r"\.downsample\.1\.", r".downsample_1."),
)


def _cutie_path(key: str) -> list[str]:
    for pat, repl in CUTIE_RENAMES:
        key = re.sub(pat, repl, key)
    return _flax_path(key)


def cutie_state_dict_from_flax(module: torch.nn.Module,
                               tree: Mapping) -> dict[str, torch.Tensor]:
    """A state dict for the port's `CUTIE` from the JAX `CUTIE`'s params;
    inverts `convert_cutie_state_dict`: attention's q / k / v projections
    (Dense (in, out)) back into the fused `in_proj_weight` (3E, E) and
    `in_proj_bias`, the query tables `query_init_embedding` /
    `query_emb_embedding` into `query_init.weight` / `query_emb.weight`,
    each eca `eca_kernel` (k,) into its Conv1d's `conv.weight` (1, 1, k);
    every other key by the generic rules and `CUTIE_RENAMES`."""
    template = module.state_dict()
    bn_prefixes = {k[:-len(".running_mean")] for k in template
                   if k.endswith(".running_mean")}
    out = {}
    for key, ref in template.items():
        base, _, leaf = key.rpartition(".")
        if leaf in ("in_proj_weight", "in_proj_bias"):
            parts = [_leaf(tree, _cutie_path(f"{base}.{p}_proj".lstrip("."))
                           + ["kernel" if leaf == "in_proj_weight"
                              else "bias"]) for p in "qkv"]
            arr = np.concatenate([a.T for a in parts] if leaf ==
                                 "in_proj_weight" else parts)
        elif re.search(r"\.(query_init|query_emb)\.weight$", key):
            arr = _leaf(tree, _cutie_path(f"{base}_embedding"))
        elif ref.ndim == 3 and key.endswith(".conv.weight"):
            arr = _leaf(tree, _cutie_path(base[:-len(".conv")]
                                          + ".eca_kernel"))
            arr = arr.reshape(1, 1, -1)
        else:
            out[key] = _from_flax(key, ref, tree, CUTIE_RENAMES, bn_prefixes,
                                  aliases=())
            continue
        out[key] = _tensor(arr, ref, key)
    return out
