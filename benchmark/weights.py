"""Seeded weights for the three models, made on the device.

Every float tensor of a model's state dict is drawn from one generator on
the model's device in two calls (one normal, one uniform draw for all of
them), then scaled per tensor:

  rank >= 2 (conv and linear weights)   N(0, 1 / fan_in)
  1-D `...weight` (norm scales)         1 + N(0, 0.1^2)
  `...running_var`                      U(0.5, 1.5)
  other 1-D (biases, running means)     N(0, 0.1^2)

so activations stay O(1) through the layers and the outputs vary with the
inputs. The tensors under a prefix of `SCALED` are multiplied by its
factor besides: RAFT's last flow-head convolution by 0.002. Unscaled,
the seeded RAFT's flows are 80-110 px at the median at 432x240 and fail
stage 3's forward-backward check on nearly every pixel, so image
propagation would fill nothing; scaled, they are 0.16-0.24 px and pass it
on 94-99.8% of the pixels, so stage 3 fills most of each hole, as it
does on real clips, and RAFT's lookups read the taps around each query's
own position, as `roofline.k1` counts them.

The tensors are assigned in the order of their sorted state-dict
names (an alias, such as RAFT's `norm3` registered twice, once), so two
modules with the same names and shapes get the same values: the program's
models and the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

MODELS = ("raft", "flowcomp", "inpaint")
# {model: {state-dict name prefix: factor}} (see the module docstring)
SCALED = {"raft": {"update_block.flow_head.conv2.": 0.002}}


def model_seed(seed: int, name: str) -> int:
    """A 63-bit seed for model `name` derived from the run's seed."""
    words = np.random.SeedSequence([seed, MODELS.index(name)]).generate_state(
        2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def _tensors(module: torch.nn.Module) -> list:
    seen, out = set(), []
    for name, t in sorted(module.state_dict(keep_vars=True).items()):
        if t.is_floating_point() and id(t) not in seen:
            seen.add(id(t))
            out.append((name, t))
    return out


@torch.no_grad()
def fill_(module: torch.nn.Module, seed: int,
          scaled: dict | None = None) -> torch.nn.Module:
    """Overwrite every float tensor of `module`'s state dict with its seeded
    values (see the module docstring), on the module's device; a tensor
    under a prefix of `scaled` ({prefix: factor}) is multiplied by its
    factor."""
    tensors = _tensors(module)
    device = tensors[0][1].device
    gen = torch.Generator(device=device).manual_seed(seed)
    uniform = [t.numel() if n.endswith("running_var") else 0
               for n, t in tensors]
    normal = [t.numel() - u for (_, t), u in zip(tensors, uniform)]
    z = torch.randn(sum(normal), generator=gen, device=device)
    u = torch.rand(sum(uniform), generator=gen, device=device)
    scale, offset = [], []
    for name, t in tensors:
        if name.endswith("running_var"):
            s, o = 1.0, 0.5
        elif t.dim() >= 2:
            s, o = float(t[0].numel()) ** -0.5, 0.0
        elif name.endswith("weight"):
            s, o = 0.1, 1.0
        else:
            s, o = 0.1, 0.0
        for prefix, factor in (scaled or {}).items():
            if name.startswith(prefix):
                s, o = s * factor, o * factor
        scale.append(s)
        offset.append(o)
    counts = torch.tensor([n + m for n, m in zip(normal, uniform)],
                          device=device)
    scale = torch.tensor(scale, device=device).repeat_interleave(counts)
    offset = torch.tensor(offset, device=device).repeat_interleave(counts)
    values = torch.empty(int(counts.sum()), device=device)
    is_u = torch.tensor([m > 0 for m in uniform],
                        device=device).repeat_interleave(counts)
    values[~is_u] = z
    values[is_u] = u
    values = values * scale + offset
    start = 0
    for _, t in tensors:
        t.copy_(values[start:start + t.numel()].view_as(t))
        start += t.numel()
    return module


def fill_models_(models: dict, seed: int) -> dict:
    """`fill_` each of {'raft', 'flowcomp', 'inpaint'} with its own seed
    derived from `seed`."""
    for name in MODELS:
        fill_(models[name], model_seed(seed, name), SCALED.get(name))
    return models
