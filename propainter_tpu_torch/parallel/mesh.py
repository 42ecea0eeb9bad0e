"""A 1-D device mesh and the helpers that split a leading batch axis over
it. Counterpart of `propainter_tpu/parallel/mesh.py:69-100`.

The JAX package shards its inference batch axes (RAFT's frames and pairs,
stage 2-3 chunks, stage-4 window batches) over a `jax.sharding.Mesh` from
one controller process. The same holds here: one process; a mesh is a list
of `torch.device`s; a batch is cut into contiguous per-device slices, each
slice runs on its device's module replica with that device current, and
the pieces are gathered on the caller's device. Kernel launches are
asynchronous, so the GPUs of a mesh work at once while the host walks the
shards. No `torch.distributed` (the multi-host bootstrap
`maybe_initialize_distributed` is not ported).

On the CPU `make_mesh(n, device="cpu")` gives n entries of the one CPU
device: the slices then run one after another, which is how the tests
stand in for the JAX package's virtual CPU devices.
"""

from __future__ import annotations

import contextlib
import copy

import torch


def canonical_device(device) -> torch.device:
    """`device` as a torch.device with an index for CUDA (`cuda` -> the
    current GPU), so equal devices compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_devices: int | None = None, device=None
              ) -> list[torch.device]:
    """The devices of a 1-D mesh. device None or 'cuda': every visible GPU,
    or the first `n_devices` (raises without a GPU); 'cpu': the CPU
    `n_devices` times (default once)."""
    kind = "cuda" if device is None else torch.device(device).type
    if kind == "cpu":
        n = 1 if n_devices is None else n_devices
        if n < 1:
            raise ValueError(f"a mesh needs a device, got n_devices={n}")
        return [torch.device("cpu")] * n
    if kind != "cuda":
        raise ValueError(f"unsupported device {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for a CPU mesh")
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"n_devices={n_devices}, but {count} GPUs are "
                         f"visible")
    return [torch.device("cuda", i) for i in range(n)]


def device_context(device):
    """The context a shard's work runs in: its GPU made current (kernel
    launches and their per-device setup follow the current device), or
    nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def replicate(module, mesh) -> dict:
    """{device: module} with one replica per distinct mesh device: the
    module itself on the device it lies on, a deep copy moved to each
    other one. Equal devices share one replica."""
    home = canonical_device(next(module.parameters()).device)
    out = {}
    for dev in mesh:
        if dev not in out:
            out[dev] = (module if dev == home
                        else copy.deepcopy(module).to(dev))
    return out


def split_batch(mesh, *tensors) -> list:
    """[(device, slices)]: each tensor's leading axis cut into len(mesh)
    contiguous slices (`torch.tensor_split` sizes: the first ones one
    longer), slice i moved to mesh[i]. Shards left empty (a batch shorter
    than the mesh) are dropped."""
    parts = [torch.tensor_split(t, len(mesh)) for t in tensors]
    return [(dev, tuple(p[i].to(dev) for p in parts))
            for i, dev in enumerate(mesh) if parts[0][i].shape[0]]


def map_shards(fn, mesh, tensors, out_device, replicas=None) -> tuple:
    """fn(replica or None, *slices) on every shard of `split_batch(mesh,
    *tensors)` with the shard's device current; fn returns a tuple of
    tensors, and each is gathered back along its leading axis on
    `out_device`."""
    outs = []
    for dev, slices in split_batch(mesh, *tensors):
        with device_context(dev):
            outs.append(fn(None if replicas is None else replicas[dev],
                           *slices))
    return tuple(torch.cat([o[i].to(out_device) for o in outs])
                 for i in range(len(outs[0])))
