"""Devices and ranks. Counterpart of `propainter_tpu/parallel/mesh.py`.

Inference (`make_mesh` and the helpers below it, the JAX module's
`:69-100`): the JAX package shards its inference batch axes (RAFT's
frames and pairs, stage 2-3 chunks, stage-4 window batches) over a
`jax.sharding.Mesh` from one controller process. The same holds here: one
process; a mesh is a list of `torch.device`s; a batch is cut into
contiguous per-device slices, each slice runs on its device's module
replica with that device current, and the pieces are gathered on the
caller's device. Kernel launches are asynchronous, so the GPUs of a mesh
work at once while the host walks the shards. On the CPU `make_mesh(n,
device="cpu")` gives n entries of the one CPU device: the slices then run
one after another, which is how the tests stand in for the JAX package's
virtual CPU devices.

Training (`maybe_initialize_distributed` and the rank helpers, the JAX
module's `:27-66`): the JAX trainer shards its batch over a mesh that
may span processes, and XLA inserts the gradient all-reduce. Here each
rank is one process on one device (`torch.distributed`: NCCL between
GPUs, gloo on the CPU); the train steps all-reduce their gradients and
loss normalisers themselves (`core/trainer.py`, `core/losses.py`). Every
helper is a no-op without a process group or with one rank.
"""

from __future__ import annotations

import contextlib
import copy
import os
import socket

import torch
import torch.distributed as dist


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


# ---------------------------------------------------------------------------
# Ranks (training)
# ---------------------------------------------------------------------------


def _env_int(*names) -> int | None:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def maybe_initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: str | None = None,
    device: str | None = None,
) -> bool:
    """Multi-process bootstrap: `torch.distributed.init_process_group`
    when configured, with the contract of the JAX package's
    `maybe_initialize_distributed`.

    Configured by `coordinator_address` (host:port of rank 0), by
    JAX_COORDINATOR_ADDRESS / COORDINATOR_ADDRESS (with JAX_NUM_PROCESSES
    and JAX_PROCESS_ID), or by torchrun's own environment (MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK), the counterpart of a TPU
    pod's automatic discovery. Unconfigured, it does nothing and returns
    False. A process count or id not given falls back to WORLD_SIZE /
    RANK.

    The backend follows the device the ranks train on: `nccl` when each
    rank owns a GPU (`device` None or 'cuda', and a GPU visible), `gloo`
    on the CPU. A GPU rank makes its GPU current: `local_device_ids` (one
    index), else LOCAL_RANK, else the process id modulo the GPU count.

    Returns True iff a process group was initialised."""
    env = os.environ
    coordinator = (coordinator_address or env.get("JAX_COORDINATOR_ADDRESS")
                   or env.get("COORDINATOR_ADDRESS"))
    torchrun = all(k in env for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE"))
    if coordinator is None and not torchrun:
        return False
    if num_processes is None:
        num_processes = _env_int("JAX_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("JAX_PROCESS_ID", "RANK")
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator {coordinator}: give the process count and this "
            f"process's id (--num_processes / --process_id, "
            f"JAX_NUM_PROCESSES / JAX_PROCESS_ID or WORLD_SIZE / RANK)")
    on_gpu = (device is None or torch.device(device).type == "cuda") and (
        torch.cuda.is_available())
    if on_gpu:
        if local_device_ids is not None:
            ids = [int(x) for x in str(local_device_ids).split(",") if x]
            if len(ids) != 1:
                raise ValueError(f"one GPU per rank: local_device_ids="
                                 f"{local_device_ids!r}")
            local = ids[0]
        else:
            local = _env_int("LOCAL_RANK")
            if local is None:
                local = process_id % torch.cuda.device_count()
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend="nccl" if on_gpu else "gloo",
        init_method=f"tcp://{coordinator}" if coordinator else "env://",
        world_size=num_processes, rank=process_id)
    return True


def free_port() -> int:
    """A TCP port free on localhost now, for a rendezvous of ranks on
    this host."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def world_size() -> int:
    """The number of ranks: 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank: 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """Rank 0, the one that writes checkpoints and logs."""
    return rank() == 0


def barrier() -> None:
    """Wait for every rank (nothing on one rank)."""
    if world_size() > 1:
        dist.barrier()


def _flat_collective(tensors, collective) -> None:
    """`collective(buffer)` on one flat buffer per (dtype, device) holding
    `tensors`, the results copied back into them."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for group in groups.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        collective(flat)
        offset = 0
        with torch.no_grad():
            for t in group:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def all_reduce_mean(tensors):
    """Each tensor averaged over the ranks, in place, through one flat
    buffer; returns `tensors`. Every rank passes the same shapes in the
    same order. Nothing happens on one rank."""
    n = world_size()
    if n > 1 and tensors:
        def mean(flat):
            dist.all_reduce(flat)
            flat /= n
        _flat_collective(tensors, mean)
    return tensors


def all_reduce_max(tensor):
    """The tensor's elementwise maximum over the ranks, in place; returns
    it. Nothing happens on one rank."""
    if world_size() > 1:
        dist.all_reduce(tensor, op=dist.ReduceOp.MAX)
    return tensor


def broadcast_modules(*modules, src: int = 0) -> None:
    """Every parameter and buffer of `modules` (None skipped) set to rank
    `src`'s, through one flat buffer per dtype. Nothing happens on one
    rank."""
    if world_size() > 1:
        tensors = [t for m in modules if m is not None
                   for t in (*m.parameters(), *m.buffers())]
        _flat_collective(tensors, lambda flat: dist.broadcast(flat, src))
