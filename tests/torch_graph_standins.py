"""CPU stand-ins for `graphs.StageGraphs`'s CUDA graphs, shared by the
tests of the pipeline's stages (tests/test_torch_graphs.py), of the
demo's regions (tests/test_torch_demo_graphs.py), of the train steps'
(tests/test_torch_train_graphs.py) and of the evaluation's
(tests/test_torch_eval_graphs.py).

No graph can be captured on the CPU: `CPUGraphs` replaces each captured
call by a `StandIn` that runs the call once at capture and again at each
replay (the launch counters left as they were, as a real replay runs no
Python), and holds every tensor the capture read besides those it made:
a replay must read the same tensors, by address, as a graph does. A
capture runs nothing on the device, so what the stand-in's capture wrote
into tensors it did not make (a train step's parameters, optimizer state
and statistics) is put back after it: the first replay runs the call.
Both run under `NoHostData`, which raises on what a graph cannot hold.
"""

import collections

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from propainter_tpu_torch import graphs

aten = torch.ops.aten


class NoHostData(TorchDispatchMode):
    """Raises on what a captured CUDA graph cannot hold: host data made
    into a tensor (`torch.as_tensor`, `torch.tensor`: aten.lift_fresh), a
    value read back (`.item()` and `bool()`: aten._local_scalar_dense;
    `torch.equal`, whose bool comes back without it), and data-dependent
    shapes (`nonzero`, indexing by a bool mask, which on CUDA runs a
    nonzero)."""

    FORBIDDEN = (aten.lift_fresh, aten._local_scalar_dense, aten.nonzero,
                 aten.equal)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in self.FORBIDDEN:
            raise AssertionError(f"{func} in a graphed region")
        if func.overloadpacket in (aten.index, aten.index_put,
                                   aten.index_put_):
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in args[1]):
                raise AssertionError(f"{func} with a bool mask in a "
                                     f"graphed region")
        return func(*args, **(kwargs or {}))


class Reads(NoHostData):
    """`NoHostData` that also records the tensors an op reads which no
    op under the mode made, by storage address: what a graph reads by
    address (its static inputs, the modules' parameters and buffers, the
    device index caches)."""

    def __init__(self):
        super().__init__()
        self.read, self.made = {}, set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        for t in _pytree.tree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor):
                ptr = t.untyped_storage().data_ptr()
                if ptr not in self.made:
                    self.read.setdefault(ptr, t)
        for t in _pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.made.add(t.untyped_storage().data_ptr())
        return out


def _written(func, args, kwargs) -> list:
    """The tensors an op writes in place: its schema's mutable arguments
    (`add_`'s self, `copy_`'s destination, an `out=`, a `_foreach_*_`'s
    list)."""
    out = []
    for i, a in enumerate(func._schema.arguments):
        if a.alias_info is None or not a.alias_info.is_write:
            continue
        v = args[i] if i < len(args) else (kwargs or {}).get(a.name)
        out += [t for t in (v if isinstance(v, (list, tuple)) else [v])
                if isinstance(t, torch.Tensor)]
    return out


class Capture(Reads):
    """`Reads` that also keeps, before an op first writes a storage that
    no op under the mode allocated (a view's or an in-place op's output
    shares its input's), a copy of it; `undo()` puts them back."""

    def __init__(self):
        super().__init__()
        self.saved, self.fresh = {}, set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        for t in _written(func, args, kwargs):
            storage = t.untyped_storage()
            ptr = storage.data_ptr()
            if ptr not in self.fresh and ptr not in self.saved:
                self.saved[ptr] = (storage, storage.clone())
        out = super().__torch_dispatch__(func, types, args, kwargs)
        given = {t.untyped_storage().data_ptr()
                 for t in _pytree.tree_leaves((args, kwargs))
                 if isinstance(t, torch.Tensor)}
        self.fresh.update(t.untyped_storage().data_ptr()
                          for t in _pytree.tree_leaves(out)
                          if isinstance(t, torch.Tensor)
                          and t.untyped_storage().data_ptr() not in given)
        return out

    def undo(self):
        for storage, copy in self.saved.values():
            storage.copy_(copy)


class StandIn:
    """A captured call on the CPU: replay runs it again on the static
    inputs into the static outputs, the launch counters kept, and checks
    that it read the tensors the capture read (held here, so no other
    tensor takes their addresses): a graph would read those addresses."""

    def __init__(self, fn, inputs, outputs, read):
        self.fn, self.inputs, self.outputs, self.read = (fn, inputs, outputs,
                                                        read)

    def replay(self):
        snap = graphs.snapshot()
        with Reads() as mode:
            out = graphs._as_tuple(self.fn(*self.inputs))
        graphs.restore(snap)
        moved = [tuple(t.shape) for p, t in self.read.items()
                 if p not in mode.read]
        assert not moved, f"a replay read other tensors than the capture " \
                          f"did, shapes {moved}"
        for o, n in zip(self.outputs, out):
            if o is not n:
                o.copy_(n)


class CPUGraphs(graphs.StageGraphs):
    """StageGraphs whose captures run under `Capture`, their writes
    undone."""

    def _capture_graph(self, fn, inputs, tensors):
        static = inputs()
        for buf, t in zip(static, tensors):
            buf.copy_(t)
        with Capture() as mode:
            out = fn(*static)
        mode.undo()
        return (StandIn(fn, static, graphs._as_tuple(out), mode.read),
                static, out)


class CountingGraphs(CPUGraphs):
    """`CPUGraphs` counting each stage's replays."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.replays = collections.Counter()

    def _capture(self, stage, fn, tensors):
        graph = super()._capture(stage, fn, tensors)
        standin, replays = graph.graph, self.replays

        class Counted:
            def replay(self):
                replays[stage] += 1
                standin.replay()

        graph.graph = Counted()
        return graph
