"""CPU stand-ins for `graphs.StageGraphs`'s CUDA graphs, shared by the
tests of the pipeline's stages (tests/test_torch_graphs.py) and of the
demo's regions (tests/test_torch_demo_graphs.py).

No graph can be captured on the CPU: `CPUGraphs` replaces each captured
call by a `StandIn` that runs the call once at capture and again at each
replay (the launch counters left as they were, as a real replay runs no
Python), and holds every tensor the capture read besides those it made:
a replay must read the same tensors, by address, as a graph does. Both
run under `NoHostData`, which raises on what a graph cannot hold.
"""

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from propainter_tpu_torch import graphs

aten = torch.ops.aten


class NoHostData(TorchDispatchMode):
    """Raises on what a captured CUDA graph cannot hold: host data made
    into a tensor (`torch.as_tensor`, `torch.tensor`: aten.lift_fresh), a
    value read back (`.item()`), and data-dependent shapes (`nonzero`,
    indexing by a bool mask, which on CUDA runs a nonzero)."""

    FORBIDDEN = (aten.lift_fresh, aten._local_scalar_dense, aten.nonzero)

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
    """StageGraphs whose captures run under `Reads`."""

    def _capture_graph(self, fn, inputs, tensors):
        static = inputs()
        for buf, t in zip(static, tensors):
            buf.copy_(t)
        with Reads() as mode:
            out = fn(*static)
        return (StandIn(fn, static, graphs._as_tuple(out), mode.read),
                static, out)
