"""CUDA graphs of the pipeline's stages and the demo's regions: the
counterpart of the JAX package's per-shape `jax.jit` executables, the
pipeline's one-dispatch window groups (`propainter_tpu/pipeline.py:264-275`,
the scan at `:528`) and the demo's jitted parts (Cutie's step, the flow
tracker's RAFT and gate, SAM's encoder and decoder).

`StageGraphs` keeps one captured graph per call key: the stage's name, the
shapes and dtypes of the call's tensors, and its static arguments. Each
owner declares its stage names: the pipeline `STAGES`, `CutieCore`
`CUTIE_REGIONS`, `FlowMaskTracker` `FLOW_TRACKER_REGIONS`, `SamSegmenter`
`SAM_REGIONS`, the train steps `TRAIN_REGIONS`, `I3DFeatures`
`I3D_REGIONS`, `RaftPairFlow` `RAFT_PAIR_REGIONS`.

  first sight   the call runs eagerly: the warm-up (cuDNN and cuBLAS plans,
                the kernels' lazy build and launch setup, the models' index
                caches);
  second sight  the call is captured once on static input buffers, into a
                memory pool the graphs of one `StageGraphs` share (the
                buffers too), then the tensors are copied in and it is
                replayed;
  afterwards    the tensors are copied in and the graph is replayed.

So a stage that runs once per video is captured on the second video, and a
RAFT chunk or stage-4 window that recurs within one video on its first.

The cache holds the keys of about one video: `begin_video` drops every key,
captured or first seen, that the last video did not use, with its graph.
A pipeline reused over videos of many lengths (an evaluation, the demo's
facade) so keeps the graphs its recurring shapes use, and a key that
recurs only across videos is captured when two consecutive videos use it.
The trackers call it when their memory is cleared (one track is one
video), the segmenter when its image is reset.

What a captured call must keep:
- it reads no tensor but its arguments and the modules' parameters and
  buffers: a graph reads its inputs by address, and a per-video tensor
  read any other way is freed memory on the next video;
- it makes no host data into a tensor, reads no value back (`.item()`,
  `nonzero`), and fills no cache on the host: its first sight runs
  eagerly, so the models' caches fill there
  (`tests/test_torch_graphs.py` and `tests/test_torch_demo_graphs.py`
  hold the regions to it on the CPU);
- each output is copied out of the pool right after a replay, before
  another graph of the pool can overwrite it.

Static input buffers are shared by the graphs of one stage at the same
argument position, shape and dtype: every replay copies all of its
arguments in, and the graphs replay one at a time on one stream.

Launch counts stay true: a kernel wrapper counts its launch when it is
called (`<wrapper>.launches`, and K4's forms by shape in `.shapes`), so a
capture would count launches that never ran and a replay none. The
counters' change over a capture is taken back and kept with the graph,
and added on each replay.

No fallback: a capture or replay that fails raises.
"""

from __future__ import annotations

import time

import torch

STAGES = ("raft", "flow_completion", "image_propagation", "generation")


def _counted() -> list:
    """The kernel wrappers: each counts its launches in `launches`, K4's
    forms also by (problems, query rows, keys) in `shapes`."""
    from propainter_tpu_torch.ops import attention, corr, deform, \
        flash_attention

    found = {id(f): f for m in (attention, corr, deform, flash_attention)
             for f in vars(m).values()
             if callable(f) and hasattr(f, "launches")}
    return list(found.values())


def snapshot() -> list:
    """The launch counters now: [(wrapper, launches, shapes copy)]."""
    return [(f, f.launches, dict(getattr(f, "shapes", {})))
            for f in _counted()]


def restore(snap: list) -> None:
    """Set the launch counters back to `snap`."""
    for f, n, shapes in snap:
        f.launches = n
        if hasattr(f, "shapes"):
            f.shapes.clear()
            f.shapes.update(shapes)


def _delta(snap: list) -> list:
    """The counters' change since `snap`: [(wrapper, launches, shapes)]."""
    out = []
    for f, n, shapes in snap:
        by_shape = {k: v - shapes.get(k, 0)
                    for k, v in getattr(f, "shapes", {}).items()
                    if v != shapes.get(k, 0)}
        if f.launches != n or by_shape:
            out.append((f, f.launches - n, by_shape))
    return out


def _add(delta: list) -> None:
    for f, n, by_shape in delta:
        f.launches += n
        for k, v in by_shape.items():
            f.shapes[k] = f.shapes.get(k, 0) + v


def _as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


class _Graph:
    """One captured call: its graph, static inputs and outputs, and the
    launch counts one replay stands for."""

    def __init__(self, graph, inputs, outputs, delta, single: bool):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.delta = delta
        self.single = single

    def replay(self, tensors):
        for buf, t in zip(self.inputs, tensors):
            buf.copy_(t)
        self.graph.replay()
        _add(self.delta)
        out = tuple(o.clone() for o in self.outputs)
        return out[0] if self.single else out


class StageGraphs:
    """Captured stage calls of one owner (see the module docstring).
    stages: the stage names to graph (a subset of `names`, the owner's
    stages; another name raises); a call of any other stage runs eagerly.
    device: the owner's; off CUDA no stage is graphed. The pipeline also
    gives it no stage over a mesh of several devices. flush: release the
    caching allocator's free blocks before each capture (a train step's
    eager first sight leaves its activations' blocks cached, which a
    capture's private pool cannot use: the step would hold both)."""

    def __init__(self, stages=(), names=STAGES, device=None,
                 flush: bool = False):
        unknown = set(stages) - set(names)
        if unknown:
            raise ValueError(f"unknown stages {sorted(unknown)}; the "
                             f"stages are {tuple(names)}")
        if device is not None and torch.device(device).type != "cuda":
            stages = ()
        self.stages = frozenset(stages)
        self.flush = flush
        self._graphs: dict = {}    # key -> _Graph, None after a first sight
        self._inputs: dict = {}    # (stage, position, shape, dtype) -> buffer
        self._used: set = set()    # the keys used since `begin_video`
        self._pool = None
        self._stream = None
        self.capture_seconds = 0.0

    def __call__(self, stage: str, fn, tensors: tuple, static: tuple = ()):
        """fn(*tensors) -> a tensor or a tuple of tensors, eager or from
        the graph of its key; `static` holds the Python values fn depends
        on besides the tensors' shapes and dtypes."""
        if stage not in self.stages:
            return fn(*tensors)
        key = (stage, static,
               tuple((tuple(t.shape), t.dtype) for t in tensors))
        self._used.add(key)
        if key not in self._graphs:
            self._graphs[key] = None
            return fn(*tensors)
        graph = self._graphs[key]
        if graph is None:
            graph = self._graphs[key] = self._capture(stage, fn, tensors)
        return graph.replay(tensors)

    def begin_video(self) -> None:
        """Drop every key that the last video (the calls since the last
        `begin_video`) did not use, its graph, and each static input no
        kept graph reads; the memory goes back to the pool for the next
        captures."""
        for key in set(self._graphs) - self._used:
            del self._graphs[key]
        kept = {id(b) for g in self._graphs.values() if g is not None
                for b in g.inputs}
        self._inputs = {k: b for k, b in self._inputs.items()
                        if id(b) in kept}
        self._used = set()

    def keys(self) -> list:
        """Every call key seen, captured or not."""
        return list(self._graphs)

    def counts(self) -> dict:
        """Captured graphs by stage."""
        out = {s: 0 for s in sorted(self.stages)}
        for key, graph in self._graphs.items():
            if graph is not None:
                out[key[0]] += 1
        return out

    def clear(self) -> None:
        """Drop every graph, static input and the pool (the stages then
        start again from a first sight)."""
        self._graphs.clear()
        self._inputs.clear()
        self._used.clear()
        self._pool = None
        self._stream = None
        self.capture_seconds = 0.0

    def _capture(self, stage, fn, tensors) -> _Graph:
        keys = [(stage, i, tuple(t.shape), t.dtype)
                for i, t in enumerate(tensors)]

        def inputs():
            for k, t in zip(keys, tensors):
                if k not in self._inputs:
                    self._inputs[k] = torch.empty_like(
                        t, memory_format=torch.contiguous_format)
            return [self._inputs[k] for k in keys]

        t0 = time.perf_counter()
        before = snapshot()
        try:
            graph, static, out = self._capture_graph(fn, inputs, tensors)
            delta = _delta(before)
        finally:
            restore(before)
        self.capture_seconds += time.perf_counter() - t0
        return _Graph(graph, static, _as_tuple(out),
                      delta, not isinstance(out, tuple))

    def _capture_graph(self, fn, inputs, tensors):
        """(graph, static inputs, outputs): fn captured on the static
        inputs, which `inputs()` gives (new ones allocated inside the
        capture, so from the shared pool: none keeps a segment of the
        caching allocator's reserved for the pipeline's life). The graph
        has not run yet; its first replay copies `tensors` in.

        Captured on one side stream per StageGraphs (the allocator reuses
        a pool's blocks on the stream that freed them, so the graphs share
        their memory), without `torch.cuda.graph`'s device synchronize
        and cache flush (unless `flush`): a capture in the middle of a
        video would otherwise make every later eager allocation a new
        cudaMalloc."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream()
        if self.flush:
            torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph()
        self._stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self._stream):
            graph.capture_begin(pool=self._pool)
            try:
                static = inputs()
                out = fn(*static)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:    # the capture the error invalidated
                    pass
                raise
            graph.capture_end()
        torch.cuda.current_stream().wait_stream(self._stream)
        return graph, static, out
