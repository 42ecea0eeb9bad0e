"""The benchmark of `propainter_tpu_torch` on NVIDIA GPUs.

  python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
      --trace <0|1>

One run of one cell of BENCHMARK.json (at the root of the checkout): a
configuration (`benchmark/configs/<name>.json`) under a traffic mix
(`benchmark/traffic/<name>.json`, whose clips the generator it names
makes: `benchmark/generators/<generator>.py`, by default `clips`). It

  1. builds one `ProPainterPipeline` as the inference CLI builds it, with
     the default CUDA graphs, on weights seeded on the device, and the
     traffic's pool of clips from the seed;
  2. warms it: the pool's clips one after another until a whole clip
     replays every stage from its graphs, or the traffic's `warm_clips`
     (set-up ends there: `setup_s` is process start to window start);
  3. measures for --seconds: `inpaint_video` on one clip after another,
     a closed loop with one client; the window ends with the clip running
     when the time has passed, and rates divide by the time measured;
     with --trace 1 two steady clips run under the device trace;
  4. reads the peak memory, runs the clip the seed samples once more on
     the same warmed pipeline, keeping its stages' outputs, frees the
     program, and holds those outputs and the window's frames of that
     clip to the plain reference (`reference/`, `compare.py`): `correct`.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones, each read by `metrics/<name>.py`), `device`,
with --trace 1 `breakdown`, and last `checks`: each number compared with
its limit. The same numbers end standard error.

Without a CUDA device, or with fewer than the cell asks for, it exits 3
and prints no result; if JAX or the JAX package is loaded when the result
would be printed, it exits 4 and prints none.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# modules the run may not hold once its window has closed: JAX and the
# JAX package, by whole top-level name (the port's name begins with the
# JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "propainter_tpu")
# clips of a traced run that run under the device trace, after three
# untraced ones
TRACE_FIRST, TRACE_CLIPS = 3, 2
# the seed samples the compared clip among the window's first three
SAMPLE_FROM = 3
# the seed's stream that draws the sampled clip (clips draw from [seed, i])
SAMPLE_STREAM = 1 << 20
# warm-up clips at most, unless the traffic sets `warm_clips`: the pool
# cycles until a whole clip replays
MAX_WARM_CLIPS = 8
DEFAULT_GENERATOR = "clips"


def caches(root: Path) -> None:
    """Every build and kernel cache the run may fill, at fixed paths in the
    checkout (the program builds its kernels into build/kernels/)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "build/torch_extensions"),
                     ("TRITON_CACHE_DIR", "build/triton"),
                     ("CUDA_CACHE_PATH", "build/nv_compute_cache")):
        os.environ[var] = str(root / sub)


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_of(spec: dict, workload: str) -> dict:
    """The cell `workload`, with its configuration entry and the metrics it
    reports: {'workload', 'config', 'end_to_end', 'per_layer'}."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the cells are "
                         f"{sorted(cells)}")
    w = cells[workload]
    config = {c["name"]: c for c in spec["configs"]}[w["config"]]

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return {"workload": w, "config": config,
            "end_to_end": [m for m in spec["end_to_end"] if mine(m)],
            "per_layer": [m for m in spec["per_layer"] if mine(m)]}


def _module(path: Path, kind: str):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod      # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = HERE):
    """The `read` function of `metrics/<name>.py`."""
    return _module(root / "metrics" / f"{name}.py", "metric").read


def traffic_pool(name: str, seed: int, root: Path = HERE) -> tuple:
    """The traffic mix `name`: its file's parameters
    (`traffic/<name>.json`) and the run's pool of clips, which the
    generator the file names (`generators/<generator>.py`) makes from the
    seed with its `pool(params, seed)`: a list of {'frames' (T, H, W, 3)
    uint8, 'flow_masks', 'masks_dilated' (T, H, W) uint8, 1 = hole}, in
    the order the window cycles through them."""
    params = json.loads((root / "traffic" / f"{name}.json").read_text())
    gen = params.get("generator", DEFAULT_GENERATOR)
    return params, _module(root / "generators" / f"{gen}.py",
                           "generator").pool(params, seed)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0]


class CountingGraphs:
    """The pipeline's `StageGraphs`, counting the stage calls that run
    their function (a first sight or a capture) rather than a replay."""

    def __init__(self, graphs):
        self.graphs = graphs
        self.ran = 0

    def __call__(self, stage, fn, tensors, static=()):
        def counted(*a):
            self.ran += 1
            return fn(*a)
        return self.graphs(stage, counted, tensors, static)

    def __getattr__(self, name):
        return getattr(self.graphs, name)


class Recorder:
    """Keeps, while `on`, copies of the outputs of the pipeline's first
    three stages for the comparison (on only after the window)."""

    STAGES = (("compute_flows", "raft"),
              ("complete_flows", "flow_completion"),
              ("propagate_images", "image_propagation"))

    def __init__(self, pipe):
        self.on = False
        self.outputs: dict = {}
        for method, key in self.STAGES:
            orig = getattr(pipe, method)

            def wrapped(*a, _orig=orig, _key=key, **k):
                out = _orig(*a, **k)
                if self.on:
                    self.outputs[_key] = tuple(t.detach().clone()
                                               for t in out)
                return out
            setattr(pipe, method, wrapped)


def launches() -> dict:
    """The program's kernel launch counters now: {wrapper: launches}, and
    K4's calls by (problems, query rows, keys) under 'k4_shapes'."""
    from propainter_tpu_torch.graphs import snapshot

    out, shapes = {}, {}
    for f, n, by_shape in snapshot():
        out[f.__name__] = n
        for k, v in by_shape.items():
            shapes[(f.__name__, *k)] = v
    out["k4_shapes"] = shapes
    return out


def delta(after: dict, before: dict) -> dict:
    out = {k: after[k] - before.get(k, 0) for k in after if k != "k4_shapes"}
    shapes = {k: v - before["k4_shapes"].get(k, 0)
              for k, v in after["k4_shapes"].items()}
    out["k4_shapes"] = {k: v for k, v in shapes.items() if v}
    return out


def build(config: dict, device: str, seed: int):
    """The pipeline as the inference CLI builds it, on weights seeded on
    the device."""
    import torch

    from propainter_tpu_torch.models.flow_completion import (
        RecurrentFlowCompleteNet)
    from propainter_tpu_torch.models.propainter import InpaintGenerator
    from propainter_tpu_torch.models.raft import RAFT
    from propainter_tpu_torch.pipeline import (PipelineConfig,
                                               ProPainterPipeline)

    from benchmark.weights import fill_models_

    with torch.device(device):
        models = {"raft": RAFT(), "flowcomp": RecurrentFlowCompleteNet(),
                  "inpaint": InpaintGenerator()}
    fill_models_(models, seed)
    return ProPainterPipeline(models["raft"], models["flowcomp"],
                              models["inpaint"],
                              PipelineConfig(**config["settings"],
                                             **config["pipeline"]),
                              device=device)


def reference_outputs(config: dict, clip: dict, device: str, seed: int,
                      control: str | None = None) -> dict:
    """The plain reference's stage outputs on `clip` (the control's, with
    `control` the precision its products' operands are rounded to)."""
    import contextlib

    import torch

    from benchmark.compare import Products
    from benchmark.reference import pipeline as ref
    from benchmark.weights import fill_models_

    models = fill_models_(ref.build_models(device), seed)
    up = [torch.from_numpy(clip[k]).to(device)
          for k in ("frames", "flow_masks", "masks_dilated")]
    with (Products(control) if control else contextlib.nullcontext()):
        return ref.run(models, *up, ref.Config(**config["settings"]))


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", root: Path = ROOT, faults=None) -> dict:
    """One run of `workload`; returns the result's fields (see the module
    docstring) and, under 'stderr', the lines that end standard error.
    device: 'cuda' on the chip, 'cpu' for a rehearsal at a tiny size (the
    program's plain versions; no trace). faults: a test's hook, called
    with the pipeline before the window."""
    import numpy as np
    import torch

    from benchmark import compare
    from benchmark import trace as tr

    spec = load_spec(root)
    cell = cell_of(spec, workload)
    here = root / Path(spec["paths"][0])
    config = json.loads((root / cell["config"]["file"]).read_text())
    traffic, pool = traffic_pool(cell["workload"]["traffic"], seed, here)
    limits = json.loads((here / "limits" / f"{workload}.json").read_text())
    cuda = device == "cuda"
    notes = []

    pipe = build(config, device, seed)
    pipe.graphs = CountingGraphs(pipe.graphs)
    if faults is not None:
        faults(pipe)
    recorder = Recorder(pipe)
    rng = np.random.default_rng([seed, SAMPLE_STREAM])
    sample = int(rng.integers(SAMPLE_FROM))

    def one(c, timings=None):
        return pipe.inpaint_video(c["frames"], c["flow_masks"],
                                  c["masks_dilated"], timings=timings)

    warm, most = 0, int(traffic.get("warm_clips", MAX_WARM_CLIPS))
    while warm < most:
        ran = pipe.graphs.ran
        one(pool[warm % len(pool)])
        warm += 1
        if (warm >= min(len(pool), most)
                and (pipe.graphs.ran == ran or not cuda)):
            break
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START

    # ---- the window
    records = []
    ran0 = pipe.graphs.ran
    traced = None

    def clip_at(i, tracing=False):
        """Clip i of the window, run and timed; its output kept to be
        checked once the window has closed."""
        c = pool[i % len(pool)]
        timings: dict = {}
        t0 = time.perf_counter()
        try:
            out, why = one(c, timings), None
        except Exception as e:   # a clip that raises is counted, not fatal
            out, why = None, f"raised {type(e).__name__}: {e}"
        records.append(dict(index=i, traced=tracing,
                            wall=time.perf_counter() - t0, timings=timings,
                            out=out, why=why))

    w0 = time.perf_counter()
    i, takes = 0, 0
    while True:
        if trace and cuda and traced is None and i >= TRACE_FIRST:
            before, t_trace = launches(), time.perf_counter()
            with tr.device_trace() as prof:
                for j in range(TRACE_CLIPS):
                    clip_at(i + j, tracing=True)
            takes += 1
            span = sum(r["wall"] for r in records[-TRACE_CLIPS:])
            take = trace_record(prof, delta(launches(), before), span, tr)
            take["trace_indices"] = list(range(i, i + TRACE_CLIPS))
            notes.append(f"trace {takes}: {TRACE_CLIPS} clips in {span:.3f} "
                         f"s, the profiler's start, stop and read "
                         f"{time.perf_counter() - t_trace - span:.1f} s")
            if take["trace_complete"] or takes == 2:
                traced = take
            if not take["trace_complete"]:
                notes.append(f"trace {takes} short of the launch counts: "
                             f"{take['trace_counts']} against "
                             f"{take['trace_want']}"
                             + ("" if traced else "; taken again"))
            i += TRACE_CLIPS
        else:
            clip_at(i)
            i += 1
        if (time.perf_counter() - w0 >= seconds and i > sample
                and (traced is not None or not trace or not cuda)):
            break
    window_s = time.perf_counter() - w0
    eager_calls = pipe.graphs.ran - ran0
    peak = torch.cuda.max_memory_reserved() if cuda else 0
    failed, window_frames = 0, None
    for r in records:
        c = pool[r["index"] % len(pool)]
        if r["why"] is None:
            r["why"] = compare.malformed(r["out"], c["frames"],
                                         c["masks_dilated"])
        if r["index"] == sample and r["why"] is None:
            window_frames = np.stack(r["out"])
        r["frames"] = len(c["frames"]) if r["why"] is None else 0
        r["out"] = None
        if r["why"] is not None:
            failed += 1
            notes.append(f"clip {r['index']}: {r['why']}")
    attempted = len(records)
    frames_done = sum(r["frames"] for r in records)

    # the sampled clip once more on the warmed pipeline, its stages'
    # outputs kept; the frames compared are the window's
    prog = {}
    recorder.on = True
    try:
        again = np.stack(one(pool[sample % len(pool)]))
        prog = {k: tuple(t.float().cpu() for t in v)
                for k, v in recorder.outputs.items()}
        if window_frames is not None:
            prog["frames"] = torch.from_numpy(window_frames)
            gap = np.abs(again.astype(int) - window_frames).max()
            notes.append(f"sampled clip run again: its frames differ from "
                         f"the window's by up to {gap} LSB")
    except Exception as e:
        notes.append(f"sampled clip run again: raised {type(e).__name__}: "
                     f"{e}")
    recorder.on = False
    graphs_pool_gib = None
    if cuda and trace:
        graphs_pool_gib = graph_memory_gib(pipe)
    del pipe, recorder
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # ---- the comparison with the plain reference
    t_ref = time.perf_counter()
    ref = reference_outputs(config, pool[sample % len(pool)], device, seed)
    values = (compare.numbers(prog, ref, pool[sample % len(pool)]
                              ["masks_dilated"])
              if set(prog) >= {"raft", "flow_completion",
                               "image_propagation", "frames"} else {})
    walls = sorted(r["wall"] for r in records)
    notes.append(f"setup_s {setup_s:.3f}, window {window_s:.3f} s over "
                 f"{attempted} clips (sampled clip {sample}: "
                 f"{records[sample]['wall']:.3f} s; clips "
                 f"{walls[0]:.3f} / {statistics.median(walls):.3f} / "
                 f"{walls[-1]:.3f} s min / median / max), reference "
                 f"{time.perf_counter() - t_ref:.1f} s")
    correct = compare.verdict(values, limits) and failed == 0
    checks = {k: {"value": values.get(k), "limit": v}
              for k, v in limits.items()}
    checks["failed_clips"] = {"value": failed, "limit": 0}

    # ---- metrics
    rec = dict(records=records, sample=sample, window_s=window_s,
               frames=frames_done, setup_s=setup_s,
               peak_bytes=peak, eager_calls=eager_calls,
               graphs_pool_gib=graphs_pool_gib,
               precision=config["precision"], traffic=traffic, pool=pool,
               config=config, notes=notes)
    if traced is not None:
        rec.update(traced)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell[kind]:
        value = reader(m["name"], here)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if cuda:
        dev["power_limit"] = power_limit()
    if traced is not None:
        dev["busy_s"] = rec["busy_s"]
        dev["window_s"] = rec["trace_window_s"]
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if traced is not None:
        result["breakdown"] = rec["breakdown"]
    result["checks"] = checks
    result["stderr"] = notes + compare.lines(values, limits) + [
        f"failed_clips {failed} <= 0"]
    return result


def graph_memory_gib(pipe) -> float:
    """GiB the pipeline's CUDA graphs hold (their private pool and static
    inputs): the caching allocator's reserve, emptied, with the graphs and
    without them."""
    import torch

    def reserved():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_reserved()

    with_graphs = reserved()
    pipe.graphs.clear()
    return (with_graphs - reserved()) / 2 ** 30


def trace_record(prof, traced_launches: dict, span_s: float, tr) -> dict:
    """What the per-layer readers take from a trace of TRACE_CLIPS clips:
    its device records, their kernels held to the launch counters,
    busy seconds, the clips' wall, the breakdown."""
    evs = tr.events(prof)
    counts = tr.kernel_counts(evs)
    want = tr.held_counts(traced_launches)
    return dict(trace_events=evs, trace_counts=counts, trace_want=want,
                trace_complete=counts == want,
                trace_launches=traced_launches, trace_clips=TRACE_CLIPS,
                busy_s=tr.busy_ns(evs) / 1e9, trace_window_s=span_s,
                breakdown=tr.breakdown(evs))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    caches(ROOT)
    import torch

    chips = cell_of(load_spec(), args.workload)["workload"]["chips"]
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < chips:
        print(f"needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 3
    return emit(run(args.workload, args.seed, args.seconds,
                    bool(args.trace)))


def emit(result: dict) -> int:
    """Print a run's lines on standard error, then its result as the last
    line of standard output, unless JAX or the JAX package is loaded now,
    after every import the run made: then exit code 4 and no result.
    Returns the exit code."""
    for line in result.pop("stderr"):
        print(line, file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
