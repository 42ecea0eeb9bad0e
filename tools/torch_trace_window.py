"""Does a profiler trace of the port's graphed main path hold every kernel
launch the launch counters saw?  Traces stopped as soon as the run
returns (as chip_smoke.py's main-path traces stopped before) against
traces taken through `chip_smoke._device_trace` (the device synchronized
and idle at both edges), alternating, on the bf16 pipelines with fp32
RAFT refinement and with 'pallas' attention, each warmed up until every
graph is captured.

    python3 tools/torch_trace_window.py [--seconds 300]

Needs a CUDA card. Prints one line a trace (the device records in it and
the kernels it is short of the launch counters) and a summary a
configuration and a way of tracing."""
import argparse
import re
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=300.0)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_trace_window: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"{cs._smi_line()}; torch {torch.__version__}", flush=True)
    cs.phase_build({})
    pipe, frames, flow_masks = cs._main_path_inputs()

    def at_return():
        return profile(activities=[ProfilerActivity.CUDA])

    ways = {"at return": at_return, "margins": cs._device_trace}
    configs = []
    for name, make in (("bf16_fp32_refine", cs._bf16_fp32_refine_pipeline),
                       ("bf16_pallas", cs._bf16_pallas_pipeline)):
        p = make(pipe)
        cs._warm_up(p, frames, flow_masks)
        want = cs._trace_counters(
            cs._graph_run(p, frames, flow_masks)["launches"])
        configs.append((name, p, want))
    tally = {(c[0], w): [0, 0, 0] for c in configs for w in ways}
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < args.seconds:
        order = list(ways) if i % 2 == 0 else list(ways)[::-1]
        for name, p, want in configs:
            for way in order:
                torch.cuda.synchronize()
                with ways[way]() as prof:
                    p.inpaint_video(frames, flow_masks, flow_masks)
                rows = cs._trace_rows(prof)
                got = {k: sum(r[2] for r in rows
                              if re.search(rf"\b{s}\b", r[0]))
                       for k, s in cs.TRACE_KERNELS.items()}
                short = {k: want[k] - got[k] for k in want
                         if got[k] != want[k]}
                n = sum(r[2] for r in rows)
                t = tally[(name, way)]
                t[0] += 1
                t[1] += bool(short)
                t[2] = max(t[2], n)
                print(f"t {time.perf_counter() - t0:6.1f} s {name} {way}: "
                      f"{n} device records, kernels short {short}",
                      flush=True)
        i += 1
    for (name, way), (n, short, most) in tally.items():
        print(f"{name} {way}: {short} of {n} traces short of the launch "
              f"counters (most device records in one trace {most})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
