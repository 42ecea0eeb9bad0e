"""The control's readings, the upper ones the limits of
`benchmark/limits/<cell>.json` are set from, at the cell's own size, on
the chip:

  python3 benchmark/control.py --workload <cell> --seeds <n> \\
      [--first-seed <s>]

For each seed, the clip a run of that seed samples, computed by the plain
reference with every product's operands rounded to the precision below
the configuration's (TF32 for fp32, fp8 e4m3 for bf16), held to the
reference (`compare.numbers`): the control, which has to come out not
correct. The program's readings, the lower ones, are those the runs of
`run.py` print. One JSON line per seed; the benchmark's runs do not run
it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE.parent) not in sys.path:
    sys.path.insert(0, str(HERE.parent))

from benchmark import run as harness  # noqa: E402


def readings(workload: str, seed: int, device: str = "cuda",
             root: Path = harness.ROOT) -> dict:
    """The control's numbers for `seed`'s sampled clip."""
    import numpy as np

    from benchmark import compare

    spec = harness.load_spec(root)
    cell = harness.cell_of(spec, workload)
    here = root / Path(spec["paths"][0])
    config = json.loads((root / cell["config"]["file"]).read_text())
    _, pool = harness.traffic_pool(cell["workload"]["traffic"], seed, here)
    sample = int(np.random.default_rng([seed, harness.SAMPLE_STREAM])
                 .integers(harness.SAMPLE_FROM))
    clip = pool[sample % len(pool)]
    ref = harness.reference_outputs(config, clip, device, seed)
    ctl = harness.reference_outputs(
        config, clip, device, seed,
        control=compare.CONTROL[config["precision"]])
    return compare.numbers(ctl, ref, clip["masks_dilated"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_000)
    args = p.parse_args(argv)
    harness.caches(harness.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    for seed in range(args.first_seed, args.first_seed + args.seeds):
        t0 = time.perf_counter()
        values = readings(args.workload, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": "control", **values,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
