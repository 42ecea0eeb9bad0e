"""The whole step's share of the chip's peak, %: the model's operations
of each of the window's steady clips (benchmark/flops.py, counted from
the clip's shapes and masks as the plain reference needs them), over
their seconds, over the peak (bf16 989 TFLOP/s; fp32 165, the 3xTF32
rate)."""

from benchmark import flops, roofline
from benchmark.records import clip_of, steady


def read(rec: dict):
    clips = steady(rec)
    if not clips:
        return None
    work: dict = {}
    for r in clips:
        i = r["index"] % len(rec["pool"])
        if i not in work:
            work[i] = flops.clip_flops(clip_of(rec, r)["masks_dilated"],
                                       rec["config"]["settings"])
    rate = (sum(work[r["index"] % len(rec["pool"])] for r in clips)
            / sum(r["wall"] for r in clips))
    return 100.0 * rate / roofline.PEAK_FLOPS[rec["precision"]]
