"""The hand-written kernels (K1-K4 in the cell's precision) in the traced
clips: the bounds of the work the clips need of them over their device
time, % (benchmark/roofline.py). A trace short of its launch counts after the
retake is read all the same (its share reads a little high), and noted."""

from benchmark import roofline


def read(rec: dict):
    if "trace_events" not in rec:
        return None
    pool = rec["pool"]
    masks = [pool[i % len(pool)]["masks_dilated"]
             for i in rec["trace_indices"]]
    return roofline.share(rec["trace_events"], rec["trace_launches"], masks,
                          rec["config"]["settings"], rec["precision"],
                          rec["notes"])
