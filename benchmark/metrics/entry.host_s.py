"""Median seconds a steady clip spends in `inpaint_video` outside its four
stages: the upload, the readback, the list of frames."""

from benchmark.records import STAGES, median, steady


def read(rec: dict):
    return median([r["wall"] - sum(r["timings"][s] for s in STAGES)
                   for r in steady(rec)])
