"""Median seconds a steady clip spends in stage 'image_propagation' of
`inpaint_video` (its `timings`, which end in a device synchronize)."""

from benchmark.records import stage_s


def read(rec: dict):
    return stage_s(rec, "image_propagation")
