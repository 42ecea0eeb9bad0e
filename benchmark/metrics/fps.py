"""Frames of every clip completed in the window over the window's measured
seconds (the window ends with the clip running when its time has
passed)."""


def read(rec: dict):
    return rec["frames"] / rec["window_s"] if rec["frames"] else None
