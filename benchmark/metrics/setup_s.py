"""Seconds from process start to window start: imports, the kernels'
libraries, seeded weights, the clips, warm-up and graph capture."""


def read(rec: dict):
    return rec["setup_s"]
