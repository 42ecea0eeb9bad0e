"""ProPainter in PyTorch for NVIDIA Hopper (H100).

A port of the JAX package `propainter_tpu`, which stays the reference it is
tested against. Layout mirrors it: `ops/` (with the hand-written CUDA
kernels' wrappers), `models/`, `utils/`, `pipeline.py`, `api.py`; the CUDA
sources live in `csrc/` and are built on first use (`_build.py`).

Entry points run on `cuda` unless the caller passes `device="cpu"`.
"""
