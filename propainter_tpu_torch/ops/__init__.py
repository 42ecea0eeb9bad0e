"""Tensor ops and the wrappers of the hand-written CUDA kernels.

Public ops keep the JAX package's layouts (NHWC images, its offset and
attention layouts). A kernel wrapper runs its plain PyTorch version for a
CPU tensor and launches its kernel for a CUDA tensor; each counts its
launches in `<wrapper>.launches`.
"""
