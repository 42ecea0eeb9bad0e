"""Evaluation: metrics and the test dataset (host-side numpy, except the
warping error, which runs on tensors)."""
