"""Precision settings the port's float32 products share."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32_matmul():
    """f32 products in full f32 on the card: TF32 off for the duration,
    the caller's setting restored afterwards (the counterpart of the JAX
    package's ``Precision.HIGHEST``)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
