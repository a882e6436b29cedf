"""The reference's precision: float32, or, for the control, one step below it.

TF32 keeps 10 of float32's 23 mantissa bits in the operands of a matrix
product and accumulates in float32. :func:`tf32` rounds the operands that way
(to nearest, ties to even), so the control computes the same on the card and
on the CPU, whatever kernel the library picks for a product. The other
float32 state of the control, a TSDF's stored values, is rounded to bfloat16
(:func:`stored`) under :func:`bf16_storage`.
"""

from __future__ import annotations

import contextlib

import torch

_state = {"tf32": False, "bf16": False}


@contextlib.contextmanager
def tf32_products():
    """Run the enclosed reference code with every matrix product in TF32."""
    old = _state["tf32"]
    _state["tf32"] = True
    try:
        yield
    finally:
        _state["tf32"] = old


@contextlib.contextmanager
def bf16_storage():
    """Run the enclosed reference code with the TSDF's stored values in bfloat16."""
    old = _state["bf16"]
    _state["bf16"] = True
    try:
        yield
    finally:
        _state["bf16"] = old


def stored(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the volume stores it: float32, or bfloat16 under :func:`bf16_storage`."""
    return x.to(torch.bfloat16).to(torch.float32) if _state["bf16"] else x


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10-bit mantissa, to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + (0x0FFF + ((i >> 13) & 1))) & -0x2000
    return i.view(torch.float32)


def _ops(*xs):
    if not _state["tf32"]:
        return xs
    return tuple(tf32(x) if x.dtype == torch.float32 else x for x in xs)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b``."""
    a, b = _ops(a, b)
    return a @ b


def einsum(eq: str, *xs: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, *_ops(*xs))
