"""Aligned 2x box downsample (the pyramid's level construction).

Plain XLA: a reshape exposing the 2x2 cells, rows averaged first, then
columns, each as ``0.5*(a + b)``.  Halving is exact in binary floating
point, so ``0.5*(a+b)`` equals ``0.5*a + 0.5*b`` bit for bit, and the
result is the two-pass banded average ``Ry @ x @ Rx`` (0.5 taps) exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

F32 = jnp.float32


@jax.jit
def box_downsample2(img: jax.Array) -> jax.Array:
    """[C, H, W] -> [C, H/2, W/2] 2x2 box mean (H, W even).

    Computed in f32; a bf16 input rounds the row average to bf16 before
    the column pass and returns bf16."""
    c, h, w = img.shape
    if h % 2 or w % 2:
        raise ValueError(f"box_downsample2 needs even dims, got {h}x{w}")
    dt = img.dtype
    x = img.astype(F32).reshape(c, h // 2, 2, w)
    rows = (F32(0.5) * (x[:, :, 0] + x[:, :, 1])).astype(dt).astype(F32)
    rows = rows.reshape(c, h // 2, w // 2, 2)
    return (F32(0.5) * (rows[..., 0] + rows[..., 1])).astype(dt)
