"""Frame layout/dtype conversion: uint8 interleaved <-> planar compute layout.

The reference ingests BGRA8 X11 pixels straight into rgba8 VkImages
(window_capture.cpp:472-568) and reads rgba8 back for SDL display
(scaler.cpp:480-614); all three shaders are channel-order-invariant, so the
reference's R/B swap cancels out (SURVEY.md §2.3.7).  This framework picks
one canonical order at ingest: frames enter as uint8 [H, W, C] RGBA and are
converted to the internal planar [C, H, W] f32/bf16 layout (W
contiguous), normalized to [0, 1] (UNORM read: x/255).

Egress quantizes with the Vulkan UNORM8 store convention (clamp, *255,
round-to-nearest-even) — shared with the oracle's quantize_unorm8.

These are plain XLA ops: unpack/transpose/convert fuse with their
producers and consumers.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

F32 = jnp.float32


@functools.partial(jax.jit, static_argnames=("dtype",))
def frames_to_planar(frames: jax.Array, dtype=jnp.float32) -> jax.Array:
    """uint8 [..., H, W, C] (or packed int32 [H, W] wire) -> planar
    [..., C, H, W] in [0,1].

    An int32 [H, W] input is the packed RGBA wire format (channel c in
    byte c, little-endian — the exact bytes of the uint8 frame): the host
    views frames as int32 lanes for free.
    """
    if frames.ndim == 2 and frames.dtype == jnp.int32:
        # reinterpret the packed wire as uint8 and share the uint8 path
        # STRUCTURALLY — a shift-based unpack builds a different float
        # graph, and XLA's algebraic rewrites could then round .5
        # quantization boundaries differently between the two wires; a
        # pure bit reinterpretation cannot.
        frames = jax.lax.bitcast_convert_type(frames, jnp.uint8)
    x = frames.astype(F32) / F32(255.0)
    x = jnp.moveaxis(x, -1, -3)
    return x.astype(dtype)


def planar_to_frames(planar: jax.Array) -> jax.Array:
    """planar [..., C, H, W] float -> uint8 [..., H, W, C] (UNORM8 store)."""
    x = jnp.moveaxis(planar.astype(F32), -3, -1)
    return jnp.round(jnp.clip(x, 0.0, 1.0) * F32(255.0)).astype(jnp.uint8)


def planar_to_i32(planar: jax.Array) -> jax.Array:
    """planar [4, H, W] float -> packed int32 [H, W] RGBA wire.

    Bit-identical bytes to ``planar_to_frames`` viewed as little-endian
    int32 lanes (channel c in byte c), without the strided channel
    transpose — shift/or of four UNORM8-quantized planes (int32 left
    shift is modular, so the alpha byte's high bit wraps exactly)."""
    x = planar.astype(F32)
    q = jnp.round(jnp.clip(x, 0.0, 1.0) * F32(255.0)).astype(jnp.int32)
    return (q[..., 0, :, :] | (q[..., 1, :, :] << 8)
            | (q[..., 2, :, :] << 16) | (q[..., 3, :, :] << 24))
