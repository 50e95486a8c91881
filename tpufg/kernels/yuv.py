"""Device-side y4m egress conversion (RGBA wire -> YUV4MPEG2 FRAME payload).

The reference's present path — readback + CPU blit into the SDL surface
(reference src/scaler.cpp:480-609) — is host work in its per-frame loop.
The device-side egress does the color conversion ON DEVICE instead: the
step's packed-RGBA wire output is converted to BT.601 limited-range planes
by fused integer ops, and what crosses the host boundary is the final
y4m FRAME payload bytes.  Two wins on top of freeing the (single-CPU) host
of per-pixel work:

- the readback shrinks 2.7x for C420 (12.4 MB vs 33.2 MB per 4K frame);
- the host's sink write degenerates to `file.write(buffer)`.

Byte contract: identical output to the host egress path
(native/fgio.cpp fg_rgba_to_yuv444 + fg_down2x2, and their numpy mirrors
in io/sinks.py) — the same 16.16 fixed-point arithmetic evaluated in i32,
pinned by tests/test_yuv.py.  The sink stays bitwise independent of which
leg (device or host) converted each frame.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

I32 = jnp.int32


def _bt601_planes(r, g, b):
    """int32 RGB codes (0..255) -> clipped int32 Y, Cb, Cr codes.

    Exactly native/fgio.cpp:yuv_px's inverse-direction constants
    (fg_rgba_to_yuv444): 16.16 fixed point, arithmetic >> 16 (numpy/XLA
    right_shift on signed int32 is arithmetic, matching C on every ABI
    this runs on), limited-range offsets, clip to [0, 255].
    """
    y = ((16829 * r + 33039 * g + 6416 * b) >> 16) + 16
    u = ((-9714 * r - 19070 * g + 28784 * b) >> 16) + 128
    v = ((28784 * r - 24103 * g - 4681 * b) >> 16) + 128
    clip = lambda p: jnp.clip(p, 0, 255)
    return clip(y), clip(u), clip(v)


def _down2x2_i32(p: jax.Array) -> jax.Array:
    """2x2 box average with (s + 2) >> 2 rounding on int32 codes —
    the "420jpeg" chroma siting, byte-matching fg_down2x2."""
    h, w = p.shape
    q = p.reshape(h // 2, 2, w // 2, 2)
    s = q[:, 0, :, 0] + q[:, 0, :, 1] + q[:, 1, :, 0] + q[:, 1, :, 1]
    return (s + 2) >> 2


@functools.partial(jax.jit, static_argnames=("chroma",))
def rgba_to_y4m_payload(frame: jax.Array, chroma: str = "420") -> jax.Array:
    """Packed-RGBA frame -> y4m FRAME payload bytes, on device.

    ``frame``: int32 [H, W] RGBA wire (channel c in byte c, little-endian)
    or uint8 [H, W, 4].  Returns uint8 [H*3//2, W] (C420; needs H % 4 == 0
    and W % 2 == 0) or [3*H, W] (C444) whose row-major bytes are exactly
    the Y, then Cb, then Cr planes — ready to write after b"FRAME\\n".

    (The chroma planes' [H//2, W//2] -> [H//4, W] reshape is a pure
    row-major byte reinterpretation, which is what lets the whole payload
    travel as ONE array.)
    """
    if frame.ndim == 3:
        if frame.shape[-1] != 4 or frame.dtype != jnp.uint8:
            raise ValueError(f"expected uint8 [H, W, 4], got "
                             f"{frame.dtype} {frame.shape}")
        frame = jax.lax.bitcast_convert_type(frame, jnp.int32)
    h, w = frame.shape
    q = frame.astype(I32)
    r = q & 0xFF
    g = (q >> 8) & 0xFF
    b = (q >> 16) & 0xFF
    y, u, v = _bt601_planes(r, g, b)
    if chroma == "444":
        return jnp.concatenate([y, u, v], axis=0).astype(jnp.uint8)
    if chroma != "420":
        raise ValueError(f"chroma must be 420 or 444, got {chroma!r}")
    if h % 4 or w % 2:
        raise ValueError(
            f"C420 payload needs H % 4 == 0 and W % 2 == 0, got {h}x{w}")
    u = _down2x2_i32(u).reshape(h // 4, w)
    v = _down2x2_i32(v).reshape(h // 4, w)
    return jnp.concatenate([y, u, v], axis=0).astype(jnp.uint8)


def payload_shape(out_h: int, out_w: int, chroma: str) -> tuple[int, int]:
    """Host-side shape of the payload array for (out_h, out_w)."""
    rows = 3 * out_h if chroma == "444" else out_h * 3 // 2
    return (rows, out_w)


def y4m_wire_ok(out_h: int, out_w: int, chroma: str) -> bool:
    """Whether the device payload path supports these dimensions."""
    if chroma == "444":
        return True
    return chroma == "420" and out_h % 4 == 0 and out_w % 2 == 0
