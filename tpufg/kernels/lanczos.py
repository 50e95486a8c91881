"""Separable Lanczos resample in plain XLA.

The reference's ``scale.comp`` (shaders/scale.comp:1-61, dispatched at
src/scaler.cpp:344-362) computes, per output pixel, a 6x6 tap stencil with
joint renormalization over in-bounds taps.  Because taps are skipped
per-axis and the 2-D weight is the separable product
``lanczos(dx)*lanczos(dy)`` (scale.comp:41), the operation factors exactly
into two 1-D resamples with per-axis normalized weights.

Each pass is 2a weighted reads of the input at static tap positions,
about 12 multiply-adds per output value: far below the GPU's ridge point,
so the passes are memory-bound.  For a rational ratio p/q with few phases
(2x, 1.5x, ...), output q*m + f reads input p*m + const for every tap, so
each phase is six static strided slices that XLA fuses into one loop with
the phase interleave; other ratios read through gathers at static clamped
indices.  Out-of-range taps carry weight 0.  No dot is involved, so no
TF32 rounding can enter.  The packed form fuses the vertical pass with
UNORM8 quantization and the RGBA channel pack; its one extra HBM round
trip is the f32 ``[C, H_in, W_out]`` horizontal intermediate.

Numerical contract: within 1e-6 absolute of the float64 evaluation of the
oracle's taps (a few f32 ulps).  The f32 oracle (tpufg.ops.oracle.
lanczos_scale) sums 36 unnormalized products and is itself further from
that value (4.6e-6 at 960x540 output, 3.2e-5 at a 1.5x ratio, CPU); on the
small frames of the tests the two agree to 2e-6.  The bit-exact path is
the oracle itself (see ops/oracle.py).
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

from tpufg.kernels.convert import planar_to_i32

F32 = jnp.float32
_NP_PI = np.float32(3.14159265359)  # scale.comp:18


def _np_lanczos_weight(x: np.ndarray, a: int) -> np.ndarray:
    """Host-side numpy mirror of ops.oracle.lanczos_weight (f32).

    Must stay numpy (not jnp): it runs while tracing under jit, and staged
    ops would leak tracers into the cached plan.
    """
    x = x.astype(np.float32)
    px = _NP_PI * x
    with np.errstate(invalid="ignore", divide="ignore"):
        w = np.float32(a) * np.sin(px) * np.sin(px / np.float32(a)) / (px * px)
    return np.where(x == 0, np.float32(1.0), w).astype(np.float32)


def _np_axis_taps(in_size: int, out_size: int, a: int):
    """Host-side numpy mirror of ops.oracle._axis_taps (f32)."""
    out_idx = np.arange(out_size, dtype=np.float32)
    uv = (out_idx + np.float32(0.5)) / np.float32(out_size)
    pixel_pos = uv * np.float32(in_size) - np.float32(0.5)
    fl = np.floor(pixel_pos)
    frac = (pixel_pos - fl).astype(np.float32)
    start = fl - np.float32(a - 1)
    k = np.arange(2 * a, dtype=np.float32)
    coords = start[:, None] + k[None, :]
    deltas = (k[None, :] - frac[:, None] - np.float32(a - 1)).astype(np.float32)
    valid = (coords >= 0) & (coords <= np.float32(in_size - 1))
    return coords.astype(np.int32), deltas, valid


@functools.lru_cache(maxsize=64)
def axis_taps(in_size: int, out_size: int, a: int):
    """Static per-axis plan: (coords [2a, out] int32, w [2a, out] f32 numpy).

    ``w[k, j]`` is output j's tap-k weight, zeroed for out-of-range taps
    and normalized per axis (exactly the shader's joint normalization,
    since tap validity is per-axis independent); ``coords`` is the tap's
    texel index, unclamped (a zero-weight tap may point outside the
    image)."""
    coords, deltas, valid = _np_axis_taps(in_size, out_size, a)
    w = _np_lanczos_weight(deltas, a)
    w = np.where(valid, w, np.float32(0.0)).astype(np.float32)
    wsum = np.sum(w, axis=1, keepdims=True, dtype=np.float32)
    w = (w / np.maximum(wsum, np.float32(1e-30))).astype(np.float32)
    return np.ascontiguousarray(coords.T), np.ascontiguousarray(w.T)


@functools.lru_cache(maxsize=64)
def polyphase_plan(in_size: int, out_size: int, a: int):
    """Phase plan of one axis, or None.

    With ``p/q = in_size/out_size`` in lowest terms, output ``q*m + f``
    (phase f) reads input ``p*m + base[f, k]`` for tap k — a strided
    static slice — whenever the f32 tap positions keep that pattern
    exactly (checked, not assumed).  Returns (p, q, base [q, 2a]) or None
    when they do not or when q exceeds 16 phases."""
    g = math.gcd(in_size, out_size)
    p, q = in_size // g, out_size // g
    if q > 16:
        return None
    coords, _ = axis_taps(in_size, out_size, a)          # [2a, out]
    base = coords[:, :q].T                               # [q, 2a]
    m = np.arange(g)
    for f in range(q):
        want = base[f][:, None] + p * m[None, :]         # [2a, g]
        if not np.array_equal(coords[:, f::q], want):
            return None
    return p, q, base


def _resample_axis(x: jax.Array, axis: int, out_size: int,
                   a: int) -> jax.Array:
    """1-D Lanczos pass along ``axis`` of an f32 array: 2a weighted reads
    per output, as static strided slices per phase (see polyphase_plan),
    or as gathers at static clamped indices when no phase plan exists."""
    in_size = x.shape[axis]
    coords, w = axis_taps(in_size, out_size, a)
    shape = [1] * x.ndim

    def weight(v):
        shape[axis] = v.shape[0]
        return jnp.asarray(v.reshape(shape))

    plan = polyphase_plan(in_size, out_size, a)
    if plan is None:
        idx = np.clip(coords, 0, in_size - 1)
        out = jnp.take(x, idx[0], axis=axis) * weight(w[0])
        for k in range(1, 2 * a):
            out = out + jnp.take(x, idx[k], axis=axis) * weight(w[k])
        return out
    p, q, base = plan
    g = out_size // q
    pad = 2 * a + p
    widths = [(0, 0)] * x.ndim
    widths[axis] = (pad, pad)
    xp = jnp.pad(x, widths)                # padded taps carry weight 0
    phases = []
    for f in range(q):
        acc = None
        for k in range(2 * a):
            start = pad + int(base[f, k])
            tap = jax.lax.slice_in_dim(xp, start, start + p * (g - 1) + 1,
                                       stride=p, axis=axis)
            term = tap * weight(w[k, f::q])
            acc = term if acc is None else acc + term
        phases.append(acc)
    out = jnp.stack(phases, axis=axis + 1)               # [..., g, q, ...]
    new_shape = list(x.shape)
    new_shape[axis] = out_size
    return out.reshape(new_shape)


def lanczos_scale_planar(img: jax.Array, out_h: int, out_w: int,
                         a: int = 3) -> jax.Array:
    """Lanczos-``a`` resample of a planar [C, H, W] stack -> f32
    [C, out_h, out_w] (any input dtype; computed in f32): the horizontal
    pass, then the vertical pass."""
    x = img.astype(F32)
    return _resample_axis(_resample_axis(x, 2, out_w, a), 1, out_h, a)


def lanczos_scale_packed(img: jax.Array, out_h: int, out_w: int,
                         a: int = 3, raw_i32: bool = False) -> jax.Array:
    """Lanczos resample fused with UNORM8 quantization and channel packing.

    ``img``: [4, H, W] planar.  Returns uint8 [out_h, out_w, 4] — the bytes
    of ``planar_to_frames(lanczos_scale_planar(...))`` — or, with
    ``raw_i32``, the same bytes as the packed int32 [out_h, out_w] RGBA
    wire (channel c in byte c, little-endian), which the host views as
    uint8 for free.
    """
    c = img.shape[0]
    if c != 4:
        raise ValueError(f"packed scale needs 4 channels, got {c}")
    packed = planar_to_i32(lanczos_scale_planar(img, out_h, out_w, a))
    if raw_i32:
        return packed
    return jax.lax.bitcast_convert_type(packed, jnp.uint8)
