"""Learned interpolation head (RIFE-style), pure JAX.

BASELINE.json config 5: "hierarchical pyramid motion search + RIFE-style
learned interpolation head".  The reference has no model code at all (its
interpolation is the fixed motion.comp/interpolate.comp pair, and dead code
at that — SURVEY.md §0); this module supplies the learned alternative:

- a small convolutional flow+fusion network (IFNet-flavored): encode the
  frame pair at 1/4 resolution, predict bidirectional flow + an occlusion
  mask, warp both frames differentiably, and fuse;
- a jit'd Adam training step (optax) minimizing L1 against a ground-truth
  middle frame — the self-supervised triplet scheme (train on frame
  triplets, predict the middle from the outer two);
- sharding-friendly: all convs are NCHW with channel-last-free layouts, and
  ``make_train_step`` accepts a mesh to shard batch (dp) and hidden
  channels (tp) via GSPMD sharding annotations — XLA inserts the
  collectives (psum on the channel-sharded convs, halo for spatial convs)
  automatically.

Compute is convolution-dominated (cuDNN on the GPU); inference runs bf16
operands with f32 accumulation, training keeps f32 master weights and f32
convolutions at HIGHEST precision (no TF32).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax import lax
import numpy as np
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

F32 = jnp.float32

HIDDEN = 64
SCALE = 4  # flow predicted at 1/SCALE resolution


def _conv(x, w, b, stride=1, dtype=F32):
    """3x3 SAME conv, NCHW/OIHW, f32 accumulation.  f32 operands run at
    HIGHEST precision: a GPU would otherwise round them to TF32."""
    prec = (jax.lax.Precision.HIGHEST if dtype == F32
            else jax.lax.Precision.DEFAULT)
    y = jax.lax.conv_general_dilated(
        x.astype(dtype), w.astype(dtype),
        window_strides=(stride, stride), padding="SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=prec, preferred_element_type=F32,
    )
    return y + b[None, :, None, None]


def init_params(key: jax.Array, hidden: int = HIDDEN) -> dict:
    """He-initialized parameters; layout {name: {w, b}} with OIHW kernels."""
    def he(k, shape):
        fan_in = int(np.prod(shape[1:]))
        return jax.random.normal(k, shape, F32) * np.sqrt(2.0 / fan_in)

    ks = jax.random.split(key, 6)
    h = hidden
    return {
        # encoder: 8 input ch (prev+curr RGBA) -> h/2 @ 1/2 -> h @ 1/4
        "enc1": {"w": he(ks[0], (h // 2, 8, 3, 3)), "b": jnp.zeros((h // 2,), F32)},
        "enc2": {"w": he(ks[1], (h, h // 2, 3, 3)), "b": jnp.zeros((h,), F32)},
        "body1": {"w": he(ks[2], (h, h, 3, 3)), "b": jnp.zeros((h,), F32)},
        "body2": {"w": he(ks[3], (h, h, 3, 3)), "b": jnp.zeros((h,), F32)},
        # head: 4 flow channels (prev dx,dy + curr dx,dy) + 1 mask logit
        "head": {"w": he(ks[4], (5, h, 3, 3)), "b": jnp.zeros((5,), F32)},
    }


def bilinear_warp(img: jax.Array, flow: jax.Array) -> jax.Array:
    """Differentiable backward warp: out[.., y, x] = img[.., y+fy, x+fx].

    ``img``: [B, C, H, W]; ``flow``: [B, 2, H, W] pixel-unit (dx, dy).
    Clamp-to-edge sampling (XLA gather; fully differentiable, used in
    training where the block warp's block granularity would bias
    gradients).
    """
    b, c, h, w = img.shape
    ys = jnp.arange(h, dtype=F32)[None, :, None] + flow[:, 1]
    xs = jnp.arange(w, dtype=F32)[None, None, :] + flow[:, 0]
    # clamp-to-edge BEFORE floor so border fractions stay in [0,1)
    ys = jnp.clip(ys, 0.0, float(h - 1))
    xs = jnp.clip(xs, 0.0, float(w - 1))
    y0 = jnp.floor(ys)
    x0 = jnp.floor(xs)
    fy = (ys - y0)[:, None]
    fx = (xs - x0)[:, None]
    y0 = jnp.clip(y0.astype(jnp.int32), 0, h - 1)
    y1 = jnp.clip(y0 + 1, 0, h - 1)
    x0 = jnp.clip(x0.astype(jnp.int32), 0, w - 1)
    x1 = jnp.clip(x0 + 1, 0, w - 1)

    bidx = jnp.arange(b)[:, None, None]

    def gather(yy, xx):
        return img[bidx[:, None], jnp.arange(c)[None, :, None, None],
                   yy[:, None], xx[:, None]]

    c00 = gather(y0, x0)
    c10 = gather(y0, x1)
    c01 = gather(y1, x0)
    c11 = gather(y1, x1)
    top = c00 * (1 - fx) + c10 * fx
    bot = c01 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def _trunk_raw(params: dict, prev: jax.Array, curr: jax.Array, dtype=F32):
    """Conv trunk: frame pair -> raw head output [B, 5, H/4, W/4]
    (4 flow channels + 1 mask logit, at the 1/SCALE prediction scale).

    ``dtype``: conv operand precision.  Training keeps f32; inference
    passes bf16 (f32 accumulate) — no visible effect on the 1/4-res flow
    field.
    """
    x = jnp.concatenate([prev, curr], axis=1).astype(F32)
    h1 = jax.nn.relu(_conv(x, params["enc1"]["w"], params["enc1"]["b"],
                           2, dtype))
    h2 = jax.nn.relu(_conv(h1, params["enc2"]["w"], params["enc2"]["b"], 2,
                           dtype))
    h3 = jax.nn.relu(_conv(h2, params["body1"]["w"], params["body1"]["b"],
                           1, dtype))
    h4 = jax.nn.relu(_conv(h3, params["body2"]["w"], params["body2"]["b"],
                           1, dtype))
    return _conv(h4, params["head"]["w"], params["head"]["b"])


def _trunk(params: dict, prev: jax.Array, curr: jax.Array, dtype=F32):
    """Frame pair -> (flow_p, flow_c, mask) at full resolution (see
    _trunk_raw for the conv stack and the ``dtype`` knob)."""
    out = _trunk_raw(params, prev, curr, dtype)
    # upsample flow/mask to full res; flow values scale with resolution
    b, _, hq, wq = out.shape
    full = jax.image.resize(out, (b, 5, hq * SCALE, wq * SCALE), "bilinear")
    return (full[:, 0:2] * F32(SCALE), full[:, 2:4] * F32(SCALE),
            jax.nn.sigmoid(full[:, 4:5]))


@functools.lru_cache(maxsize=16)
def _band_mat(n_out: int, n_in: int, scale: int = SCALE) -> np.ndarray:
    """Bilinear-upsample band matrix [n_out, n_in] replicating
    jax.image.resize's half-sample-centered 'bilinear' weights (out x
    reads in coord (x+0.5)/scale - 0.5, clamped 2-tap lerp)."""
    R = np.zeros((n_out, n_in), np.float32)
    for x in range(n_out):
        c = (x + 0.5) / scale - 0.5
        i0 = int(np.floor(c))
        f = c - i0
        i0c = min(max(i0, 0), n_in - 1)
        i1c = min(max(i0 + 1, 0), n_in - 1)
        R[x, i0c] += 1.0 - f
        R[x, i1c] += f
    return R


def _st_round(x: jax.Array) -> jax.Array:
    """Straight-through rounding: forward = round(x), gradient = identity
    (the QAT estimator) — lets training run the integer flows inference
    actually executes while keeping the flow heads trainable."""
    return x + jax.lax.stop_gradient(jnp.round(x) - x)


def _block_flow(lat: jax.Array, clip_r: float, block: int,
                integer: bool = True) -> jax.Array:
    """Lattice flow [B, 2, nh, nw] -> per-pixel constant-per-block flow
    [B, 2, nh*block, nw*block]: straight-through round (``integer``; the
    fractional tail keeps the real-valued flow), the warp kernel's clamp
    (warp_matmul.py clips MV to +-search_radius), then nearest upsampling
    (each block is one rigid shift, exactly the one-hot block warp's
    granularity)."""
    f = jnp.clip(_st_round(lat) if integer else lat, -clip_r, clip_r)
    return jnp.repeat(jnp.repeat(f, block, axis=2), block, axis=3)


def _ft_tail(out: jax.Array, prev: jax.Array, curr: jax.Array, t: float,
             grid: int = 16, max_flow: int = 8,
             integer_flow: bool = True) -> jax.Array:
    """Differentiable replica of the inference tail (:func:`_fast_tail`)
    for fast-consistent training: the SAME closed-form lattice sample,
    straight-through integer rounding in place of round() (``integer_flow``
    — v1's deployed tail; v2 deploys fractional, see interpolate_fast2),
    and a constant-per-block backward warp in place of the one-hot block
    warp.

    With integer flows the bilinear gather degenerates to an exact shift
    with clamp-to-edge taps — semantically identical to the single-mode
    one-hot warp (which edge-pads and applies no OOB blank); with
    fractional flows both paths compute the same 2x2-tap lerp (the warp's
    edge-padded taps equal the gather's clamp-then-lerp at every border
    case, since all clamped taps read the same edge pixel) — so forward
    values match inference to f32 rounding either way (pinned in
    tests/test_rife.py).  Training on this tail removes the
    train/inference distribution shift the r3/r4 evals measured as the
    fast path's ~0.4-0.9 dB loss.

    ``out``: raw head output [B, 5, H/4, W/4]; ``prev``/``curr``:
    [B, C, H, W] with H, W divisible by ``grid``.
    """
    if grid != 4 * SCALE:
        raise ValueError(f"_ft_tail expects grid == {4 * SCALE}")
    b, _, hq, wq = out.shape
    nh, nw = hq // 4, wq // 4
    ry = (out[:, :, 1::4][:, :, :nh] * F32(0.375)
          + out[:, :, 2::4][:, :, :nh] * F32(0.625))
    lat = (ry[:, :, :, 1::4][:, :, :, :nw] * F32(0.375)
           + ry[:, :, :, 2::4][:, :, :, :nw] * F32(0.625))
    sp, sc = _flow_t_scales(t)
    flow_p = _block_flow(_scale_flow(lat[:, 0:2], SCALE, sp),
                         float(max_flow), grid, integer_flow)
    flow_c = _block_flow(_scale_flow(lat[:, 2:4], SCALE, sc),
                         float(max_flow), grid, integer_flow)
    mask = jax.nn.sigmoid(jax.image.resize(
        out[:, 4:5], (b, 1, hq * SCALE, wq * SCALE), "bilinear"))
    warped_p = bilinear_warp(prev.astype(F32), flow_p)
    warped_c = bilinear_warp(curr.astype(F32), flow_c)
    return _fuse(warped_p, warped_c, mask, t)


def _flow_t_scales(t):
    """Per-side flow scale factors for an arbitrary time point.

    The heads are trained exclusively at the triplet midpoint, so their
    flow channels are the motions FROM t=0.5: fp ≈ −V/2, fc ≈ +V/2 for a
    constant pair velocity V.  The frame at time t needs −t·V toward prev
    and (1−t)·V toward curr, i.e. fp·2t and fc·2(1−t).  Both factors are
    exactly 1.0 at t=0.5 (a multiply by 1.0f is exact), so the k=2
    deployment/eval path is bitwise-unchanged; only k>2 time points move.
    Measured motivation: before this scaling the k=3/4 learned rows
    warped every in-between with the MIDPOINT flows (r4d2 campaign:
    36.97/36.91 dB vs 40.83 at k=2 on the same corpus).

    ``t`` may be a traced f32 scalar (multi-t training: the trainer draws
    a fresh t per step, so t must be a step ARGUMENT, not a compile-time
    constant); the static-float path is unchanged."""
    if isinstance(t, (int, float, np.floating)):
        return 2.0 * float(t), 2.0 * (1.0 - float(t))
    t = jnp.asarray(t, F32)
    return F32(2.0) * t, F32(2.0) * (F32(1.0) - t)


def _scale_flow(flow, mult: float, s):
    """``flow * (mult * s)`` with the static-t constant folded exactly as
    before this helper existed.  ``mult`` is always a power of two here
    (SCALE or 1), so fold-then-cast and cast-then-multiply are bitwise
    equal — the branch only keeps the static-t jaxpr literally identical
    while letting a traced ``s`` flow through as a runtime scalar."""
    if isinstance(s, float):
        return flow * F32(mult * s)
    return flow * (F32(mult) * s)


def _is_midpoint(t) -> bool:
    """True for the static t=0.5 fast path (scaling is a provable no-op
    there; skipping it keeps the deployed k=2 graphs byte-identical)."""
    return isinstance(t, (int, float, np.floating)) and float(t) == 0.5


def _fuse(warped_p, warped_c, mask, t):
    tt = (F32(t) if isinstance(t, (int, float, np.floating))
          else jnp.asarray(t, F32))
    # occlusion-weighted fusion biased by temporal position
    w_p = mask * (F32(1.0) - tt)
    w_c = (F32(1.0) - mask) * tt
    return (warped_p * w_p + warped_c * w_c) / (w_p + w_c + F32(1e-6))


def _smooth_tail(out: jax.Array, prev: jax.Array, curr: jax.Array,
                 t: float) -> jax.Array:
    """Training tail: raw head output [B, 5, h, w] -> predicted frame via
    bilinear flow upsampling and the differentiable per-pixel gather warp
    (same math _trunk + forward always computed, factored so the
    supervised losses can reuse the head output they also supervise)."""
    b, _, hq, wq = out.shape
    sp, sc = _flow_t_scales(t)
    full = jax.image.resize(out, (b, 5, hq * SCALE, wq * SCALE), "bilinear")
    warped_p = bilinear_warp(prev.astype(F32),
                             _scale_flow(full[:, 0:2], SCALE, sp))
    warped_c = bilinear_warp(curr.astype(F32),
                             _scale_flow(full[:, 2:4], SCALE, sc))
    return _fuse(warped_p, warped_c, jax.nn.sigmoid(full[:, 4:5]), t)


def forward(params: dict, prev: jax.Array, curr: jax.Array,
            t: float = 0.5, ft: bool = False) -> jax.Array:
    """Predict the frame at time t between prev and curr (training path).

    ``prev``/``curr``: planar [B, 4, H, W] in [0,1]; H, W divisible by 4
    (by 16 with ``ft``).
    Uses the differentiable per-pixel gather warp (correct gradients);
    inference uses :func:`interpolate_fast`.

    ``ft`` (fast-consistent training): run the differentiable replica of
    the INFERENCE tail instead — lattice-sampled, straight-through-rounded
    block flows (see :func:`_ft_tail`) — so the loss measures exactly what
    the deployed fast path produces.
    """
    out = _trunk_raw(params, prev, curr)
    if ft:
        return _ft_tail(out, prev, curr, t)
    return _smooth_tail(out, prev, curr, t)


def interpolate_fast(params: dict, prev: jax.Array, curr: jax.Array,
                     t: float = 0.5, grid: int = 16,
                     max_flow: int = 8, dtype=jnp.bfloat16,
                     integer_flow: bool | None = None) -> jax.Array:
    """Inference path: predicted flow block-subsampled through the
    production one-hot warp (tpufg.kernels.warp_matmul) — no gathers.

    ``prev``/``curr``: planar [C, H, W] (no batch); H, W divisible by
    ``grid``.  RIFE-style flow is smooth at the 1/4-res prediction scale,
    so the 16-px block quantization costs little; the learned occlusion
    mask stays per-pixel.

    ``max_flow`` clamps the PER-FRAME flow (flows are t-scaled motions,
    so 8 covers ~±16 px/frame of true motion); the one-hot warp's span,
    and so its cost, scales with it.

    ``integer_flow`` rounds the subsampled flow to integer pixels; the
    warp then takes the single-band integer-offset path in the exact
    integer-code domain (bf16 bitwise == f32; kernels/warp_matmul.py
    u8_exact).  The default (None) resolves PER ARCHITECTURE, both ways
    measured on the rich natural corpus (round 4):

    - v1 -> True: v1's converged flows are sub-pixel (p50 0.55 px, max
      ~1.1 px — the single-stage head plateaus near a smart crossfade),
      so the fractional lerp only softens texture; integer measured
      +0.27 dB / +0.011 SSIM over fractional.
    - v2 -> False: the two-stage head learns real fractional flows (p95
      ~1.7 px), and rounding them measured -2.44 dB / -0.028 SSIM — the
      whole v2 fast-path regression; fractional recovers it exactly (the
      16-px block subsample itself costs +0.01 dB).  The fractional warp
      is speed-neutral (memory-bound; the lerp is hidden).
    """
    if is_v3(params):
        return interpolate_fast3(params, prev, curr, t, grid, max_flow,
                                 dtype, integer_flow)
    if is_v2(params):
        return interpolate_fast2(params, prev, curr, t, grid, max_flow,
                                 dtype, integer_flow)
    if integer_flow is None:
        integer_flow = True
    if grid != 4 * SCALE:
        raise ValueError(f"interpolate_fast expects grid == {4 * SCALE}")
    out = _trunk_raw(params, prev[None], curr[None], dtype=dtype)[0]
    return _fast_tail(out, prev, curr, t, grid, max_flow, dtype,
                      integer_flow)


def _fast_tail(out, prev, curr, t, grid, max_flow, dtype, integer_flow):
    """One-time-point wrapper over :func:`_fast_tails`."""
    return _fast_tails(out, prev, curr, (t,), grid, max_flow, dtype,
                       integer_flow)[0]


def _fast_tails(out, prev, curr, ts, grid, max_flow, dtype, integer_flow):
    """Shared inference tail: head output [5, H/4, W/4] (flows in 1/4-res
    units + mask logit) -> fused frame via the lattice flow sample and the
    production one-hot warp (see interpolate_fast's docstring for the
    closed-form lattice derivation and the integer_flow trade).

    Takes SEVERAL time points at once (the engine's --fps-multiplier k
    emits k-1 in-betweens per pair): the lattice sample, the mask
    upsample, and the warp's banded frame representation
    (warp_single_prepare) are t-independent, so they are computed once
    and only the t-scaled flows, the banded warps, and the fusion run
    per time point.  XLA may CSE identical per-t prep subgraphs on its
    own; the explicit split makes the sharing deterministic instead of an
    optimizer courtesy; the
    per-t remainder is genuine work (distinct t-scaled flows need
    distinct one-hot warps).  Bitwise-identical per time point to the
    one-t form (the split warp halves are the same ops in the same
    order; pinned by TestTailsFast and an engine-level pre/post
    comparison)."""
    from tpufg.kernels.warp_matmul import (warp_single_banded,
                                           warp_single_prepare)

    if grid != 4 * SCALE:
        raise ValueError(f"interpolate_fast expects grid == {4 * SCALE}")
    hq, wq = out.shape[1:]
    nh, nw = hq // 4, wq // 4
    # closed-form lattice sample: the old path bilinearly upsampled the
    # head output to FULL resolution (5ch) then subsampled
    # at block centers.  Block-center row r = grid/2 + grid*k maps to
    # head coords (r+0.5)/SCALE - 0.5 = 1.625 + 4k — constant fraction
    # 0.625 between head rows 1+4k and 2+4k — so the lattice IS two
    # strided slices with fixed weights (same math, none of the full-res
    # traffic); only the per-pixel mask still upsamples (1ch).
    ry = (out[:, 1::4, :][:, :nh] * F32(0.375)
          + out[:, 2::4, :][:, :nh] * F32(0.625))
    lat = (ry[:, :, 1::4][:, :, :nw] * F32(0.375)
           + ry[:, :, 2::4][:, :, :nw] * F32(0.625))
    # mask upsample as a banded matmul pair (a separable bilinear upsample
    # IS two banded matmuls): same math as jax.image.resize to f32
    # rounding (5e-7 on N(0,1) logits); the bf16 production path runs the
    # pair at DEFAULT precision (~1e-2 on a sigmoid logit at worst —
    # metric-immaterial)
    prec = (jax.lax.Precision.HIGHEST if dtype == jnp.float32
            else jax.lax.Precision.DEFAULT)
    R = jnp.asarray(_band_mat(hq * SCALE, hq))
    C = jnp.asarray(_band_mat(wq * SCALE, wq))
    t_m = jnp.einsum("rh,hw->rw", R, out[4], precision=prec,
                     preferred_element_type=F32)
    mask_logit = jnp.einsum("rw,xw->rx", t_m, C, precision=prec,
                            preferred_element_type=F32)
    mask = jax.nn.sigmoid(mask_logit)[None]               # [1, H, W]

    # t-independent banded warp prep, once per side.  Columns edge-pad to
    # the warp's 128 tiling here (exactly what warp_blend_matmul does
    # internally) so the prep covers every time point.
    _, h, w = prev.shape
    wp128 = -(-w // 128) * 128
    if wp128 != w:
        cw = ((0, 0), (0, 0), (0, wp128 - w))
        prev = jnp.pad(prev, cw, mode="edge")
        curr = jnp.pad(curr, cw, mode="edge")
    kw = dict(block=grid, search_radius=max_flow, dtype=dtype,
              integer_offsets=integer_flow, u8_exact=integer_flow)
    bp = warp_single_prepare(prev, **kw)
    bc = warp_single_prepare(curr, **kw)

    fused = []
    for t in ts:
        # per-side t-scaling of the midpoint-trained flows
        # (_flow_t_scales: exact no-op at t=0.5, the k>2 fix for the
        # r4d2 multi-rate deficit)
        sp, sc = _flow_t_scales(t)
        fp = lat[0:2] * F32(SCALE * sp)
        fc = lat[2:4] * F32(SCALE * sc)
        if integer_flow:
            fp = jnp.round(fp)
            fc = jnp.round(fc)
        if wp128 != w:
            cb = ((0, 0), (0, 0), (0, (wp128 - w) // grid))
            fp = jnp.pad(fp, cb, mode="edge")
            fc = jnp.pad(fc, cb, mode="edge")
        warped_p = warp_single_banded(bp, fp, **kw)[:, :, :w]
        warped_c = warp_single_banded(bc, fc, **kw)[:, :, :w]
        fused.append(_fuse(warped_p, warped_c, mask, t))
    return fused


# ---------------------------------------------------------------------------
# v2: two-stage coarse-to-fine IFNet (round 4).
#
# The r3 plateau record (docs/DESIGN.md 5b: L1 flat at ~0.044 across lr/
# width sweeps) pinned the single-stage 1/4-res flow as the limiter, naming
# the pyramidal IFNet as the known fix.  v2 is the smallest such network:
#
#   stage 1 @ 1/8: enc3(s2) -> body -> head0: coarse flow + mask
#   stage 2 @ 1/4: warp the 1/4-res frames by the upsampled coarse flow,
#                  then predict RESIDUAL flow + mask from
#                  [pair features, warped frames, coarse flow, mask logit]
#
# Same scheme as RIFE's IFBlock cascade (coarse flow, warp, refine), sized
# to keep 4K inference cheap: stage 2 replaces v1's
# 1/4-res body convs rather than adding to them, and stage 1 runs at 1/8
# (a quarter of the 1/4-res cost per conv).
# ---------------------------------------------------------------------------

def init_params2(key: jax.Array, hidden: int = HIDDEN) -> dict:
    """Two-stage parameters; same {name: {w, b}} OIHW layout as v1."""
    def he(k, shape):
        fan_in = int(np.prod(shape[1:]))
        return jax.random.normal(k, shape, F32) * np.sqrt(2.0 / fan_in)

    ks = jax.random.split(key, 8)
    h = hidden
    return {
        # shared encoder (pair-joint, as v1): 1/2 then 1/4
        "enc1": {"w": he(ks[0], (h // 2, 8, 3, 3)), "b": jnp.zeros((h // 2,), F32)},
        "enc2": {"w": he(ks[1], (h, h // 2, 3, 3)), "b": jnp.zeros((h,), F32)},
        # stage 1 (coarse, 1/8)
        "enc3": {"w": he(ks[2], (h, h, 3, 3)), "b": jnp.zeros((h,), F32)},
        "c_body": {"w": he(ks[3], (h, h, 3, 3)), "b": jnp.zeros((h,), F32)},
        # flow heads are ZERO-initialized (RIFE practice): training starts
        # from zero flow / mask 0.5.  He-init heads emit large random
        # flows, and a bilinear warp's flow gradient is the LOCAL image
        # gradient — with random large flows it is noise, and the loss
        # sits flat at the blend floor (observed: 2000 steps, no movement)
        "c_head": {"w": jnp.zeros((5, h, 3, 3), F32), "b": jnp.zeros((5,), F32)},
        # stage 2 (refine, 1/4): input = F4 (h) + warped p4/c4 (8) +
        # coarse flow (4, 1/4-res units) + coarse mask logit (1)
        "r_in": {"w": he(ks[5], (h, h + 13, 3, 3)), "b": jnp.zeros((h,), F32)},
        "r_body": {"w": he(ks[6], (h, h, 3, 3)), "b": jnp.zeros((h,), F32)},
        "r_head": {"w": jnp.zeros((5, h, 3, 3), F32), "b": jnp.zeros((5,), F32)},
    }


def is_v2(params: dict) -> bool:
    # two-stage with the pair-joint (8-channel) encoder; the streaming
    # v3 shares the layer names but encodes per-frame (4 channels)
    return "enc3" in params and params["enc1"]["w"].shape[1] == 8


def _down2_mean(x: jax.Array) -> jax.Array:
    """2x2 box downsample of [B, C, H, W] (exact mean)."""
    b, c, h, w = x.shape
    return x.reshape(b, c, h // 2, 2, w // 2, 2).mean((3, 5))


def _down4_mean(x: jax.Array) -> jax.Array:
    """4x4 box downsample of [B, C, H, W] — the v2 stage-2 frame feed.

    Same mean as two chained :func:`_down2_mean` up to f32 re-association
    (max |d| 3e-5 on 0..255 frames), lowered as ONE reduce_window.
    reduce_window-with-add is linear, so the training path (which shares
    this helper via _head2_raw) keeps exact gradients."""
    return lax.reduce_window(x, 0.0, lax.add, (1, 1, 4, 4), (1, 1, 4, 4),
                             "VALID") * F32(1.0 / 16.0)


def _up2(out: jax.Array) -> jax.Array:
    """Head output [B, 5, h, w] -> [B, 5, 2h, 2w]; flow VALUES double with
    resolution, the mask logit does not."""
    b, _, h, w = out.shape
    up = jax.image.resize(out, (b, 5, 2 * h, 2 * w), "bilinear")
    return up * jnp.array([2, 2, 2, 2, 1], F32)[None, :, None, None]


def _head2_raw(params: dict, prev: jax.Array, curr: jax.Array, dtype=F32,
               fast: bool = False, ft: bool = False, p4=None, c4=None):
    """Two-stage trunk: frame pair -> refined head output
    [B, 5, H/4, W/4] (flows in 1/4-res pixel units + mask logit) plus the
    coarse stage-1 output [B, 5, H/8, W/8] for auxiliary supervision.

    ``p4``/``c4``: optional precomputed quarter-res frames
    [B, C, H/4, W/4] f32 (the stage-2 warp inputs).  The streaming
    engine downsamples each frame ONCE and threads the result between
    steps (prev's quarter == last step's curr quarter, see
    _down4_mean); identical
    output by construction (same function, same input).

    ``ft`` (fast-consistent training): the stage-2 coarse warp runs the
    differentiable replica of the INFERENCE coarse warp (4-px lattice,
    straight-through integer flows, clamp +-4) instead of the smooth
    per-pixel bilinear warp — the residual head then trains on the same
    blocky coarse warps it refines in production.
    """
    x = jnp.concatenate([prev, curr], axis=1).astype(F32)
    h1 = jax.nn.relu(_conv(x, params["enc1"]["w"], params["enc1"]["b"],
                           2, dtype))
    f4 = jax.nn.relu(_conv(h1, params["enc2"]["w"], params["enc2"]["b"], 2,
                           dtype))
    # stage 1 @ 1/8
    f8 = jax.nn.relu(_conv(f4, params["enc3"]["w"], params["enc3"]["b"], 2,
                           dtype))
    g = jax.nn.relu(_conv(f8, params["c_body"]["w"], params["c_body"]["b"],
                          1, dtype))
    out0 = _conv(g, params["c_head"]["w"], params["c_head"]["b"])
    # stage 2 @ 1/4: warp the quarter-res frames by the coarse flow and
    # refine the residual.
    out0_4 = _up2(out0)
    if p4 is None:
        p4 = _down4_mean(prev.astype(F32))
    if c4 is None:
        c4 = _down4_mean(curr.astype(F32))
    if fast:
        # inference: the coarse warp uses the production one-hot block
        # warp on a 4-px lattice of the 1/4 frame (= the same 16-px
        # full-res block granularity as the final warp), integer flows.
        # Stage 2's residual head absorbs the quantization — it sees
        # blockier coarse warps than in training, but its JOB is
        # correcting coarse-warp error.
        from tpufg.kernels.warp_matmul import warp_blend_matmul
        lat = out0_4[0, :, 2::4, 2::4]              # [5, H/16, W/16]
        fp4 = jnp.round(lat[0:2])
        fc4 = jnp.round(lat[2:4])
        kw = dict(single=True, block=4, search_radius=4, dtype=dtype,
                  integer_offsets=True)
        p4w = warp_blend_matmul(p4[0], p4[0], fp4, **kw)[None]
        c4w = warp_blend_matmul(c4[0], c4[0], fc4, **kw)[None]
    elif ft:
        # differentiable replica of the fast branch above: same 4-px
        # lattice sample, straight-through round, the warp's +-4 clamp
        lat0 = out0_4[:, :, 2::4, 2::4]
        p4w = bilinear_warp(p4, _block_flow(lat0[:, 0:2], 4.0, 4))
        c4w = bilinear_warp(c4, _block_flow(lat0[:, 2:4], 4.0, 4))
    else:
        p4w = bilinear_warp(p4, out0_4[:, 0:2])
        c4w = bilinear_warp(c4, out0_4[:, 2:4])
    r = jnp.concatenate([f4, p4w, c4w, out0_4], axis=1)
    r = jax.nn.relu(_conv(r, params["r_in"]["w"], params["r_in"]["b"], 1,
                          dtype))
    r = jax.nn.relu(_conv(r, params["r_body"]["w"], params["r_body"]["b"],
                          1, dtype))
    res = _conv(r, params["r_head"]["w"], params["r_head"]["b"])
    return out0_4 + res, out0


def forward2(params: dict, prev: jax.Array, curr: jax.Array,
             t: float = 0.5, with_aux: bool = False, ft: bool = False):
    """v2 training path: predict the frame at time t (H, W divisible by 8;
    by 16 with ``ft``).

    ``with_aux``: also return the coarse stage-1 prediction at 1/8
    resolution (per-stage supervision, RIFE-style).

    ``ft``: fast-consistent training — the stage-2 coarse warp AND the
    final tail run differentiable replicas of the inference path (see
    :func:`_ft_tail`); the aux stage-1 supervision stays smooth (its job
    is keeping the coarse flow meaningful, not matching inference)."""
    out1, out0 = _head2_raw(params, prev, curr, ft=ft)
    if ft:
        # fractional replica: v2's deployed tail keeps real-valued flows
        pred = _ft_tail(out1, prev, curr, t, integer_flow=False)
    else:
        pred = _smooth_tail(out1, prev, curr, t)
    if not with_aux:
        return pred
    # coarse prediction AT 1/8 scale: warp the 1/8 frames by the coarse
    # flow directly (flows are already in 1/8-res units)
    p8 = _down2_mean(_down2_mean(_down2_mean(prev.astype(F32))))
    c8 = _down2_mean(_down2_mean(_down2_mean(curr.astype(F32))))
    f8p, f8c = out0[:, 0:2], out0[:, 2:4]
    if not _is_midpoint(t):  # coarse flows are midpoint motions too
        sp, sc = _flow_t_scales(t)
        f8p, f8c = _scale_flow(f8p, 1.0, sp), _scale_flow(f8c, 1.0, sc)
    w_p8 = bilinear_warp(p8, f8p)
    w_c8 = bilinear_warp(c8, f8c)
    pred8 = _fuse(w_p8, w_c8, jax.nn.sigmoid(out0[:, 4:5]), t)
    return pred, pred8


def _two_stage_loss(head_fn, params, prev, curr, target, t, aux_weight,
                    ft=False, sup=None, flow_weight=0.1, mask_weight=0.02):
    """Shared v2/v3 two-stage loss (both heads return (out1 at 1/4,
    out0 at 1/8) with identical channel semantics, so the loss math is
    one function of the trunk): L1 on the refined prediction + weighted
    L1 on the coarse stage warped at 1/8 scale.  ``ft`` runs the
    inference-replica trunk + tail (see loss_fn2/loss_fn3).  With
    ``sup``, adds the analytic flow/mask supervision of BOTH stages and
    returns (loss, (photo, l_flow)) — the v2f recipe."""
    out1, out0 = head_fn(params, prev, curr, ft=ft)
    if ft:
        # fractional replica: the deployed tail keeps real-valued flows
        pred = _ft_tail(out1, prev, curr, t, integer_flow=False)
    else:
        pred = _smooth_tail(out1, prev, curr, t)
    p8 = _down2_mean(_down2_mean(_down2_mean(prev.astype(F32))))
    c8 = _down2_mean(_down2_mean(_down2_mean(curr.astype(F32))))
    f8p, f8c = out0[:, 0:2], out0[:, 2:4]
    if not _is_midpoint(t):  # multi-t: coarse flows are midpoint motions
        sp8, sc8 = _flow_t_scales(t)
        f8p, f8c = _scale_flow(f8p, 1.0, sp8), _scale_flow(f8c, 1.0, sc8)
    pred8 = _fuse(bilinear_warp(p8, f8p),
                  bilinear_warp(c8, f8c),
                  jax.nn.sigmoid(out0[:, 4:5]), t)
    t8 = _down2_mean(_down2_mean(_down2_mean(target.astype(F32))))
    photo = (jnp.mean(jnp.abs(pred - target.astype(F32)))
             + F32(aux_weight) * jnp.mean(jnp.abs(pred8 - t8)))
    if sup is None:
        return photo
    f1, m1 = _flow_sup_terms(out1, sup["flow4"], sup["vp4"], sup["vc4"])
    f0, m0 = _flow_sup_terms(out0, sup["flow8"], sup["vp8"], sup["vc8"])
    l_flow = f1 + F32(aux_weight) * f0
    l_mask = m1 + F32(aux_weight) * m0
    return (photo + F32(flow_weight) * l_flow
            + F32(mask_weight) * l_mask), (photo, l_flow)


def loss_fn2(params, prev, curr, target, t: float = 0.5,
             aux_weight: float = 0.3, ft: bool = False):
    """L1 on the refined prediction + weighted L1 on the coarse stage at
    1/8 scale (per-stage supervision keeps stage 1 from collapsing to
    zero flow and letting stage 2 do all the work beyond its reach)."""
    return _two_stage_loss(_head2_raw, params, prev, curr, target, t,
                           aux_weight, ft=ft)


# ---------------------------------------------------------------------------
# v3: streaming two-stage IFNet.  Same coarse-to-fine scheme as v2 with
# three changes that cut the 4K->4K inference step:
#
#   - SIAMESE per-frame encoder (enc1 4ch->h/2 @1/2, enc2 h/2->h/2 @1/4):
#     the streaming engine threads curr's features between steps exactly
#     like the v2 quarter cache, so each frame is encoded ONCE per stream
#     instead of once per pair (a pair-joint encoder runs twice per frame).
#   - stage 2 consumes [warped quarter frames, coarse flow, mask] only
#     (13 ch — vanilla RIFE IFBlock inputs) instead of 77 with pair
#     features (the r_in conv is the fattest in the trunk).
#   - the coarse warp runs at 8-px blocks on the quarter frame (32-px
#     full-res granularity; stage 2's job is refining it anyway).
#
# Stage 1 is unchanged (coarse flow at 1/8 from the concatenated
# per-frame features); the inference tail is v1/v2's (fractional flows).
# ---------------------------------------------------------------------------


def init_params3(key: jax.Array, hidden: int = HIDDEN,
                 stage2_diff: bool = False,
                 coarse_body2: bool = False) -> dict:
    """Streaming two-stage parameters; same {name: {w, b}} layout.

    ``stage2_diff`` ("v3d", round 5 — the capacity
    probe inside v3's device headroom): stage 2 additionally sees the
    SIGNED WARPED DIFFERENCE p4w - c4w (4 ch), the cheapest pair-
    interaction signal available at 1/4 res — where the warped frames
    agree it is ~0, where the coarse flow errs it localizes the error —
    so r_in widens 13 -> 17 input channels.  The only extra device cost
    is that fatter first conv (the subtraction fuses); everything else
    (siamese encoder, stream cache, tail) is unchanged.

    ``coarse_body2`` ("v3c", round 5 — the second headroom probe): a
    RESIDUAL second body conv in the coarse stage,
    ``g = g + gelu(conv(g))``, zero-initialized so the expanded head is
    bit-identical to its seed at step 0 (gelu(0) = 0; gelu rather than
    relu so the zero-init branch still receives gradient — see
    _head3_raw).  Runs at 1/8 res — a quarter of stage 2's pixels —
    and deepens exactly the stage whose flow quality
    bounds everything downstream.  Composable with ``stage2_diff``
    ("v3dc")."""
    def he(k, shape):
        fan_in = int(np.prod(shape[1:]))
        return jax.random.normal(k, shape, F32) * np.sqrt(2.0 / fan_in)

    ks = jax.random.split(key, 8)
    h = hidden
    r_in_ch = 17 if stage2_diff else 13
    extra = {}
    if coarse_body2:
        extra["c_body2"] = {"w": jnp.zeros((h, h, 3, 3), F32),
                            "b": jnp.zeros((h,), F32)}
    return extra | {
        # per-frame encoder (4 input ch): 1/2 then 1/4
        "enc1": {"w": he(ks[0], (h // 2, 4, 3, 3)),
                 "b": jnp.zeros((h // 2,), F32)},
        "enc2": {"w": he(ks[1], (h // 2, h // 2, 3, 3)),
                 "b": jnp.zeros((h // 2,), F32)},
        # stage 1 (coarse, 1/8): input = concat of both frames' features
        "enc3": {"w": he(ks[2], (h, h, 3, 3)), "b": jnp.zeros((h,), F32)},
        "c_body": {"w": he(ks[3], (h, h, 3, 3)), "b": jnp.zeros((h,), F32)},
        "c_head": {"w": jnp.zeros((5, h, 3, 3), F32),
                   "b": jnp.zeros((5,), F32)},
        # stage 2 (refine, 1/4): input = warped p4/c4 (8) + coarse flow
        # (4) + coarse mask logit (1) — the vanilla RIFE IFBlock feed —
        # (+ the signed warped difference (4) on the v3d variant)
        "r_in": {"w": he(ks[5], (h, r_in_ch, 3, 3)),
                 "b": jnp.zeros((h,), F32)},
        "r_body": {"w": he(ks[6], (h, h, 3, 3)), "b": jnp.zeros((h,), F32)},
        "r_head": {"w": jnp.zeros((5, h, 3, 3), F32),
                   "b": jnp.zeros((5,), F32)},
    }


def bundled_checkpoint() -> Optional[str]:
    """Path of the newest bundled default head, or None.

    One place decides the precedence (newest first), so the CLI and the
    eval/profile tools cannot disagree about what "the bundled default"
    means.  head64_v4 is the round-5 photometrically-hardened v3d head;
    head64_v3 remains bundled for reproduction of the r4 tables."""
    import os
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for name in ("head64_v4.npz", "head64_v3.npz", "head64_v2.npz",
                 "head64.npz"):
        p = os.path.join(root, "checkpoints", name)
        if os.path.exists(p):
            return p
    return None


def has_stage2_diff(params: dict) -> bool:
    """v3d discriminator: stage 2 consumes the warped-difference input."""
    return is_v3(params) and params["r_in"]["w"].shape[1] == 17


def has_coarse_body2(params: dict) -> bool:
    """v3c discriminator: residual second coarse-body conv present."""
    return is_v3(params) and "c_body2" in params


def expand_v3_coarse_body2(params: dict) -> dict:
    """Add a ZERO-initialized residual c_body2 to a v3/v3d head: the
    expanded head computes bit-identical outputs to the original until
    training moves the new layer (g + gelu(0) = g; gelu so the branch
    still receives gradient, see _head3_raw) — the same no-quality-cliff
    warm start as expand_v3_stage2_diff, with which it composes."""
    if has_coarse_body2(params):
        return params
    if not is_v3(params):
        raise ValueError("expand_v3_coarse_body2 needs a v3 head")
    h = params["c_body"]["w"].shape[0]
    out = dict(params)
    out["c_body2"] = {"w": jnp.zeros((h, h, 3, 3), F32),
                      "b": jnp.zeros((h,), F32)}
    return out


def expand_v3_stage2_diff(params: dict) -> dict:
    """Zero-pad a v3 head's r_in to the v3d 17-channel input: the new
    difference channels start at weight 0, so the expanded head computes
    BIT-IDENTICAL outputs to the original until training moves them —
    the exact warm-start the capacity probe wants (no quality cliff at
    step 0)."""
    if has_stage2_diff(params):
        return params
    if not is_v3(params):
        raise ValueError("expand_v3_stage2_diff needs a v3 head")
    w = params["r_in"]["w"]
    out = dict(params)
    out["r_in"] = {"w": jnp.pad(w, ((0, 0), (0, 4), (0, 0), (0, 0))),
                   "b": params["r_in"]["b"]}
    return out


def is_v3(params: dict) -> bool:
    # v3 shares v2's layer names; the per-frame encoder's 4 input
    # channels (vs the pair-joint 8) is the discriminator
    return "enc3" in params and params["enc1"]["w"].shape[1] == 4


def encode3(params: dict, frame: jax.Array, dtype=F32) -> jax.Array:
    """Per-frame feature encoder: [B, 4, H, W] -> [B, h/2, H/4, W/4].
    The streaming engine calls this once per FRAME and threads the
    result between steps (prev's features == last step's curr's)."""
    h1 = jax.nn.relu(_conv(frame.astype(F32), params["enc1"]["w"],
                           params["enc1"]["b"], 2, dtype))
    return jax.nn.relu(_conv(h1, params["enc2"]["w"], params["enc2"]["b"],
                             2, dtype))


def _coarse_warp8(out0_4, p4, c4, dtype):
    """Inference coarse warp at 8-px blocks on the quarter frames
    (integer flows, clamp +-4 via the warp kernel).  1/4-res extents are
    not always 8-multiples (4K height -> 540; a 720- or 1360-px-wide
    stream -> quarter width % 8 == 4): pad frame rows AND columns plus
    the flow lattice to the block grid, crop after."""
    from tpufg.kernels.warp_matmul import warp_blend_matmul
    lat = out0_4[0, :, 4::8, 4::8]
    fp4 = jnp.round(lat[0:2])
    fc4 = jnp.round(lat[2:4])
    hq, wq = p4.shape[2], p4.shape[3]
    hpad, wpad = (-hq) % 8, (-wq) % 8
    p4b, c4b = p4, c4
    if hpad or wpad:
        pads = ((0, 0), (0, 0), (0, hpad), (0, wpad))
        p4b = jnp.pad(p4, pads, mode="edge")
        c4b = jnp.pad(c4, pads, mode="edge")
    rpad = (hq + hpad) // 8 - fp4.shape[1]
    cpad = (wq + wpad) // 8 - fp4.shape[2]
    if rpad or cpad:
        pads = ((0, 0), (0, rpad), (0, cpad))
        fp4 = jnp.pad(fp4, pads, mode="edge")
        fc4 = jnp.pad(fc4, pads, mode="edge")
    kw = dict(single=True, block=8, search_radius=4, dtype=dtype,
              integer_offsets=True)
    p4w = warp_blend_matmul(p4b[0], p4b[0], fp4, **kw)[None, :, :hq, :wq]
    c4w = warp_blend_matmul(c4b[0], c4b[0], fc4, **kw)[None, :, :hq, :wq]
    return p4w, c4w


def _head3_raw(params: dict, prev: jax.Array, curr: jax.Array, dtype=F32,
               fast: bool = False, ft: bool = False,
               p4=None, c4=None, f4p=None, f4c=None):
    """v3 trunk: frame pair -> (refined head output [B, 5, H/4, W/4],
    coarse stage-1 output [B, 5, H/8, W/8]).

    ``p4``/``c4``: precomputed quarter frames; ``f4p``/``f4c``:
    precomputed per-frame encoder features — the engine threads BOTH for
    prev (each frame is downsampled and encoded once per stream).

    ``ft`` (fast-consistent training): the stage-2 coarse warp runs the
    differentiable replica of the INFERENCE coarse warp (_coarse_warp8's
    8-px lattice, straight-through integer flows, clamp +-4) instead of
    the smooth per-pixel bilinear warp — quarter dims must then be
    8-multiples (crop divisible by 32)."""
    if f4p is None:
        f4p = encode3(params, prev, dtype)
    if f4c is None:
        f4c = encode3(params, curr, dtype)
    f4 = jnp.concatenate([f4p, f4c], axis=1)
    f8 = jax.nn.relu(_conv(f4, params["enc3"]["w"], params["enc3"]["b"], 2,
                           dtype))
    g = jax.nn.relu(_conv(f8, params["c_body"]["w"], params["c_body"]["b"],
                          1, dtype))
    if "c_body2" in params:
        # v3c: residual second coarse-body conv (zero-init = identity at
        # warm start; 1/8-res, so ~1/4 of a stage-2 conv's cost).  GELU,
        # not relu: gelu(0) = 0 keeps the zero-init bitwise-identity,
        # while gelu'(0) = 0.5 lets gradients reach the new layer —
        # relu'(0) = 0 would leave a zero-init relu branch permanently
        # dead (caught by test_training_v3c_moves_new_layer).
        g = g + jax.nn.gelu(_conv(g, params["c_body2"]["w"],
                                  params["c_body2"]["b"], 1, dtype))
    out0 = _conv(g, params["c_head"]["w"], params["c_head"]["b"])
    out0_4 = _up2(out0)
    if p4 is None:
        p4 = _down4_mean(prev.astype(F32))
    if c4 is None:
        c4 = _down4_mean(curr.astype(F32))
    if fast:
        p4w, c4w = _coarse_warp8(out0_4, p4, c4, dtype)
    elif ft:
        # differentiable replica of _coarse_warp8: same 8-px lattice
        # sample, straight-through round, the warp's +-4 clamp
        lat0 = out0_4[:, :, 4::8, 4::8]
        p4w = bilinear_warp(p4, _block_flow(lat0[:, 0:2], 4.0, 8))
        c4w = bilinear_warp(c4, _block_flow(lat0[:, 2:4], 4.0, 8))
    else:
        p4w = bilinear_warp(p4, out0_4[:, 0:2])
        c4w = bilinear_warp(c4, out0_4[:, 2:4])
    parts = [p4w, c4w, out0_4]
    if params["r_in"]["w"].shape[1] == 17:
        # v3d: the signed warped difference — the cheap pair-interaction
        # input (fuses into the r_in conv's producer; see init_params3)
        parts.append(p4w - c4w)
    r = jnp.concatenate(parts, axis=1)
    r = jax.nn.relu(_conv(r, params["r_in"]["w"], params["r_in"]["b"], 1,
                          dtype))
    r = jax.nn.relu(_conv(r, params["r_body"]["w"], params["r_body"]["b"],
                          1, dtype))
    res = _conv(r, params["r_head"]["w"], params["r_head"]["b"])
    return out0_4 + res, out0


def loss_fn3_sup(params, prev, curr, target, sup, t: float = 0.5,
                 aux_weight: float = 0.3, flow_weight: float = 0.1,
                 mask_weight: float = 0.02):
    """v3 photometric (+1/8 aux) + analytic-flow supervision — the v2f
    recipe (loss_fn2_sup) on the v3 trunk."""
    return _two_stage_loss(_head3_raw, params, prev, curr, target, t,
                           aux_weight, sup=sup, flow_weight=flow_weight,
                           mask_weight=mask_weight)


def loss_fn3(params, prev, curr, target, t: float = 0.5,
             aux_weight: float = 0.3, ft: bool = False):
    """v3 photometric loss (smooth tail + 1/8 aux); ``ft`` runs the
    fractional inference-tail replica like loss_fn2 — INCLUDING the
    stage-2 8-px coarse-warp replica in the trunk (the aux stage-1
    supervision stays smooth; its job is flow accuracy, not
    warp-granularity robustness)."""
    return _two_stage_loss(_head3_raw, params, prev, curr, target, t,
                           aux_weight, ft=ft)


def interpolate_fast3(params: dict, prev: jax.Array, curr: jax.Array,
                      t: float = 0.5, grid: int = 16,
                      max_flow: int = 8, dtype=jnp.bfloat16,
                      integer_flow: bool | None = None,
                      p4=None, c4=None, f4p=None, f4c=None) -> jax.Array:
    """v3 inference: streaming trunk + the v1/v2 tail (fractional flows
    by default, as v2 — the two-stage head learns real sub-pixel flows).

    ``p4``/``c4``/``f4p``/``f4c``: the engine's per-frame stream cache
    ([C, H/4, W/4] quarter frame and [h/2, H/4, W/4] features)."""
    if integer_flow is None:
        integer_flow = False
    out1, _ = _head3_raw(params, prev[None], curr[None], dtype=dtype,
                         fast=True,
                         p4=None if p4 is None else p4[None],
                         c4=None if c4 is None else c4[None],
                         f4p=None if f4p is None else f4p[None],
                         f4c=None if f4c is None else f4c[None])
    return _fast_tail(out1[0], prev, curr, t, grid, max_flow, dtype,
                      integer_flow)


def trunk_fast(params: dict, prev: jax.Array, curr: jax.Array,
               dtype=jnp.bfloat16, p4=None, c4=None, f4p=None, f4c=None):
    """t-INDEPENDENT inference trunk output [5, H/4, W/4] (any arch).

    The learned heads' flows/mask depend only on the frame pair — the
    tail scales the midpoint-trained flows per side (_flow_t_scales) and
    fuses with t-biased weights — so a k-fps-multiplying engine step
    computes the trunk ONCE per pair and runs only the tail per time
    point (k-1 tails instead of k-1 full heads; relying on XLA CSE to
    merge k-1 structurally identical trunks is not a contract).

    ``p4``/``c4``/``f4p``/``f4c``: the engine's per-frame stream cache
    (v2 uses the quarter frames; v3 also the encoder features)."""
    if is_v3(params):
        out1, _ = _head3_raw(params, prev[None], curr[None], dtype=dtype,
                             fast=True,
                             p4=None if p4 is None else p4[None],
                             c4=None if c4 is None else c4[None],
                             f4p=None if f4p is None else f4p[None],
                             f4c=None if f4c is None else f4c[None])
        return out1[0]
    if is_v2(params):
        out1, _ = _head2_raw(params, prev[None], curr[None], dtype=dtype,
                             fast=True,
                             p4=None if p4 is None else p4[None],
                             c4=None if c4 is None else c4[None])
        return out1[0]
    return _trunk_raw(params, prev[None], curr[None], dtype=dtype)[0]


def tail_fast(params: dict, out, prev: jax.Array, curr: jax.Array,
              t: float = 0.5, grid: int = 16, max_flow: int = 8,
              dtype=jnp.bfloat16,
              integer_flow: bool | None = None) -> jax.Array:
    """The per-time-point tail on a precomputed trunk output (see
    trunk_fast).  tail_fast(params, trunk_fast(params, p, c), p, c, t)
    == interpolate_fast(params, p, c, t) exactly — same ops, same
    per-arch integer_flow default (v1 True, v2/v3 False; the rationale
    tables live on interpolate_fast)."""
    if integer_flow is None:
        integer_flow = not (is_v2(params) or is_v3(params))
    return _fast_tail(out, prev, curr, t, grid, max_flow, dtype,
                      integer_flow)


def tails_fast(params: dict, out, prev: jax.Array, curr: jax.Array,
               ts, grid: int = 16, max_flow: int = 8,
               dtype=jnp.bfloat16,
               integer_flow: bool | None = None) -> list[jax.Array]:
    """All of a step's time points in one call: bitwise-identical to
    ``[tail_fast(params, out, prev, curr, t) for t in ts]`` with the
    t-independent work (lattice sample, mask upsample, the warp's banded
    frame prep) shared by construction instead of by XLA CSE (see
    _fast_tails — this is structure, not speed).
    The engine's --fps-multiplier k step is the caller."""
    if integer_flow is None:
        integer_flow = not (is_v2(params) or is_v3(params))
    return _fast_tails(out, prev, curr, tuple(ts), grid, max_flow, dtype,
                       integer_flow)


def param_shardings3(mesh: Mesh, coarse_body2: bool = False) -> dict:
    """v3 tensor-parallel layout — identical to v2's (the two trunks
    share the 8-layer {enc1..3, c_body/c_head, r_in/r_body/r_head}
    layout; one table keeps them in sync).  ``coarse_body2`` adds the
    v3c residual layer, sharded like c_body (hidden over 'tp')."""
    table = param_shardings2(mesh)
    if coarse_body2:
        table = dict(table)
        table["c_body2"] = table["c_body"]
    return table


# ---------------------------------------------------------------------------
# Analytic supervision (round 4): the procedural corpus knows the exact
# per-pixel flow between any two times of a shot (every layer is a closed-
# form rigid motion — tpufg/data/corpus.py), so the trainer can supervise
# the flow heads DIRECTLY instead of only through the photometric loss.
# This is RIFE's privileged-teacher distillation with the renderer itself
# as the teacher; measured motivation: photometric-only training plateaus
# ~5 dB below the deployed tail's oracle-flow ceiling (40.8 dB on the rich
# eval corpus — .data/diag_oracle_tail.py / docs/DESIGN.md 5b r4).
# ---------------------------------------------------------------------------

def _flow_sup_terms(out, flow_t, vp, vc):
    """Supervision of one raw head output against analytic targets.

    ``out``: [B, 5, h, w] (4 flow channels in the head's res units + mask
    logit); ``flow_t``: [B, 4, h, w] analytic (dxp, dyp, dxc, dyc);
    ``vp``/``vc``: [B, 1, h, w] per-side validity in {0, 1} (a side's flow
    is only defined where the content is visible in that frame).

    Returns (l_flow, l_mask): masked L1 endpoint error, and BCE on the
    occlusion logit where exactly ONE side is valid (there the fusion
    answer is known: _fuse weights prev by sigmoid(logit), so the target
    is 1 where only prev sees the content, 0 where only curr does;
    where both or neither see it the logit is left to the photometric
    loss)."""
    l_flow = (jnp.sum(jnp.abs(out[:, 0:2] - flow_t[:, 0:2]) * vp)
              / (2.0 * jnp.sum(vp) + 1.0)
              + jnp.sum(jnp.abs(out[:, 2:4] - flow_t[:, 2:4]) * vc)
              / (2.0 * jnp.sum(vc) + 1.0))
    xor = vp * (1.0 - vc) + vc * (1.0 - vp)
    tgt = vp * (1.0 - vc)
    logit = out[:, 4:5]
    bce = (jnp.maximum(logit, 0.0) - logit * tgt
           + jnp.log1p(jnp.exp(-jnp.abs(logit))))
    l_mask = jnp.sum(bce * xor) / (jnp.sum(xor) + 1.0)
    return l_flow, l_mask


def loss_fn_sup(params, prev, curr, target, sup, t: float = 0.5,
                flow_weight: float = 0.1, mask_weight: float = 0.02):
    """v1 photometric + analytic-flow supervision.  ``sup``: dict with
    flow4 [B,4,H/4,W/4] (quarter-res units), vp4/vc4 [B,1,H/4,W/4]
    (tpufg.data.corpus.synthetic_triplets layout)."""
    out = _trunk_raw(params, prev, curr)
    pred = _smooth_tail(out, prev, curr, t)
    photo = jnp.mean(jnp.abs(pred - target.astype(F32)))
    l_flow, l_mask = _flow_sup_terms(out, sup["flow4"], sup["vp4"],
                                     sup["vc4"])
    return (photo + F32(flow_weight) * l_flow
            + F32(mask_weight) * l_mask), (photo, l_flow)


def loss_fn2_sup(params, prev, curr, target, sup, t: float = 0.5,
                 aux_weight: float = 0.3, flow_weight: float = 0.1,
                 mask_weight: float = 0.02):
    """v2 photometric (+1/8 aux) + analytic-flow supervision of BOTH
    stages: the refined head against the quarter-res targets and the
    coarse stage against the 1/8 targets (each in its own res units —
    sup keys flow4/vp4/vc4 and flow8/vp8/vc8)."""
    return _two_stage_loss(_head2_raw, params, prev, curr, target, t,
                           aux_weight, sup=sup, flow_weight=flow_weight,
                           mask_weight=mask_weight)


def interpolate_fast2(params: dict, prev: jax.Array, curr: jax.Array,
                      t: float = 0.5, grid: int = 16,
                      max_flow: int = 8, dtype=jnp.bfloat16,
                      integer_flow: bool | None = None,
                      p4=None, c4=None) -> jax.Array:
    """v2 inference: the two-stage trunk's refined head output feeds the
    SAME lattice-sample + one-hot-warp tail as v1 (the refined output has
    v1's exact shape/semantics: [5, H/4, W/4], flows in 1/4-res units) —
    but with FRACTIONAL block flows by default: v2 learns real sub-pixel
    flows, and rounding them measured -2.44 dB on the rich corpus (see
    interpolate_fast's integer_flow docs for both measurements).

    ``p4``/``c4``: optional precomputed quarter frames [C, H/4, W/4]
    (the engine's streaming cache — see _head2_raw)."""
    if integer_flow is None:
        integer_flow = False
    out1, _ = _head2_raw(params, prev[None], curr[None], dtype=dtype,
                         fast=True,
                         p4=None if p4 is None else p4[None],
                         c4=None if c4 is None else c4[None])
    return _fast_tail(out1[0], prev, curr, t, grid, max_flow, dtype,
                      integer_flow)


def param_shardings2(mesh: Mesh) -> dict:
    """v2 tensor-parallel layout (same rule as v1: hidden channels over
    'tp' for interior convs; heads gather)."""
    def ns(*spec):
        return NamedSharding(mesh, P(*spec))

    tp_w = {"w": ns("tp", None, None, None), "b": ns("tp")}
    return {
        "enc1": tp_w, "enc2": tp_w, "enc3": tp_w,
        "c_body": tp_w, "r_in": tp_w, "r_body": tp_w,
        "c_head": {"w": ns(None, "tp", None, None), "b": ns(None)},
        "r_head": {"w": ns(None, "tp", None, None), "b": ns(None)},
    }


def load_params(path: str) -> dict:
    """Load a checkpoint saved by tpufg.utils.checkpoint.save_pytree.

    The architecture is inferred from the leaf count (v1: 5 layers = 10
    leaves; v2: 8 layers = 16) and the hidden width from the first leaf
    (a body bias in both layouts' sorted key order).
    """
    import numpy as np2

    from tpufg.utils.checkpoint import load_pytree

    data = np2.load(path)
    n_leaves = sum(1 for k in data.files if k.startswith("leaf_"))
    hidden = int(data["leaf_0"].shape[0])  # v1 body1.b / v2+v3 c_body.b
    if n_leaves == 16:
        # v2 and v3 share the 8-layer layout; sorted-key leaf 5 is
        # enc1.w, whose input-channel count discriminates (8 pair-joint
        # vs 4 per-frame); leaf 15 is r_in.w, whose input-channel count
        # discriminates v3d (17: + warped-difference) from v3 (13)
        if data["leaf_5"].shape[1] == 4:
            init = functools.partial(
                init_params3, stage2_diff=data["leaf_15"].shape[1] == 17)
        else:
            init = init_params2
    elif n_leaves == 18:
        # v3c: the residual c_body2 layer (sorted keys shift leaves by
        # 2: enc1.w -> leaf_7, r_in.w -> leaf_17); only v3 grows it
        init = functools.partial(
            init_params3, coarse_body2=True,
            stage2_diff=data["leaf_17"].shape[1] == 17)
    else:
        init = init_params
    like = init(jax.random.PRNGKey(0), hidden)
    return load_pytree(path, like)


def loss_fn(params, prev, curr, target, t: float = 0.5, ft: bool = False):
    pred = forward(params, prev, curr, t, ft=ft)
    return jnp.mean(jnp.abs(pred - target.astype(F32)))


def param_shardings(mesh: Mesh) -> dict:
    """Tensor-parallel layout: hidden channels sharded over 'tp'.

    enc2/body convs shard output channels; body inputs shard input
    channels (XLA inserts the psum); head gathers (replicated).
    """
    def ns(*spec):
        return NamedSharding(mesh, P(*spec))

    return {
        "enc1": {"w": ns("tp", None, None, None), "b": ns("tp")},
        "enc2": {"w": ns("tp", None, None, None), "b": ns("tp")},
        "body1": {"w": ns("tp", None, None, None), "b": ns("tp")},
        "body2": {"w": ns("tp", None, None, None), "b": ns("tp")},
        "head": {"w": ns(None, "tp", None, None), "b": ns(None)},
    }


def make_train_step(
    learning_rate=1e-4,  # float or optax schedule (cosine via the trainer)
    mesh: Optional[Mesh] = None,
    t: float = 0.5,
    arch: str = "v1",
    ft: bool = False,
    flow_weight: float = 0.0,
    mask_weight: Optional[float] = None,
    ema_decay: float = 0.0,
) -> tuple[Callable, Callable, optax.GradientTransformation]:
    """Returns (init_state, train_step, optimizer).

    With a mesh (axes 'dp' and 'tp'), parameters are tp-sharded and batches
    dp-sharded; XLA GSPMD inserts the collectives.  train_step signature:
    (params, opt_state, prev, curr, target) -> (params, opt_state, loss).

    ``arch``: "v1" (single-stage 1/4-res flow) or "v2" (two-stage
    coarse-to-fine; adds the 1/8-scale auxiliary supervision term).

    ``ft``: fast-consistent training — the loss runs the differentiable
    replica of the deployed inference tail (straight-through integer block
    flows; see :func:`_ft_tail`).  Use to fine-tune a smooth-trained
    checkpoint toward what interpolate_fast actually executes.

    ``flow_weight`` > 0: analytic-flow supervision (the procedural-corpus
    teacher; requires the synthetic trainer feed).  The step signature
    gains a trailing ``sup`` dict (see loss_fn2_sup) and the returned loss
    becomes (total, photo, flow).  ``mask_weight`` defaults to
    flow_weight / 5.  Mutually exclusive with ``ft``.

    Multi-t training: every step variant accepts an OPTIONAL trailing f32
    scalar ``t`` (traced, so all steps share one compiled program) and the
    loss then predicts the frame at that time through the t-scaled tails
    (:func:`_flow_t_scales`) instead of the closure-time ``t``.  The raw
    flow semantics stay midpoint (supervision targets remain the midpoint
    motions); only the photometric terms move with t.  Closes the
    constant-velocity-only gap the k>2 fix documented: the
    head sees off-midpoint targets in training instead of only
    extrapolating to them (the trainer's ``--multi-t``).

    ``ema_decay`` > 0: the step additionally maintains an exponential
    moving average of the parameters (Polyak averaging — the evaluation
    weights of most modern vision training recipes).  The step signature
    gains a trailing ``ema`` pytree (same structure as params, seeded
    from the initial params) and returns it updated:
    ``ema' = ema_decay * ema + (1 - ema_decay) * params'``.  The update
    runs inside the jitted step, so the average lives on device.
    """
    v3_variants = ("v3", "v3d", "v3c", "v3dc")
    if arch not in ("v1", "v2") + v3_variants:
        raise ValueError(f"arch must be v1, v2, v3, v3d, v3c or v3dc, "
                         f"got {arch!r}")
    sup = flow_weight > 0.0
    if sup and ft:
        raise ValueError("flow supervision and --ft are mutually exclusive "
                         "(supervision trains the smooth tail)")
    # the v3 variants (v3d widened stage-2 input, v3c residual coarse
    # body, v3dc both) share the v3 losses: _head3_raw routes on the
    # params' own shapes/keys
    lf_sup = {"v1": loss_fn_sup, "v2": loss_fn2_sup,
              **{v: loss_fn3_sup for v in v3_variants}}[arch]
    lf_photo = {"v1": loss_fn, "v2": loss_fn2,
                **{v: loss_fn3 for v in v3_variants}}[arch]
    if sup:
        mw = flow_weight / 5.0 if mask_weight is None else mask_weight
        lf = functools.partial(lf_sup, flow_weight=flow_weight,
                               mask_weight=mw)
    elif ft:
        lf = functools.partial(lf_photo, ft=True)
    else:
        lf = lf_photo
    opt = optax.adam(learning_rate)
    init_p = {"v1": init_params, "v2": init_params2, "v3": init_params3,
              "v3d": functools.partial(init_params3, stage2_diff=True),
              "v3c": functools.partial(init_params3, coarse_body2=True),
              "v3dc": functools.partial(init_params3, stage2_diff=True,
                                        coarse_body2=True),
              }[arch]
    body2 = arch in ("v3c", "v3dc")
    shard_p = {"v1": param_shardings, "v2": param_shardings2,
               **{v: functools.partial(param_shardings3,
                                       coarse_body2=body2)
                  for v in v3_variants}}[arch]

    def init_state(key, hidden: int = HIDDEN):
        params = init_p(key, hidden)
        if mesh is not None:
            shardings = shard_p(mesh)
            params = jax.tree_util.tree_map(
                lambda x, s: jax.device_put(x, s), params, shardings)
        return params, opt.init(params)

    def _constrain(x):
        if mesh is None:
            return x
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(mesh, P("dp", *([None] * (x.ndim - 1)))))

    def _step(params, opt_state, prev, curr, target, t_in=None):
        prev, curr, target = map(_constrain, (prev, curr, target))
        t_eff = t if t_in is None else t_in
        loss, grads = jax.value_and_grad(lf)(
            params, prev, curr, target, t_eff)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def _step_sup(params, opt_state, prev, curr, target, sup_batch,
                  t_in=None):
        prev, curr, target = map(_constrain, (prev, curr, target))
        sup_batch = jax.tree_util.tree_map(_constrain, sup_batch)
        t_eff = t if t_in is None else t_in
        (loss, (photo, flow)), grads = jax.value_and_grad(lf, has_aux=True)(
            params, prev, curr, target, sup_batch, t_eff)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, (loss, photo, flow)

    if ema_decay > 0.0:
        d = float(ema_decay)

        def _ema(ema, params):
            return jax.tree_util.tree_map(
                lambda e, p: e * d + p * (1.0 - d), ema, params)

        def _step_ema(params, opt_state, ema, prev, curr, target,
                      t_in=None):
            params, opt_state, loss = _step(
                params, opt_state, prev, curr, target, t_in)
            return params, opt_state, _ema(ema, params), loss

        def _step_sup_ema(params, opt_state, ema, prev, curr, target,
                          sup_batch, t_in=None):
            params, opt_state, loss = _step_sup(
                params, opt_state, prev, curr, target, sup_batch, t_in)
            return params, opt_state, _ema(ema, params), loss

        return init_state, jax.jit(_step_sup_ema if sup else _step_ema), opt
    return init_state, jax.jit(_step_sup if sup else _step), opt
