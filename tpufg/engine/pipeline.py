"""Jit'd per-frame pipeline steps.

Replaces the reference's Scaler::ProcessFrame orchestration
(src/scaler.cpp:397-624) and the dead FrameManager::InterpolateFrames
sequence (frame_manager.cpp:216-372, zero call sites — SURVEY.md §0): here
the interpolation path is real and fused into a single XLA program per step.
Where the reference serializes three submit+vkQueueWaitIdle round-trips per
frame (scaler.cpp:393,532; window_capture.cpp:566), a step is one traced
computation — XLA dataflow replaces every image barrier, including the
missing one between the motion and interpolate dispatches
(frame_manager.cpp:344-366, latent bug #11).

Two precision modes:
- "fast": the production path — plain XLA ops plus the exhaustive-search
  Triton kernel; ``dtype`` bf16 or f32 selects the warp/head operand
  precision (SSIM >= 0.999 contract between the two)
- "exact": the jnp f32 oracle ops end to end (bit-for-bit the GLSL spec)

Motion modes mirror BASELINE.json configs: "none" (pure cross-fade,
config 2), "exhaustive" (motion.comp parity, config 3), "pyramid"
(production hierarchical search, configs 4/5).
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

from tpufg.config import EngineConfig
from tpufg.kernels.convert import (frames_to_planar, planar_to_frames,
                                   planar_to_i32)
from tpufg.kernels.lanczos import lanczos_scale_packed
from tpufg.kernels.motion import motion_search_sites
from tpufg.kernels.motion_xla import motion_search_xla
from tpufg.kernels.warp_matmul import warp_blend_matmul
from tpufg.models.pyramid import pyramid_motion_search
from tpufg.ops import oracle
from tpufg.kernels.common import round_up

F32 = jnp.float32

# block lattice of the production MV grid / warp kernel
MV_GRID = 16
PYR_LEVELS = 3


def _dtype(cfg: EngineConfig):
    return jnp.bfloat16 if cfg.dtype == "bf16" else jnp.float32


def _edge_pad_chw(x: jax.Array, hp: int, wp: int) -> jax.Array:
    c, h, w = x.shape
    return jnp.pad(x, ((0, 0), (0, hp - h), (0, wp - w)), mode="edge")


def make_scale_step(cfg: EngineConfig, wire: str = "u8",
                    sink_wire: str = "rgba") -> Callable:
    """uint8 [H, W, 4] -> scaled uint8 [outH, outW, 4]  (config 1 path).

    ``wire="i32"``: frames cross the host boundary as packed int32 [H, W]
    RGBA lanes instead (identical bytes; the host's uint8 view is free) —
    skips the on-device u8<->i32 bitcast relayouts (see frames_to_planar /
    lanczos_scale_packed raw_i32).

    ``sink_wire="y4m420"/"y4m444"``: outputs leave the device as ready
    y4m FRAME payload bytes (kernels/yuv.py) instead of RGBA — the color
    conversion runs fused on-device and the C420 readback is 2.7x smaller.
    """
    out_h, out_w = cfg.output_height, cfg.output_width
    a = cfg.lanczos_a
    dt = _dtype(cfg)
    i32 = wire == "i32"
    to_y4m = _sink_packer(sink_wire)

    @jax.jit
    def step(frame_u8):
        if ((out_h, out_w) == (cfg.input_height, cfg.input_width)
                and cfg.input_height > 0):
            # identity resample: integer-offset taps give the center tap
            # weight exactly 1 and the rest exactly 0 (sin(pi*k) = 0), and
            # the UNORM8 round-trip is exact (round(255*(k/255)) == k), so
            # the output bytes ARE the input bytes — pass through
            return to_y4m(frame_u8) if to_y4m else frame_u8
        # the resample runs in f32 whatever cfg.dtype says (bf16 storage
        # costs ~1 uint8 code; the pass is memory-bound anyway)
        planar = frames_to_planar(frame_u8, F32)
        # scale fused with quantize+pack: final wire bytes
        out = lanczos_scale_packed(planar, out_h, out_w, a,
                                   raw_i32=i32 or to_y4m is not None)
        return to_y4m(out) if to_y4m else out

    return step


def _sink_packer(sink_wire: str):
    """None for the RGBA wire, else the device-side y4m payload converter."""
    if sink_wire == "rgba":
        return None
    if sink_wire in ("y4m420", "y4m444"):
        from tpufg.kernels.yuv import rgba_to_y4m_payload
        return functools.partial(rgba_to_y4m_payload,
                                 chroma=sink_wire[3:])
    raise ValueError(f"unknown sink wire {sink_wire!r}")


def make_exact_scale_step(cfg: EngineConfig) -> Callable:
    """Oracle (bit-exact f32) scale step."""
    out_h, out_w = cfg.output_height, cfg.output_width
    a = cfg.lanczos_a

    @jax.jit
    def step(frame_u8):
        img = oracle.dequantize_unorm8(frame_u8)
        out = oracle.lanczos_scale(img, out_h, out_w, a)
        return oracle.quantize_unorm8(out)

    return step


def interp_planar(p, c, *, mode: str, factors, dt, block_size: int,
                  search_radius: int, model_params=None,
                  skip_finest_refine: int = 1, mv_grid: int = MV_GRID,
                  subpel: bool = False, mv_bias: float = 0.0,
                  mv_filter: bool = False,
                  occlusion_blend: bool = False,
                  mc_fallback: bool = False,
                  scene_cut_threshold: float = 0.0,
                  scene_cut_axis: str | None = None,
                  mv_seed=None, return_mv: bool = False,
                  motion_skip_alpha: bool = False,
                  q_seed=None, return_q: bool = False,
                  site_search: Callable = motion_search_sites):
    """The production interpolation core, shared by the single-chip step and
    the multi-chip sharded step (tpufg.parallel.spatial) so multi-chip runs
    the SAME math per shard.

    ``p``/``c``: planar f32 [C, h, w] frames (any h/w; padded internally to
    the motion/warp lattice and cropped back).  Returns one [C, h, w]
    interpolated frame per blend factor in ``factors``.

    ``mv_grid``: warp granularity.  16 warps whole MV-lattice blocks;
    8 bilinearly upsamples the MV field to an 8-px lattice first;
    1 is the per-pixel mode — exact bilinear MV interpolation along x and
    overlapped block motion compensation along y (bilinearly blended block
    warps), the production counterpart of interpolate.comp's per-pixel
    bilinear MV read (shaders/interpolate.comp:30-31).

    ``scene_cut_threshold`` > 0: when mean |p - c| exceeds it, the pair
    straddles a cut — block matching finds no true correspondences and the
    warp double-exposes — so each in-between frame falls back to the
    temporally nearer source (t < 0.5 -> prev, else curr; the standard
    MEMC cut fallback).  ``scene_cut_axis``: mesh axis name to pmean the
    detector over so spatial shards agree on the decision (no seams).

    ``mv_seed``: temporal predictor MV field on the PADDED lattice
    [2, Hp/16, Wp/16] (pyramid mode; see pyramid_motion_search).  With
    ``return_mv`` the return value is ``(interps, mv_out)`` where mv_out
    is the estimated field to seed the next pair (zeroed on a scene cut —
    the predictor must not leak across a discontinuity).

    ``motion_skip_alpha``: drop the alpha channel from MOTION ESTIMATION
    only (search kernels, probe warps, subpel costs; the output warp
    still carries all 4 channels).  Valid when both frames hold the SAME
    spatially constant alpha (every real video wire here: y4m decode
    synthesizes 255; X11-class capture is constant 0xFF): the alpha
    distance term is then exactly 0.0 for every candidate, and since
    adding 0.0f is exact, every cost — and the MV field — is BITWISE the
    4-channel result (tested) at ~25% less search arithmetic.

    ``site_search``: the exhaustive lattice-site search of block size 8
    (default the Triton kernel); any function with its signature and
    contract, e.g. a plain-XLA competitor timed against it.
    """
    _, h, w = p.shape
    interps = []
    cut = None
    if scene_cut_threshold > 0.0:
        # RGB channels only: every real source carries constant alpha, which
        # would dilute the mean to 3/4 of the documented [0,1] RGB units
        d = jnp.mean(jnp.abs(p[:3].astype(F32) - c[:3].astype(F32)))
        if scene_cut_axis is not None:
            d = jax.lax.pmean(d, scene_cut_axis)
        cut = d > F32(scene_cut_threshold)

    def cut_fallback(warped, tf):
        if cut is None:
            return warped
        src = p.astype(F32) if tf < 0.5 else c.astype(F32)
        return jnp.where(cut, src, warped)
    if mode == "none":
        # the cut fallback applies here too: a crossfade across a shot
        # change is the double exposure the flag promises to suppress
        for tf in factors:
            interps.append(cut_fallback(
                p.astype(F32) * F32(1.0 - tf) + c.astype(F32) * F32(tf),
                tf))
        return interps
    if mode == "learned":
        # config 5: RIFE-style head predicts the in-between frames
        # (gather-free inference path)
        from tpufg.models import rife
        hp, wp = round_up(h, 16), round_up(w, 16)
        pp = _edge_pad_chw(p.astype(F32), hp, wp)
        cp = _edge_pad_chw(c.astype(F32), hp, wp)
        if rife.is_v3(model_params):
            # v3 streaming head: curr's quarter frame AND per-frame
            # encoder features are computed ONCE here; prev's come from
            # the threaded stream cache (q_seed = last step's q_out —
            # same functions on the same frame, identical by
            # construction).  bf16 matches interpolate_fast3's internal
            # compute dtype so the cache is exactly what the inline
            # path would compute.
            import jax.numpy as _jnp
            c4 = rife._down4_mean(cp[None])[0]
            f4c = rife.encode3(model_params, cp[None],
                               dtype=_jnp.bfloat16)[0]
            if q_seed is not None:
                p4, f4p = q_seed
            else:
                p4 = rife._down4_mean(pp[None])[0]
                f4p = rife.encode3(model_params, pp[None],
                                   dtype=_jnp.bfloat16)[0]
            # the trunk is t-independent: ONE trunk per pair, and
            # tails_fast shares the per-pair warp prep across the k-1
            # time points (k-1 t-scaled warps at --fps-multiplier k)
            out = rife.trunk_fast(model_params, pp, cp, p4=p4, c4=c4,
                                  f4p=f4p, f4c=f4c)
            for tf, tail in zip(factors, rife.tails_fast(
                    model_params, out, pp, cp, factors)):
                interps.append(cut_fallback(tail[:, :h, :w], tf))
            return (interps, (c4, f4c)) if return_q else interps
        if rife.is_v2(model_params):
            # v2 stage-2 quarter frames: curr's is computed ONCE here
            # prev's comes from the threaded
            # stream cache when the engine provides it (q_seed = last
            # step's q_out — bitwise-identical to recomputing, same
            # function on the same frame)
            c4 = rife._down4_mean(cp[None])[0]
            p4 = q_seed if q_seed is not None \
                else rife._down4_mean(pp[None])[0]
            out = rife.trunk_fast(model_params, pp, cp, p4=p4, c4=c4)
            for tf, tail in zip(factors, rife.tails_fast(
                    model_params, out, pp, cp, factors)):
                interps.append(cut_fallback(tail[:, :h, :w], tf))
            return (interps, c4) if return_q else interps
        out = rife.trunk_fast(model_params, pp, cp)
        for tf, tail in zip(factors, rife.tails_fast(
                model_params, out, pp, cp, factors)):
            interps.append(cut_fallback(tail[:, :h, :w], tf))
        return (interps, None) if return_q else interps
    # pad to the motion/warp lattice (pyramid needs grid*2^(L-1))
    mult = MV_GRID * 2 ** (PYR_LEVELS - 1)
    hp, wp = round_up(h, mult), round_up(w, mult)
    pp = _edge_pad_chw(p.astype(F32), hp, wp)
    cp = _edge_pad_chw(c.astype(F32), hp, wp)
    # motion-estimation views: alpha dropped when it is degenerate (see
    # docstring) — the output warp below always reads the full pp/cp
    mp = pp[:3] if motion_skip_alpha and pp.shape[0] == 4 else pp
    mc = cp[:3] if motion_skip_alpha and cp.shape[0] == 4 else cp
    if mode == "pyramid":
        # latency mode (skip_finest_refine=1): skip the full-res residual
        # refine (the single most expensive stage; MV lattice effectively 2x)
        mv = pyramid_motion_search(
            mp, mc, levels=PYR_LEVELS, base_radius=4,
            refine_radius=2, block_size=block_size, grid=MV_GRID,
            skip_finest_refine=skip_finest_refine,
            seed=mv_seed, bias=mv_bias)
    elif block_size == 8:  # exhaustive parity search at the MV sites
        mv = site_search(mp, mc, block_size=block_size,
                         search_radius=search_radius, grid=MV_GRID)
    else:  # non-reference block sizes: per-pixel XLA search, subsampled
        mv_px = motion_search_xla(mp, mc, block_size=block_size,
                                  search_radius=search_radius)
        mv = mv_px[:, MV_GRID // 2::MV_GRID, MV_GRID // 2::MV_GRID]
    # the warp clamps MVs to its static reach: the pyramid's own bound by
    # default, extended to the temporal clamp + pyramid reach when seeded
    r_warp = max(search_radius, 8)
    if mv_seed is not None:
        from tpufg.models.pyramid import TEMPORAL_CLAMP
        r_warp = max(r_warp, TEMPORAL_CLAMP + 24)
    if subpel:
        # ±1 px re-search + parabolic sub-pel fit: the integer (2-px in
        # latency mode) MV quantization, not warp granularity, is the
        # quality ceiling on smooth motion — see models/pyramid.py
        from tpufg.models.pyramid import subpel_refine
        # subpel keeps all 4 channels even under motion_skip_alpha: its
        # probe warp zero-pads beyond the frame (unlike the search
        # kernels' clamp-to-edge fetch), so the alpha term is NOT zero at
        # border blocks and dropping it would break the bitwise contract
        mv = subpel_refine(pp, cp, mv, grid=MV_GRID, search_radius=r_warp,
                           bias=mv_bias, dtype=dt)
    if mv_filter:
        from tpufg.models.pyramid import median_filter_mv
        mv = median_filter_mv(mv)
    mv_out = None
    if return_mv:
        # next pair's predictor; a cut resets it (no leak across the
        # discontinuity — constant-velocity assumption is void there)
        mv_out = mv
        if cut is not None:
            mv_out = jnp.where(cut, jnp.zeros_like(mv), mv)
    bilin = mv_grid == 1
    if mv_grid != MV_GRID:
        # bilinear MV-field upsample to the finer lattice: both lattices
        # have half-cell-centered sites, exactly jax.image.resize's
        # "linear" convention, so cell centers interpolate correctly.
        # Per-pixel mode (mv_grid=1) warps from an 8-px site lattice —
        # the warp interpolates the rest: exactly along x, by bilinear
        # value blending (OBMC) between the 8-px sites along y.
        f = MV_GRID // (8 if bilin else mv_grid)
        mv = jax.image.resize(
            mv, (2, mv.shape[1] * f, mv.shape[2] * f), method="linear")
    # integer-offset fast path: pyramid latency-mode MVs are EVEN integers
    # (the final upsample doubles an integer lattice; the 3x3 median of
    # even integers is even), so at t=0.5 each frame's offsets are exact —
    # the warp drops the lerp and second row read (bitwise-identical
    # result; x*1 + y*0 is exact).  Any fractional source — a temporal
    # seed, the mv-grid upsample, t != 0.5, or an ODD warp clip bound
    # (the warp clips MVs to ±r_warp; clipping an even MV to an odd bound
    # makes the half-offset fractional) — disables it.
    int_offs = (mode == "pyramid" and skip_finest_refine >= 1
                and mv_grid == MV_GRID and mv_seed is None
                and not subpel
                and all(tf == 0.5 for tf in factors)
                and r_warp % 2 == 0)
    for tf in factors:  # one MV field shared by all time points
        warped = warp_blend_matmul(pp, cp, -mv, factor=tf,
                                   block=8 if bilin else mv_grid,
                                   bilinear=bilin,
                                   search_radius=r_warp,
                                   dtype=dt, occlusion=occlusion_blend,
                                   mc_fallback=mc_fallback,
                                   integer_offsets=int_offs,
                                   # engine frames are always dequantized
                                   # uint8 -> the integer-offset bf16 warp
                                   # runs in the exact integer-code domain
                                   u8_exact=True)
        interps.append(cut_fallback(warped[:, :h, :w], tf))
    if return_mv:
        return interps, mv_out
    return interps


def make_interp_step(cfg: EngineConfig, precision: str = "fast",
                     model_params=None, wire: str = "u8",
                     sink_wire: str = "rgba",
                     motion_skip_alpha: bool = False,
                     q_feed: bool = False,
                     site_search: Callable = motion_search_sites) -> Callable:
    """(prev_u8, curr_u8) -> (interp_scaled_u8, ..., curr_scaled_u8).

    The fps-multiplying streaming step.  With cfg.fps_multiplier == k it
    emits k-1 motion-compensated in-between frames (t = 1/k .. (k-1)/k,
    sharing one MV field) plus the scaled current frame; with k == 2 the
    single in-between point is cfg.interpolation_factor (the reference's
    blend-factor semantic, main.cpp:25).  ``model_params``: learned-head
    parameters, required for motion_mode="learned" (config 5).

    ``wire="i32"``: identical bytes as packed int32 [H, W] RGBA lanes at
    both boundaries (fast precision only) — the host views uint8 frames
    as int32 for free, and the step skips the on-device u8<->i32 bitcast
    relayouts.

    ``motion_skip_alpha``: drop alpha from motion estimation (fast path
    only; bitwise-equal MV field when both frames carry the same constant
    alpha — see interp_planar).  The engine sets this from the source's
    ``const_alpha`` hint; the exact oracle path ignores it (the oracle IS
    the 4-channel spec).

    ``q_feed`` (v2 learned head, streaming): the step takes a third arg
    ``q_seed`` — prev's quarter-res stage-2 frame (donated) — and
    returns curr's as an extra trailing output, so the runner threads
    it between pairs and each frame is box-downsampled ONCE instead of
    twice (see rife._down4_mean).  Bitwise-
    identical outputs (the cache is the same function on the same
    frame).  Opt-in so the 2-arg step API stays stable for tools; a
    no-op request (v1 head, exact path) is silently dropped.  Initial
    seed: ``make_q_init(cfg)``.

    ``site_search``: see :func:`interp_planar`.
    """
    out_h, out_w = cfg.output_height, cfg.output_width
    t = cfg.interpolation_factor
    a = cfg.lanczos_a
    b = cfg.block_size
    r = cfg.search_radius
    mode = cfg.motion_mode
    dt = _dtype(cfg)
    if mode == "learned" and model_params is None:
        raise ValueError("motion_mode='learned' requires model_params "
                         "(--model-path)")
    k = max(2, int(cfg.fps_multiplier))
    factors = ([t] if k == 2
               else [i / float(k) for i in range(1, k)])
    i32 = wire == "i32"
    if i32 and precision == "exact":
        raise ValueError("wire='i32' applies to the fast path only "
                         "(the exact oracle speaks uint8 frames)")
    to_y4m = _sink_packer(sink_wire)
    if to_y4m is not None and precision == "exact":
        raise ValueError("sink_wire y4m applies to the fast path only")

    # Donating prev only pays when an output buffer can actually alias it:
    # the equal-size fps-multiply config (uint8 [H,W,4] in and out).  For
    # scaling configs no output matches the input shape and XLA would just
    # warn "Some donated buffers were not usable" every run.  A temporal
    # step also donates the consumed MV seed (mv_out aliases it exactly).
    donate = ((out_h, out_w) == (cfg.input_height, cfg.input_width)
              and cfg.input_height > 0 and to_y4m is None)
    temporal = (bool(cfg.temporal_mv) and mode == "pyramid"
                and precision != "exact")
    qfeed = False
    if q_feed and mode == "learned" and precision != "exact" \
            and model_params is not None:
        from tpufg.models import rife as _rife
        qfeed = _rife.is_v2(model_params) or _rife.is_v3(model_params)
    donate_idx = ((0,) if donate else ()) \
        + ((2,) if temporal or qfeed else ())
    jit_step = (functools.partial(jax.jit, donate_argnums=donate_idx)
                if donate_idx else jax.jit)

    if precision == "exact":
        @jit_step
        def step(prev_u8, curr_u8):
            p = oracle.dequantize_unorm8(prev_u8)
            c = oracle.dequantize_unorm8(curr_u8)
            if mode == "none":
                mv = None
            else:  # oracle path always uses the full exhaustive search
                mv = -oracle.motion_search(p, c, b, r)  # negate: bug #12
            outs = []
            for tf in factors:
                interp = oracle.warp_blend(p, c, mv, tf)
                outs.append(oracle.quantize_unorm8(
                    oracle.lanczos_scale(interp, out_h, out_w, a)))
            outs.append(oracle.quantize_unorm8(
                oracle.lanczos_scale(c, out_h, out_w, a)))
            return tuple(outs)

        return step

    def body(prev_u8, curr_u8, mv_seed=None, q_seed=None):
        # f32 storage end to end; dt picks warp/head operand precision
        p = frames_to_planar(prev_u8, F32)
        c = frames_to_planar(curr_u8, F32)
        _, h, w = p.shape
        res = interp_planar(p, c, mode=mode, factors=factors, dt=dt,
                            block_size=b, search_radius=r,
                            model_params=model_params,
                            mv_grid=cfg.mv_grid,
                            subpel=cfg.subpel,
                            mv_bias=cfg.mv_bias,
                            mv_filter=cfg.mv_filter,
                            occlusion_blend=cfg.occlusion_blend,
                            mc_fallback=cfg.mc_fallback,
                            scene_cut_threshold=cfg.scene_cut_threshold,
                            mv_seed=mv_seed, return_mv=temporal,
                            motion_skip_alpha=motion_skip_alpha,
                            q_seed=q_seed, return_q=qfeed,
                            site_search=site_search)
        mv_out = q_out = None
        if temporal:
            interps, mv_out = res
        elif qfeed:
            interps, q_out = res
        else:
            interps = res
        # separate scale calls per output (a stacked-channel call would
        # materialize the concatenated frames)
        if (out_h, out_w) == (h, w):
            # identity resample (see make_scale_step): skip the resample
            pack = planar_to_i32 if i32 else planar_to_frames
        else:
            # scale fused with quantize+pack: the vertical pass writes the
            # final wire bytes, no f32 scaled frame or channel transpose
            pack = lambda x: lanczos_scale_packed(x, out_h, out_w, a,
                                                  raw_i32=i32)
        outs = [pack(x) for x in interps]
        if (out_h, out_w) == (h, w):
            # the scaled current frame at identity size is byte-identical
            # to the input (exact UNORM8 round-trip) — pass it through
            # instead of repacking the planar form
            outs.append(curr_u8)
        else:
            outs.append(pack(c))
        if to_y4m is not None:
            # device-side y4m egress: outputs leave as FRAME payload bytes
            outs = [to_y4m(o) for o in outs]
        if temporal:
            return tuple(outs) + (mv_out,)
        if qfeed:
            return tuple(outs) + (q_out,)
        return tuple(outs)

    if temporal:
        @jit_step
        def step(prev_u8, curr_u8, mv_seed):
            # (..., mv_seed) -> (*frames, mv_out): thread the MV field
            # between pairs (runner keeps it on-device; zeros to start)
            return body(prev_u8, curr_u8, mv_seed)
    elif qfeed:
        @jit_step
        def step(prev_u8, curr_u8, q_seed):
            # (..., q_seed) -> (*frames, q_out): thread the v2 quarter
            # frame between pairs (runner keeps it on-device; seeded by
            # make_q_init on the stream's first frame)
            return body(prev_u8, curr_u8, q_seed=q_seed)
    else:
        @jit_step
        def step(prev_u8, curr_u8):
            return body(prev_u8, curr_u8)

    return step


def make_q_init(cfg: EngineConfig, model_params=None):
    """Jit'd frame -> the learned head's stream-cache seed, replicating
    the padded learned path EXACTLY (frames_to_planar -> edge pad to the
    16-px lattice -> rife._down4_mean), so seeding a q_feed step with it
    is identical to the step computing prev's state itself.  For the v3
    streaming head (``model_params`` given and is_v3) the seed is the
    (quarter frame, per-frame encoder features) pair; otherwise the v2
    quarter frame alone.  Compiled once per stream."""
    from tpufg.models import rife
    hp = round_up(cfg.input_height, 16)
    wp = round_up(cfg.input_width, 16)
    v3 = model_params is not None and rife.is_v3(model_params)

    @jax.jit
    def q_init(frame):
        p = frames_to_planar(frame, F32)
        pp = _edge_pad_chw(p, hp, wp)[None]
        q4 = rife._down4_mean(pp)[0]
        if not v3:
            return q4
        import jax.numpy as _jnp
        return (q4, rife.encode3(model_params, pp,
                                 dtype=_jnp.bfloat16)[0])

    return q_init


def mv_lattice_shape(cfg: EngineConfig) -> tuple[int, int, int]:
    """Shape of the temporal MV state threaded through a temporal step:
    the padded-frame block lattice [2, Hp/16, Wp/16] (interp_planar pads
    to the pyramid's grid*2^(L-1) lattice before estimating)."""
    mult = MV_GRID * 2 ** (PYR_LEVELS - 1)
    hp = round_up(cfg.input_height, mult)
    wp = round_up(cfg.input_width, mult)
    return (2, hp // MV_GRID, wp // MV_GRID)
