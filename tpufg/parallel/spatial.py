"""Multi-device spatial sharding with row-halo exchange.

The reference is strictly single-GPU (one device, one queue —
src/vulkan_context.cpp:76-153; SURVEY.md §2.4): its only parallel
decomposition is the 16x16 workgroup grid.  This build scales the same
math across the cards of one host:

- **sp (spatial)**: a frame's rows are sharded across the mesh; motion
  search at pixel p reads a (blockSize/2 + searchRadius)-row neighborhood
  (motion.comp:22-47 — 20 rows at reference constants; more through the
  pyramid), so shards exchange fixed-width row halos with their neighbors
  via ``jax.lax.ppermute`` inside ``shard_map`` (collectives that XLA
  hands to NCCL over NVLink) — the same pattern as ring attention's
  block-wise KV pass (SURVEY.md §5.7).
- **dp (data/frame)**: independent frame pairs (offline transcode) shard
  trivially over a leading batch axis.

Boundary semantics: interior shard edges see real neighbor rows — results
match the single-chip run away from frame edges (bitwise for MVs and the
scaled-current path; <= 1 uint8 code at < 1e-4 of pixels for the warped
path, see make_sharded_interp_step); the outermost shards edge-replicate.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from tpufg.config import ConfigError, EngineConfig
from tpufg.kernels.convert import frames_to_planar, planar_to_frames
from tpufg.kernels.lanczos import lanczos_scale_packed

F32 = jnp.float32

# one halo covers the pyramid's total reach + warp + scale taps, and keeps
# shard extents on the pyramid's 64-row lattice
HALO = 64


def make_spatial_mesh(n_devices: Optional[int] = None,
                      dp: int = 1) -> Mesh:
    """Build a (dp, sp) mesh over the available devices.  A plain reshape
    of ``jax.devices()``: every card of the host reaches every other at
    the same NVLink rate, so the mesh follows the algorithm alone."""
    devs = jax.devices()
    n = n_devices or len(devs)
    if n % dp:
        raise ValueError(f"{n} devices not divisible by dp={dp}")
    arr = np.array(devs[:n]).reshape(dp, n // dp)
    return Mesh(arr, axis_names=("dp", "sp"))


def halo_exchange_rows(x: jax.Array, axis_name: str, halo: int,
                       n: Optional[int] = None) -> jax.Array:
    """Append neighbor row halos to a [C, Hs, W] shard (edge-replicate at
    the frame border).  Returns [C, Hs + 2*halo, W]."""
    if n is None:
        n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    # my bottom rows go to the shard below (they become its top halo)
    from_above = jax.lax.ppermute(
        x[:, -halo:, :], axis_name, [(i, i + 1) for i in range(n - 1)])
    from_below = jax.lax.ppermute(
        x[:, :halo, :], axis_name, [(i, i - 1) for i in range(1, n)])
    # outermost shards: replicate the frame edge (clamp-to-edge semantics)
    top_edge = jnp.broadcast_to(x[:, :1, :], x[:, :halo, :].shape)
    bot_edge = jnp.broadcast_to(x[:, -1:, :], x[:, :halo, :].shape)
    top = jnp.where(idx == 0, top_edge, from_above)
    bot = jnp.where(idx == n - 1, bot_edge, from_below)
    return jnp.concatenate([top, x, bot], axis=1)


def make_sharded_interp_step(
    mesh: Mesh,
    cfg: EngineConfig,
    model_params=None,
    motion_skip_alpha: bool = False,
    q_feed: bool = False,
) -> Callable:
    """Jit'd multi-chip fps-multiplying step — the PRODUCTION pipeline math
    (tpufg.engine.pipeline.interp_planar: pyramid with skip_finest_refine=1,
    warp_blend_matmul at the configured compute dtype, the configured
    fps_multiplier / interpolation_factor / kernel constants), run per
    spatial shard with explicit row-halo exchange.

    Input: uint8 [B, H, W, 4] frame pairs (prev, curr), B sharded over dp,
    rows over sp.  Returns cfg.fps_multiplier outputs, each uint8
    [B, out_h, out_w, 4]: k-1 interpolated frames then the scaled current
    frame (same output tuple as make_interp_step).

    Correctness contract (tested in tests/test_parallel.py): away from the
    frame's outer edges the per-shard MV fields are bitwise-identical to the
    single-chip run, the f32 scaled-current output is bitwise-identical to
    make_interp_step, and the remaining outputs (warped path; everything in
    bf16) match to within one uint8 code at < 1e-4 of pixels — XLA
    fuses/tiles the chain differently for the two shapes, so isolated sums
    land 1 ulp apart and flip a rounding at exact .5 quantization
    boundaries.  At the frame's outer edges the halo
    is edge-replicated, which differs from the single-chip border handling
    (skip-and-renormalize Lanczos taps, clamped search windows) by design —
    a fixed-width frame-border effect, not a shard-seam effect.

    H must be divisible by sp*64 (the pyramid's shard lattice; sp*128 in
    temporal mode); use ``pad_to_shard_lattice`` for arbitrary heights.

    ``cfg.temporal_mv`` (dp=1 only — the predictor is sequential
    per-stream state): the step takes and returns a row-sharded MV state
    [B, 2, H/16, Wp/16] (``sharded_mv_lattice_shape``); the state's halo
    lattice rows are ppermute-exchanged each pair exactly like frame
    rows, so the seeded search matches the single-chip temporal engine
    away from frame edges.

    ``q_feed`` (learned v2/v3 heads, streaming — verdict r4 item 6): the
    step takes the per-stream siamese cache as trailing args and returns
    the current frame's as trailing outputs, so a caller threads it
    between pairs and each frame is downsampled/encoded ONCE per stream
    instead of once per pair — the same contract as the single-chip
    ``make_interp_step(q_feed=True)``.  The cache is stored for the
    HALO-EXTENDED shard frame (rows Hs + 2*halo): the frame-level halo
    exchange runs BEFORE the encoder, so this step's returned cache of
    ``halo_exchange(curr)`` is bitwise the bytes the next step would
    recompute from ``halo_exchange(prev)`` (same function, same frame) —
    the cache needs no feature-level exchange of its own and the cached
    path stays bitwise-identical to the cache-less sharded path, whose
    interior parity vs single-chip is the tested contract.  v3 cache:
    (quarter frame [B, 4, (Hs+2*halo)/4, Wp/4] f32, encoder features
    [B, h2, (Hs+2*halo)/4, Wp/4] bf16), both row-stacked across sp (each
    shard's slab INCLUDES its halos — an opaque state layout, not a
    croppable frame); v2: the quarter frame alone.  Seed with
    ``make_sharded_q_init``; shapes from ``sharded_q_shapes``.  Each
    batch element is an independent stream (its own cache) — under dp
    the caller must keep stream order within each batch lane.
    """
    cfg.validate()
    in_h, in_w = cfg.input_height, cfg.input_width
    out_h, out_w = cfg.output_height, cfg.output_width
    mode = cfg.motion_mode
    if mode == "learned" and model_params is None:
        raise ConfigError(
            "motion_mode='learned' requires model_params (--model-path)")
    # learned-mode halo adequacy: the trunk's receptive field (five 3x3
    # convs, two at stride 2 -> ~±20 full-res px) plus the clamped flow
    # reach (±16 px/frame, rife.interpolate_fast max_flow) stays well
    # inside the 64-row halo, so the same exchange covers the conv head.
    temporal = bool(cfg.temporal_mv)
    if temporal and mesh.shape["dp"] > 1:
        raise ConfigError(
            "--temporal-mv under --devices needs --dp 1: the MV predictor "
            "is sequential per-stream state, which contradicts dp's "
            "batched pair parallelism (spatial sharding threads it fine)")
    qfeed = v3 = False
    if q_feed:
        from tpufg.models import rife as _rife
        if mode != "learned":
            raise ConfigError("q_feed applies to motion_mode='learned' only")
        v3 = _rife.is_v3(model_params)
        qfeed = v3 or _rife.is_v2(model_params)
        if not qfeed:
            raise ConfigError("q_feed needs a v2/v3 learned head (the v1 "
                              "head has no per-frame stream state)")
    t = cfg.interpolation_factor
    k = max(2, int(cfg.fps_multiplier))
    factors = [t] if k == 2 else [i / float(k) for i in range(1, k)]
    dt = jnp.bfloat16 if cfg.dtype == "bf16" else jnp.float32

    # temporal mode doubles the halo: the seeded pyramid's reach is the
    # |seed| clamp (TEMPORAL_CLAMP=48) + the per-pair search (~22) + the
    # block window — ~74 rows, beyond the unseeded 64-row halo
    halo = 2 * HALO if temporal else HALO
    sp = mesh.shape["sp"]
    if in_h % (sp * halo):
        raise ConfigError(
            f"input height {in_h} must be divisible by sp*{halo} = "
            f"{sp * halo} (pad_to_shard_lattice handles arbitrary heights)")
    # the scaled halo rows to crop from each shard's scaled output
    if (halo * out_h) % in_h or (in_h // sp * out_h) % in_h:
        raise ConfigError(
            f"scale {out_h}/{in_h} must map the {halo}-row halo and the "
            f"{in_h // sp}-row shard to whole output rows")
    halo_out = halo * out_h // in_h
    out_hs = (in_h // sp) * out_h // in_h  # output rows per shard
    identity = (out_h, out_w) == (in_h, in_w)

    from tpufg.engine.pipeline import interp_planar

    def pair_fn(prev_u8, curr_u8, *state):
        # [Hs, W, 4] per-shard uint8 -> k outputs [out_hs, out_w, 4]
        # (+ the next MV predictor state in temporal mode, or the next
        # stream cache in q_feed mode)
        p = frames_to_planar(prev_u8, F32)
        c = frames_to_planar(curr_u8, F32)
        p_ext = halo_exchange_rows(p, "sp", halo)
        c_ext = halo_exchange_rows(c, "sp", halo)
        seed_ext = q_seed = None
        if temporal:
            # the MV state shards exactly like frame rows (16-px lattice):
            # exchange halo//16 lattice rows so the seeded search sees its
            # neighbors' predictor, mirroring the frame halos
            seed_ext = halo_exchange_rows(state[0], "sp", halo // 16)
        elif qfeed:
            # the stream cache is stored for the halo-EXTENDED frame
            # (encoded after the frame-level exchange), so it needs no
            # exchange of its own: these are bitwise the bytes this
            # step would recompute from halo_exchange(prev)
            q_seed = state if v3 else state[0]
        res = interp_planar(
            p_ext, c_ext, mode=mode, factors=factors, dt=dt,
            block_size=cfg.block_size, search_radius=cfg.search_radius,
            mv_grid=cfg.mv_grid,
            model_params=model_params,
            subpel=cfg.subpel, mv_bias=cfg.mv_bias,
            mv_filter=cfg.mv_filter, occlusion_blend=cfg.occlusion_blend,
            mc_fallback=cfg.mc_fallback,
            mv_seed=seed_ext, return_mv=temporal,
            motion_skip_alpha=motion_skip_alpha,
            q_seed=q_seed, return_q=qfeed,
            # pmean over sp: all spatial shards must agree on the cut
            # decision or the fallback would seam at shard boundaries
            # (the mean includes each shard's replicated halo rows — a
            # fixed border effect identical across configs, and cuts are
            # decided by order-of-magnitude margins, so the detector's
            # threshold semantics are unchanged)
            scene_cut_threshold=cfg.scene_cut_threshold,
            scene_cut_axis="sp" if cfg.scene_cut_threshold > 0 else None)
        mv_out = q_out = None
        if temporal:
            interps, mv_out = res
        elif qfeed:
            interps, q_out = res
        else:
            interps = res
        # scale WITH the halo present (interior Lanczos taps see real
        # neighbor rows), then crop the scaled halo.  Non-identity sizes
        # scale fused with quantize+pack (same bytes as
        # planar_to_frames(lanczos_scale_planar(...))).
        if identity:
            # interpolated frames still round-trip through planar; the
            # scaled-current output is handled below as a passthrough
            pack = lambda x: planar_to_frames(x)[halo:-halo]
        else:
            pack = lambda x: lanczos_scale_packed(
                x, out_hs + 2 * halo_out, out_w,
                cfg.lanczos_a)[halo_out:-halo_out]
        outs = [pack(x) for x in interps]
        if identity:
            # byte-identical to pack(c_ext): exact UNORM8 round-trip +
            # halo crop recovers exactly the input shard rows
            outs.append(curr_u8)
        else:
            outs.append(pack(c_ext))
        if temporal:
            # crop the halo lattice rows back off: the core rows are this
            # shard's next predictor (neighbors re-exchange next pair)
            h16 = halo // 16
            outs.append(mv_out[:, h16:-h16, :])
        elif qfeed:
            # the cache keeps its halo rows (see docstring: an opaque
            # per-shard state, bitwise next step's prev-side inputs)
            outs.extend(q_out if v3 else (q_out,))
        return tuple(outs)

    shard_fn = jax.vmap(pair_fn)  # local batch axis (dp block)

    n_state = 1 if temporal else (2 if v3 else 1) if qfeed else 0
    specs = P("dp", "sp", None, None)
    # temporal MV state and the q_feed stream cache both shard their row
    # axis (dim 2 of [B, C, rows, cols]) over sp
    st_specs = P("dp", None, "sp", None)
    smapped = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(specs, specs) + (st_specs,) * n_state,
        out_specs=(specs,) * k + (st_specs,) * n_state,
        check_vma=False,
    )

    in_sharding = NamedSharding(mesh, specs)
    st_sharding = NamedSharding(mesh, st_specs)

    if n_state:
        @jax.jit
        def step(prev_b, curr_b, *state_b):
            prev_b = jax.lax.with_sharding_constraint(prev_b, in_sharding)
            curr_b = jax.lax.with_sharding_constraint(curr_b, in_sharding)
            state_b = tuple(
                jax.lax.with_sharding_constraint(s, st_sharding)
                for s in state_b)
            return smapped(prev_b, curr_b, *state_b)
    else:
        @jax.jit
        def step(prev_b, curr_b):
            prev_b = jax.lax.with_sharding_constraint(prev_b, in_sharding)
            curr_b = jax.lax.with_sharding_constraint(curr_b, in_sharding)
            return smapped(prev_b, curr_b)

    return step


def _q_ext_height(cfg: EngineConfig, sp: int) -> int:
    """Rows of one shard's halo-extended frame in q_feed mode (learned
    mode uses the un-doubled HALO; validated divisible upstream)."""
    return cfg.input_height // sp + 2 * HALO


def sharded_q_shapes(cfg: EngineConfig, sp: int, model_params):
    """Shape/dtype structs of ONE batch element's sharded stream cache as
    the GLOBAL (row-stacked across sp) arrays a q_feed step threads:
    v3 -> (quarter frame, encoder features), v2 -> (quarter frame,).
    Derived by eval_shape of the same functions the step runs, so dtype
    and feature width track the head, not a hardcoded table."""
    from tpufg.kernels.common import round_up
    from tpufg.models import rife
    ext_h = _q_ext_height(cfg, sp)
    wp = round_up(cfg.input_width, 16)
    frame = jax.ShapeDtypeStruct((1, 4, ext_h, wp), F32)
    q4 = jax.eval_shape(rife._down4_mean, frame)
    stack = lambda s: jax.ShapeDtypeStruct((s.shape[1], sp * s.shape[2],
                                            s.shape[3]), s.dtype)
    if not rife.is_v3(model_params):
        return (stack(q4),)
    f4 = jax.eval_shape(
        lambda x: rife.encode3(model_params, x, dtype=jnp.bfloat16), frame)
    return (stack(q4), stack(f4))


def make_sharded_q_init(mesh: Mesh, cfg: EngineConfig,
                        model_params) -> Callable:
    """Jit'd [B, H, W, 4] uint8 frame -> the sharded stream-cache seed
    for ``make_sharded_interp_step(..., q_feed=True)``.

    Replicates the sharded learned path EXACTLY — frames_to_planar ->
    frame-level halo exchange -> edge pad W to the 16-px lattice ->
    _down4_mean (+ encode3 for v3) — so seeding a q_feed step with it is
    bitwise-identical to the step computing prev's cache itself (the
    single-chip analog is pipeline.make_q_init)."""
    from tpufg.engine.pipeline import _edge_pad_chw
    from tpufg.kernels.common import round_up
    from tpufg.models import rife
    v3 = rife.is_v3(model_params)
    wp = round_up(cfg.input_width, 16)
    ext_h = _q_ext_height(cfg, mesh.shape["sp"])

    def shard_init(frame_u8):
        p = frames_to_planar(frame_u8, F32)
        p_ext = halo_exchange_rows(p, "sp", HALO)
        pp = _edge_pad_chw(p_ext, ext_h, wp)[None]
        q4 = rife._down4_mean(pp)[0]
        if not v3:
            return (q4,)
        return (q4, rife.encode3(model_params, pp,
                                 dtype=jnp.bfloat16)[0])

    specs = P("dp", "sp", None, None)
    st_specs = P("dp", None, "sp", None)
    n_out = 2 if v3 else 1
    smapped = shard_map(
        jax.vmap(shard_init), mesh=mesh,
        in_specs=(specs,), out_specs=(st_specs,) * n_out,
        check_vma=False)

    in_sharding = NamedSharding(mesh, specs)

    @jax.jit
    def q_init(frame_b):
        frame_b = jax.lax.with_sharding_constraint(frame_b, in_sharding)
        return smapped(frame_b)

    return q_init


def sharded_mv_lattice_shape(cfg: EngineConfig) -> tuple[int, int, int]:
    """Shape of the temporal MV state threaded through a TEMPORAL sharded
    step (batch dim excluded): the full-frame 16-px lattice at the width
    interp_planar pads to.  Rows need no extra padding — the sharded step
    already requires the height on the shard lattice."""
    from tpufg.kernels.common import round_up
    return (2, cfg.input_height // 16, round_up(cfg.input_width, 64) // 16)


def pad_to_shard_lattice(h: int, sp: int, temporal: bool = False) -> int:
    """Smallest height >= h divisible by sp*halo (frames edge-padded to
    this before sharding; outputs cropped back).  Temporal mode doubles
    the halo (seeded-search reach)."""
    lat = sp * (2 * HALO if temporal else HALO)
    return ((h + lat - 1) // lat) * lat
