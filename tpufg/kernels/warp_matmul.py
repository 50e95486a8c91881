"""Block-granular warp+blend as fused one-hot shifts (pure XLA).

Production warp path.  The per-block warp of interpolate.comp becomes a
few dozen LARGE fused operations instead of many small per-block ones:

  - frames are viewed as overlapping 16-row bands (each band's blocks can
    reach +-halo rows, so bands duplicate rows ~3.5x — inherent to
    separable per-block warping);
  - the horizontal shift is a pair of batched einsums against per-column
    two-banded shift matrices; the vertical shift is a one-hot
    accumulation over the 2r+1 possible offsets: for each offset, a static
    slice pair is bilinearly lerped and masked by (block_shift == offset),
    which XLA fuses into one elementwise traversal;
  - OOB transparent-black masking and the t-blend are fused elementwise.

Matches the oracle to f32 rounding.  Semantics identical:
MV in pixel units, forward flow, clamp-to-edge taps, uv-outside-[0,1]
blanked (interpolate.comp:15-22, 34-38).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpufg.kernels.common import round_up

F32 = jnp.float32

# occlusion-blend response: k=0 below OCC_D0 mean-abs disagreement
# ([0,1] units), saturating to a hard side-pick over 1/OCC_SLOPE
# (thresholds tuned on the occluding-box content in tests/test_engine.py)
OCC_D0 = 0.08
OCC_SLOPE = 8.0

# adaptive MC->crossfade fallback response (mc_fallback=True): per 8x8
# cell, the warped pair's photometric disagreement is compared against the
# ZERO-MOTION disagreement |prev - curr| of the same cell.  Where warping
# does not reduce disagreement the motion is wrong (aperture traps,
# rotation, thin two-motion blocks) and a crossfade has strictly lower
# expected pointwise error; where warping clearly helps, MC keeps its
# structural advantage.  rel = D_mc / (D_cf + FB_FLOOR): full MC at
# rel <= FB_LO, full crossfade at rel >= FB_HI, linear between.  FB_FLOOR
# (~4 LSB) keeps noise in near-static cells from triggering the fallback.
FB_FLOOR = 0.015
FB_LO = 0.5
FB_HI = 1.0


def _build_bands(ext, *, g, halo, n_by, dtype, max_off):
    """Flow-independent overlapping row bands of an edge-padded frame.

    Band ``by`` covers ext rows [by*g, by*g + g + 2*halo) = global
    [by*g - halo, by*g + g + halo), built from g-row groups with shifted
    slices + concat (a plain gather would materialize every band row),
    then trimmed to the 8-aligned window the vertical pass actually reads
    (17% less band/einsum traffic at the default halo=16, eff_r=8).

    Factored out of :func:`_warp_one` so single-mode callers can compute
    it ONCE per frame and reuse it across several flow fields — a k-fps-
    multiplying learned tail warps the same pair at k-1 time points.  XLA
    may CSE the identical prep subgraphs on its own; the explicit split
    makes the sharing deterministic instead of an optimizer courtesy.
    Returns (bands [C, n_by, R', We], band_rows, halo_v).
    """
    c = ext.shape[0]
    we = ext.shape[-1]
    band_rows = g + 2 * halo  # rows a band's blocks reach (|off|<=halo-1)
    n_seg = band_rows // g
    assert band_rows % g == 0 and ext.shape[1] % g == 0
    groups = ext.astype(dtype).reshape(c, ext.shape[1] // g, g, we)
    lo = max(0, (halo - max_off) // 8 * 8)
    hi = min(band_rows, -(-(halo + max_off + g + 1) // 8) * 8)
    halo_v = halo - lo             # vertical-slice origin within bands
    # one joint band tensor, segment slices taken afterwards (banding the
    # two 128-col segments separately would duplicate the concat reads)
    bands = jnp.concatenate(
        [groups[:, i:i + n_by] for i in range(n_seg)], axis=2
    )[:, :, lo:hi]                                        # [C, n_by, R', We]
    return bands, hi - lo, halo_v


def _warp_one(ext, ix0, fx, iy0, fy, *, g, halo, n_by, n_bx, h, w,
              dtype, prec, max_off, integer_offsets=False,
              obmc=False, halo_r=None, bands=None):
    """Warp one frame by per-block offsets (prev and curr are two calls:
    a leading frame axis would force layout copies of the stacked pair).

    ext: [C, H + 2*halo_rows, W'] edge-padded planar frame (compute dtype);
    halo_rows is ``halo`` (block mode) or ``halo_r`` (obmc mode).
    ix0/iy0: [n_by, n_bx] int32 floor offsets; fx/fy fractions.
    Returns [C, H, W].

    ``integer_offsets``: caller-guaranteed fx == fy == 0 (the pyramid's
    latency-mode MVs are even, so at t=0.5 each frame's offsets are exact
    integers): the shift matrices collapse to a single 0/1 band and the
    vertical pass to a pure select — no lerp, no second row read.

    ``obmc``: per-pixel-MV mode (interpolate.comp:30-31's bilinear MV
    read).  ix0/fx/iy0/fy are then PER-COLUMN [n_by, W] offsets — the MV
    lattice bilinearly interpolated along x at each band's own lattice
    row — and each band warps the 2g rows its MV site influences (bands
    centered on lattice sites, i.e. offset g/2 from block alignment).
    The final output row blends the two overlapping bands with linear
    cell-centered weights: exact bilinear-MV warping along x, overlapped
    block motion compensation (value-domain bilinear) along y.  The
    structure is identical — the horizontal shift matrices were already
    per-column and the vertical one-hot mask per-(band, column); only the
    band geometry and the final blend differ.

    ``bands``: optional precomputed (bands, band_rows, halo_v) from
    :func:`_build_bands` (non-obmc only); ``ext`` may then be None.
    """
    src = ext if bands is None else bands[0]
    c = src.shape[0]
    we = src.shape[-1]
    one = jnp.asarray(1.0, dtype)
    zero = jnp.asarray(0.0, dtype)

    if obmc:
        assert bands is None  # per-column geometry; no precomputed form
        # bands of 2g output rows centered on MV sites (c_j = j*g + g/2),
        # built from 8-row groups at stride g (origin j*g + lo)
        hr = halo_r
        h_g = 8                        # 8-row group height
        out_rows = 2 * g
        lo = max(0, (hr - g // 2 - max_off) // 8 * 8)
        hi = -(-(hr + 3 * g // 2 + max_off + 1) // 8) * 8
        assert hi <= g + 2 * hr and ext.shape[1] % h_g == 0, (hi, g, hr)
        assert g % h_g == 0
        band_rows = hi - lo
        halo_v = hr - g // 2 - lo      # local row of band-output row 0
        groups = ext.astype(dtype).reshape(c, ext.shape[1] // h_g, h_g, we)
        step = g // h_g                # groups per band stride
        g0 = lo // h_g
        bands = jnp.concatenate(
            [groups[:, g0 + i: g0 + i + step * (n_by - 1) + 1: step]
             for i in range(band_rows // h_g)], axis=2)    # [C,n_by,R',We]
        sx, fxc = ix0, fx              # already per-column [n_by, W]
    else:
        out_rows = g
        # overlapping row bands (see _build_bands); precomputed and reused
        # across flow fields when the caller warps the same frame several
        # times (warp_single_prepare / warp_single_banded)
        if bands is None:
            bands, band_rows, halo_v = _build_bands(
                ext, g=g, halo=halo, n_by=n_by, dtype=dtype, max_off=max_off)
        else:
            bands, band_rows, halo_v = bands

        sx = jnp.repeat(ix0, g, axis=1)                   # [n_by, W]
        fxc = jnp.repeat(fx, g, axis=1)

    # --- horizontal: per-column 2-banded shift matrices.  Output col tile t
    # (128 wide) reads ext cols [t*128+1, t*128+128+2*halo) — a 256 window,
    # split into its two aligned 128-col segments -> two big batched
    # einsums (column-shifted slices along the contiguous axis fuse poorly)
    n_tx = w // 128
    span = 256
    ii = jax.lax.broadcasted_iota(jnp.int32, (span, 128), 0)
    jj = jax.lax.broadcasted_iota(jnp.int32, (span, 128), 1)
    d = ii - jj - halo                                    # [256, 128]
    sh = jnp.transpose(sx.reshape(n_by, n_tx, 128), (1, 0, 2))[:, :, None, :]
    fr = jnp.transpose(fxc.reshape(n_by, n_tx, 128),
                       (1, 0, 2))[:, :, None, :].astype(dtype)
    # built directly in the compute dtype: an f32 [n_tx,n_by,256,128]
    # intermediate + convert would move ~134 MB at 1080p for a matrix the
    # einsum reads in the compute dtype anyway
    if integer_offsets:
        s_full = jnp.where(d[None, None] == sh, one, zero)
    else:
        s_full = (jnp.where(d[None, None] == sh, one - fr, zero)
                  + jnp.where(d[None, None] == sh + 1, fr, zero))
    segs = bands.reshape(c, n_by, band_rows, n_tx + 1, 128)
    segs0 = segs[..., :-1, :]
    segs1 = segs[..., 1:, :]
    # einsums emit the compute dtype: each element is f32-accumulated
    # then rounded once; only outputs whose 2-tap window spans
    # the segment boundary (<= 2 cols per 128) pick up a second rounding
    # from the cross-segment add (<= 1 ulp; f32 path unchanged — dtype=F32
    # makes this identical to an f32 accumulate)
    hx = (jnp.einsum("cbrtw,tbwj->cbrtj", segs0,
                     s_full[:, :, :128, :], precision=prec,
                     preferred_element_type=dtype)
          + jnp.einsum("cbrtw,tbwj->cbrtj", segs1,
                       s_full[:, :, 128:, :], precision=prec,
                       preferred_element_type=dtype))
    hx = hx.reshape(c, n_by, band_rows, w)                # [C, n_by, R, W]

    # --- vertical: one-hot accumulation over the possible integer offsets,
    # slicing rows (fuses into one traversal; a batched-matmul form would
    # be 8k tiny [16,64]@[64,64] products).  Runs in the compute dtype:
    # with centered operands bf16 costs <= 1/2^10 here.
    # accumulate in the compute dtype: exactly ONE delta fires per element
    # (iy0 is a single integer in [-max_off, max_off]), so the "sum" is a
    # select chain — bf16 accumulation is exact (terms are already
    # bf16-rounded) and drops a per-delta convert
    if obmc:
        iy0c = iy0[None, :, None, :]                      # [1,n_by,1,W]
        fyc = fy[None, :, None, :].astype(dtype)
    else:
        iy0c = jnp.repeat(iy0, g, axis=1)[None, :, None, :]
        fyc = jnp.repeat(fy, g, axis=1)[None, :, None, :].astype(dtype)
    out = jnp.zeros((c, n_by, out_rows, w), dtype)
    for delta in range(-max_off, max_off + 1):
        m = (iy0c == delta)
        rows0 = hx[:, :, halo_v + delta: halo_v + delta + out_rows, :]
        if integer_offsets:
            sel = rows0
        else:
            rows1 = hx[:, :, halo_v + delta + 1:
                       halo_v + delta + out_rows + 1, :]
            sel = rows0 * (one - fyc) + rows1 * fyc
        out = out + jnp.where(m, sel, zero)
    if not obmc:
        return out.reshape(c, h, w).astype(F32)
    # --- obmc assembly: output row y between MV site centers c_j and
    # c_{j+1} blends band j (local row g+k) and band j+1 (local row k)
    # with the cell-centered linear weight t = (k + 0.5)/g — the value-
    # domain counterpart of the shader's bilinear MV read; rows above the
    # first / below the last site clamp to the edge band (the MV texture's
    # clamp-to-edge in interpolate.comp).
    t_y = ((jnp.arange(g, dtype=F32) + F32(0.5)) / F32(g)).astype(dtype)
    wy = t_y[None, None, :, None]
    top = out[:, 0, g // 2: g, :]                         # rows [0, g/2)
    mid = (out[:, :-1, g:, :] * (one - wy) + out[:, 1:, :g, :] * wy)
    mid = mid.reshape(c, (n_by - 1) * g, w)
    bot = out[:, -1, g: g + g // 2, :]                    # last g/2 rows
    return jnp.concatenate([top, mid, bot], axis=1).astype(F32)


@functools.partial(
    jax.jit,
    static_argnames=("factor", "block", "search_radius", "single", "dtype",
                     "occlusion", "integer_offsets", "bilinear", "u8_exact",
                     "mc_fallback", "_valid_w"),
)
def warp_blend_matmul(
    prev: jax.Array,
    curr: jax.Array,
    mv: jax.Array,
    factor: float = 0.5,
    block: int = 16,
    search_radius: int = 16,
    single: bool = False,
    dtype=jnp.float32,
    occlusion: bool = False,
    integer_offsets: bool = False,
    bilinear: bool = False,
    u8_exact: bool = False,
    mc_fallback: bool = False,
    _valid_w: int | None = None,
) -> jax.Array:
    """Motion-compensated blend (production XLA path).

    Planar [C, H, W] f32 frames, [2, H//block, W//block] pixel-unit
    forward-flow MVs; the oracle's semantics with the MV field read
    block-constant.
    ``dtype`` selects the matmul precision (bf16 for production).
    W must be a multiple of 128 and H of ``block``.

    ``occlusion``: occlusion-aware blending.  Where the two warped sources
    disagree photometrically, one of them is occluded (covered/revealed
    content exists in only one frame) and averaging produces a
    double-exposure ghost; instead the blend shifts toward the temporally
    closer frame.  Fused elementwise on the already-materialized warped
    pair.  Off by default (the shader spec blends
    unconditionally, interpolate.comp:38).

    ``mc_fallback``: adaptive per-cell fallback to a plain crossfade where
    motion compensation does not reduce photometric disagreement (FB_*
    constants; wrong-motion regions then degrade to the blur of a
    crossfade instead of structural ghosting — the pointwise-safer
    failure mode).  Off by default (a quality extension beyond
    interpolate.comp's unconditional blend).

    ``u8_exact``: caller-guaranteed frame values are exact UNORM8 codes
    (x == k/255 to f32 rounding — true for every engine frame).  With
    ``integer_offsets`` the warp is then a pure permutation of 255
    distinct codes, so the bf16 operands are built as CENTERED INTEGER
    codes (round(255x) − 128 ∈ [−128, 127] — every value exactly
    representable in bf16's 8 significant bits) instead of centered
    [−½, ½] reals: the one-hot matmuls and the vertical select move exact
    integers, and the production bf16 path becomes bitwise equal to f32
    at identical op count.  Ignored unless ``integer_offsets`` (fractional
    lerp weights would leave the integer domain immediately).
    """
    n_ch, h, w = prev.shape
    g = int(block)
    r = int(search_radius)
    if h % g or w % g:
        raise ValueError(f"frame {h}x{w}: H%{g} and W%{g} must be 0")
    if w % 128:
        # the segment einsums need 128-col tiling: edge-pad + crop
        wp = round_up(w, 128)
        pw = wp - w
        prev = jnp.pad(prev, ((0, 0), (0, 0), (0, pw)), mode="edge")
        curr = jnp.pad(curr, ((0, 0), (0, 0), (0, pw)), mode="edge")
        mv = jnp.pad(mv, ((0, 0), (0, 0), (0, pw // g)), mode="edge")
        out = warp_blend_matmul(prev, curr, mv, factor=factor, block=block,
                                search_radius=search_radius, single=single,
                                integer_offsets=integer_offsets,
                                bilinear=bilinear, u8_exact=u8_exact,
                                mc_fallback=mc_fallback,
                                dtype=dtype, occlusion=occlusion, _valid_w=w)
        return out[:, :, :w]
    n_by, n_bx = h // g, w // g
    if mv.shape != (2, n_by, n_bx):
        raise ValueError(f"mv shape {mv.shape} != (2, {n_by}, {n_bx})")
    # per-frame offsets are bounded by r*max(t, 1-t) in blend mode (each
    # frame warps only a fraction of the MV), r in single mode — the halo,
    # band height and one-hot range shrink accordingly (t=0.5 halves them)
    import math
    eff_r = r if single else max(1, int(math.ceil(
        r * max(float(factor), 1.0 - float(factor)))))
    halo = round_up(eff_r + 2, 8)
    while (2 * halo) % g:   # band construction needs g | 2*halo
        halo += 8
    if halo > 63:
        raise ValueError("search radius too large for the 256-col window")
    if bilinear and integer_offsets:
        raise ValueError("bilinear MV offsets are fractional by nature")
    if bilinear and g % 8:
        # obmc bands are built from 8-row groups
        raise ValueError(f"bilinear warp needs block % 8 == 0, got {g}")
    # obmc bands span 2g rows around MV sites: wider row halo (the column
    # halo — the 256-window constraint — is unchanged)
    halo_r = round_up(eff_r + g // 2 + 10, 8) if bilinear else halo
    prec = (jax.lax.Precision.HIGHEST if dtype == jnp.float32
            else jax.lax.Precision.DEFAULT)
    t = F32(factor)

    mdx = jnp.clip(mv[0].astype(F32), -r, r)
    mdy = jnp.clip(mv[1].astype(F32), -r, r)

    # applied for f32 too: the centered-real pad's x-1/2 can round in the
    # last bit (binade change), so the integer domain is both the exact
    # form AND what makes bf16 bitwise-equal to f32 here
    int_domain = bool(u8_exact) and integer_offsets

    def pad(x):
        # centered around 0: the warp is affine with unit weight sums, so
        # f(x - 1/2) + 1/2 == f(x) exactly — but bf16's absolute rounding
        # on [-1/2, 1/2] operands is half that on [0, 1].  Cast to the
        # compute dtype BEFORE the edge pad (identical values — the cast
        # previously happened on the padded tensor) so the f32 extended
        # frame never touches HBM.  int_domain: centered integer codes
        # instead — exact in bf16 (see u8_exact in the docstring).
        v = (jnp.round(x.astype(F32) * F32(255.0)) - F32(128.0)
             if int_domain else x.astype(F32) - F32(0.5))
        return jnp.pad(v.astype(dtype),
                       ((0, 0), (halo_r, halo_r), (halo, 128 - halo)),
                       mode="edge")

    def unscale(o):
        # back to [0,1]; int_domain divides like the dequantizer, so the
        # warped values are the same UNORM8 reads the f32 path carries
        return ((o + F32(128.0)) / F32(255.0) if int_domain
                else o + F32(0.5))

    def offsets(scale):
        ox = mdx * scale
        oy = mdy * scale
        if bilinear:
            # per-column offsets: the MV lattice bilinearly interpolated
            # along x (resize's half-cell-centered "linear" convention ==
            # MV sites at block centers, clamped at edges — exactly the
            # MV texture read of interpolate.comp:30-31 along this axis)
            ox = jax.image.resize(ox, (n_by, w), method="linear")
            oy = jax.image.resize(oy, (n_by, w), method="linear")
        ix0 = jnp.floor(ox)
        iy0 = jnp.floor(oy)
        return (ix0.astype(jnp.int32), ox - ix0,
                iy0.astype(jnp.int32), oy - iy0)

    def oob_mask(scale):
        # shader blanking: sample uv outside [0,1] -> 0 (interpolate.comp:17)
        if bilinear:
            fx_pp = jax.image.resize(mdx * scale, (h, w), method="linear")
            fy_pp = jax.image.resize(mdy * scale, (h, w), method="linear")
        else:
            fx_pp = jnp.repeat(mdx * scale, g, axis=1).repeat(g, axis=0)[:h, :w]
            fy_pp = jnp.repeat(mdy * scale, g, axis=1).repeat(g, axis=0)[:h, :w]
        px = jnp.arange(w, dtype=F32)[None, :] + fx_pp
        py = jnp.arange(h, dtype=F32)[:, None] + fy_pp
        ok = ((px >= -0.5) & (px <= valid_w - 0.5)
              & (py >= -0.5) & (py <= h - 0.5))
        return ok.astype(F32)[None]

    valid_w = _valid_w if _valid_w is not None else w
    kw = dict(g=g, halo=halo, n_by=n_by, n_bx=n_bx, h=h, w=w,
              integer_offsets=integer_offsets, obmc=bilinear, halo_r=halo_r,
              dtype=dtype, prec=prec, max_off=eff_r)
    if single:
        return unscale(_warp_one(pad(prev), *offsets(F32(1.0)), **kw))

    p_ext = pad(prev)
    c_ext = pad(curr)
    warped_p = unscale(_warp_one(p_ext, *offsets(-t), **kw))
    warped_c = unscale(_warp_one(c_ext, *offsets(F32(1.0) - t), **kw))
    mask_p = oob_mask(-t)
    mask_c = oob_mask(F32(1.0) - t)
    base = warped_p * mask_p * (F32(1.0) - t) + warped_c * mask_c * t
    out = base
    if occlusion:
        # photometric disagreement of the two warped sources ([0,1] units):
        # large -> covered/revealed content, averaging would double-expose
        d = jnp.mean(jnp.abs(warped_p - warped_c), axis=0, keepdims=True)
        k = jnp.clip((d - F32(OCC_D0)) * F32(OCC_SLOPE), F32(0.0), F32(1.0))
        chosen = (warped_p * mask_p if float(factor) <= 0.5
                  else warped_c * mask_c)
        out = base * (F32(1.0) - k) + chosen * k
    if not mc_fallback:
        return out
    # adaptive MC->crossfade fallback (see FB_* constants above): compare
    # the warped pair's disagreement against the zero-motion disagreement
    # per 8x8 cell (RGB channels only — constant alpha would dilute both).
    # Masked (OOB-blanked) samples read as large disagreement, so blanked
    # borders fall back to a crossfade instead of black — a deliberate
    # quality divergence from the shader's blanking, opt-in via the flag.
    nc = min(3, n_ch)
    d_mc = jnp.mean(jnp.abs(warped_p[:nc] * mask_p - warped_c[:nc] * mask_c),
                    axis=0, keepdims=True)
    d_cf = jnp.mean(jnp.abs(prev[:nc].astype(F32) - curr[:nc].astype(F32)),
                    axis=0, keepdims=True)
    if h % 8 == 0 and w % 8 == 0:
        def cell_mean(x):
            m = x.reshape(1, h // 8, 8, w // 8, 8).mean(axis=(2, 4))
            return jax.image.resize(m, (1, h, w), method="linear")
        d_mc, d_cf = cell_mean(d_mc), cell_mean(d_cf)
    rel = d_mc / (d_cf + F32(FB_FLOOR))
    wfb = jnp.clip((rel - F32(FB_LO)) / F32(FB_HI - FB_LO),
                   F32(0.0), F32(1.0))
    crossfade = (prev.astype(F32) * (F32(1.0) - t)
                 + curr.astype(F32) * t)
    return out * (F32(1.0) - wfb) + crossfade * wfb


def _single_halo(g: int, r: int) -> int:
    """Single-mode band halo (eff_r == r; warp_blend_matmul's derivation)."""
    halo = round_up(r + 2, 8)
    while (2 * halo) % g:   # band construction needs g | 2*halo
        halo += 8
    if halo > 63:
        raise ValueError("search radius too large for the 256-col window")
    return halo


@functools.partial(
    jax.jit,
    static_argnames=("block", "search_radius", "dtype", "integer_offsets",
                     "u8_exact"),
)
def warp_single_prepare(
    frame: jax.Array,
    block: int = 16,
    search_radius: int = 16,
    dtype=jnp.float32,
    integer_offsets: bool = False,
    u8_exact: bool = False,
) -> jax.Array:
    """FLOW-INDEPENDENT half of a single-mode warp: the centered, edge-
    padded, banded frame representation (``_build_bands``).

    ``warp_single_banded(warp_single_prepare(f, **kw), mv, **kw)`` is
    bitwise-identical to ``warp_blend_matmul(f, f, mv, single=True,
    **kw)`` — same ops in the same order, just split so a caller warping
    ONE frame by SEVERAL flow fields (the k-fps-multiplying learned tail:
    k-1 t-scaled flows per side) shares the pad+band construction by
    CONSTRUCTION instead of relying on XLA to CSE identical subgraphs
    (the per-t remainder is genuine work: distinct t-scaled flows need
    distinct one-hot shifts).

    Requires W % 128 == 0 (edge-pad the columns first — exactly what
    warp_blend_matmul does internally for other widths) and H % block
    == 0.  The same (block, search_radius, dtype, integer_offsets,
    u8_exact) must be passed to both halves: the banded layout and the
    value domain (centered reals vs centered integer codes) depend on
    them.
    """
    n_ch, h, w = frame.shape
    g = int(block)
    r = int(search_radius)
    if h % g or w % 128 or w % g:
        raise ValueError(f"frame {h}x{w}: need H%{g}==0, W%128==0, W%{g}==0")
    halo = _single_halo(g, r)
    int_domain = bool(u8_exact) and integer_offsets
    v = (jnp.round(frame.astype(F32) * F32(255.0)) - F32(128.0)
         if int_domain else frame.astype(F32) - F32(0.5))
    ext = jnp.pad(v.astype(dtype),
                  ((0, 0), (halo, halo), (halo, 128 - halo)), mode="edge")
    bands, _, _ = _build_bands(ext, g=g, halo=halo, n_by=h // g,
                               dtype=dtype, max_off=r)
    return bands


@functools.partial(
    jax.jit,
    static_argnames=("block", "search_radius", "dtype", "integer_offsets",
                     "u8_exact"),
)
def warp_single_banded(
    bands: jax.Array,
    mv: jax.Array,
    block: int = 16,
    search_radius: int = 16,
    dtype=jnp.float32,
    integer_offsets: bool = False,
    u8_exact: bool = False,
) -> jax.Array:
    """FLOW-DEPENDENT half of a single-mode warp on a precomputed banded
    frame (see :func:`warp_single_prepare` for the contract)."""
    g = int(block)
    r = int(search_radius)
    c, n_by, br, we = bands.shape
    w = we - 128
    h = n_by * g
    n_bx = w // g
    if mv.shape != (2, n_by, n_bx):
        raise ValueError(f"mv shape {mv.shape} != (2, {n_by}, {n_bx})")
    halo = _single_halo(g, r)
    # recompute _build_bands' trim geometry; validate against the tensor
    band_rows0 = g + 2 * halo
    lo = max(0, (halo - r) // 8 * 8)
    hi = min(band_rows0, -(-(halo + r + g + 1) // 8) * 8)
    if br != hi - lo:
        raise ValueError(
            f"bands rows {br} do not match block={g} search_radius={r} "
            f"geometry ({hi - lo})")
    halo_v = halo - lo
    prec = (jax.lax.Precision.HIGHEST if dtype == jnp.float32
            else jax.lax.Precision.DEFAULT)
    int_domain = bool(u8_exact) and integer_offsets
    mdx = jnp.clip(mv[0].astype(F32), -r, r)
    mdy = jnp.clip(mv[1].astype(F32), -r, r)
    ix0 = jnp.floor(mdx)
    iy0 = jnp.floor(mdy)
    out = _warp_one(None, ix0.astype(jnp.int32), mdx - ix0,
                    iy0.astype(jnp.int32), mdy - iy0,
                    g=g, halo=halo, n_by=n_by, n_bx=n_bx, h=h, w=w,
                    dtype=dtype, prec=prec, max_off=r,
                    integer_offsets=integer_offsets, obmc=False,
                    halo_r=halo, bands=(bands, br, halo_v))
    return ((out + F32(128.0)) / F32(255.0) if int_domain
            else out + F32(0.5))
