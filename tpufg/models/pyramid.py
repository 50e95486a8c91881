"""Hierarchical pyramid motion search — the production motion path.

The reference's exhaustive per-pixel block matching (shaders/motion.comp,
(2r+1)^2 = 1089 candidates at full resolution) is a WIP placeholder whose
cost is quadratic in the search radius; it exists here as the parity path
(tpufg.kernels.motion, engine config 3).  The production path is the classic coarse-to-fine
pyramid (BASELINE.json config 5):

1. build a box-filtered image pyramid (2x per level);
2. exhaustive search at the coarsest level with a small radius (covers the
   same +-16 px full-res displacement at 1/2^L scale);
3. at each finer level: upsample the MV field 2x (values doubled), warp the
   previous frame by the estimate (block-granular warp), and run a
   small-radius residual search between the warped prev and curr; the
   residual is added to the estimate.

Cost: O(levels * small-radius^2) instead of O(radius^2) at full resolution —
~40x fewer candidate evaluations for the reference's r=16 at 3 levels.

Output is a block-granular MV field [2, H/G, W/G] in full-resolution pixel
units, backward flow (curr[q] ~= prev[q + m]) like motion.comp.  The engine
negates it before warping (reference bug #12, see ops/oracle.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from tpufg.kernels.motion_xla import motion_search_lattice, motion_search_xla
from tpufg.kernels.resize import box_downsample2
from tpufg.kernels.warp_matmul import warp_blend_matmul

F32 = jnp.float32

# max |temporal seed| in full-resolution pixels: bounds the seeded coarse
# warp's static halo (48/4 = 12 coarse px at the default 3 levels) and the
# production warp's range when --temporal-mv is on; 48 balances tracking
# range (~±70 px/frame total incl. the pyramid's own reach) against the
# one-hot/halo growth of the wider warp.
TEMPORAL_CLAMP = 48


def _lattice_ok(radius: int, block: int, grid: int) -> bool:
    """Lattice fast path applies when candidate windows stay in-cell."""
    off = (grid - block) // 2
    return off - radius >= 0 and off + block + radius <= grid


def _block_subsample(mv: jax.Array, g: int) -> jax.Array:
    """Per-pixel MV [2, H, W] -> block grid [2, H/g, W/g] (block centers)."""
    return mv[:, g // 2::g, g // 2::g]


def median_filter_mv(mv: jax.Array) -> jax.Array:
    """3x3 per-component median on the block-MV lattice (edge-replicated).

    The classic block-matching post-filter: a block whose best match is an
    outlier (flat/noisy texture, occlusion) gets snapped to its neighbors'
    consensus, removing isolated wrong vectors before they become warp
    artifacts.  The reference's WIP never got here (readme.md:85-92 —
    "Improve interpolation quality" unchecked); quality gain is gated by
    TestMotionQuality-style margins in tests/test_engine.py.
    """
    c, hb, wb = mv.shape
    p = jnp.pad(mv, ((0, 0), (1, 1), (1, 1)), mode="edge")
    taps = jnp.stack([p[:, i:i + hb, j:j + wb]
                      for i in range(3) for j in range(3)])
    return jnp.median(taps, axis=0).astype(mv.dtype)


@functools.partial(jax.jit, static_argnames=("grid", "search_radius",
                                             "bias", "iters", "dtype"))
def subpel_refine(prev: jax.Array, curr: jax.Array, mv: jax.Array,
                  grid: int = 16, search_radius: int = 16,
                  bias: float = 0.0, iters: int = 2,
                  dtype=jnp.float32) -> jax.Array:
    """Full-resolution ±1 px re-search + parabolic sub-pixel fit.

    The pyramid's MV field is integer-valued (and effectively 2-px
    quantized in the engine's latency mode, where the finest refine is
    skipped and level-1 integers are doubled).  On smoothly varying
    motion that quantization — not warp granularity — is the quality
    ceiling: the classic codec answer is half/quarter-pel refinement.

    Per MV site: warp ``prev`` by the current estimate (one block warp),
    evaluate the block cost (motion.comp:41-45's summed Euclidean RGBA
    distance over the site's grid cell) at the 3x3 integer offsets around
    it, take the argmin, then fit a 1-D parabola through the cost triple
    along each axis for the fractional minimum (frac = 0 at the 3x3 rim,
    where a neighbor is missing).  Nine fused full-frame difference maps +
    block-sum reductions — far cheaper than a dense search level.

    Returns the refined f32 field, same shape/units as ``mv``.
    """
    c, h, w = prev.shape
    g = int(grid)
    n_by, n_bx = h // g, w // g
    p32 = prev.astype(F32)
    c32 = curr.astype(F32)
    iy = jnp.arange(n_by)[:, None]
    ix = jnp.arange(n_bx)[None, :]

    def parab(cm, c0, cp):
        denom = cm - 2.0 * c0 + cp
        frac = jnp.where(denom > F32(1e-6),
                         F32(0.5) * (cm - cp) / denom, F32(0.0))
        return jnp.clip(frac, -0.5, 0.5)

    # ``iters`` rounds: when the integer re-search steps to the 3x3 rim
    # the parabola has no bracketing neighbor there (frac = 0, error up to
    # 0.5 px); the next round re-centers on the stepped estimate and fits
    # the fraction.  Two rounds reach quarter-pel-class accuracy.
    # the probe warp runs in single mode, so its reach is the FULL radius —
    # capped at the warp kernel's 54-px halo ceiling (halo <= 63 for the
    # 256-col window).  Vectors beyond 54 px (reachable only with
    # --temporal-mv, whose clamp+pyramid reach is 72) are clipped in the
    # probe alone: their 3x3 cost surface degrades and the refinement
    # contributes at most +-1.5 px/round there, while every in-reach site
    # refines exactly.  Without the cap, --subpel with --temporal-mv or
    # --search-radius > 54 failed at jit trace inside the warp kernel.
    r_probe = min(int(search_radius), 54)
    for _ in range(max(1, int(iters))):
        # ``dtype`` speeds the probe warp (bf16 in production): costs
        # only drive an argmin + parabola, which tolerate the rounding
        warped = warp_blend_matmul(p32, p32, mv, block=g,
                                   search_radius=r_probe,
                                   single=True, dtype=dtype)
        # pad by 1 so the ±1 shifted views are static slices
        wp = jnp.pad(warped, ((0, 0), (1, 1), (1, 1)), mode="edge")

        def cost(dy, dx):
            d = wp[:, 1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w] - c32
            # Euclidean color distance per pixel (motion.comp:44), summed
            # over the site's grid cell
            e = jnp.sqrt(jnp.maximum(jnp.sum(d * d, axis=0), F32(0.0)))
            c_ = e.reshape(n_by, g, n_bx, g).sum((1, 3))
            if bias:
                # same small-step preference as motion_search_lattice:
                # keep the current estimate on near-flat cost surfaces
                c_ = c_ + F32(bias * (abs(dx) + abs(dy)))
            return c_

        costs = jnp.stack([jnp.stack([cost(dy, dx) for dx in (-1, 0, 1)])
                           for dy in (-1, 0, 1)])         # [3, 3, by, bx]
        flat = costs.reshape(9, n_by, n_bx)
        best = jnp.argmin(flat, axis=0)                   # first-min ties
        by, bx = best // 3 - 1, best % 3 - 1              # integer offsets
        c0 = flat[best, iy, ix]

        def axis_frac(off_this, off_other, axis):
            # cost at (argmin +- 1) along `axis`, clamped at the 3x3 rim
            om = jnp.clip(off_this - 1, -1, 1)
            op = jnp.clip(off_this + 1, -1, 1)
            if axis == 0:
                cm = costs[om + 1, off_other + 1, iy, ix]
                cp = costs[op + 1, off_other + 1, iy, ix]
            else:
                cm = costs[off_other + 1, om + 1, iy, ix]
                cp = costs[off_other + 1, op + 1, iy, ix]
            interior = (off_this == 0)
            return jnp.where(interior, parab(cm, c0, cp), F32(0.0))

        fy = axis_frac(by, bx, 0)
        fx = axis_frac(bx, by, 1)
        mv = jnp.stack([mv[0] + bx.astype(F32) + fx,
                        mv[1] + by.astype(F32) + fy])
    return mv


@functools.partial(
    jax.jit,
    static_argnames=("levels", "base_radius", "refine_radius", "block_size",
                     "grid", "skip_finest_refine", "bias"),
)
def pyramid_motion_search(
    prev: jax.Array,
    curr: jax.Array,
    levels: int = 3,
    base_radius: int = 4,
    refine_radius: int = 2,
    block_size: int = 8,
    grid: int = 16,
    skip_finest_refine: int = 0,
    seed: jax.Array | None = None,
    bias: float = 0.0,
) -> jax.Array:
    """Coarse-to-fine block-matching motion estimation.

    ``prev``/``curr``: planar [C, H, W] f32; H, W must be divisible by
    ``grid * 2**(levels-1)``.  Returns f32 [2, H/grid, W/grid] pixel-unit
    backward-flow MVs on the ``grid``-granular block lattice.

    ``skip_finest_refine``: number of the finest levels whose residual
    search is skipped (MVs upsampled instead) — the streaming engine's
    latency mode uses 1 (full-res refinement is the single most expensive
    stage; MV granularity effectively halves, like half-pel codec search).

    ``seed``: optional temporal predictor — a full-resolution-lattice MV
    field [2, H/grid, W/grid] (e.g. the previous pair's result).  The
    coarsest level then warps by the downscaled seed and searches only the
    RESIDUAL, so total displacement is bounded by |seed| + the pyramid's
    own reach rather than the pyramid's reach alone — the classic codec
    temporal predictor, which lets the tracker lock onto motion faster
    than the per-pair search range.
    """
    c, h, w = prev.shape
    scale = grid * 2 ** (levels - 1)
    if h % scale or w % scale:
        raise ValueError(
            f"frame {h}x{w} must be divisible by grid*2^(levels-1) = {scale}"
        )

    pyr = [(prev.astype(F32), curr.astype(F32))]
    for _ in range(levels - 1):
        p, q = pyr[-1]
        pyr.append((box_downsample2(p), box_downsample2(q)))

    # coarsest level: exhaustive small-radius search subsampled to the
    # block grid.  The lattice path evaluates candidates only at the grid
    # centers the pyramid consumes (256x less argmin work than the
    # per-pixel search); the per-pixel XLA search (motion_search_xla) is
    # the fallback for radii whose windows leave the grid cell.
    p0, q0 = pyr[-1]
    seed_c = None
    if seed is not None:
        # full-res lattice -> coarse lattice: mean over 2^(L-1)-cell
        # groups (smooth), values scaled to coarse-level pixel units and
        # clamped to the warp's static reach (TEMPORAL_CLAMP full-res px)
        f = 2 ** (levels - 1)
        hb, wb = seed.shape[1] // f, seed.shape[2] // f
        r_c = max(TEMPORAL_CLAMP // f, 1)
        seed_c = jnp.clip(
            seed.astype(F32).reshape(2, hb, f, wb, f).mean((2, 4)) / F32(f),
            -r_c, r_c)
        p0 = warp_blend_matmul(p0, p0, seed_c, block=grid,
                               search_radius=r_c, single=True)
    if _lattice_ok(base_radius, block_size, grid):
        mv = motion_search_lattice(
            p0, q0, grid=grid, block_size=block_size,
            search_radius=base_radius, bias=bias)
    else:
        mv_px = motion_search_xla(p0, q0, block_size=block_size,
                                  search_radius=base_radius)
        mv = _block_subsample(mv_px, grid)
    if seed_c is not None:
        mv = mv + seed_c  # residual + predictor, both in coarse-level px

    if seed is not None:
        # each executed refine level warps by the running estimate, whose
        # reach includes the temporal clamp: check the actual per-level
        # radius against the warp kernel's halo ceiling (eff_r <= 54,
        # kernels/warp_matmul.py 256-col window) instead of a level-count
        # heuristic, so every seeded config that would fail deep inside
        # warp_blend_matmul gets this descriptive error instead
        for _lvl in range(levels - 2, -1, -1):
            if _lvl < skip_finest_refine:
                continue
            _reach = base_radius * 2 ** (levels - 1 - _lvl) + \
                sum(refine_radius * 2 ** k for k in range(levels - 1 - _lvl))
            _reach += TEMPORAL_CLAMP // 2 ** _lvl
            if _reach > 54:
                raise ValueError(
                    "temporal seeding: the level-"
                    f"{_lvl} refine warp reach ({_reach} px) exceeds the "
                    "warp kernel's halo range (54 px); raise "
                    "skip_finest_refine (the engine uses 1)")

    for lvl in range(levels - 2, -1, -1):
        p_l, q_l = pyr[lvl]
        # upsample MV grid 2x: same block lattice at the finer level
        mv = jnp.repeat(jnp.repeat(mv, 2, axis=1), 2, axis=2) * F32(2.0)
        if lvl < skip_finest_refine:
            continue
        max_disp = base_radius * 2 ** (levels - 1 - lvl) + \
            sum(refine_radius * 2 ** k for k in range(levels - 1 - lvl))
        if seed is not None:
            # seeded MVs carry up to TEMPORAL_CLAMP full-res px on top of
            # the pyramid's own reach (level-lvl pixel units here)
            max_disp += TEMPORAL_CLAMP // 2 ** lvl
        # warp prev by the current estimate, then search the residual.
        # Unseeded refine MVs are integers (lattice results doubled per
        # level), so the single-warp takes the exact integer fast path.
        warped = warp_blend_matmul(
            p_l, p_l, mv, block=grid, search_radius=max(int(max_disp), 1),
            single=True, integer_offsets=seed is None,
        )
        if _lattice_ok(refine_radius, block_size, grid):
            res = motion_search_lattice(
                warped, q_l, grid=grid, block_size=block_size,
                search_radius=refine_radius, bias=bias)
        else:
            res_px = motion_search_xla(warped, q_l, block_size=block_size,
                                       search_radius=refine_radius)
            res = _block_subsample(res_px, grid)
        mv = mv + res
    return mv
