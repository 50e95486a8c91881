"""Exhaustive block-matching motion search on the MV lattice (Pallas, Triton).

The reference's ``motion.comp`` (shaders/motion.comp:16-57, dispatched at
src/frame_manager.cpp:323-344 with blockSize=8, searchRadius=16) scores, per
output pixel, every displacement in the (2r+1)^2 square by an 8x8 block sum
of per-pixel RGBA Euclidean distances.  The engine consumes one vector per
``grid x grid`` lattice cell (the block centre), so this kernel evaluates
the search only at those sites.

Layout: one program owns ``S`` neighbouring sites of one lattice row; a
program-local ``[S, DX]`` tensor holds one lane per (site, horizontal
displacement), DX being the next power of two above 2r+1.  A loop inside
the program walks the vertical displacements; for each it accumulates the
block cost over the b*b block pixels in the shader's y-outer/x-inner order
(a loop over block rows, the b columns unrolled),
each term the channel-ordered Euclidean distance of a curr pixel (one value
per site, broadcast over the lanes) to the clamped prev pixel the lane
reads.  Lanes of one site read neighbouring prev columns, so the loads
coalesce, and the (b + 2r)^2 prev window of a site stays in L1 across the
candidate loop.  A final cross-lane reduction picks the per-site argmin.

Conventions (identical to the oracle, tpufg.ops.oracle.motion_search):
the prev fetch is clamp-to-edge; block pixels at lattice sites never leave
the frame (H, W are lattice multiples and b <= grid), so no term is dropped;
costs accumulate in the y-outer/x-inner order, the argmin is strict ``<``
over the dy-outer/dx-inner scan from -r to r, first found winning a tie.
The MV field is therefore bitwise the oracle's at the lattice sites.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from tpufg.kernels.common import cdiv, use_interpret

F32 = jnp.float32


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


NUM_WARPS = 4


def sites_plan(n_sites: int, search_radius: int) -> tuple[int, int]:
    """(sites per program S, dx lanes DX): DX is the power of two above
    2r+1, and S gives each of the program's 32*NUM_WARPS threads about
    two (site, dx) lanes whatever the radius (the fastest of the tiles
    timed at 1080p r=16, see PERF.md)."""
    dx = _next_pow2(2 * int(search_radius) + 1)
    s = max(1, (64 * NUM_WARPS) // dx)
    return min(_next_pow2(n_sites), s), dx


def _sites_kernel(prev_ref, curr_ref, out_ref, *, H, W, r, b, g, n_ch,
                  n_sites, S, DX):
    k = pl.program_id(0)
    t = pl.program_id(1)
    anchor = b // 2
    n_dx = 2 * r + 1

    site = jnp.minimum(t * S + jax.lax.broadcasted_iota(jnp.int32, (S,), 0),
                       n_sites - 1)
    col0 = site * g + (g // 2 - anchor)                    # [S] block cols
    row0 = k * g + (g // 2 - anchor)                       # block top row
    lane = jax.lax.broadcasted_iota(jnp.int32, (S, DX), 1)  # dx + r
    # clamped prev columns per block column (dy-independent)
    xp = [jnp.clip(col0[:, None] + (bx - r) + lane, 0, W - 1)
          for bx in range(b)]

    def dy_body(dyi, carry):
        best_cost, best_dyi = carry

        def by_body(by, cost):                  # y outer — motion.comp:33
            y = row0 + by
            yp = jnp.clip(y + dyi - r, 0, H - 1)
            for bx in range(b):                 # x inner — motion.comp:34
                acc = None
                for c in range(n_ch):           # dot(d, d) channel order
                    cv = curr_ref[c, y, col0 + bx]               # [S]
                    pv = prev_ref[c, yp, xp[bx]]                 # [S, DX]
                    d = cv[:, None] - pv
                    acc = d * d if acc is None else acc + d * d
                cost = cost + jnp.sqrt(acc)
            return cost

        cost = jax.lax.fori_loop(0, b, by_body, jnp.zeros((S, DX), F32))
        upd = cost < best_cost                  # strict <: first found wins
        return (jnp.where(upd, cost, best_cost),
                jnp.where(upd, dyi, best_dyi))

    init = (jnp.full((S, DX), 1e10, F32),       # motion.comp:25
            jnp.zeros((S, DX), jnp.int32))
    best_cost, best_dyi = jax.lax.fori_loop(0, n_dx, dy_body, init)
    # first-found among the lanes: the smallest (dy, dx) at the min cost
    best_cost = jnp.where(lane < n_dx, best_cost, jnp.inf)
    c_min = jnp.min(best_cost, axis=1)
    key = jnp.where(best_cost == c_min[:, None], best_dyi * DX + lane,
                    jnp.int32(n_dx * DX))
    kmin = jnp.min(key, axis=1)
    out_ref[0, :] = (kmin % DX - r).astype(F32)
    out_ref[1, :] = (kmin // DX - r).astype(F32)


@functools.partial(
    jax.jit,
    static_argnames=("block_size", "search_radius", "grid", "interpret"),
)
def motion_search_sites(
    prev: jax.Array,
    curr: jax.Array,
    block_size: int = 8,
    search_radius: int = 16,
    grid: int = 16,
    interpret: bool | None = None,
) -> jax.Array:
    """Exhaustive block matching at the MV-lattice sites.

    ``prev``/``curr``: planar [C, H, W] (computed in f32); H and W must be
    multiples of ``grid``.  Returns f32 [2, H/grid, W/grid] (plane 0 = dx,
    plane 1 = dy, pixel units, backward flow: curr[q] ~= prev[q + mv]) —
    bitwise ``oracle.motion_search``'s field at pixels
    (grid//2 + grid*i, grid//2 + grid*j).  The program tile comes from
    :func:`sites_plan`.
    """
    b, r, g = int(block_size), int(search_radius), int(grid)
    if b > g or b % 2:
        raise ValueError(f"block_size {b} must be even and <= grid {g}")
    _, H, W = prev.shape
    if H % g or W % g:
        raise ValueError(f"frame {H}x{W} must be divisible by grid={g}")
    S, _ = sites_plan(W // g, r)
    return _sites_call(prev, curr, b, r, g, S, interpret)


def _sites_call(prev, curr, b: int, r: int, g: int, S: int,
                interpret: bool | None) -> jax.Array:
    """The Triton call with ``S`` sites per program (a power of two)."""
    if interpret is None:
        interpret = use_interpret()
    n_ch, H, W = prev.shape
    m, n = H // g, W // g
    DX = _next_pow2(2 * r + 1)
    n_t = cdiv(n, S)
    kernel = functools.partial(_sites_kernel, H=H, W=W, r=r, b=b, g=g,
                               n_ch=n_ch, n_sites=n, S=S, DX=DX)
    out = pl.pallas_call(
        kernel,
        grid=(m, n_t),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((2, None, S), lambda i, j: (0, i, j)),
        out_shape=jax.ShapeDtypeStruct((2, m, n_t * S), F32),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="motion_search_sites",
    )(prev.astype(F32), curr.astype(F32))
    return out[:, :, :n]
