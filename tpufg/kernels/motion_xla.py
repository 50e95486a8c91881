"""Block-matching motion search in pure XLA.

The Triton kernel (tpufg.kernels.motion) is the full-radius search at the
MV-lattice sites (engine config 3).  :func:`motion_search_lattice` is the
pyramid's small-radius search at the same sites (candidates unrolled at
trace time, so it suits r <= 4).  :func:`motion_search_xla` is the
per-pixel search for the block sizes and radii the lattice paths do not
take: a loop over candidates, each a shifted window of the edge-padded
previous frame, a fused elementwise distance field and one additive
``reduce_window`` box-sum, so its program size does not grow with r.

Same conventions as the kernel/oracle: curr out-of-image block pixels
contribute nothing (zero padding of the distance field), prev clamp-to-edge
(edge padding), strict-< argmin in dy-outer/dx-inner scan order.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

F32 = jnp.float32


@functools.partial(
    jax.jit, static_argnames=("block_size", "search_radius", "metric"))
def motion_search_xla(
    prev: jax.Array,
    curr: jax.Array,
    block_size: int = 8,
    search_radius: int = 4,
    metric: str = "euclidean",
) -> jax.Array:
    """Exhaustive per-pixel search, XLA path: planar [C, H, W] -> f32
    [2, H, W] pixel-unit backward-flow MVs (oracle conventions; the box
    sum is separable, rows then x).

    ``metric``: "euclidean" is the shader's per-pixel RGBA distance
    (motion.comp:45 — sqrt per pixel); "ssd" drops the sqrt (sum of
    squared differences) — the standard codec cost, cheaper, usually an
    equally good or better argmin.  The production pyramid uses the
    euclidean lattice search (motion_search_lattice) for shader-metric
    consistency; "ssd" is available for experiments.
    """
    n_ch, h, w = prev.shape
    b = int(block_size)
    r = int(search_radius)
    anchor = b // 2
    prev = prev.astype(F32)
    curr = curr.astype(F32)

    prev_p = jnp.pad(prev, ((0, 0), (r, r), (r, r)), mode="edge")

    def box(x):
        # separable block box-sum anchored at pixel - anchor, zero outside
        pad = (anchor, b - 1 - anchor)
        x = jax.lax.reduce_window(x, F32(0.0), jax.lax.add,
                                  (b, 1), (1, 1), (pad, (0, 0)))
        return jax.lax.reduce_window(x, F32(0.0), jax.lax.add,
                                     (1, b), (1, 1), ((0, 0), pad))

    n_dx = 2 * r + 1

    def body(i, carry):
        best_cost, best_dx, best_dy = carry
        dyi, dxi = i // n_dx, i % n_dx   # dy outer, dx inner — motion.comp:27
        shifted = jax.lax.dynamic_slice(prev_p, (0, dyi, dxi), (n_ch, h, w))
        diff = curr - shifted
        acc = diff[0] * diff[0]
        for ci in range(1, n_ch):
            acc = acc + diff[ci] * diff[ci]
        dist = jnp.sqrt(acc) if metric == "euclidean" else acc
        cost = box(dist)
        upd = cost < best_cost           # strict <: first found wins
        return (jnp.where(upd, cost, best_cost),
                jnp.where(upd, (dxi - r).astype(F32), best_dx),
                jnp.where(upd, (dyi - r).astype(F32), best_dy))

    init = (jnp.full((h, w), 1e10, F32), jnp.zeros((h, w), F32),
            jnp.zeros((h, w), F32))
    _, best_dx, best_dy = jax.lax.fori_loop(0, n_dx * n_dx, body, init)
    return jnp.stack([best_dx, best_dy])


@functools.partial(
    jax.jit, static_argnames=("grid", "block_size", "search_radius", "bias",
                              "return_cost"))
def motion_search_lattice(
    prev: jax.Array,
    curr: jax.Array,
    grid: int = 16,
    block_size: int = 8,
    search_radius: int = 4,
    bias: float = 0.0,
    return_cost: bool = False,
) -> jax.Array:
    """Block-lattice exhaustive search: MVs only at block centers.

    The pyramid consumes one MV per ``grid x grid`` cell
    (models/pyramid.py), so computing the per-pixel field and subsampling
    wastes grid^2 = 256x the argmin work.  This evaluates candidates only
    at the lattice centers (grid*i + grid/2, grid*j + grid/2).

    When ``search_radius + block_size/2 <= grid/2`` every candidate's
    prev-frame block window stays inside the SAME grid cell as the curr
    block, so after one [C, Hb, g, Wb, g] reshape each candidate is a pair
    of static strided slices — no shifted image copies at all (the
    reference's ~70k reads/px become ~(b+2r)^2 reads per cell).

    Same conventions as motion_search_xla: Euclidean per-pixel distance,
    separable rows-then-x block sum in the same f32 accumulation order,
    strict-< argmin over the dy-outer/dx-inner scan — output is bitwise
    the subsampled motion_search_xla field.  Block windows at
    these centers never leave the image (blockStart = g/2 - b/2 >= 0), so
    the validity mask and clamp-to-edge halo never engage.

    ``prev``/``curr``: planar [C, H, W] with H, W divisible by ``grid``.
    Returns f32 [2, H/grid, W/grid] (plane 0 = dx, plane 1 = dy).
    """
    n_ch, h, w = prev.shape
    g = int(grid)
    b = int(block_size)
    r = int(search_radius)
    off = (g - b) // 2  # block start within its cell
    if h % g or w % g:
        raise ValueError(f"frame {h}x{w} not divisible by grid {g}")
    if off - r < 0 or off + b + r > g:
        raise ValueError(
            f"radius {r} leaves the grid cell (need r + b/2 <= g/2); "
            "use motion_search_xla")
    return _lattice_impl(prev, curr, g, b, r, bias, return_cost)


def _lattice_impl(prev, curr, g, b, r, bias, return_cost):
    """Unjitted search body (shared so callers can vmap it)."""
    n_ch, h, w = prev.shape
    off = (g - b) // 2
    hb, wb = h // g, w // g

    # [C, Hb, g, Wb, g]: one layout pass each, then only static slices
    prev_cells = prev.astype(F32).reshape(n_ch, hb, g, wb, g)
    curr_blk = curr.astype(F32).reshape(n_ch, hb, g, wb, g)[
        :, :, off:off + b, :, off:off + b]

    # ordered box-sum loops (not .sum() reductions) keep the bitwise tie
    # to motion_search_xla's accumulation order
    best_cost = jnp.full((hb, wb), 1e10, F32)
    best_dx = jnp.zeros((hb, wb), F32)
    best_dy = jnp.zeros((hb, wb), F32)
    for dy in range(-r, r + 1):          # dy outer — motion.comp:27
        for dx in range(-r, r + 1):      # dx inner — motion.comp:28
            shifted = prev_cells[:, :, off + dy:off + dy + b,
                                 :, off + dx:off + dx + b]
            d = curr_blk[0] - shifted[0]
            acc = d * d
            for ci in range(1, n_ch):
                d = curr_blk[ci] - shifted[ci]
                acc = acc + d * d
            dist = jnp.sqrt(acc)                      # [Hb, b, Wb, b]
            # separable box-sum, rows-then-x, sequential adds: bitwise
            # motion_search_xla's accumulation order
            rowsum = dist[:, 0]
            for ky in range(1, b):
                rowsum = rowsum + dist[:, ky]         # [Hb, Wb, b]
            cost = rowsum[..., 0]
            for kx in range(1, b):
                cost = cost + rowsum[..., kx]         # [Hb, Wb]
            if bias:
                # small-magnitude preference (codec zero/predictor bias):
                # on near-flat cost surfaces — the aperture problem, where
                # a dy shift trades off against a dx shift — the strict-<
                # scan otherwise locks onto arbitrary extreme candidates.
                # A static per-candidate penalty proportional to |d| snaps
                # those ties toward the smallest displacement (toward the
                # PREDICTOR in seeded/residual searches).  bias=0 (the
                # default) keeps the bitwise tie to motion_search_xla.
                cost = cost + F32(bias * (abs(dx) + abs(dy)))
            upd = cost < best_cost       # strict <: first found wins
            best_cost = jnp.where(upd, cost, best_cost)
            best_dx = jnp.where(upd, F32(dx), best_dx)
            best_dy = jnp.where(upd, F32(dy), best_dy)
    if return_cost:
        return jnp.stack([best_dx, best_dy]), best_cost
    return jnp.stack([best_dx, best_dy])
