"""Exhaustive-search Triton kernel vs the f32 oracle (CPU interpret mode)."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tests.conftest import random_frame
from tpufg.kernels.motion import _sites_call, motion_search_sites
from tpufg.ops import motion_search


def _pair(rng, h, w, sx, sy, pad=8):
    base = random_frame(rng, h + 2 * pad, w + 2 * pad)
    prev = base[pad : pad + h, pad : pad + w]
    curr = base[pad - sy : pad - sy + h, pad - sx : pad - sx + w]
    return jnp.asarray(prev), jnp.asarray(curr)


def _chw(x):
    return jnp.transpose(x, (2, 0, 1))


def _oracle_sites(prev_hwc, curr_hwc, b, r, g=16):
    ref = _chw(motion_search(prev_hwc, curr_hwc, block_size=b,
                             search_radius=r))
    return np.asarray(ref)[:, g // 2::g, g // 2::g]


class TestExactParity:
    @pytest.mark.parametrize("hw,shift,b,r", [
        ((32, 48), (3, 2), 4, 4),
        ((16, 16), (0, 0), 4, 2),
        ((48, 32), (-2, 3), 8, 4),   # taller than wide, b=8
        ((32, 160), (1, -1), 4, 2),  # more sites than one program holds
    ])
    def test_bitwise_equal_to_oracle(self, rng, hw, shift, b, r):
        prev, curr = _pair(rng, *hw, *shift)
        ref = _oracle_sites(prev, curr, b, r)
        out = motion_search_sites(_chw(prev), _chw(curr), block_size=b,
                                  search_radius=r)
        np.testing.assert_array_equal(np.asarray(out), ref)

    def test_constant_pair_tiebreak(self):
        # all-candidate tie: strict < keeps the first (-r,-r) — motion.comp:49
        const = jnp.full((4, 32, 32), 0.3, jnp.float32)
        mv = motion_search_sites(const, const, block_size=8, search_radius=2)
        np.testing.assert_array_equal(np.unique(np.asarray(mv)), [-2.0])


class TestUncorrelated:
    def test_bitwise_on_noise(self, rng):
        # no true match: the argmin rides on f32 rounding of the costs, so
        # only the oracle's exact accumulation order reproduces it
        prev = jnp.asarray(random_frame(rng, 32, 64))
        curr = jnp.asarray(random_frame(rng, 32, 64))
        ref = _oracle_sites(prev, curr, 8, 3)
        out = motion_search_sites(_chw(prev), _chw(curr), search_radius=3)
        np.testing.assert_array_equal(np.asarray(out), ref)


class TestBounds:
    def test_output_bounded_by_radius(self, rng):
        prev = _chw(jnp.asarray(random_frame(rng, 32, 48)))
        curr = _chw(jnp.asarray(random_frame(rng, 32, 48)))
        mv = np.asarray(motion_search_sites(prev, curr, block_size=8,
                                            search_radius=3))
        assert np.all(np.abs(mv) <= 3.0)
        assert mv.shape == (2, 2, 3)


class TestSitesKernel:
    """Lattice-site search at production block/grid, vs the oracle."""

    @pytest.mark.parametrize("hw,r", [((64, 256), 4), ((96, 384), 8)])
    def test_bitwise_vs_oracle_sites(self, rng, hw, r):
        h, w = hw
        prev = rng.random((h, w, 4)).astype(np.float32)
        curr = np.roll(prev, (3, -2), (0, 1))
        ref = _oracle_sites(jnp.asarray(prev), jnp.asarray(curr), 8, r)
        out = motion_search_sites(_chw(jnp.asarray(prev)),
                                  _chw(jnp.asarray(curr)), search_radius=r)
        np.testing.assert_array_equal(np.asarray(out), ref)

    def test_sites_tile_invariant(self, rng):
        prev = jnp.asarray(rng.random((4, 32, 128)).astype(np.float32))
        curr = jnp.asarray(np.roll(np.asarray(prev), 2, 2))
        # one site per program vs the planned tile (the last tile's
        # clamped tail sites included): the same field
        a = _sites_call(prev, curr, 8, 4, 16, 1, None)
        b = motion_search_sites(prev, curr, search_radius=4)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_unsupported_params_rejected(self):
        z = jnp.zeros((4, 64, 256), jnp.float32)
        with pytest.raises(ValueError, match="block_size"):
            motion_search_sites(z, z, block_size=32)
        with pytest.raises(ValueError, match="divisible by grid"):
            motion_search_sites(jnp.zeros((4, 72, 256), jnp.float32),
                                jnp.zeros((4, 72, 256), jnp.float32))

    def test_lowers_to_triton_for_cuda(self):
        # the compiled route: lowering for CUDA runs the Pallas->Triton
        # lowering in full (no card needed), at the 1080p lattice shape
        f = jax.jit(functools.partial(motion_search_sites, search_radius=16,
                                      interpret=False))
        x = jax.ShapeDtypeStruct((4, 1088, 1920), jnp.float32)
        text = f.trace(x, x).lower(lowering_platforms=("cuda",)).as_text()
        assert "__gpu$xla.gpu.triton" in text
