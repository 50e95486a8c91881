"""Production block warp (warp_blend_matmul) vs the f32 oracle."""

import numpy as np
import jax.numpy as jnp
import pytest

from tests.conftest import random_frame
from tpufg.kernels.resize import box_downsample2
from tpufg.kernels.warp_matmul import warp_blend_matmul
from tpufg.ops import warp_blend


def _chw(x):
    return jnp.transpose(x, (2, 0, 1))


def _hwc(x):
    return jnp.transpose(x, (1, 2, 0))


def _oracle_block(prev, curr, mvb, t, g=16):
    """Per-pixel oracle with the block MV field upsampled block-constant."""
    mvp = jnp.transpose(jnp.repeat(jnp.repeat(mvb, g, axis=1), g, axis=2),
                        (1, 2, 0))
    return _chw(warp_blend(_hwc(prev), _hwc(curr), mvp, t))


@pytest.fixture
def frames(rng):
    return (jnp.asarray(random_frame(rng, 64, 256)).transpose(2, 0, 1),
            jnp.asarray(random_frame(rng, 64, 256)).transpose(2, 0, 1))


class TestWarpMatmul:
    @pytest.mark.parametrize("t", [0.0, 0.25, 0.5, 1.0])
    def test_matches_block_constant_oracle(self, rng, frames, t):
        prev, curr = frames
        mv = jnp.asarray(
            rng.uniform(-15, 15, (2, 4, 16)).astype(np.float32))
        a = warp_blend_matmul(prev, curr, mv, t)
        b = _oracle_block(prev, curr, mv, t)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)

    def test_matches_oracle_uniform(self, rng, frames):
        prev, curr = frames
        mvu = jnp.broadcast_to(
            jnp.array([3.25, -2.5], jnp.float32)[:, None, None], (2, 4, 16))
        mvp = jnp.broadcast_to(jnp.array([3.25, -2.5], jnp.float32),
                               (64, 256, 2))
        ref = _chw(warp_blend(jnp.transpose(prev, (1, 2, 0)),
                              jnp.transpose(curr, (1, 2, 0)), mvp, 0.5))
        out = warp_blend_matmul(prev, curr, mvu, 0.5)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)

    def test_single_mode_integer_shift(self, frames):
        prev, _ = frames
        mv = jnp.full((2, 4, 16), 4.0, jnp.float32)
        out = np.asarray(warp_blend_matmul(prev, prev, mv, single=True))
        ref = np.asarray(prev)
        np.testing.assert_allclose(out[:, :-4, :-4], ref[:, 4:, 4:], atol=1e-6)

    def test_non128_width_padding(self, rng):
        prev = jnp.asarray(rng.random((4, 64, 960), np.float32))
        curr = jnp.asarray(rng.random((4, 64, 960), np.float32))
        mv = jnp.asarray(rng.uniform(-5, 5, (2, 4, 60)).astype(np.float32))
        out = warp_blend_matmul(prev, curr, mv, 0.5)
        assert out.shape == (4, 64, 960)
        # the edge-pad + crop must not disturb the oracle's semantics.  The
        # oracle samples through normalized uv (x = u*960 - 0.5), whose f32
        # round trip moves sample positions by up to ulp(960) = 6e-5 px,
        # hence the bound (the block warp adds integer offsets exactly)
        ref = _oracle_block(prev, curr, mv, 0.5)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-4)

    def test_integer_offsets_bitwise(self, frames):
        """The integer fast path must be BITWISE the general path on even
        MVs at t=0.5 (x*1 + y*0 is exact), in both dtypes and modes."""
        prev, curr = frames
        rng = np.random.default_rng(3)
        mv = (rng.integers(-8, 9, (2, prev.shape[1] // 16,
                                   prev.shape[2] // 16)) * 2).astype(
                                       np.float32)
        for dt in (jnp.float32, jnp.bfloat16):
            a = warp_blend_matmul(prev, curr, jnp.asarray(mv), 0.5,
                                  dtype=dt)
            b = warp_blend_matmul(prev, curr, jnp.asarray(mv), 0.5,
                                  dtype=dt, integer_offsets=True)
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        # single mode with plain-integer MVs
        mvi = rng.integers(-8, 9, mv.shape).astype(np.float32)
        a = warp_blend_matmul(prev, prev, jnp.asarray(mvi), single=True)
        b = warp_blend_matmul(prev, prev, jnp.asarray(mvi), single=True,
                              integer_offsets=True)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_u8_exact_integer_domain_bitwise(self, frames):
        # with integer offsets + UNORM8-code frames, the bf16 path runs in
        # the centered-integer-code domain (every value exact in bf16) and
        # is BITWISE equal to f32 — the production identity-size config
        prev, curr = frames
        rng = np.random.default_rng(7)
        mv = (rng.integers(-8, 9, (2, prev.shape[1] // 16,
                                   prev.shape[2] // 16)) * 2).astype(
                                       np.float32)
        for occ in (False, True):
            a = warp_blend_matmul(prev, curr, jnp.asarray(mv), 0.5,
                                  dtype=jnp.float32, integer_offsets=True,
                                  u8_exact=True, occlusion=occ)
            b = warp_blend_matmul(prev, curr, jnp.asarray(mv), 0.5,
                                  dtype=jnp.bfloat16, integer_offsets=True,
                                  u8_exact=True, occlusion=occ)
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            if not occ:
                # the integer domain changes f32 results by at most the
                # centered-real pad's last-bit rounding
                c = warp_blend_matmul(prev, curr, jnp.asarray(mv), 0.5,
                                      dtype=jnp.float32,
                                      integer_offsets=True)
                assert float(jnp.max(jnp.abs(a - c))) < 1e-6

    def test_mc_fallback_kernel_level(self, frames):
        """mc_fallback: identical frames + zero MV is an exact no-op (the
        warped pair agrees perfectly, fallback weight 0 — and crossfade of
        equal frames would be the same anyway, so test a DISAGREEING pair
        region too: uncorrelated frames converge to the crossfade)."""
        prev, curr = frames
        mv0 = jnp.zeros((2, 4, 16), jnp.float32)
        a = warp_blend_matmul(prev, prev, mv0, 0.5)
        b = warp_blend_matmul(prev, prev, mv0, 0.5, mc_fallback=True)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
        # uncorrelated pair + a WRONG uniform MV: d_mc >> d_cf is not
        # possible pointwise everywhere, but rel >= FB_HI holds where the
        # warp misaligns uncorrelated noise — fallback must pull the
        # output toward the plain crossfade vs the non-fallback warp
        mv = jnp.full((2, 4, 16), 8.0, jnp.float32)
        cf = np.asarray(prev * 0.5 + curr * 0.5)
        out_mc = np.asarray(warp_blend_matmul(prev, curr, mv, 0.5))
        out_fb = np.asarray(warp_blend_matmul(prev, curr, mv, 0.5,
                                              mc_fallback=True))
        inner = (slice(None), slice(16, -16), slice(16, -16))
        gap_mc = np.abs(out_mc[inner] - cf[inner]).mean()
        gap_fb = np.abs(out_fb[inner] - cf[inner]).mean()
        assert gap_fb < 0.5 * gap_mc, (gap_fb, gap_mc)

    def test_bf16_close(self, frames):
        prev, curr = frames
        mv = jnp.full((2, 4, 16), 3.5, jnp.float32)
        a = warp_blend_matmul(prev, curr, mv, 0.5, dtype=jnp.bfloat16)
        b = warp_blend_matmul(prev, curr, mv, 0.5)
        assert float(jnp.max(jnp.abs(a - b))) < 0.02

    def test_bad_mv_shape_rejected(self, frames):
        prev, curr = frames
        with pytest.raises(ValueError):
            warp_blend_matmul(prev, curr, jnp.zeros((2, 3, 3)), 0.5)


class TestAgainstOracle:
    """The shapes and MV patterns the retired block-warp kernel's suite
    pinned, now held directly against the oracle (32x128 frames)."""

    @pytest.fixture
    def small(self, rng):
        return (_chw(jnp.asarray(random_frame(rng, 32, 128))),
                _chw(jnp.asarray(random_frame(rng, 32, 128))))

    @pytest.mark.parametrize("mvxy,t", [
        ((3.25, -2.5), 0.5),
        ((0.0, 0.0), 0.25),
        ((-7.75, 6.5), 0.75),
        ((16.0, -16.0), 0.5),   # full reference search radius
    ])
    def test_uniform_mv_matches_perpixel_oracle(self, small, mvxy, t):
        prev, curr = small
        mvb = jnp.broadcast_to(
            jnp.array(mvxy, jnp.float32)[:, None, None], (2, 2, 8))
        out = warp_blend_matmul(prev, curr, mvb, t)
        ref = _oracle_block(prev, curr, mvb, t)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   atol=1e-5)

    @pytest.mark.parametrize("t", [0.0, 1.0])
    def test_endpoint_factor_is_a_source_frame(self, small, t):
        prev, curr = small
        out = warp_blend_matmul(prev, curr, jnp.zeros((2, 2, 8)), t)
        np.testing.assert_allclose(np.asarray(out),
                                   np.asarray(curr if t else prev),
                                   atol=1e-6)

    def test_oob_transparent_black(self):
        # reference-radius motion at t=0.5 pushes border samples off-image
        ones = jnp.ones((4, 32, 128), jnp.float32)
        mv = jnp.full((2, 2, 8), 16.0, jnp.float32)
        out = np.asarray(warp_blend_matmul(ones, ones, mv, 0.5))
        assert out[:, 0, 0].max() <= 0.5 + 1e-6       # one tap blanked
        assert np.allclose(out[:, 16, 64], 1.0)       # interior intact
        ref = np.asarray(_oracle_block(ones, ones, mv, 0.5))
        np.testing.assert_allclose(out, ref, atol=1e-6)

    def test_varying_block_mvs(self, small):
        prev, curr = small
        mvb = jnp.asarray(np.random.default_rng(11).integers(
            -4, 5, size=(2, 2, 8)).astype(np.float32))
        out = warp_blend_matmul(prev, curr, mvb, 0.5)
        ref = _oracle_block(prev, curr, mvb, 0.5)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   atol=1e-5)

    def test_single_mode_integer_shift(self, small):
        prev, _ = small
        mv = jnp.full((2, 2, 8), 4.0, jnp.float32)
        out = np.asarray(warp_blend_matmul(prev, prev, mv, single=True))
        # interior: out[p] = prev[p + 4] (edge-clamped outside)
        np.testing.assert_allclose(out[:, :-4, :-4],
                                   np.asarray(prev)[:, 4:, 4:], atol=1e-6)


def _banded_box2(x):
    """The banded two-pass form Ry @ x @ Rx (0.5 taps), in numpy."""
    c, h, w = x.shape
    ry = np.zeros((h // 2, h), np.float32)
    ry[np.arange(h // 2), 2 * np.arange(h // 2)] = 0.5
    ry[np.arange(h // 2), 2 * np.arange(h // 2) + 1] = 0.5
    rx = np.zeros((w, w // 2), np.float32)
    rx[2 * np.arange(w // 2), np.arange(w // 2)] = 0.5
    rx[2 * np.arange(w // 2) + 1, np.arange(w // 2)] = 0.5
    return np.stack([ry @ x[i] @ rx for i in range(c)])


class TestBoxDownsample:
    @pytest.mark.parametrize("shape", [(4, 36, 150), (3, 2, 2),
                                       (1, 1088, 64)])
    def test_bitwise_vs_banded_formula(self, rng, shape):
        x = rng.random(shape).astype(np.float32)
        out = np.asarray(box_downsample2(jnp.asarray(x)))
        np.testing.assert_array_equal(out, _banded_box2(x))

    def test_bf16_keeps_dtype(self, rng):
        x = jnp.asarray(rng.random((4, 16, 32)).astype(np.float32))
        out = box_downsample2(x.astype(jnp.bfloat16))
        assert out.dtype == jnp.bfloat16 and out.shape == (4, 8, 16)
        ref = _banded_box2(np.asarray(x.astype(jnp.bfloat16), np.float32))
        np.testing.assert_allclose(np.asarray(out, np.float32), ref,
                                   atol=4e-3)

    def test_matches_reshape_mean(self, rng):
        x = jnp.asarray(rng.random((4, 36, 150), np.float32))
        ref = np.asarray(x).reshape(4, 18, 2, 75, 2).mean(axis=(2, 4))
        out = box_downsample2(x)
        np.testing.assert_allclose(np.asarray(out), ref, atol=1e-6)

    def test_odd_dims_rejected(self, rng):
        with pytest.raises(ValueError):
            box_downsample2(jnp.zeros((1, 7, 8)))


class TestSinglePrepareBanded:
    """warp_single_prepare + warp_single_banded == the inline single-mode
    warp, bitwise, in every value domain (centered reals f32/bf16,
    centered integer codes) — the split exists so k>2 learned tails pay
    the flow-independent pad+band construction once per frame."""

    @pytest.mark.parametrize("io,u8", [(False, False), (True, True),
                                       (True, False)])
    @pytest.mark.parametrize("dt", [jnp.float32, jnp.bfloat16])
    def test_bitwise_vs_inline(self, rng, io, u8, dt):
        from tpufg.kernels.warp_matmul import (warp_blend_matmul,
                                               warp_single_banded,
                                               warp_single_prepare)
        f = jnp.asarray(
            np.round(rng.random((4, 64, 256)).astype(np.float32) * 255)
            / np.float32(255))
        mv = rng.uniform(-8, 8, (2, 4, 16)).astype(np.float32)
        if io:
            mv = np.round(mv)
        mv = jnp.asarray(mv)
        kw = dict(block=16, search_radius=8, dtype=dt,
                  integer_offsets=io, u8_exact=u8)
        a = warp_blend_matmul(f, f, mv, single=True, **kw)
        b = warp_single_banded(warp_single_prepare(f, **kw), mv, **kw)
        assert np.array_equal(np.asarray(a), np.asarray(b))

    def test_geometry_mismatch_rejected(self, rng):
        from tpufg.kernels.warp_matmul import (warp_single_banded,
                                               warp_single_prepare)
        f = jnp.asarray(rng.random((4, 64, 256)).astype(np.float32))
        bands = warp_single_prepare(f, block=16, search_radius=8)
        mv = jnp.zeros((2, 4, 16), jnp.float32)
        with pytest.raises(ValueError, match="geometry"):
            warp_single_banded(bands, mv, block=16, search_radius=16)
