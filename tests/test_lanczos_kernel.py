"""Plain-XLA separable Lanczos resample vs the f32 oracle.

Covers SURVEY.md §4's kernel-parity matrix: odd and non-divisible sizes,
identity, up/down/non-uniform scaling, and the bf16 SSIM contract.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from tests.conftest import random_frame
from tpufg.kernels.lanczos import lanczos_scale_planar
from tpufg.ops import lanczos_scale
from tpufg.utils.quality import ssim


def _oracle_chw(img_chw, out_h, out_w):
    hwc = jnp.transpose(img_chw, (1, 2, 0))
    return jnp.transpose(lanczos_scale(hwc, out_h, out_w), (2, 0, 1))


def _rand_chw(rng, c, h, w):
    return jnp.asarray(
        rng.integers(0, 256, size=(c, h, w)).astype(np.float32) / 255.0
    )


@pytest.mark.parametrize(
    "in_hw,out_hw",
    [
        ((24, 40), (48, 80)),      # clean 2x
        ((24, 40), (24, 40)),      # identity
        ((37, 53), (19, 27)),      # odd downscale
        ((30, 50), (75, 33)),      # non-uniform (up y, down x)
        ((16, 16), (300, 300)),    # large ratio
        ((130, 258), (260, 516)),  # non-power-of-two 2x
    ],
)
def test_matches_oracle_f32(rng, in_hw, out_hw):
    img = _rand_chw(rng, 4, *in_hw)
    ref = _oracle_chw(img, *out_hw)
    out = lanczos_scale_planar(img, *out_hw)
    assert out.shape == ref.shape
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-6)


def test_bf16_ssim_contract(rng):
    img = _rand_chw(rng, 4, 72, 96)
    ref = np.asarray(_oracle_chw(img, 144, 192))
    out = np.asarray(
        lanczos_scale_planar(img.astype(jnp.bfloat16), 144, 192)
    )
    s = ssim(np.transpose(ref, (1, 2, 0)), np.transpose(out, (1, 2, 0)))
    assert s >= 0.999, f"bf16 SSIM {s} below contract"


def test_three_channel(rng):
    img = _rand_chw(rng, 3, 20, 36)
    ref = _oracle_chw(img, 40, 72)
    out = lanczos_scale_planar(img, 40, 72)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-6)


def test_constant_preserved(rng):
    img = jnp.full((4, 33, 47), 0.5, jnp.float32)
    out = lanczos_scale_planar(img, 66, 94)
    np.testing.assert_allclose(np.asarray(out), 0.5, atol=1e-5)


class TestPackedScale:
    """lanczos_scale_packed: scale + UNORM8 quantize + channel pack must
    emit the same bytes as planar_to_frames(lanczos_scale_planar(...))."""

    @pytest.mark.parametrize("in_hw,out_hw", [
        ((64, 96), (128, 192)),     # clean 2x
        ((50, 70), (173, 241)),     # ugly ratio
        ((128, 128), (96, 96)),     # downscale
    ])
    def test_matches_fast_plus_convert(self, rng, in_hw, out_hw):
        from tpufg.kernels.convert import planar_to_frames
        from tpufg.kernels.lanczos import lanczos_scale_packed

        img = _rand_chw(rng, 4, *in_hw)
        for dt in (jnp.float32, jnp.bfloat16):
            x = img.astype(dt)
            ref = np.asarray(planar_to_frames(
                lanczos_scale_planar(x, *out_hw)))
            got = np.asarray(lanczos_scale_packed(x, *out_hw))
            assert got.shape == (*out_hw, 4)
            # identical math per channel; the only permitted divergence is
            # 1-ulp accumulation from a different fusion
            d = np.abs(got.astype(int) - ref.astype(int))
            assert d.max() <= 1
            assert (d > 0).mean() < 1e-5

    def test_needs_four_channels(self, rng):
        from tpufg.kernels.lanczos import lanczos_scale_packed
        with pytest.raises(ValueError):
            lanczos_scale_packed(_rand_chw(rng, 3, 16, 16), 32, 32)


def test_raw_i32_is_the_uint8_bytes(rng):
    from tpufg.kernels.lanczos import lanczos_scale_packed
    img = _rand_chw(rng, 4, 30, 44)
    u8 = np.asarray(lanczos_scale_packed(img, 45, 66))
    i32 = np.asarray(lanczos_scale_packed(img, 45, 66, raw_i32=True))
    assert i32.dtype == np.int32 and i32.shape == (45, 66)
    np.testing.assert_array_equal(i32.view(np.uint8).reshape(45, 66, 4), u8)


@pytest.mark.parametrize("in_size,out_size", [(1080, 2160), (37, 19),
                                              (7, 300)])
def test_axis_taps_partition_of_unity(in_size, out_size):
    from tpufg.kernels.lanczos import axis_taps
    coords, w = axis_taps(in_size, out_size, 3)
    assert coords.shape == w.shape == (6, out_size)
    live = w != 0
    assert coords[live].min() >= 0 and coords[live].max() <= in_size - 1
    np.testing.assert_allclose(w.sum(axis=0), 1.0, atol=1e-6)


@pytest.mark.parametrize("in_size,out_size,phases", [
    (1080, 2160, 2), (1920, 3840, 2), (720, 1440, 2), (1080, 1620, 3),
    (2160, 1080, 1), (37, 19, None), (16, 300, None)])
def test_polyphase_plan(in_size, out_size, phases):
    """Small-phase ratios take strided slices; the plan reproduces every
    tap coordinate exactly, else the gather path is used."""
    from tpufg.kernels.lanczos import axis_taps, polyphase_plan
    plan = polyphase_plan(in_size, out_size, 3)
    if phases is None:
        assert plan is None
        return
    p, q, base = plan
    assert q == phases
    coords, _ = axis_taps(in_size, out_size, 3)
    j = np.arange(out_size)
    np.testing.assert_array_equal(
        coords, base[j % q].T + p * (j // q)[None, :])


def test_quantized_bytes_vs_oracle_only_at_ties(rng):
    """Packed bytes equal the oracle's quantized bytes except where the
    f32 value sits within rounding of a .5 quantization boundary."""
    from tpufg.kernels.lanczos import lanczos_scale_packed
    from tpufg.ops import quantize_unorm8
    img = _rand_chw(rng, 4, 40, 64)
    ref_f = np.asarray(_oracle_chw(img, 80, 128))
    ref = np.asarray(quantize_unorm8(jnp.asarray(
        np.transpose(ref_f, (1, 2, 0)))))
    got = np.asarray(lanczos_scale_packed(img, 80, 128))
    diff = got != ref
    frac = np.transpose(ref_f, (1, 2, 0)) * 255.0
    near_tie = np.abs(frac - np.floor(frac) - 0.5) < 1e-3
    assert not np.any(diff & ~near_tie)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
