"""Streaming engine + pipeline integration (BASELINE configs on CPU)."""

import numpy as np
import jax.numpy as jnp
import pytest

from tpufg.config import EngineConfig, resolve_sizes
from tpufg.engine.pipeline import make_interp_step, make_scale_step
from tpufg.engine.runner import run_stream
from tpufg.io.sinks import NullSink
from tpufg.io.sources import SyntheticSource
from tpufg.ops import oracle
from tpufg.utils.quality import ssim


def _cfg(**kw):
    base = dict(input_width=64, input_height=64,
                output_width=128, output_height=128, dtype="f32")
    base.update(kw)
    return resolve_sizes(EngineConfig(**base))


class TestScaleStep:
    def test_matches_oracle(self, rng):
        # config 1: Lanczos-only path vs oracle through uint8 round-trip
        cfg = _cfg()
        step = make_scale_step(cfg)
        frame = rng.integers(0, 256, (64, 64, 4), dtype=np.uint8)
        out = np.asarray(step(jnp.asarray(frame)))
        ref = np.asarray(oracle.quantize_unorm8(oracle.lanczos_scale(
            oracle.dequantize_unorm8(jnp.asarray(frame)), 128, 128)))
        # fast path differs from oracle by ~1e-6 pre-quantization; allow
        # off-by-one codes at rounding boundaries
        diff = np.abs(out.astype(int) - ref.astype(int))
        assert diff.max() <= 1
        assert (diff > 0).mean() < 0.01

    def test_bf16_ssim(self, rng):
        cfg = _cfg(dtype="bf16")
        step = make_scale_step(cfg)
        frame = rng.integers(0, 256, (64, 64, 4), dtype=np.uint8)
        out = np.asarray(step(jnp.asarray(frame))).astype(np.float32) / 255.0
        ref = np.asarray(oracle.lanczos_scale(
            oracle.dequantize_unorm8(jnp.asarray(frame)), 128, 128))
        assert ssim(np.clip(ref, 0, 1), out) >= 0.999


class TestIdentitySize:
    def test_scale_step_equal_size_is_exact_identity(self, rng):
        # in == out: Lanczos taps are one-hot (sin(pi*k) = 0), the pipeline
        # skips the kernel, and the uint8 round-trip is exact
        cfg = _cfg(output_width=64, output_height=64)
        frame = rng.integers(0, 256, (64, 64, 4), dtype=np.uint8)
        out = np.asarray(make_scale_step(cfg)(jnp.asarray(frame)))
        np.testing.assert_array_equal(out, frame)

    def test_interp_step_equal_size_curr_passthrough(self, rng):
        cfg = _cfg(output_width=64, output_height=64, motion_mode="none")
        prev = rng.integers(0, 256, (64, 64, 4), dtype=np.uint8)
        curr = rng.integers(0, 256, (64, 64, 4), dtype=np.uint8)
        outs = make_interp_step(cfg)(jnp.asarray(prev), jnp.asarray(curr))
        # last output is the scaled current frame == curr exactly
        np.testing.assert_array_equal(np.asarray(outs[-1]), curr)

    def test_equal_size_bf16_bitwise_f32(self, rng):
        # default equal-size pyramid config takes the integer-offset warp
        # in the exact integer-code domain: production bf16 output BYTES
        # equal the f32 path's (kernels/warp_matmul.py u8_exact)
        prev = rng.integers(0, 256, (64, 128, 4), dtype=np.uint8)
        curr = np.roll(prev, (4, -6), (0, 1))
        outs = {}
        for dt in ("bf16", "f32"):
            cfg = _cfg(input_width=128, output_width=128,
                       output_height=64, motion_mode="pyramid", dtype=dt)
            outs[dt] = [np.asarray(o) for o in make_interp_step(cfg)(
                jnp.asarray(prev), jnp.asarray(curr))]
        for a, b in zip(outs["bf16"], outs["f32"]):
            np.testing.assert_array_equal(a, b)


class TestInterpStep:
    def test_crossfade_mode(self, rng):
        # config 2: fixed blend, no motion
        cfg = _cfg(motion_mode="none")
        step = make_interp_step(cfg)
        a = rng.integers(0, 256, (64, 64, 4), dtype=np.uint8)
        b = rng.integers(0, 256, (64, 64, 4), dtype=np.uint8)
        out_i, out_c = step(jnp.asarray(a), jnp.asarray(b))
        assert out_i.shape == (128, 128, 4)
        assert out_c.shape == (128, 128, 4)

    def test_pyramid_mode_shapes(self, rng):
        cfg = _cfg(motion_mode="pyramid")
        step = make_interp_step(cfg)
        a = rng.integers(0, 256, (64, 64, 4), dtype=np.uint8)
        b = rng.integers(0, 256, (64, 64, 4), dtype=np.uint8)
        out_i, out_c = step(jnp.asarray(a), jnp.asarray(b))
        assert out_i.shape == (128, 128, 4)

    def test_nonaligned_size_padding(self, rng):
        # 72x88 is not divisible by the 64-px pyramid lattice: exercises
        # the engine's pad/crop path
        cfg = _cfg(input_width=88, input_height=72,
                   output_width=176, output_height=144,
                   motion_mode="pyramid")
        step = make_interp_step(cfg)
        a = rng.integers(0, 256, (72, 88, 4), dtype=np.uint8)
        b = rng.integers(0, 256, (72, 88, 4), dtype=np.uint8)
        out_i, _ = step(jnp.asarray(a), jnp.asarray(b))
        assert out_i.shape == (144, 176, 4)

    def test_exact_mode_is_oracle(self, rng):
        cfg = _cfg(motion_mode="none", block_size=4, search_radius=2)
        step = make_interp_step(cfg, "exact")
        a = rng.integers(0, 256, (64, 64, 4), dtype=np.uint8)
        b = rng.integers(0, 256, (64, 64, 4), dtype=np.uint8)
        out_i, out_c = step(jnp.asarray(a), jnp.asarray(b))
        pa = oracle.dequantize_unorm8(jnp.asarray(a))
        pb = oracle.dequantize_unorm8(jnp.asarray(b))
        ref = oracle.quantize_unorm8(oracle.lanczos_scale(
            oracle.warp_blend(pa, pb, None, 0.5), 128, 128))
        # the step is one fused jit program; XLA fusion can flip the last
        # ulp pre-quantization vs separately-jitted oracle calls, moving
        # isolated pixels by one code at rounding boundaries
        diff = np.abs(np.asarray(out_i).astype(int)
                      - np.asarray(ref).astype(int))
        assert diff.max() <= 1
        assert (diff > 0).mean() < 1e-3


class TestStreaming:
    def test_frame_doubling_count(self):
        cfg = _cfg(motion_mode="none")
        src = SyntheticSource(64, 64, n_frames=5)
        sink = NullSink()
        stats = run_stream(cfg, src, sink, paced=False)
        assert stats.frames_in == 5
        assert stats.frames_out == 9  # 1 + 4*2
        assert sink.count == 9
        # latency sampling excludes warmup frames
        assert stats.latency["n"] >= 1

    def test_no_interp_passthrough_count(self):
        cfg = _cfg(enable_interpolation=False)
        src = SyntheticSource(64, 64, n_frames=4)
        sink = NullSink()
        stats = run_stream(cfg, src, sink, paced=False)
        assert stats.frames_out == 4

    def test_max_frames(self):
        cfg = _cfg(enable_interpolation=False)
        src = SyntheticSource(64, 64, n_frames=100)
        stats = run_stream(cfg, src, NullSink(), max_frames=3, paced=False)
        assert stats.frames_in == 3

    def test_paced_deadline_accounting(self):
        # generous 5 fps budget on a tiny no-motion config: warmup frames
        # excluded (clock re-anchors after compile), the rest must meet
        # their absolute deadlines
        cfg = _cfg(motion_mode="none", target_fps=5)
        src = SyntheticSource(64, 64, n_frames=8)
        stats = run_stream(cfg, src, NullSink(), paced=True)
        assert stats.paced_frames == 6  # 8 minus 2 warmup
        assert stats.deadline_misses == 0
        # unpaced runs report no pacing stats
        stats2 = run_stream(cfg, SyntheticSource(64, 64, n_frames=4),
                            NullSink(), paced=False)
        assert stats2.paced_frames == 0

    def test_all_quality_features_compose(self, tmp_path):
        """Every round-2 quality flag at once through the full engine:
        temporal MV threading + scene-cut + MV filter + occlusion blend +
        overlay burn-in (a host sink so the overlay branch runs);
        counts and the white stats text pinned."""
        from tpufg.io.sinks import RawVideoSink

        cfg = _cfg(input_width=128, input_height=64, output_width=128,
                   output_height=64, motion_mode="pyramid",
                   temporal_mv=True, scene_cut_threshold=0.12,
                   mv_filter=True, occlusion_blend=True, mc_fallback=True,
                   overlay=True)
        src = SyntheticSource(128, 64, n_frames=5, pattern="panmix")
        out = tmp_path / "all.raw"
        with RawVideoSink(str(out)) as sink:
            stats = run_stream(cfg, src, sink, paced=False)
        assert stats.frames_in == 5
        assert stats.frames_out == 9
        data = np.fromfile(out, np.uint8).reshape(9, 64, 128, 4)
        band = data[0, 8:24, 8:120, :3]
        assert (band == 255).all(axis=-1).any()  # stats text burned in

    def test_temporal_mv_streaming(self):
        """The runner threads the MV predictor through the temporal step
        (state init, donation, pop-before-sink) — full engine path."""
        cfg = _cfg(input_width=128, input_height=64, output_width=128,
                   output_height=64, motion_mode="pyramid",
                   temporal_mv=True)
        src = SyntheticSource(128, 64, n_frames=6)
        sink = NullSink()
        stats = run_stream(cfg, src, sink, paced=False)
        assert stats.frames_in == 6
        assert stats.frames_out == 11  # 1 + 5*2 (MV output not emitted)
        assert sink.count == 11


class TestFpsMultiplier:
    def test_k4_output_count_and_ordering(self, rng):
        cfg = _cfg(motion_mode="none", fps_multiplier=4)
        step = make_interp_step(cfg)
        a = rng.integers(0, 256, (64, 64, 4), dtype=np.uint8)
        b = rng.integers(0, 256, (64, 64, 4), dtype=np.uint8)
        outs = step(jnp.asarray(a), jnp.asarray(b))
        assert len(outs) == 4  # t=1/4, 2/4, 3/4 + scaled curr
        # crossfade: earlier t closer to prev
        pa = np.asarray(outs[0]).astype(np.float64)
        pc = np.asarray(outs[2]).astype(np.float64)
        a_up = np.asarray(make_scale_step(cfg)(jnp.asarray(a))).astype(np.float64)
        assert np.abs(pa - a_up).mean() < np.abs(pc - a_up).mean()

    def test_multiplier_below_two_rejected(self):
        from tpufg.config import ConfigError
        with pytest.raises(ConfigError):
            _cfg(fps_multiplier=1)


class TestMotionQuality:
    def test_pyramid_interp_beats_crossfade(self, rng):
        # end-to-end: on panning content the motion-compensated midpoint
        # must reconstruct the true middle frame far better than a blend
        from tpufg.utils.quality import psnr

        h, w, vx = 128, 128, 6  # even velocity -> exact integer midpoint
        base = rng.random((h + 64, w + 64, 4)).astype(np.float32)
        for k in (1, 2):
            base = (base + np.roll(base, k, 0) + np.roll(base, k, 1)) / 3
        base = (base * 255).astype(np.uint8)

        def frame(i):
            return base[32: 32 + h, 32 + vx * i: 32 + vx * i + w]

        cfg_m = _cfg(input_width=w, input_height=h, output_width=w,
                     output_height=h, motion_mode="pyramid")
        cfg_x = _cfg(input_width=w, input_height=h, output_width=w,
                     output_height=h, motion_mode="none")
        truth = frame(1).astype(np.float64)  # exact middle of frames 0 and 2
        prev, curr = jnp.asarray(frame(0)), jnp.asarray(frame(2))
        interp_m = np.asarray(make_interp_step(cfg_m)(prev, curr)[0])
        prev, curr = jnp.asarray(frame(0)), jnp.asarray(frame(2))
        interp_x = np.asarray(make_interp_step(cfg_x)(prev, curr)[0])
        inner = (slice(24, -24), slice(24, -24))
        p_m = psnr(truth[inner] / 255, interp_m.astype(np.float64)[inner] / 255)
        p_x = psnr(truth[inner] / 255, interp_x.astype(np.float64)[inner] / 255)
        assert p_m > p_x + 6, (p_m, p_x)  # >6 dB better than crossfade

    def test_exhaustive_mode_end_to_end(self, rng):
        """Config 3 regression: the engine's --motion-mode exhaustive path
        (motion.comp parity kernel, lattice-subsampled MVs feeding the
        production warp) must reconstruct a known shift like the pyramid
        does, and beat crossfade by the same margin."""
        from tpufg.utils.quality import psnr

        h, w, vx = 128, 128, 6
        base = rng.random((h + 64, w + 64, 4)).astype(np.float32)
        for k in (1, 2):
            base = (base + np.roll(base, k, 0) + np.roll(base, k, 1)) / 3
        base = (base * 255).astype(np.uint8)

        def frame(i):
            return base[32: 32 + h, 32 + vx * i: 32 + vx * i + w]

        cfg_e = _cfg(input_width=w, input_height=h, output_width=w,
                     output_height=h, motion_mode="exhaustive")
        cfg_x = _cfg(input_width=w, input_height=h, output_width=w,
                     output_height=h, motion_mode="none")
        truth = frame(1).astype(np.float64)
        prev, curr = jnp.asarray(frame(0)), jnp.asarray(frame(2))
        interp_e = np.asarray(make_interp_step(cfg_e)(prev, curr)[0])
        prev, curr = jnp.asarray(frame(0)), jnp.asarray(frame(2))
        interp_x = np.asarray(make_interp_step(cfg_x)(prev, curr)[0])
        inner = (slice(24, -24), slice(24, -24))
        p_e = psnr(truth[inner] / 255, interp_e.astype(np.float64)[inner] / 255)
        p_x = psnr(truth[inner] / 255, interp_x.astype(np.float64)[inner] / 255)
        assert p_e > p_x + 6, (p_e, p_x)

    def test_mv_grid_8_improves_shear(self, rng):
        """--mv-grid 8: bilinear MV-field upsample + 8-px block warp must
        beat the 16-px lattice on motion that varies WITHIN a 16-px block
        (interpolate.comp:30-31 reads the MV field per-pixel bilinearly;
        this closes part of that granularity gap)."""
        from tpufg.utils.quality import psnr

        h, w = 128, 128
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)

        def frame(t):
            # horizontal velocity ramp vx(y) = y/16 px/frame; sinusoidal
            # texture gives exact fractional shifts analytically
            shift = (ys * t) / 16.0
            out = np.zeros((h, w, 4))
            for i, period in enumerate([7.3, 11.1, 17.9, 29.0]):
                out[..., i] = 127.5 + 100 * np.sin(
                    2 * np.pi * (xs - shift) / period + i)
            return np.clip(np.round(out), 0, 255).astype(np.uint8)

        prev, curr, truth = frame(0), frame(2), frame(1)
        inner = (slice(24, -24), slice(24, -24))
        scores = {}
        for grid in (16, 8):
            cfg = _cfg(input_width=w, input_height=h, output_width=w,
                       output_height=h, motion_mode="pyramid", mv_grid=grid)
            out = np.asarray(make_interp_step(cfg)(
                jnp.asarray(prev), jnp.asarray(curr))[0])
            scores[grid] = psnr(truth[inner].astype(np.float64) / 255,
                                out[inner].astype(np.float64) / 255)
        assert scores[8] > scores[16] + 0.3, scores

    def test_mv_grid_8_constant_pan_unchanged(self, rng):
        """On block-constant motion the upsampled field equals the lattice
        field, so mv_grid=8 must reconstruct at least as well as 16."""
        from tpufg.utils.quality import psnr

        h, w, vx = 128, 128, 6
        base = rng.random((h + 64, w + 64, 4)).astype(np.float32)
        for k in (1, 2):
            base = (base + np.roll(base, k, 0) + np.roll(base, k, 1)) / 3
        base = (base * 255).astype(np.uint8)

        def frame(i):
            return base[32: 32 + h, 32 + vx * i: 32 + vx * i + w]

        truth = frame(1).astype(np.float64)
        inner = (slice(24, -24), slice(24, -24))
        scores = {}
        for grid in (16, 8):
            cfg = _cfg(input_width=w, input_height=h, output_width=w,
                       output_height=h, motion_mode="pyramid", mv_grid=grid)
            out = np.asarray(make_interp_step(cfg)(
                jnp.asarray(frame(0)), jnp.asarray(frame(2)))[0])
            scores[grid] = psnr(truth[inner] / 255,
                                out[inner].astype(np.float64) / 255)
        assert scores[8] >= scores[16] - 0.2, scores

    def test_mv_filter_snaps_outliers(self):
        """median_filter_mv: an isolated wrong vector in a consensus field
        is removed exactly; a constant field is untouched (so the filter
        can never hurt clean content)."""
        from tpufg.models.pyramid import median_filter_mv

        field = np.full((2, 8, 10), 6.0, np.float32)
        field[0, 3, 4] = -16.0   # isolated outlier
        field[1, 5, 7] = 12.0
        out = np.asarray(median_filter_mv(jnp.asarray(field)))
        np.testing.assert_array_equal(out, np.full((2, 8, 10), 6.0))

    def test_mv_filter_noise_no_harm(self, rng):
        """--mv-filter through the pipeline: at worst neutral on clean and
        noisy pan content (the PSNR gain under heavy noise is real but
        seed-dependent — +0.1..0.3 dB at sigma=60 — so the regression
        gate is no-harm, and the outlier-snapping is unit-tested above)."""
        from tpufg.utils.quality import psnr

        h, w, vx = 128, 128, 6
        base = rng.random((h + 64, w + 64, 4)).astype(np.float32)
        for k in (1, 2):
            base = (base + np.roll(base, k, 0) + np.roll(base, k, 1)) / 3
        base = base * 255

        def frame(i, noise):
            f = base[32: 32 + h, 32 + vx * i: 32 + vx * i + w]
            n = rng.normal(0, noise, f.shape)
            return np.clip(np.round(f + n), 0, 255).astype(np.uint8)

        truth = base[32: 32 + h, 32 + vx: 32 + vx + w].astype(np.float64)
        inner = (slice(24, -24), slice(24, -24))
        # same noise draw for both configs; keep on host — the equal-size
        # step donates its first arg, so device arrays can't be reused
        pairs = {n: (frame(0, n), frame(2, n)) for n in (0, 60)}

        def run(noise, mv_filter):
            cfg = _cfg(input_width=w, input_height=h, output_width=w,
                       output_height=h, motion_mode="pyramid",
                       mv_filter=mv_filter)
            a, b = pairs[noise]
            out = np.asarray(make_interp_step(cfg)(
                jnp.asarray(a), jnp.asarray(b))[0])
            return psnr(truth[inner] / 255,
                        out[inner].astype(np.float64) / 255)

        assert run(0, True) > run(0, False) - 0.05   # clean: no-op
        assert run(60, True) > run(60, False) - 0.05  # noisy: never worse

    def test_occlusion_blend_reduces_covered_ghosting(self, rng):
        """--occlusion-blend: where warped sources disagree (covered or
        revealed background around a mover), the blend shifts toward the
        temporally closer frame.  Measured characteristic (DESIGN.md): the
        covered strip's ghosting drops by ~30%; net full-frame PSNR may dip
        slightly because the symmetric revealed strip prefers the other
        frame — bound that cost."""
        from tpufg.utils.quality import psnr

        h, w = 128, 128
        bg = rng.random((h, w, 4)).astype(np.float32)
        for k in (1, 2):
            bg = (bg + np.roll(bg, k, 0) + np.roll(bg, k, 1)) / 3
        box = rng.random((32, 32, 4)).astype(np.float32)
        for k in (1, 2):
            box = (box + np.roll(box, k, 0) + np.roll(box, k, 1)) / 3

        def frame(t):
            f = bg.copy()
            x = 32 + 8 * t
            f[48:80, x:x + 32] = box
            return np.clip(f * 255, 0, 255).astype(np.uint8)

        prev, curr, truth = frame(0), frame(2), frame(1).astype(np.float64)

        def run(occ):
            cfg = _cfg(input_width=w, input_height=h, output_width=w,
                       output_height=h, motion_mode="pyramid",
                       occlusion_blend=occ)
            return np.asarray(make_interp_step(cfg)(
                jnp.asarray(prev), jnp.asarray(curr))[0]).astype(np.float64)

        out_p, out_o = run(False), run(True)
        covered = (slice(48, 80), slice(72, 80))  # bg about to be covered

        def rmse(x, reg):
            return np.sqrt(np.mean((x[reg] - truth[reg]) ** 2))

        assert rmse(out_o, covered) < 0.8 * rmse(out_p, covered), (
            rmse(out_o, covered), rmse(out_p, covered))
        inner = (slice(16, -16), slice(16, -16))
        p_p = psnr(truth[inner] / 255, out_p[inner] / 255)
        p_o = psnr(truth[inner] / 255, out_o[inner] / 255)
        assert p_o > p_p - 0.8, (p_o, p_p)  # bounded net cost

    def test_mc_fallback_adaptive(self, rng):
        """--mc-fallback: per-cell crossfade fallback wherever warping does
        not reduce photometric disagreement vs zero motion.

        Two characteristics: (a) on content with NO true correspondence
        (a region whose texture is independently redrawn between frames —
        block matching locks onto spurious matches) the fallback output
        converges to the crossfade; (b) on clean translational motion the
        fallback is a near-no-op (MC keeps its structural win)."""
        from tpufg.utils.quality import psnr

        h, w = 128, 128

        def smooth(x):
            for k in (1, 2):
                x = (x + np.roll(x, k, 0) + np.roll(x, k, 1)) / 3
            return x

        def run(prev, curr, fb, mode="pyramid"):
            cfg = _cfg(input_width=w, input_height=h, output_width=w,
                       output_height=h, motion_mode=mode, mc_fallback=fb)
            return np.asarray(make_interp_step(cfg)(
                jnp.asarray(prev), jnp.asarray(curr))[0]).astype(np.float64)

        # (a) spurious-motion content: independent textures per frame
        a = np.clip(smooth(rng.random((h, w, 4)).astype(np.float32)) * 255,
                    0, 255).astype(np.uint8)
        b = np.clip(smooth(rng.random((h, w, 4)).astype(np.float32)) * 255,
                    0, 255).astype(np.uint8)
        crossfade = run(a, b, False, mode="none")
        out_mc = run(a, b, False)
        out_fb = run(a, b, True)
        inner = (slice(16, -16), slice(16, -16), slice(0, 3))
        gap_mc = np.abs(out_mc[inner] - crossfade[inner]).mean()
        gap_fb = np.abs(out_fb[inner] - crossfade[inner]).mean()
        assert gap_fb < 0.35 * gap_mc, (gap_fb, gap_mc)

        # (b) clean translation: fallback must not cost MC's win
        bg = smooth(rng.random((h + 16, w + 16, 4)).astype(np.float32))
        f0 = np.clip(bg[:h, :w] * 255, 0, 255).astype(np.uint8)
        f1 = np.clip(bg[8:h + 8, 8:w + 8] * 255, 0, 255).astype(np.uint8)
        truth = np.clip(bg[4:h + 4, 4:w + 4] * 255, 0, 255) / 255.0
        p_mc = psnr(truth[inner], run(f0, f1, False)[inner] / 255)
        p_fb = psnr(truth[inner], run(f0, f1, True)[inner] / 255)
        p_cf = psnr(truth[inner], run(f0, f1, False, mode="none")[inner]
                    / 255)
        assert p_fb > p_cf + 3.0, (p_fb, p_cf)   # keeps the MC win
        assert p_fb > p_mc - 0.3, (p_fb, p_mc)   # near-no-op vs pure MC

    def test_exhaustive_streaming_run(self):
        """Exhaustive mode through the whole streaming engine (runner +
        ring + sink), not just the step function."""
        from tpufg.engine.runner import run_stream
        from tpufg.io.sinks import NullSink
        from tpufg.io.sources import SyntheticSource

        cfg = _cfg(input_width=64, input_height=64, output_width=64,
                   output_height=64, motion_mode="exhaustive")
        src = SyntheticSource(64, 64, n_frames=5, pattern="pan")
        sink = NullSink()
        stats = run_stream(cfg, src, sink, paced=False)
        assert stats.frames_in == 5
        assert stats.frames_out == 1 + 4 * 2


class TestSceneCut:
    """--scene-cut: across a cut, in-between frames repeat the nearer
    source instead of interpolating (the standard MEMC cut fallback)."""

    def test_cut_repeats_nearer_source(self, rng):
        cfg = _cfg(input_width=128, input_height=64, output_width=128,
                   output_height=64, motion_mode="pyramid",
                   fps_multiplier=4, scene_cut_threshold=0.1)
        # unrelated random frames: mean |p-c| ~ 1/3 >> 0.1
        prev = rng.integers(0, 256, (64, 128, 4), dtype=np.uint8)
        curr = rng.integers(0, 256, (64, 128, 4), dtype=np.uint8)
        outs = make_interp_step(cfg)(jnp.asarray(prev), jnp.asarray(curr))
        # t = 1/4 -> prev; t = 1/2, 3/4 -> curr (t >= 0.5 picks curr)
        np.testing.assert_array_equal(np.asarray(outs[0]), prev)
        np.testing.assert_array_equal(np.asarray(outs[1]), curr)
        np.testing.assert_array_equal(np.asarray(outs[2]), curr)

    def test_continuous_content_unchanged(self, rng):
        base = dict(input_width=128, input_height=64, output_width=256,
                    output_height=128, motion_mode="pyramid")
        prev = rng.integers(0, 256, (64, 128, 4), dtype=np.uint8)
        # small shift: mean |p-c| stays well under the threshold for
        # smooth content; use a blurred frame to keep the diff small
        f = prev.astype(np.float32)
        for k in (1, 2, 4):
            f = (f + np.roll(f, k, 0) + np.roll(f, k, 1)) / 3
        prev = f.astype(np.uint8)
        curr = np.roll(prev, 2, axis=1)
        a = make_interp_step(_cfg(**base))(
            jnp.asarray(prev), jnp.asarray(curr))
        b = make_interp_step(_cfg(**base, scene_cut_threshold=0.2))(
            jnp.asarray(prev), jnp.asarray(curr))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    def test_bad_threshold_rejected(self):
        with pytest.raises(Exception):
            _cfg(scene_cut_threshold=1.5)

    def test_cut_fallback_in_crossfade_mode(self, rng):
        """mode='none' honors --scene-cut too: a crossfade across a shot
        change is exactly the double exposure the flag suppresses."""
        cfg = _cfg(input_width=128, input_height=64, output_width=128,
                   output_height=64, motion_mode="none",
                   scene_cut_threshold=0.1)
        prev = rng.integers(0, 256, (64, 128, 4), dtype=np.uint8)
        curr = rng.integers(0, 256, (64, 128, 4), dtype=np.uint8)
        outs = make_interp_step(cfg)(jnp.asarray(prev), jnp.asarray(curr))
        np.testing.assert_array_equal(np.asarray(outs[0]), curr)  # t=0.5


class TestTemporalMV:
    """--temporal-mv: the previous pair's MV field seeds the next search,
    so sustained motion beyond the per-pair pyramid reach (~±22 px) locks
    in after the first pairs (codec-style temporal predictor)."""

    def _pan_frames(self, rng, h, w, v, n):
        base = rng.random((h + 16, w + v * (n + 1) + 16, 4))
        base = base.astype(np.float32)
        for k in (1, 2, 4):
            base = (base + np.roll(base, k, 0) + np.roll(base, k, 1)) / 3
        base = (base * 255).astype(np.uint8)
        return [np.ascontiguousarray(base[8:8 + h, 8 + v * i:8 + v * i + w])
                for i in range(n + 1)]

    def test_fast_pan_locks_on(self, rng):
        from tpufg.engine.pipeline import mv_lattice_shape
        from tpufg.utils.quality import psnr

        h, w, v = 64, 256, 28  # 28 px/frame: beyond the per-pair reach
        frames = self._pan_frames(rng, h, w, v, 5)
        cfg_t = _cfg(input_width=w, input_height=h, output_width=w,
                     output_height=h, motion_mode="pyramid",
                     temporal_mv=True)
        cfg_0 = _cfg(input_width=w, input_height=h, output_width=w,
                     output_height=h, motion_mode="pyramid")
        step_t = make_interp_step(cfg_t)
        step_0 = make_interp_step(cfg_0)
        mv = jnp.zeros(mv_lattice_shape(cfg_t), jnp.float32)
        inner = (slice(8, -8), slice(3 * v, -3 * v))
        p_t = p_0 = None
        for i in range(5):
            # fresh device arrays per call: the equal-size steps donate
            # their prev argument
            *outs_t, mv = step_t(jnp.asarray(frames[i]),
                                 jnp.asarray(frames[i + 1]), mv)
            outs_0 = step_0(jnp.asarray(frames[i]),
                            jnp.asarray(frames[i + 1]))
            # analytic mid-frame: frames[i] shifted by v/2 (v even -> exact)
            mid = np.roll(frames[i], -v // 2, axis=1).astype(np.float64)
            p_t = psnr(mid[inner] / 255,
                       np.asarray(outs_t[0]).astype(np.float64)[inner] / 255)
            p_0 = psnr(mid[inner] / 255,
                       np.asarray(outs_0[0]).astype(np.float64)[inner] / 255)
        # after 5 pairs the temporal tracker must be locked on (the
        # per-pair search cannot reach 28 px): large margin over baseline
        assert p_t > p_0 + 6, (p_t, p_0)
        # and the threaded MV field must have converged to the true motion
        # magnitude (sign convention pinned by the reconstruction check)
        mv_np = np.asarray(mv)
        interior_mv = mv_np[0, 1:-1, 6:-6]
        assert np.abs(np.abs(interior_mv) - v).mean() < 2.0, (
            interior_mv.mean())

    def test_cut_resets_predictor(self, rng):
        from tpufg.engine.pipeline import mv_lattice_shape

        h, w, v = 64, 256, 20
        frames = self._pan_frames(rng, h, w, v, 3)
        cfg = _cfg(input_width=w, input_height=h, output_width=w,
                   output_height=h, motion_mode="pyramid",
                   temporal_mv=True, scene_cut_threshold=0.1)
        step = make_interp_step(cfg)
        mv = jnp.zeros(mv_lattice_shape(cfg), jnp.float32)
        for i in range(3):
            *_, mv = step(jnp.asarray(frames[i]),
                          jnp.asarray(frames[i + 1]), mv)
        assert float(jnp.abs(mv).max()) > 0  # locked on the pan
        cut_frame = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        *_, mv = step(jnp.asarray(frames[3]), jnp.asarray(cut_frame), mv)
        assert float(jnp.abs(mv).max()) == 0.0  # predictor reset

    def test_temporal_requires_pyramid(self):
        with pytest.raises(Exception):
            _cfg(motion_mode="exhaustive", temporal_mv=True)

    def test_temporal_range_limits_rejected(self):
        """The widened temporal warp reach caps the blend weight: k > 4 or
        extreme interpolation factors must be rejected at config time (not
        as a kernel-internal trace error)."""
        from tpufg.config import ConfigError
        with pytest.raises(ConfigError):
            _cfg(motion_mode="pyramid", temporal_mv=True, fps_multiplier=5)
        with pytest.raises(ConfigError):
            _cfg(motion_mode="pyramid", temporal_mv=True,
                 interpolation_factor=0.9)
        # boundary cases stay valid
        _cfg(motion_mode="pyramid", temporal_mv=True, fps_multiplier=4)
        _cfg(motion_mode="pyramid", temporal_mv=True,
             interpolation_factor=0.75)

    def test_sharded_temporal_rejects_dp_batching(self, rng):
        # temporal state is sequential per-stream: dp>1 batches
        # independent pairs and must be rejected; dp=1 is supported
        # (functional coverage: tests/test_parallel.py)
        import jax

        from tpufg.config import ConfigError
        from tpufg.parallel.spatial import (make_sharded_interp_step,
                                            make_spatial_mesh)
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        cfg = _cfg(input_width=128, input_height=1024,
                   output_width=128, output_height=1024,
                   motion_mode="pyramid", temporal_mv=True)
        with pytest.raises(ConfigError, match="dp 1"):
            make_sharded_interp_step(make_spatial_mesh(8, dp=2), cfg)


class TestIntegerOffsetGate:
    def test_odd_search_radius_uses_general_path(self, rng):
        """The warp clips MVs to ±r: an ODD --search-radius turns clipped
        even MVs odd (fractional half-offsets at t=0.5), so the integer
        fast path must stay off — the step must bitwise-match an explicit
        general-path recomputation."""
        from tpufg.engine.pipeline import interp_planar
        from tpufg.kernels.convert import frames_to_planar, planar_to_frames
        from tpufg.kernels.warp_matmul import warp_blend_matmul
        from tpufg.models.pyramid import pyramid_motion_search
        import jax.numpy as jnp2

        h, w, v = 64, 128, 20  # motion beyond the clip bound
        base = rng.integers(0, 256, (h, w + 3 * v, 4), dtype=np.uint8)
        prev = np.ascontiguousarray(base[:, :w])
        curr = np.ascontiguousarray(base[:, v:v + w])
        cfg = _cfg(input_width=w, input_height=h, output_width=w,
                   output_height=h, motion_mode="pyramid", search_radius=9)
        out = np.asarray(make_interp_step(cfg)(jnp.asarray(prev),
                                               jnp.asarray(curr))[0])
        # explicit general-path recomputation of the same step
        p = frames_to_planar(jnp.asarray(prev), jnp2.float32)
        c = frames_to_planar(jnp.asarray(curr), jnp2.float32)
        mv = pyramid_motion_search(p, c, levels=3, base_radius=4,
                                   refine_radius=2, block_size=8, grid=16,
                                   skip_finest_refine=1)
        ref = warp_blend_matmul(p, c, -mv, 0.5, search_radius=9,
                                dtype=jnp2.float32, integer_offsets=False)
        ref_u8 = np.asarray(planar_to_frames(ref))
        # <= 1 code: XLA fuses the in-step chain differently than the
        # standalone recomputation (same rounding-at-.5 phenomenon as the
        # sharded contract).  The guarded bug — integer_offsets dropping
        # the clipped MVs' half-pixel fraction — misaligns content by
        # 0.5 px and fails this by tens of codes.
        d = np.abs(out.astype(int) - ref_u8.astype(int))
        assert d.max() <= 1, d.max()


class TestI32Wire:
    """The packed-int32 wire must be byte-identical to the uint8 wire."""

    def test_planar_roundtrip_bitwise(self, rng):
        from tpufg.kernels.convert import (frames_to_planar,
                                           planar_to_frames, planar_to_i32)
        u8 = rng.integers(0, 256, (64, 128, 4), dtype=np.uint8)
        i32 = u8.view(np.int32).reshape(64, 128)
        a = np.asarray(frames_to_planar(jnp.asarray(u8)))
        b = np.asarray(frames_to_planar(jnp.asarray(i32)))
        np.testing.assert_array_equal(a, b)
        planar = jnp.asarray(rng.random((4, 64, 128)).astype(np.float32))
        pu = np.asarray(planar_to_frames(planar))
        pi = np.asarray(planar_to_i32(planar))
        np.testing.assert_array_equal(
            pu, pi.view(np.uint8).reshape(64, 128, 4))

    def test_interp_step_bitwise(self, rng):
        cfg = _cfg(input_width=128, input_height=64, output_width=256,
                   output_height=128, dtype="bf16", motion_mode="pyramid")
        u8s = [rng.integers(0, 256, (64, 128, 4), dtype=np.uint8)
               for _ in range(2)]
        outs_u8 = make_interp_step(cfg)(*map(jnp.asarray, u8s))
        i32s = [u.view(np.int32).reshape(64, 128) for u in u8s]
        outs_i32 = make_interp_step(cfg, wire="i32")(*map(jnp.asarray, i32s))
        assert len(outs_u8) == len(outs_i32)
        for a, b in zip(outs_u8, outs_i32):
            bu = np.asarray(b)
            np.testing.assert_array_equal(
                np.asarray(a),
                bu.view(np.uint8).reshape(bu.shape[0], bu.shape[1], 4))

    def test_identity_size_step_bitwise(self, rng):
        cfg = _cfg(input_width=128, input_height=64, output_width=128,
                   output_height=64, motion_mode="none")
        u8s = [rng.integers(0, 256, (64, 128, 4), dtype=np.uint8)
               for _ in range(2)]
        outs_u8 = make_interp_step(cfg)(*map(jnp.asarray, u8s))
        i32s = [u.view(np.int32).reshape(64, 128) for u in u8s]
        outs_i32 = make_interp_step(cfg, wire="i32")(*map(jnp.asarray, i32s))
        for a, b in zip(outs_u8, outs_i32):
            bu = np.asarray(b)
            np.testing.assert_array_equal(
                np.asarray(a),
                bu.view(np.uint8).reshape(bu.shape[0], bu.shape[1], 4))

    def test_exact_precision_rejects_i32(self):
        cfg = _cfg()
        with pytest.raises(ValueError):
            make_interp_step(cfg, "exact", wire="i32")


class TestResume:
    def test_start_frame_resumes(self):
        # segment outputs stitch: full run == run[0:] + resumed run minus
        # its re-emitted first frame
        cfg = _cfg(motion_mode="none")

        class CollectSink:
            needs_host = True

            def __init__(self):
                self.frames = []

            def write(self, f):
                self.frames.append(np.asarray(f).copy())

        full = CollectSink()
        run_stream(cfg, SyntheticSource(64, 64, n_frames=6), full,
                   paced=False)
        resumed = CollectSink()
        run_stream(cfg, SyntheticSource(64, 64, n_frames=6), resumed,
                   paced=False, start_frame=3)
        # full emits 1 + 5*2 = 11; resumed emits 1 + 2*2 = 5
        assert len(full.frames) == 11 and len(resumed.frames) == 5
        # resumed[1:] must equal the tail of the full run
        for a, b in zip(resumed.frames[1:], full.frames[-4:]):
            np.testing.assert_array_equal(a, b)


class TestPerPixelQuality:
    def test_per_pixel_mode_beats_8px_on_shear(self, rng):
        """--mv-grid 1 --subpel --mv-bias 0.1: per-pixel warp + sub-pel MV
        refinement + aperture-stabilizing cost bias must decisively beat
        the 8-px granularity point on within-block-varying motion (the
        interpolate.comp:30-31 per-pixel-MV semantics, production path).
        Measured r3: 37.9 dB vs 22.2 (8-px) vs 21.5 (16-px blocks)."""
        from tpufg.utils.quality import psnr

        h, w = 128, 128
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)

        def frame(t):
            shift = (ys * t) / 16.0
            out = np.zeros((h, w, 4))
            for i, period in enumerate([7.3, 11.1, 17.9, 29.0]):
                out[..., i] = 127.5 + 100 * np.sin(
                    2 * np.pi * (xs - shift) / period + i)
            return np.clip(np.round(out), 0, 255).astype(np.uint8)

        prev, curr, truth = frame(0), frame(2), frame(1)
        inner = (slice(24, -24), slice(24, -24))
        scores = {}
        for tag, kw in (("pp", dict(mv_grid=1, subpel=True, mv_bias=0.1)),
                        ("g8", dict(mv_grid=8))):
            cfg = _cfg(input_width=w, input_height=h, output_width=w,
                       output_height=h, motion_mode="pyramid", **kw)
            out = np.asarray(make_interp_step(cfg)(
                jnp.asarray(prev), jnp.asarray(curr))[0])
            scores[tag] = psnr(truth[inner].astype(np.float64) / 255,
                               out[inner].astype(np.float64) / 255)
        assert scores["pp"] > scores["g8"] + 5, scores

    def test_bias_zero_keeps_round2_field(self, rng):
        """mv_bias=0 (the default) preserves the unbiased strict-< scan:
        pyramid fields with and without bias=0.0 are identical."""
        from tpufg.models.pyramid import pyramid_motion_search
        base = rng.random((4, 128, 128)).astype(np.float32)
        p = jnp.asarray(base)
        c = jnp.asarray(np.roll(base, 3, axis=2).copy())
        a = pyramid_motion_search(p, c, skip_finest_refine=1)
        b = pyramid_motion_search(p, c, skip_finest_refine=1, bias=0.0)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_subpel_recovers_fractional_shift(self, rng):
        """Sub-pel refinement on a half-pixel global shift: the refined
        field must land within 0.35 px of the true fractional motion
        (integer search alone is off by >= 0.5 px)."""
        from tpufg.models.pyramid import pyramid_motion_search, subpel_refine

        h, w = 128, 128
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
        def make(shift):
            out = np.zeros((4, h, w), np.float32)
            for i, period in enumerate([7.3, 11.1, 17.9, 29.0]):
                out[i] = 0.5 + 0.4 * np.sin(
                    2 * np.pi * (xs - shift) / period + i)
            return out
        p = jnp.asarray(make(0.0))
        c = jnp.asarray(make(2.5))  # true backward flow dx = -2.5
        mv = pyramid_motion_search(p, c, skip_finest_refine=1, bias=0.1)
        mvr = np.asarray(subpel_refine(p, c, mv, bias=0.1))
        inner = mvr[0][2:-2, 2:-2]
        assert np.abs(inner + 2.5).max() < 0.35, inner


class TestRound3AdvisorRegressions:
    """Flag combinations that used to die at jit trace deep inside the
    warp kernel (round-3 advisor findings) now trace cleanly."""

    def test_subpel_with_temporal_mv_traces(self):
        """--temporal-mv --subpel: the subpel probe warp (single mode,
        reach = full r_warp = 72 px with the temporal clamp) caps its
        radius at the warp kernel's 54-px halo ceiling instead of
        raising 'search radius too large' at trace."""
        import jax
        from tpufg.engine.pipeline import mv_lattice_shape
        cfg = _cfg(output_width=64, output_height=64,
                   motion_mode="pyramid", temporal_mv=True, subpel=True)
        step = make_interp_step(cfg)
        u8 = jax.ShapeDtypeStruct((64, 64, 4), jnp.uint8)
        seed = jax.ShapeDtypeStruct(mv_lattice_shape(cfg), jnp.float32)
        outs = jax.eval_shape(step, u8, u8, seed)
        assert outs[0].shape == (64, 64, 4)

    def test_subpel_with_large_search_radius_traces(self):
        """--subpel --search-radius 60 (accepted by validate: blend reach
        30 <= 54) used to exceed the single-mode probe warp's ceiling."""
        import jax
        cfg = _cfg(output_width=64, output_height=64,
                   motion_mode="pyramid", subpel=True, search_radius=60)
        step = make_interp_step(cfg)
        u8 = jax.ShapeDtypeStruct((64, 64, 4), jnp.uint8)
        outs = jax.eval_shape(step, u8, u8)
        assert outs[-1].shape == (64, 64, 4)

    def test_exhaustive_large_radius_traces_and_tile_fits_vmem(self):
        """Exhaustive mode sizes the site kernel's per-program tile from
        the search radius, so a program's [sites, dx] tensors stay small
        at every radius validate() accepts, and the step still traces."""
        import jax
        from tpufg.kernels.motion import sites_plan
        assert sites_plan(120, 16) == (4, 64)    # 1080p lattice, r=16
        for r in (54, 80, 108):  # radii validate() accepts at factor 0.5
            s_, dx = sites_plan(120, r)
            assert dx >= 2 * r + 1 and s_ * dx <= 256, (r, s_, dx)
        cfg = _cfg(output_width=64, output_height=64,
                   motion_mode="exhaustive", search_radius=80)
        step = make_interp_step(cfg)
        u8 = jax.ShapeDtypeStruct((64, 64, 4), jnp.uint8)
        outs = jax.eval_shape(step, u8, u8)
        assert outs[0].shape == (64, 64, 4)


class TestMotionSkipAlpha:
    """motion_skip_alpha: with the same constant alpha in both frames the
    alpha distance term is exactly 0.0 for every candidate, so the MV
    field — and every output byte — must be BITWISE the 4-channel result
    (the engine's gate for ~25% less search arithmetic)."""

    @pytest.mark.parametrize("mode,kw", [
        ("pyramid", {}),
        ("pyramid", dict(subpel=True, mv_grid=1)),
        ("exhaustive", dict(search_radius=4)),
    ])
    def test_bitwise_equal_on_const_alpha(self, rng, mode, kw):
        cfg = _cfg(output_width=64, output_height=64,
                   motion_mode=mode, **kw)
        frames = []
        for shift in (0, 3):
            f = rng.integers(0, 256, (64, 64, 4), dtype=np.uint8)
            f = np.roll(f, shift, axis=1)
            f[..., 3] = 255  # same constant alpha in both frames
            frames.append(f)
        # fresh device arrays per call: the equal-size step donates arg 0
        ref = make_interp_step(cfg)(*map(jnp.asarray, frames))
        got = make_interp_step(cfg, motion_skip_alpha=True)(
            *map(jnp.asarray, frames))
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(r), np.asarray(g))

    def test_sources_report_const_alpha(self, tmp_path):
        from tpufg.io.sources import RawVideoSource, SyntheticSource
        rng = np.random.default_rng(3)
        const = rng.integers(0, 256, (4, 16, 16, 4), dtype=np.uint8)
        const[..., 3] = 255
        varied = rng.integers(0, 256, (4, 16, 16, 4), dtype=np.uint8)
        pc, pv = str(tmp_path / "c.raw"), str(tmp_path / "v.raw")
        open(pc, "wb").write(const.tobytes())
        open(pv, "wb").write(varied.tobytes())
        assert RawVideoSource(pc, 16, 16).const_alpha is True
        assert RawVideoSource(pv, 16, 16).const_alpha is False
        # synthetic textures carry varying alpha: no guarantee
        assert SyntheticSource(16, 16).const_alpha is None

    def test_const_alpha_scan_covers_whole_file(self, tmp_path):
        """const_alpha=True is a per-stream guarantee, so the open-time
        scan must reject a file whose alpha varies only LATE (round-4
        review finding: a 16-frame prefix scan promised 'every frame')."""
        from tpufg.io import sources
        from tpufg.io.sources import RawVideoSource
        rng = np.random.default_rng(4)
        frames = rng.integers(0, 256, (24, 16, 16, 4), dtype=np.uint8)
        frames[..., 3] = 255
        frames[20, 5, 5, 3] = 7  # one byte, frame 20 of 24
        p = str(tmp_path / "late.raw")
        open(p, "wb").write(frames.tobytes())
        assert RawVideoSource(p, 16, 16).const_alpha is False
        # beyond the IO budget the scan reports unknown, never a promise
        orig = sources._ALPHA_SCAN_MAX_BYTES
        sources._ALPHA_SCAN_MAX_BYTES = 16 * 16 * 4
        try:
            assert RawVideoSource(p, 16, 16).const_alpha is None
        finally:
            sources._ALPHA_SCAN_MAX_BYTES = orig

    def test_y4m_source_guarantees_const_alpha(self, tmp_path):
        from tpufg.io.sinks import Y4MSink
        from tpufg.io.sources import Y4MSource
        p = str(tmp_path / "s.y4m")
        with Y4MSink(p, 16, 16, fps=30) as s:
            s.write(np.zeros((16, 16, 4), np.uint8))
        assert Y4MSource(p).const_alpha is True


def test_measure_paced_rate_smoke():
    """Adaptive paced-demo calibration: p50 host-visible step seconds at
    small shapes must be a positive finite float (the campaign's
    paced_cal stage divides by it to pick the demo rate)."""
    from tpufg.config import EngineConfig, resolve_sizes
    from tpufg.engine.runner import measure_paced_rate
    cfg = resolve_sizes(EngineConfig(
        input_width=64, input_height=48, output_width=128,
        output_height=96, target_fps=24, fps_multiplier=2))
    s = measure_paced_rate(cfg, n=3)
    assert s > 0.0 and np.isfinite(s)
