"""GPU regression lane: compiled kernels on a CUDA card.

Run with ``TPUFG_TEST_GPU=1 python -m pytest tests/ -m gpu -q`` (any other
invocation skips these).  The rest of the suite exercises the kernels in
interpret mode on CPU; this lane pins the PRODUCTION artifact — the
Triton-compiled kernel and XLA's GPU code — against the same oracles:

- plain Lanczos vs f32 oracle (<= 2e-6), bf16-input SSIM >= 0.999
- exhaustive-search Triton kernel f32 BITWISE vs oracle (tie-break/scan)
- warp_blend_matmul vs oracle to f32 rounding
- full production steps (shapes, y4m payload byte parity vs host, the
  bundled learned head's streamed step)

Sizes here are moderate; the 1080p/4K full-size comparisons live in
chip_smoke.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

pytestmark = [pytest.mark.gpu, pytest.mark.usefixtures("gpu_backend")]


def _rand_chw(rng, c, h, w):
    return jnp.asarray(
        rng.integers(0, 256, size=(c, h, w)).astype(np.float32) / 255.0)


def _hwc(x):
    return jnp.transpose(x, (1, 2, 0))


class TestBackendPolicy:
    def test_kernels_compile_on_gpu(self):
        from tpufg.kernels.common import use_interpret
        assert use_interpret() is False


def _on_cpu(fn, *args):
    """Run ``fn`` jitted on the CPU device: the oracle's Lanczos weights
    need libm-accurate ``sin``, which the GPU's XLA lowering is not
    (PARITY.md, backend scope note)."""
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        return jax.jit(fn)(*[jax.device_put(a, cpu) for a in args])


class TestLanczosOnChip:
    def test_f32_matches_oracle(self, rng):
        from tpufg.kernels.lanczos import lanczos_scale_planar
        from tpufg.ops import lanczos_scale
        img = _rand_chw(rng, 4, 72, 96)
        ref = _on_cpu(lambda x: lanczos_scale(_hwc(x), 144, 192), img)
        out = lanczos_scale_planar(img, 144, 192)
        # weighted reads, no dot: the module's own f32 contract holds
        np.testing.assert_allclose(np.asarray(out),
                                   np.transpose(np.asarray(ref), (2, 0, 1)),
                                   atol=2e-6)

    def test_bf16_ssim_contract(self, rng):
        from tpufg.kernels.lanczos import lanczos_scale_planar
        from tpufg.ops import lanczos_scale
        from tpufg.utils.quality import ssim
        img = _rand_chw(rng, 4, 72, 96)
        ref = np.asarray(_on_cpu(lambda x: lanczos_scale(_hwc(x), 144, 192),
                                 img))
        out = np.asarray(lanczos_scale_planar(img.astype(jnp.bfloat16),
                                              144, 192))
        assert ssim(ref, np.transpose(out, (1, 2, 0))) >= 0.999

    def test_packed_bytes_match_unpacked(self, rng):
        from tpufg.kernels.convert import planar_to_frames
        from tpufg.kernels.lanczos import (lanczos_scale_packed,
                                           lanczos_scale_planar)
        img = _rand_chw(rng, 4, 64, 128)
        a = np.asarray(planar_to_frames(lanczos_scale_planar(img, 128, 256)))
        b = np.asarray(lanczos_scale_packed(img, 128, 256))
        np.testing.assert_array_equal(a, b)


class TestMotionOnChip:
    def test_sites_bitwise_parity_r16(self, rng):
        """Compiled Triton search == oracle, bitwise, incl. tie-break
        (first-found most-negative dy-then-dx scan, motion.comp:27-52)."""
        from tpufg.kernels.motion import motion_search_sites
        from tpufg.ops import oracle
        h, w = 128, 256
        base = rng.random((h + 24, w + 24, 4)).astype(np.float32)
        p_hwc = base[8:8 + h, 8:8 + w]
        c_hwc = base[3:3 + h, 12:12 + w]
        ref = jax.jit(oracle.motion_search, static_argnums=(2, 3))(
            jnp.asarray(p_hwc), jnp.asarray(c_hwc), 8, 16)
        out = motion_search_sites(_chw_np(p_hwc), _chw_np(c_hwc),
                                  search_radius=16)
        np.testing.assert_array_equal(
            np.asarray(out),
            np.transpose(np.asarray(ref), (2, 0, 1))[:, 8::16, 8::16])

    def test_sites_bitwise_on_noise(self, rng):
        from tpufg.kernels.motion import motion_search_sites
        from tpufg.ops import oracle
        p = rng.integers(0, 256, (64, 128, 4)).astype(np.float32) / 255
        c = rng.integers(0, 256, (64, 128, 4)).astype(np.float32) / 255
        ref = jax.jit(oracle.motion_search, static_argnums=(2, 3))(
            jnp.asarray(p), jnp.asarray(c), 8, 4)
        out = motion_search_sites(_chw_np(p), _chw_np(c), search_radius=4)
        np.testing.assert_array_equal(
            np.asarray(out),
            np.transpose(np.asarray(ref), (2, 0, 1))[:, 8::16, 8::16])

    def test_lattice_matches_xla_subsampled(self, rng):
        from tpufg.kernels.motion_xla import (motion_search_lattice,
                                              motion_search_xla)
        p = _rand_chw(rng, 4, 64, 128)
        c = _rand_chw(rng, 4, 64, 128)
        full = motion_search_xla(p, c, block_size=8, search_radius=4)
        lat = motion_search_lattice(p, c, grid=16, block_size=8,
                                    search_radius=4)
        np.testing.assert_array_equal(
            np.asarray(full)[:, 8::16, 8::16], np.asarray(lat))


def _chw_np(x):
    return jnp.asarray(np.ascontiguousarray(np.transpose(x, (2, 0, 1))))


class TestResizeOnChip:
    def test_box_downsample_bitwise_vs_banded(self, rng):
        from tpufg.kernels.resize import box_downsample2
        x = rng.random((4, 64, 256)).astype(np.float32)
        out = np.asarray(box_downsample2(jnp.asarray(x)))
        ref = 0.5 * (0.5 * (x[:, 0::2, 0::2] + x[:, 1::2, 0::2])
                     + 0.5 * (x[:, 0::2, 1::2] + x[:, 1::2, 1::2]))
        np.testing.assert_array_equal(out, ref.astype(np.float32))


class TestConvOnChip:
    def test_f32_conv_is_highest_precision(self, rng):
        """f32 convs must not run in TF32: compare with a float64 host
        convolution (TF32 would miss by ~1e-3 here)."""
        from tpufg.models import rife
        x = rng.random((1, 8, 32, 64)).astype(np.float32)
        w = rng.normal(0, 0.2, (16, 8, 3, 3)).astype(np.float32)
        b = np.zeros((16,), np.float32)
        got = np.asarray(rife._conv(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b), 1, jnp.float32))
        xp = np.pad(x.astype(np.float64), ((0, 0), (0, 0), (1, 1), (1, 1)))
        ref = np.zeros((1, 16, 32, 64))
        for dy in range(3):
            for dx in range(3):
                ref += np.einsum("oc,bchw->bohw", w[:, :, dy, dx],
                                 xp[:, :, dy:dy + 32, dx:dx + 64])
        np.testing.assert_allclose(got, ref, atol=2e-5)


class TestWarpOnChip:
    def test_warp_matches_oracle_f32(self, rng):
        from tpufg.kernels.warp_matmul import warp_blend_matmul
        from tpufg.ops import oracle
        h, w, g = 64, 128, 16
        p = _rand_chw(rng, 4, h, w)
        c = _rand_chw(rng, 4, h, w)
        mv = jnp.asarray(
            rng.uniform(-5, 5, (2, h // g, w // g)).astype(np.float32))
        out = warp_blend_matmul(p, c, mv, factor=0.5, block=g,
                                search_radius=8)
        # the oracle reads the lattice field per-pixel when warping
        # block-granular: expand to per-pixel by repetition
        mv_pp = np.repeat(np.repeat(np.asarray(mv), g, 1), g, 2)
        ref = jax.jit(oracle.warp_blend, static_argnums=3)(
            _hwc(p), _hwc(c), jnp.asarray(np.transpose(mv_pp, (1, 2, 0))),
            0.5)
        np.testing.assert_allclose(
            np.asarray(out), np.transpose(np.asarray(ref), (2, 0, 1)),
            atol=3e-6)


class TestWarpIntegerDomainOnChip:
    def test_equal_size_bf16_bitwise_f32_compiled(self, rng):
        """The integer-code-domain claim (kernels/warp_matmul.py u8_exact)
        must hold compiled, not just on the CPU: default equal-size
        pyramid config, bf16 output bytes == f32's."""
        from tpufg.config import EngineConfig, resolve_sizes
        from tpufg.engine.pipeline import make_interp_step

        prev = rng.integers(0, 256, (64, 128, 4), dtype=np.uint8)
        curr = np.roll(prev, (4, -6), (0, 1))
        outs = {}
        for dt in ("bf16", "f32"):
            cfg = resolve_sizes(EngineConfig(
                input_width=128, input_height=64, output_width=128,
                output_height=64, dtype=dt, motion_mode="pyramid"))
            outs[dt] = [np.asarray(jax.device_get(o)) for o in
                        make_interp_step(cfg)(jnp.asarray(prev),
                                              jnp.asarray(curr))]
        for a, b in zip(outs["bf16"], outs["f32"]):
            np.testing.assert_array_equal(a, b)


class TestStepOnChip:
    def test_production_step_and_y4m_payload(self, rng):
        """One full compiled production step (pyramid + warp + scale) on
        the card: output shapes, plus device-side y4m payload bytes ==
        host-side conversion of the RGBA output."""
        from tpufg.config import EngineConfig, resolve_sizes
        from tpufg.engine.pipeline import make_interp_step
        from tpufg.io.sinks import _down2x2, _rgb_to_bt601

        cfg = resolve_sizes(EngineConfig(
            input_width=128, input_height=96, output_width=256,
            output_height=192, dtype="bf16", motion_mode="pyramid"))
        step_rgba = make_interp_step(cfg, wire="i32")
        step_y4m = make_interp_step(cfg, wire="i32", sink_wire="y4m420")

        a = rng.integers(0, 256, (96, 128, 4), dtype=np.uint8)
        b = rng.integers(0, 256, (96, 128, 4), dtype=np.uint8)
        ai = jnp.asarray(a.view(np.int32).reshape(96, 128))
        bi = jnp.asarray(b.view(np.int32).reshape(96, 128))
        outs = step_rgba(ai, bi)
        assert all(o.shape == (192, 256) for o in outs)
        pay = step_y4m(ai, bi)
        assert all(p.shape == (192 * 3 // 2, 256) for p in pay)
        for o, p in zip(outs, pay):
            rgba = np.asarray(jax.device_get(o)).view(np.uint8).reshape(
                192, 256, 4)
            y, u, v = _rgb_to_bt601(rgba[..., :3])
            host = y.tobytes() + _down2x2(u).tobytes() + _down2x2(v).tobytes()
            assert np.asarray(jax.device_get(p)).tobytes() == host


class TestLearnedDefaultOnChip:
    def test_v3_bundled_head_stream_bitwise(self, rng):
        """The shipping default (bundled v3 streaming head, bf16
        production config) compiled on the card: the q_feed streamed
        step is bitwise-identical to the plain 2-arg step, and outputs
        are valid frames — real weights, not random init."""
        from tpufg.config import EngineConfig, resolve_sizes
        from tpufg.engine.pipeline import make_interp_step, make_q_init
        from tpufg.models import rife

        params = rife.load_params(rife.bundled_checkpoint())
        assert rife.is_v3(params)
        cfg = resolve_sizes(EngineConfig(
            input_width=128, input_height=96, output_width=128,
            output_height=96, dtype="bf16", motion_mode="learned"))
        plain = make_interp_step(cfg, model_params=params)
        qstep = make_interp_step(cfg, model_params=params, q_feed=True)
        frames = [rng.integers(0, 256, (96, 128, 4), dtype=np.uint8)
                  for _ in range(3)]
        fa = [jnp.asarray(f) for f in frames]
        fb = [jnp.asarray(f) for f in frames]
        q = make_q_init(cfg, model_params=params)(fb[0])
        for i in range(2):
            ref = plain(fa[i], fa[i + 1])
            *outs, q = qstep(fb[i], fb[i + 1], q)
            assert len(outs) == len(ref)
            for r, o in zip(ref, outs):
                r, o = np.asarray(r), np.asarray(o)
                assert r.shape == (96, 128, 4) and r.dtype == np.uint8
                assert (r == o).all()


class TestWarpPrepSplitOnChip:
    def test_prepare_banded_bitwise_compiled(self, rng):
        """The split single-mode warp (warp_single_prepare +
        warp_single_banded, the k>2 learned-tail path) compiled is
        bitwise the inline single-mode warp, in the production bf16
        fractional domain AND the v1 integer-code domain."""
        from tpufg.kernels.warp_matmul import (warp_blend_matmul,
                                               warp_single_banded,
                                               warp_single_prepare)
        f = jnp.asarray(
            np.round(rng.random((4, 64, 256)).astype(np.float32) * 255)
            / np.float32(255))
        for io, u8 in ((False, False), (True, True)):
            mv = rng.uniform(-8, 8, (2, 4, 16)).astype(np.float32)
            if io:
                mv = np.round(mv)
            mv = jnp.asarray(mv)
            kw = dict(block=16, search_radius=8, dtype=jnp.bfloat16,
                      integer_offsets=io, u8_exact=u8)
            a = warp_blend_matmul(f, f, mv, single=True, **kw)
            b = warp_single_banded(warp_single_prepare(f, **kw), mv, **kw)
            assert np.array_equal(np.asarray(a), np.asarray(b)), (io, u8)

    def test_multi_t_tails_bitwise_compiled(self, rng):
        """tails_fast at three time points == per-t tail_fast, compiled."""
        from tpufg.models import rife
        params = rife.init_params3(jax.random.PRNGKey(3), hidden=16)
        prev = jnp.asarray(rng.random((4, 48, 128)).astype(np.float32))
        curr = jnp.asarray(rng.random((4, 48, 128)).astype(np.float32))
        out = jax.jit(rife.trunk_fast)(params, prev, curr)
        ts = (1.0 / 3.0, 0.5, 2.0 / 3.0)
        multi = jax.jit(lambda o, p, c: rife.tails_fast(params, o, p, c, ts))(
            out, prev, curr)
        for t, m in zip(ts, multi):
            single = jax.jit(lambda o, p, c: rife.tail_fast(
                params, o, p, c, t))(out, prev, curr)
            assert np.array_equal(np.asarray(m), np.asarray(single)), t
