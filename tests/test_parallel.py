"""Multi-chip sharding on the 8-virtual-device CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from tpufg.parallel.spatial import (HALO, halo_exchange_rows,
                                    make_sharded_interp_step,
                                    make_spatial_mesh)


@pytest.fixture(scope="module")
def devices():
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    return devs


class TestHaloExchange:
    def test_neighbor_rows_and_edge_replication(self, devices):
        mesh = Mesh(np.array(devices[:4]), axis_names=("sp",))
        h_per = 8
        x = jnp.arange(4 * h_per, dtype=jnp.float32).reshape(1, 4 * h_per, 1)
        x = jnp.broadcast_to(x, (1, 4 * h_per, 8)).copy()

        f = shard_map(
            lambda s: halo_exchange_rows(s, "sp", 2),
            mesh=mesh, in_specs=P(None, "sp", None),
            out_specs=P(None, "sp", None), check_vma=False,
        )
        out = np.asarray(jax.jit(f)(x))  # [1, 4*(8+4), 8]
        blocks = out.reshape(1, 4, h_per + 4, 8)
        # interior shard 1: top halo = last rows of shard 0
        np.testing.assert_array_equal(blocks[0, 1, :2, 0], [6.0, 7.0])
        # bottom halo of shard 1 = first rows of shard 2
        np.testing.assert_array_equal(blocks[0, 1, -2:, 0], [16.0, 17.0])
        # shard 0 top halo: edge-replicated row 0
        np.testing.assert_array_equal(blocks[0, 0, :2, 0], [0.0, 0.0])
        # shard 3 bottom halo: edge-replicated last row
        np.testing.assert_array_equal(blocks[0, 3, -2:, 0], [31.0, 31.0])


class TestShardedStep:
    """The sharded step must run the production pipeline math per shard:
    every output (interpolated AND scaled-current) must bitwise-match the
    single-chip make_interp_step away from the frame's outer edges.

    Interior margin: the edge-replicated frame-border halo can perturb MV
    cells within the pyramid's reach (<= HALO rows) plus the warp reach;
    96 input rows (> 64 + 24 + taps) is conservative.  Shard SEAMS sit well
    inside the interior — three of them at rows 128/256/384 here — so this
    pins exactly the cross-shard halo-exchange correctness.
    """

    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_interp_matches_single_chip_interior(self, devices, rng, dtype):
        from tpufg.config import EngineConfig, resolve_sizes
        from tpufg.engine.pipeline import make_interp_step

        mesh = make_spatial_mesh(8, dp=2)
        sp = 4
        in_h, in_w = 2 * sp * HALO, 128     # 4 sp shards x 128 rows
        out_h, out_w = in_h * 2, in_w * 2
        cfg = resolve_sizes(EngineConfig(
            input_width=in_w, input_height=in_h,
            output_width=out_w, output_height=out_h,
            dtype=dtype, motion_mode="pyramid"))
        step = make_sharded_interp_step(mesh, cfg)

        # moving pattern: shifted views of one texture (real cross-shard
        # motion dependence — MVs near seams need neighbor rows)
        tex = rng.integers(0, 256, (in_h + 16, in_w + 16, 4), dtype=np.uint8)
        prev1 = np.ascontiguousarray(tex[:in_h, :in_w])
        curr1 = np.ascontiguousarray(tex[5:in_h + 5, 3:in_w + 3])
        prev2 = np.ascontiguousarray(tex[8:in_h + 8, :in_w])
        curr2 = np.ascontiguousarray(tex[2:in_h + 2, 6:in_w + 6])
        prev_b = jnp.asarray(np.stack([prev1, prev2]))
        curr_b = jnp.asarray(np.stack([curr1, curr2]))
        out_i, out_c = step(prev_b, curr_b)
        assert out_i.shape == (2, out_h, out_w, 4)

        ref_step = make_interp_step(cfg)
        interior = slice(96 * 2, -96 * 2)   # output rows (scale 2)
        for bi, (p, c) in enumerate([(prev1, curr1), (prev2, curr2)]):
            ref_i, ref_c = ref_step(jnp.asarray(p), jnp.asarray(c))
            if dtype == "f32":
                # scaled-current path: bitwise-exact interior in f32 (halo
                # covers all Lanczos taps; per-row scale math is
                # shape-independent)
                np.testing.assert_array_equal(
                    np.asarray(out_c[bi])[interior],
                    np.asarray(ref_c)[interior],
                    err_msg=f"curr pair {bi}: sharded interior diverges")
            # Remaining tolerance is rounding, not semantics: the MV field
            # and a standalone warp are bitwise-identical per shard
            # (verified separately), but inside one jit XLA fuses/tiles the
            # chain differently for the two shapes (and bf16 matmul tiling
            # differs with operand shape), so isolated sums land 1 ulp
            # apart and flip a uint8 rounding at exact .5 boundaries.
            # Contract: <= 1 code, < 0.01% of interior pixels.
            checks = [("interp", out_i[bi], ref_i)]
            if dtype == "bf16":
                checks.append(("curr", out_c[bi], ref_c))
            for name, got, ref in checks:
                d = np.abs(np.asarray(got)[interior].astype(int)
                           - np.asarray(ref)[interior].astype(int))
                assert d.max() <= 1, f"{dtype} {name} pair {bi}: {d.max()}"
                frac = (d > 0).mean()
                assert frac < 1e-4, f"{dtype} {name} pair {bi}: {frac:.2e}"

    def test_scene_cut_agrees_across_shards(self, devices, rng):
        """The cut detector pmeans over sp, so all spatial shards take the
        fallback together (no seams): on a cut pair every in-between frame
        must equal the nearer source frame exactly, across all shards."""
        from tpufg.config import EngineConfig, resolve_sizes

        mesh = make_spatial_mesh(8, dp=2)
        in_h, in_w = 4 * HALO, 128
        cfg = resolve_sizes(EngineConfig(
            input_width=in_w, input_height=in_h,
            output_width=in_w, output_height=in_h,
            dtype="bf16", motion_mode="pyramid",
            scene_cut_threshold=0.1))
        step = make_sharded_interp_step(mesh, cfg)
        p = rng.integers(0, 256, (in_h, in_w, 4), dtype=np.uint8)
        c = rng.integers(0, 256, (in_h, in_w, 4), dtype=np.uint8)
        pb = jnp.asarray(np.stack([p, p]))
        cb = jnp.asarray(np.stack([c, c]))
        out_i, out_c = step(pb, cb)
        # t = 0.5 -> nearer source is curr; identity size -> exact bytes
        np.testing.assert_array_equal(np.asarray(out_i[0]), c)
        np.testing.assert_array_equal(np.asarray(out_c[0]), c)

    def test_dp_replica_consistency(self, devices, rng):
        from tpufg.config import EngineConfig, resolve_sizes

        mesh = make_spatial_mesh(8, dp=2)
        in_h, in_w = 4 * HALO, 128
        cfg = resolve_sizes(EngineConfig(
            input_width=in_w, input_height=in_h,
            output_width=in_w * 2, output_height=in_h * 2,
            dtype="bf16", motion_mode="pyramid"))
        step = make_sharded_interp_step(mesh, cfg)
        p = rng.integers(0, 256, (in_h, in_w, 4), dtype=np.uint8)
        c = rng.integers(0, 256, (in_h, in_w, 4), dtype=np.uint8)
        pb = jnp.asarray(np.stack([p, p]))
        cb = jnp.asarray(np.stack([c, c]))
        out_i, out_c = step(pb, cb)
        np.testing.assert_array_equal(np.asarray(out_i[0]),
                                      np.asarray(out_i[1]))
        np.testing.assert_array_equal(np.asarray(out_c[0]),
                                      np.asarray(out_c[1]))

    def test_fps_multiplier_outputs(self, devices, rng):
        from tpufg.config import EngineConfig, resolve_sizes

        mesh = make_spatial_mesh(8, dp=2)
        in_h, in_w = 4 * HALO, 128
        cfg = resolve_sizes(EngineConfig(
            input_width=in_w, input_height=in_h,
            output_width=in_w, output_height=in_h,  # identity scale
            dtype="bf16", motion_mode="pyramid", fps_multiplier=4))
        step = make_sharded_interp_step(mesh, cfg)
        p = rng.integers(0, 256, (2, in_h, in_w, 4), dtype=np.uint8)
        c = rng.integers(0, 256, (2, in_h, in_w, 4), dtype=np.uint8)
        outs = step(jnp.asarray(p), jnp.asarray(c))
        assert len(outs) == 4           # 3 in-between + scaled current
        np.testing.assert_array_equal(np.asarray(outs[-1]), c)


class TestMeshFactory:
    def test_bad_dp_rejected(self, devices):
        with pytest.raises(ValueError):
            make_spatial_mesh(8, dp=3)


class TestShardedCLI:
    """--devices N exposes the sharded transcode from the CLI (the
    multi-chip path is the same product, reachable the same way)."""

    def _run(self, tmp_path, extra, h=256, frames=5):
        from tpufg.cli import main
        out = tmp_path / ("out_" + "_".join(extra).replace("-", "") + ".raw")
        rc = main([f"synthetic:128x{h}", "--frames", str(frames),
                   "--output-width", "256", "--no-pacing",
                   "--output", str(out), *extra])
        assert rc == 0
        return np.fromfile(out, np.uint8)

    def test_temporal_mv_sharded_stream(self, devices, tmp_path):
        # --temporal-mv + --devices (dp=1): the runner threads the
        # row-sharded predictor state between sequential pairs
        data = self._run(tmp_path, ["--devices", "2", "--temporal-mv"],
                         h=100, frames=5)  # padded to the 256-row lattice
        assert data.size == 9 * (200 * 256 * 4)  # 1 + 4*2 outputs

    def test_temporal_mv_rejects_dp_batching(self, devices, tmp_path):
        from tpufg.cli import main
        rc = main(["synthetic:128x256", "--frames", "4", "--devices", "8",
                   "--dp", "2", "--temporal-mv", "--output-width", "256",
                   "--no-pacing", "--output", "null"])
        assert rc == 1  # clean config error, not a traceback

    def test_matches_single_chip_stream(self, devices, tmp_path):
        single = self._run(tmp_path, [])
        sharded = self._run(tmp_path, ["--devices", "8", "--dp", "2"])
        assert single.size == sharded.size  # same frame count: 1 + 4*2
        out_h, out_w = 512, 256
        fb = out_h * out_w * 4
        n = single.size // fb
        s1 = single.reshape(n, out_h, out_w, 4).astype(int)
        s8 = sharded.reshape(n, out_h, out_w, 4).astype(int)
        # interior rows (frame-border halo effects excluded, see
        # make_sharded_interp_step contract): <= 1 uint8 code
        d = np.abs(s1[:, 192:-192] - s8[:, 192:-192])
        assert d.max() <= 1
        assert (d > 0).mean() < 1e-4

    def test_nonlattice_height_padded(self, devices, tmp_path):
        # 200 rows -> padded to sp*64=512... (sp=4) and cropped back
        data = self._run(tmp_path, ["--devices", "8", "--dp", "2"],
                         h=200, frames=4)
        fb = 400 * 256 * 4
        assert data.size == fb * (1 + 3 * 2)

    def test_overlay_applies_on_sharded_path(self, devices, tmp_path):
        """--overlay must not be silently dropped by --devices (the
        sharded emit burns the same stats line as the single-chip path)."""
        plain = self._run(tmp_path, ["--devices", "8", "--dp", "2"],
                          frames=3)
        overlaid = self._run(tmp_path, ["--devices", "8", "--dp", "2",
                                        "--overlay"], frames=3)
        assert plain.size == overlaid.size
        assert not np.array_equal(plain, overlaid)
        # the stats text is white-on-frame at (10,10): overlaid frames
        # must contain pure-white pixels in that band
        fb = 512 * 256 * 4
        f0 = overlaid[:fb].reshape(512, 256, 4)
        band = f0[8:24, 8:200, :3]
        assert (band == 255).all(axis=-1).any()

    def test_too_many_devices_rejected(self, devices, tmp_path):
        from tpufg.cli import main
        rc = main(["synthetic:128x256", "--devices", "999",
                   "--output-width", "256", "--no-pacing"])
        assert rc == 1


class TestShardedLearned:
    def test_sharded_learned_matches_single_chip_interior(self, devices,
                                                          rng):
        """Sharded learned mode: the conv trunk runs per shard on the
        64-row-halo-extended rows (the trunk's receptive field + clamped
        flow reach stay inside the halo), so interior rows must match the
        single-chip learned step to <= 1 uint8 code."""
        from tpufg.config import EngineConfig, resolve_sizes
        from tpufg.engine.pipeline import make_interp_step
        from tpufg.models import rife

        params = rife.init_params(jax.random.PRNGKey(0), hidden=16)
        mesh = make_spatial_mesh(4, dp=1)
        in_h, in_w = 4 * HALO, 128
        cfg = resolve_sizes(EngineConfig(
            input_width=in_w, input_height=in_h,
            output_width=in_w, output_height=in_h,
            dtype="f32", motion_mode="learned"))
        step = make_sharded_interp_step(mesh, cfg, model_params=params)
        ref_step = make_interp_step(cfg, model_params=params)

        base = rng.random((in_h + 16, in_w + 16, 4)).astype(np.float32)
        for k in (1, 2):
            base = (base + np.roll(base, k, 0) + np.roll(base, k, 1)) / 3
        base = (base * 255).astype(np.uint8)
        p = base[:in_h, :in_w]
        c = base[8:8 + in_h, 4:4 + in_w]
        out_i, out_c = step(jnp.asarray(p)[None], jnp.asarray(c)[None])
        ref_i, ref_c = ref_step(jnp.asarray(p), jnp.asarray(c))
        # away from the frame's outer edges (halo edge-replication differs
        # from single-chip conv zero-padding there by design)
        interior = (slice(HALO, -HALO), slice(8, -8))
        d = np.abs(np.asarray(out_i[0])[interior].astype(int)
                   - np.asarray(ref_i)[interior].astype(int))
        assert d.max() <= 1, d.max()
        assert (d > 0).mean() < 1e-3
        np.testing.assert_array_equal(np.asarray(out_c[0]), np.asarray(ref_c))

    def test_sharded_temporal_matches_single_chip(self, devices, rng):
        """Temporal-MV under spatial sharding (dp=1): the row-sharded
        predictor state is halo-exchanged like frame rows, so a sustained
        fast pan must lock on exactly as the single-chip temporal engine
        does — interior MV state bitwise, outputs <= 1 code interior."""
        from tpufg.config import EngineConfig, resolve_sizes
        from tpufg.engine.pipeline import make_interp_step, mv_lattice_shape

        mesh = make_spatial_mesh(2, dp=1)
        in_h, in_w = 4 * 2 * HALO, 256      # temporal halo is 2*HALO
        cfg = resolve_sizes(EngineConfig(
            input_width=in_w, input_height=in_h,
            output_width=in_w, output_height=in_h,
            dtype="f32", motion_mode="pyramid", temporal_mv=True))
        step = make_sharded_interp_step(mesh, cfg)
        ref_step = make_interp_step(cfg)

        # 28 px/frame pan: beyond the per-pair pyramid reach — only the
        # threaded predictor can track it (models/pyramid.py seeding; the
        # multi-octave smoothing makes the coarse levels matchable, same
        # recipe as TestTemporalMV)
        base = rng.random((in_h, in_w + 256, 4)).astype(np.float32)
        for k in (1, 2, 4):
            base = (base + np.roll(base, k, 0) + np.roll(base, k, 1)) / 3
        base = (base * 255).astype(np.uint8)
        frames = [np.ascontiguousarray(base[:, 28 * i:28 * i + in_w])
                  for i in range(5)]

        from tpufg.parallel.spatial import sharded_mv_lattice_shape
        assert sharded_mv_lattice_shape(cfg) == mv_lattice_shape(cfg)
        mv_sh = jnp.zeros((1,) + sharded_mv_lattice_shape(cfg), jnp.float32)
        mv_ref = jnp.zeros(mv_lattice_shape(cfg), jnp.float32)
        for i in range(4):
            p, c = jnp.asarray(frames[i]), jnp.asarray(frames[i + 1])
            *outs_sh, mv_sh = step(p[None], c[None], mv_sh)
            *outs_ref, mv_ref = ref_step(p, c, mv_ref)
        # the tracker locked on (backward flow of a left-shifting view)
        med = float(jnp.median(mv_ref[0]))
        assert abs(med - 28.0) <= 4.0, med
        # interior lattice rows (exclude 2*HALO/16 rows at frame edges and
        # the shard seam's reach) must match bitwise
        lat_halo = 2 * HALO // 16
        np.testing.assert_array_equal(
            np.asarray(mv_sh[0])[:, lat_halo:-lat_halo, :],
            np.asarray(mv_ref)[:, lat_halo:-lat_halo, :])
        d = np.abs(np.asarray(outs_sh[0][0]).astype(int)
                   - np.asarray(outs_ref[0]).astype(int))[
                       2 * HALO:-2 * HALO]
        assert d.max() <= 1, d.max()

    def test_sharded_learned_requires_params(self, devices):
        from tpufg.config import ConfigError, EngineConfig, resolve_sizes
        mesh = make_spatial_mesh(4, dp=1)
        cfg = resolve_sizes(EngineConfig(
            input_width=128, input_height=4 * HALO,
            motion_mode="learned"))
        with pytest.raises(ConfigError):
            make_sharded_interp_step(mesh, cfg)


class TestShardedStreamCache:
    """q_feed under spatial sharding (verdict r4 item 6): the v2/v3
    per-stream siamese cache threads through the sharded step.  The cache
    holds the encoder outputs of the HALO-EXTENDED shard frame (encoded
    after the frame-level exchange), so the cached path must be
    bitwise-identical to the cache-less sharded path — which is itself
    interior-parity-pinned against single-chip above."""

    def _frames(self, rng, in_h, in_w, n=3):
        base = rng.random((in_h + 32, in_w + 32, 4)).astype(np.float32)
        for k in (1, 2):
            base = (base + np.roll(base, k, 0) + np.roll(base, k, 1)) / 3
        base = (base * 255).astype(np.uint8)
        return [np.ascontiguousarray(base[4 * i:4 * i + in_h,
                                          3 * i:3 * i + in_w])
                for i in range(n)]

    @pytest.mark.parametrize("arch", ["v2", "v3"])
    def test_cached_stream_bitwise_matches_cacheless(self, devices, rng,
                                                     arch):
        from tpufg.config import EngineConfig, resolve_sizes
        from tpufg.models import rife
        from tpufg.parallel.spatial import (make_sharded_q_init,
                                            sharded_q_shapes)

        init = rife.init_params2 if arch == "v2" else rife.init_params3
        params = init(jax.random.PRNGKey(0), hidden=16)
        mesh = make_spatial_mesh(4, dp=1)
        in_h, in_w = 4 * HALO, 128
        cfg = resolve_sizes(EngineConfig(
            input_width=in_w, input_height=in_h,
            output_width=in_w, output_height=in_h,
            dtype="f32", motion_mode="learned"))
        step = make_sharded_interp_step(mesh, cfg, model_params=params)
        step_q = make_sharded_interp_step(mesh, cfg, model_params=params,
                                          q_feed=True)
        q_init = make_sharded_q_init(mesh, cfg, params)

        frames = self._frames(rng, in_h, in_w)
        cache = q_init(jnp.asarray(frames[0])[None])
        shapes = sharded_q_shapes(cfg, 4, params)
        assert len(cache) == len(shapes) == (2 if arch == "v3" else 1)
        for got, want in zip(cache, shapes):
            assert got.shape[1:] == want.shape and got.dtype == want.dtype
        # two consecutive pairs: the threaded cache must reproduce the
        # cache-less outputs bitwise at EVERY pixel (same math, cached)
        for i in range(2):
            p = jnp.asarray(frames[i])[None]
            c = jnp.asarray(frames[i + 1])[None]
            ref = step(p, c)
            n_cache = len(cache)
            *outs, = step_q(p, c, *cache)
            outs, cache = outs[:-n_cache], tuple(outs[-n_cache:])
            for o, r in zip(outs, ref):
                np.testing.assert_array_equal(np.asarray(o), np.asarray(r))

    def test_runner_sharded_learned_stream_uses_cache(self, devices, rng,
                                                      tmp_path):
        """run_sharded_stream (learned, dp=1) threads the stream cache;
        its emitted frames must be BITWISE the cache-less sharded step's
        outputs pair by pair (the cache contract, at the product level)."""
        import jax.numpy as jnp
        from tpufg.config import EngineConfig, resolve_sizes
        from tpufg.engine.runner import run_sharded_stream
        from tpufg.models import rife

        params = rife.init_params3(jax.random.PRNGKey(2), hidden=16)
        in_h, in_w = 4 * HALO, 128
        cfg = resolve_sizes(EngineConfig(
            input_width=in_w, input_height=in_h,
            output_width=in_w, output_height=in_h,
            dtype="f32", motion_mode="learned"))
        frames = self._frames(rng, in_h, in_w, n=4)

        class ListSource:
            const_alpha = None

            def __iter__(self):
                return iter(frames)

        class ListSink:
            def __init__(self):
                self.out = []

            def write(self, arr):
                self.out.append(np.array(arr))

            def close(self):
                pass

        sink = ListSink()
        stats = run_sharded_stream(cfg, ListSource(), sink, devices=4,
                                   dp=1, model_params=params)
        assert stats.frames_in == 4
        # 1 first-frame scale + 3 pairs x 2 outputs
        assert len(sink.out) == 7

        mesh = make_spatial_mesh(4, dp=1)
        ref_step = make_sharded_interp_step(mesh, cfg, model_params=params)
        idx = 1
        for i in range(3):
            ref = ref_step(jnp.asarray(frames[i])[None],
                           jnp.asarray(frames[i + 1])[None])
            for r in ref:
                np.testing.assert_array_equal(sink.out[idx],
                                              np.asarray(r[0]))
                idx += 1

    def test_q_feed_rejects_non_learned_and_v1(self, devices):
        from tpufg.config import ConfigError, EngineConfig, resolve_sizes
        from tpufg.models import rife
        mesh = make_spatial_mesh(4, dp=1)
        cfg = resolve_sizes(EngineConfig(
            input_width=128, input_height=4 * HALO,
            motion_mode="pyramid"))
        with pytest.raises(ConfigError, match="learned"):
            make_sharded_interp_step(mesh, cfg, q_feed=True)
        cfg_l = resolve_sizes(EngineConfig(
            input_width=128, input_height=4 * HALO,
            motion_mode="learned"))
        v1 = rife.init_params(jax.random.PRNGKey(0), hidden=16)
        with pytest.raises(ConfigError, match="v2/v3"):
            make_sharded_interp_step(mesh, cfg_l, model_params=v1,
                                     q_feed=True)


class TestShardedMotionModeMatrix:
    """Every motion_mode x --devices combination either works (interior
    parity vs the single-chip step) or fails at config time.  pyramid,
    learned and temporal-mv are pinned above; exhaustive and none here
    (these cells were previously untested)."""

    def test_sharded_quality_preset_interior(self, devices, rng):
        """The full --quality preset (mv_grid 1 + subpel + mv_bias +
        mv_filter + mc_fallback, plus occlusion_blend) under --devices:
        interior parity vs the single-chip step.  Pins that every
        preset component — the OBMC warp's band geometry, the subpel
        probe warp, and the fallback's 8x8 cell statistics — stays
        local enough that halo exchange preserves the interior."""
        from tpufg.config import EngineConfig, resolve_sizes
        from tpufg.engine.pipeline import make_interp_step

        mesh = make_spatial_mesh(8, dp=2)
        sp = 4
        in_h, in_w = sp * HALO, 128
        cfg = resolve_sizes(EngineConfig(
            input_width=in_w, input_height=in_h,
            output_width=in_w, output_height=in_h,
            dtype="f32", motion_mode="pyramid", mv_grid=1, subpel=True,
            mv_bias=0.1, mv_filter=True, mc_fallback=True,
            occlusion_blend=True))
        step = make_sharded_interp_step(mesh, cfg)

        tex = rng.integers(0, 256, (in_h + 16, in_w + 16, 4), dtype=np.uint8)
        prev1 = np.ascontiguousarray(tex[:in_h, :in_w])
        curr1 = np.ascontiguousarray(tex[4:in_h + 4, 2:in_w + 2])
        prev2 = np.ascontiguousarray(tex[8:in_h + 8, :in_w])
        curr2 = np.ascontiguousarray(tex[2:in_h + 2, 6:in_w + 6])
        out_i, out_c = step(jnp.asarray(np.stack([prev1, prev2])),
                            jnp.asarray(np.stack([curr1, curr2])))

        ref_step = make_interp_step(cfg)
        interior = slice(96, -96)
        for bi, (p, c) in enumerate([(prev1, curr1), (prev2, curr2)]):
            ref_i, ref_c = ref_step(jnp.asarray(p), jnp.asarray(c))
            np.testing.assert_array_equal(
                np.asarray(out_c[bi])[interior],
                np.asarray(ref_c)[interior],
                err_msg=f"quality curr pair {bi}: sharded interior diverges")
            d = np.abs(np.asarray(out_i[bi])[interior].astype(int)
                       - np.asarray(ref_i)[interior].astype(int))
            assert d.max() <= 1, f"quality interp pair {bi}: {d.max()}"
            assert (d > 0).mean() < 1e-4, f"quality interp pair {bi}"

    @pytest.mark.parametrize("mode,r", [("exhaustive", 8), ("none", 16)])
    def test_sharded_mode_matches_single_chip_interior(self, devices, rng,
                                                       mode, r):
        from tpufg.config import EngineConfig, resolve_sizes
        from tpufg.engine.pipeline import make_interp_step

        mesh = make_spatial_mesh(8, dp=2)
        sp = 4
        in_h, in_w = sp * HALO, 128
        cfg = resolve_sizes(EngineConfig(
            input_width=in_w, input_height=in_h,
            output_width=in_w * 2, output_height=in_h * 2,
            dtype="f32", motion_mode=mode, search_radius=r))
        step = make_sharded_interp_step(mesh, cfg)

        tex = rng.integers(0, 256, (in_h + 16, in_w + 16, 4), dtype=np.uint8)
        prev1 = np.ascontiguousarray(tex[:in_h, :in_w])
        curr1 = np.ascontiguousarray(tex[4:in_h + 4, 2:in_w + 2])
        prev2 = np.ascontiguousarray(tex[8:in_h + 8, :in_w])
        curr2 = np.ascontiguousarray(tex[2:in_h + 2, 6:in_w + 6])
        out_i, out_c = step(jnp.asarray(np.stack([prev1, prev2])),
                            jnp.asarray(np.stack([curr1, curr2])))

        ref_step = make_interp_step(cfg)
        interior = slice(96 * 2, -96 * 2)
        for bi, (p, c) in enumerate([(prev1, curr1), (prev2, curr2)]):
            ref_i, ref_c = ref_step(jnp.asarray(p), jnp.asarray(c))
            # scaled-current: bitwise interior in f32 (same contract as
            # the pyramid parity test)
            np.testing.assert_array_equal(
                np.asarray(out_c[bi])[interior],
                np.asarray(ref_c)[interior],
                err_msg=f"{mode} curr pair {bi}: sharded interior diverges")
            d = np.abs(np.asarray(out_i[bi])[interior].astype(int)
                       - np.asarray(ref_i)[interior].astype(int))
            assert d.max() <= 1, f"{mode} interp pair {bi}: {d.max()}"
            assert (d > 0).mean() < 1e-4, f"{mode} interp pair {bi}"
