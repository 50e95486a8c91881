"""Learned interpolation head (config 5)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tpufg.models import rife


def _opt_like_const(lr, hidden):
    """An opt-state template matching a constant-lr training run."""
    init_state, _, _ = rife.make_train_step(lr)
    _, opt_like = init_state(jax.random.PRNGKey(0), hidden)
    return opt_like


@pytest.fixture
def triplet(rng):
    prev = jnp.asarray(rng.random((2, 4, 32, 48)).astype(np.float32))
    curr = jnp.asarray(rng.random((2, 4, 32, 48)).astype(np.float32))
    target = 0.5 * (prev + curr)
    return prev, curr, target


def test_forward_shapes_finite(triplet):
    prev, curr, _ = triplet
    params = rife.init_params(jax.random.PRNGKey(0), hidden=32)
    out = rife.forward(params, prev, curr, 0.5)
    assert out.shape == prev.shape
    assert bool(jnp.all(jnp.isfinite(out)))


def test_training_reduces_loss(triplet):
    prev, curr, target = triplet
    init_state, train_step, _ = rife.make_train_step(1e-3)
    params, opt_state = init_state(jax.random.PRNGKey(0), 32)
    losses = []
    for _ in range(8):
        params, opt_state, loss = train_step(params, opt_state, prev, curr,
                                             target)
        losses.append(float(loss))
    assert losses[-1] < losses[0]


def test_bilinear_warp_integer_shift(rng):
    img = jnp.asarray(rng.random((1, 1, 8, 16)).astype(np.float32))
    flow = jnp.full((1, 2, 8, 16), 2.0, jnp.float32)
    out = rife.bilinear_warp(img, flow)
    np.testing.assert_allclose(np.asarray(out[0, 0, :-2, :-2]),
                               np.asarray(img[0, 0, 2:, 2:]), atol=1e-6)


def test_warp_gradients_flow(rng):
    img = jnp.asarray(rng.random((1, 1, 8, 16)).astype(np.float32))
    flow = jnp.full((1, 2, 8, 16), 0.5, jnp.float32)
    g = jax.grad(lambda f: jnp.sum(rife.bilinear_warp(img, f)))(flow)
    assert bool(jnp.any(g != 0))
    assert bool(jnp.all(jnp.isfinite(g)))


def test_tp_sharded_training_step(rng):
    devs = jax.devices()
    if len(devs) < 8:
        pytest.skip("needs 8 virtual devices")
    from jax.sharding import Mesh
    mesh = Mesh(np.array(devs[:8]).reshape(4, 2), axis_names=("dp", "tp"))
    init_state, train_step, _ = rife.make_train_step(1e-4, mesh=mesh)
    with mesh:
        params, opt_state = init_state(jax.random.PRNGKey(0), 32)
        prev = jnp.asarray(rng.random((8, 4, 32, 64)).astype(np.float32))
        curr = jnp.asarray(rng.random((8, 4, 32, 64)).astype(np.float32))
        target = 0.5 * (prev + curr)
        params, opt_state, loss = train_step(params, opt_state, prev, curr,
                                             target)
    assert np.isfinite(float(loss))


class TestIFNet2:
    """Two-stage coarse-to-fine head (v2, round 4)."""

    def test_down4_mean_matches_chained_down2(self, rng):
        """_down4_mean is the chained 2x2 mean up to f32 re-association
        (one reduce_window — see its docstring)."""
        x = jnp.asarray(rng.random((2, 4, 32, 48)).astype("float32") * 255)
        a = rife._down4_mean(x)
        b = rife._down2_mean(rife._down2_mean(x))
        assert a.shape == b.shape == (2, 4, 8, 12)
        assert float(jnp.max(jnp.abs(a - b))) < 1e-4

    def test_forward2_shapes_finite(self, triplet):
        prev, curr, _ = triplet
        params = rife.init_params2(jax.random.PRNGKey(0), hidden=32)
        out = rife.forward2(params, prev, curr, 0.5)
        assert out.shape == prev.shape
        assert bool(jnp.all(jnp.isfinite(out)))
        pred, pred8 = rife.forward2(params, prev, curr, 0.5, with_aux=True)
        assert pred8.shape == (2, 4, prev.shape[2] // 8, prev.shape[3] // 8)

    def test_training2_reduces_loss(self, triplet):
        prev, curr, _ = triplet
        # NOT the midpoint blend: v2's zero-initialized flow heads start
        # exactly at the blend (flow 0, mask 0.5), so a blend target
        # would be optimal at init — bias toward prev instead, which the
        # mask must learn
        target = 0.8 * prev + 0.2 * curr
        init_state, train_step, _ = rife.make_train_step(1e-3, arch="v2")
        params, opt_state = init_state(jax.random.PRNGKey(0), 32)
        losses = []
        for _ in range(8):
            params, opt_state, loss = train_step(params, opt_state, prev,
                                                 curr, target)
            losses.append(float(loss))
        assert losses[-1] < losses[0]

    def test_interpolate_fast_dispatches_v2(self, rng):
        params = rife.init_params2(jax.random.PRNGKey(1), hidden=32)
        prev = jnp.asarray(rng.random((4, 32, 64)).astype(np.float32))
        curr = jnp.asarray(rng.random((4, 32, 64)).astype(np.float32))
        out = rife.interpolate_fast(params, prev, curr, 0.5)
        assert out.shape == prev.shape
        assert bool(jnp.all(jnp.isfinite(out)))

    def test_integer_flow_default_per_arch(self, rng):
        """v1 defaults to integer block flows, v2 to fractional: v1's
        converged flows are sub-pixel (rounding measured +0.27 dB), v2
        learns real fractional flows (rounding measured -2.44 dB on the
        rich corpus — the round-4 fast-path regression)."""
        prev = jnp.asarray(rng.random((4, 32, 64)).astype(np.float32))
        curr = jnp.asarray(rng.random((4, 32, 64)).astype(np.float32))

        def noisy(params):  # zero-init heads emit flow 0 — perturb
            return jax.tree_util.tree_map(
                lambda x: x + 0.05 * jax.random.normal(
                    jax.random.PRNGKey(9), x.shape), params)

        v2 = noisy(rife.init_params2(jax.random.PRNGKey(1), hidden=32))
        d = rife.interpolate_fast(v2, prev, curr, dtype=jnp.float32)
        f = rife.interpolate_fast(v2, prev, curr, dtype=jnp.float32,
                                  integer_flow=False)
        np.testing.assert_array_equal(np.asarray(d), np.asarray(f))

        v1 = noisy(rife.init_params(jax.random.PRNGKey(1), hidden=32))
        d1 = rife.interpolate_fast(v1, prev, curr, dtype=jnp.float32)
        i1 = rife.interpolate_fast(v1, prev, curr, dtype=jnp.float32,
                                   integer_flow=True)
        np.testing.assert_array_equal(np.asarray(d1), np.asarray(i1))

    @pytest.mark.parametrize("arch", ["v1", "v2", "v3"])
    def test_trunk_tail_split_matches_fused(self, arch, rng):
        """The fps-multiplying engine computes the t-independent trunk
        ONCE per pair and one tail per time point; the split must be
        bitwise-equal to the fused interpolate_fast at every t."""
        init = {"v1": rife.init_params, "v2": rife.init_params2,
                "v3": rife.init_params3}[arch]
        params = jax.tree_util.tree_map(
            lambda x: x + 0.05 * jax.random.normal(
                jax.random.PRNGKey(7), x.shape),
            init(jax.random.PRNGKey(1), hidden=32))
        prev = jnp.asarray(rng.random((4, 64, 64)).astype(np.float32))
        curr = jnp.asarray(rng.random((4, 64, 64)).astype(np.float32))
        out = rife.trunk_fast(params, prev, curr, dtype=jnp.float32)
        for t in (0.25, 0.5, 0.75):
            split = rife.tail_fast(params, out, prev, curr, t,
                                   dtype=jnp.float32)
            fused = rife.interpolate_fast(params, prev, curr, t,
                                          dtype=jnp.float32)
            np.testing.assert_array_equal(np.asarray(split),
                                          np.asarray(fused))

    def test_checkpoint_roundtrip_infers_arch(self, tmp_path):
        from tpufg.utils.checkpoint import save_pytree
        for init, name in ((rife.init_params, "v1"),
                           (rife.init_params2, "v2")):
            params = init(jax.random.PRNGKey(2), hidden=32)
            p = str(tmp_path / f"{name}.npz")
            save_pytree(p, params)
            loaded = rife.load_params(p)
            assert rife.is_v2(loaded) == (name == "v2")
            jax.tree_util.tree_map(
                lambda a, b: np.testing.assert_array_equal(
                    np.asarray(a), np.asarray(b)), params, loaded)

    def test_tp_sharded_training2_step(self, rng):
        devs = jax.devices()
        if len(devs) < 8:
            pytest.skip("needs 8 virtual devices")
        from jax.sharding import Mesh
        mesh = Mesh(np.array(devs[:8]).reshape(4, 2), axis_names=("dp", "tp"))
        init_state, train_step, _ = rife.make_train_step(1e-4, mesh=mesh,
                                                         arch="v2")
        with mesh:
            params, opt_state = init_state(jax.random.PRNGKey(0), 32)
            prev = jnp.asarray(rng.random((8, 4, 32, 64)).astype(np.float32))
            curr = jnp.asarray(rng.random((8, 4, 32, 64)).astype(np.float32))
            target = 0.5 * (prev + curr)
            params, opt_state, loss = train_step(params, opt_state, prev,
                                                 curr, target)
        assert np.isfinite(float(loss))

    def test_engine_runs_v2_head(self, rng, tmp_path):
        from tpufg.config import EngineConfig, resolve_sizes
        from tpufg.engine.pipeline import make_interp_step
        from tpufg.utils.checkpoint import save_pytree
        params = rife.init_params2(jax.random.PRNGKey(3), hidden=32)
        cfg = resolve_sizes(EngineConfig(
            input_width=64, input_height=32, output_width=64,
            output_height=32, dtype="f32", motion_mode="learned"))
        step = make_interp_step(cfg, model_params=params)
        f = rng.integers(0, 256, (2, 32, 64, 4), dtype=np.uint8)
        outs = step(jnp.asarray(f[0]), jnp.asarray(f[1]))
        assert outs[0].shape == (32, 64, 4)


class TestFastConsistentTraining:
    """ft mode (round 4): the training loss runs a differentiable replica
    of the deployed inference tail — pin the replica against the REAL
    inference path (Pallas conv + one-hot block warp) at f32, and that
    gradients still reach the flow heads through the straight-through
    rounding."""

    @pytest.fixture
    def u8pair(self, rng):
        f = rng.integers(0, 256, (2, 4, 64, 96)).astype(np.float32) / 255.0
        return jnp.asarray(f[0]), jnp.asarray(f[1])

    def _noisy(self, params, key=7, scale=0.03):
        # v2 flow heads are zero-init; perturb so flows/masks are nonzero
        return jax.tree_util.tree_map(
            lambda x: x + scale * jax.random.normal(
                jax.random.PRNGKey(key), x.shape), params)

    @pytest.mark.parametrize("arch", ["v1", "v2", "v3"])
    def test_ft_matches_inference_f32(self, arch, u8pair):
        prev, curr = u8pair
        if arch == "v3":
            # no forward3 wrapper: replicate loss_fn3's ft path — trunk
            # with the 8-px coarse-warp replica + fractional tail replica
            params = self._noisy(rife.init_params3(jax.random.PRNGKey(1)))
            out1, _ = rife._head3_raw(params, prev[None], curr[None],
                                      ft=True)
            ft = rife._ft_tail(out1, prev[None], curr[None], 0.5,
                               integer_flow=False)
        else:
            init = rife.init_params if arch == "v1" else rife.init_params2
            fwd = rife.forward if arch == "v1" else rife.forward2
            params = self._noisy(init(jax.random.PRNGKey(1)))
            ft = fwd(params, prev[None], curr[None], 0.5, ft=True)
        fast = rife.interpolate_fast(params, prev, curr, 0.5,
                                     dtype=jnp.float32)
        assert float(jnp.max(jnp.abs(ft[0] - fast))) < 1e-5

    @pytest.mark.parametrize("arch", ["v1", "v2", "v3"])
    def test_ft_gradients_reach_flow_heads(self, arch, u8pair):
        prev, curr = u8pair
        init = {"v1": rife.init_params, "v2": rife.init_params2,
                "v3": rife.init_params3}[arch]
        lf = {"v1": rife.loss_fn, "v2": rife.loss_fn2,
              "v3": rife.loss_fn3}[arch]
        params = self._noisy(init(jax.random.PRNGKey(1)))
        target = 0.3 * prev + 0.7 * curr
        grads = jax.grad(lambda p: lf(p, prev[None], curr[None],
                                      target[None], ft=True))(params)
        head = grads["head" if arch == "v1" else "r_head"]["w"]
        assert bool(jnp.all(jnp.isfinite(head)))
        assert float(jnp.max(jnp.abs(head))) > 0.0

    def test_ft_training_reduces_loss(self, u8pair):
        prev, curr = u8pair
        target = 0.8 * prev + 0.2 * curr
        # fine-tune lr: from zero-init at 1e-3 the straight-through flow
        # gradients oscillate (measured: loss 0.10 -> 0.26 plateau); ft is
        # documented as a fine-tuning mode and 1e-4 descends monotonically
        init_state, train_step, _ = rife.make_train_step(
            1e-4, arch="v2", ft=True)
        params, opt_state = init_state(jax.random.PRNGKey(0), 16)
        losses = []
        for _ in range(6):
            params, opt_state, loss = train_step(
                params, opt_state, prev[None], curr[None], target[None])
            losses.append(float(loss))
        assert losses[-1] < losses[0]


class TestTrainCLI:
    def test_save_every_checkpoints_midrun(self, tmp_path, monkeypatch):
        """--save-every N writes the checkpoint DURING the run (a
        bounded/killed run keeps its progress — the end-of-run-only
        save lost a 5540-step round-4 campaign run)."""
        import tpufg.utils.checkpoint as ckpt_mod
        from tpufg.models import train
        saves = []
        orig = ckpt_mod.save_pytree
        monkeypatch.setattr(
            ckpt_mod, "save_pytree",
            lambda path, tree: (saves.append(path), orig(path, tree))[1])
        ckpt = str(tmp_path / "periodic.npz")
        rc = train.main(["synthetic:64x64", "--steps", "5", "--batch",
                         "2", "--crop", "32x48", "--hidden", "16",
                         "--save-every", "2", "--checkpoint", ckpt,
                         "--log-every", "2"])
        assert rc == 0
        # mid-run saves at steps 2 and 4, plus the final save; each save
        # writes the params file AND the sidecar train state
        state = str(tmp_path / "periodic.state.npz")
        assert saves == [ckpt, state] * 3
        from tpufg.models import rife
        assert rife.load_params(ckpt)["enc2"]["w"].shape[0] == 16

    def test_resume_continues_from_saved_step(self, tmp_path):
        """--resume with the sidecar state is a TRUE resume: the run
        continues from the saved step with the saved optimizer (the lr
        schedule count rides in the optimizer state), and a checkpoint
        already at --steps is rejected rather than silently retrained."""
        import jax

        from tpufg.models import train
        ckpt = str(tmp_path / "r.npz")
        args = ["synthetic:64x64", "--batch", "2", "--crop", "32x48",
                "--hidden", "16", "--cosine", "--log-every", "2",
                "--checkpoint", ckpt]
        assert train.main(args + ["--steps", "3"]) == 0
        import optax

        # the sidecar's structure includes the schedule state, so opt_like
        # must be built with a schedule too (the run used --cosine)
        init_state, _, _ = rife.make_train_step(optax.constant_schedule(1e-4))
        _, opt_like = init_state(jax.random.PRNGKey(0), 16)
        _, step, _ = train.load_state(train._state_path(ckpt), opt_like)
        assert step == 3
        # resuming with --steps == the saved step: nothing to do
        assert train.main(args + ["--steps", "3", "--resume", ckpt]) == 1
        # true resume to the full horizon; final state records step 6
        assert train.main(args + ["--steps", "6", "--resume", ckpt]) == 0
        _, step, _ = train.load_state(train._state_path(ckpt), opt_like)
        assert step == 6

    def test_ema_step_math(self):
        """make_train_step(ema_decay=d) returns exactly
        d*ema + (1-d)*params' (computed on device, same op order)."""
        import jax
        import jax.numpy as jnp
        import numpy as np

        init_state, step, _ = rife.make_train_step(1e-3, ema_decay=0.9)
        params, opt = init_state(jax.random.PRNGKey(0), 16)
        k = jax.random.PRNGKey(1)
        prev, curr, tgt = (
            jax.random.uniform(jax.random.fold_in(k, i), (1, 4, 32, 48),
                               dtype=jnp.float32) for i in range(3))
        p1, _, ema1, _ = step(params, opt, params, prev, curr, tgt)
        want = jax.tree_util.tree_map(
            lambda e, p: e * 0.9 + p * (1.0 - 0.9), params, p1)
        # compiled step may fuse the blend into FMAs — compare to f32 eps
        for got, exp in zip(jax.tree_util.tree_leaves(ema1),
                            jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(np.asarray(got), np.asarray(exp),
                                       rtol=1e-6, atol=1e-7)

    def test_ema_trainer_end_to_end(self, tmp_path):
        """--ema writes <ckpt>.ema.npz (a loadable head that differs from
        the raw params), stores the average in the sidecar, and resume
        continues it — including a resume WITHOUT --ema (the optimizer
        state must survive the sidecar's extra leaves)."""
        import os

        import numpy as np

        from tpufg.models import train
        ckpt = str(tmp_path / "e.npz")
        args = ["synthetic:64x64", "--batch", "2", "--crop", "32x48",
                "--hidden", "16", "--checkpoint", ckpt, "--log-every", "2",
                "--lr", "1e-2"]
        assert train.main(args + ["--steps", "2", "--ema", "0.5"]) == 0
        ep = train._ema_path(ckpt)
        assert os.path.exists(ep)
        raw = rife.load_params(ckpt)
        ema = rife.load_params(ep)
        # 2 steps at decay 0.5 from init: the average lags the raw params
        diffs = [float(np.abs(a - b).max()) for a, b in zip(
            jax.tree_util.tree_leaves(raw), jax.tree_util.tree_leaves(ema))]
        assert max(diffs) > 0.0
        # true resume keeps the average going (step 2 -> 4)
        assert train.main(args + ["--steps", "4", "--ema", "0.5",
                                  "--resume", ckpt]) == 0
        _, step, saved_ema = train.load_state(
            train._state_path(ckpt), _opt_like_const(1e-2, 16), ema_like=raw)
        assert step == 4 and saved_ema is not None
        # toggling --ema off on resume still restores the optimizer state
        assert train.main(args + ["--steps", "6", "--resume", ckpt]) == 0
        _, step, _ = train.load_state(
            train._state_path(ckpt), _opt_like_const(1e-2, 16))
        assert step == 6

    def test_resume_without_sidecar_warm_restarts(self, tmp_path):
        """params-only checkpoints (no sidecar) keep the old semantics:
        fresh optimizer, step 0."""
        import os

        from tpufg.models import train
        ckpt = str(tmp_path / "w.npz")
        args = ["synthetic:64x64", "--batch", "2", "--crop", "32x48",
                "--hidden", "16", "--checkpoint", ckpt, "--log-every", "2"]
        assert train.main(args + ["--steps", "2"]) == 0
        os.unlink(train._state_path(ckpt))
        assert train.main(args + ["--steps", "2", "--resume", ckpt]) == 0

    def test_train_main_raw_file_epochs(self, rng, tmp_path):
        """Trainer on a raw FILE source: size flags accepted, multiple
        epochs over a short file (re-opened per epoch — the one-shot
        native ring cannot re-iterate), checkpoint written."""
        from tpufg.models import train
        raw = str(tmp_path / "t.raw")
        frames = rng.integers(0, 256, (10, 48, 64, 4), dtype=np.uint8)
        open(raw, "wb").write(frames.tobytes())
        ckpt = str(tmp_path / "h.npz")
        # 10 frames -> 8 triplets/epoch -> 4 batches/epoch; 9 steps needs
        # 3 epochs
        rc = train.main([raw, "--input-width", "64", "--input-height", "48",
                         "--arch", "v2", "--steps", "9", "--batch", "2",
                         "--crop", "32x48", "--hidden", "16",
                         "--checkpoint", ckpt])
        assert rc == 0
        import os
        assert os.path.exists(ckpt)
        loaded = rife.load_params(ckpt)
        assert rife.is_v2(loaded)

    def test_train_main_multi_input_interleave_cosine(self, rng, tmp_path):
        """Multiple INPUTs round-robin batch-by-batch (each source visited
        throughout the run, not sequentially) with --cosine lr; steps past
        one source's length force per-source epoch re-opens."""
        from tpufg.models import train
        paths = []
        for i in range(2):
            raw = str(tmp_path / f"t{i}.raw")
            frames = rng.integers(0, 256, (8, 48, 64, 4), dtype=np.uint8)
            open(raw, "wb").write(frames.tobytes())
            paths.append(raw)
        ckpt = str(tmp_path / "h.npz")
        # 8 frames -> 6 triplets -> 3 batches/epoch/source; 14 steps needs
        # >2 epochs of each source interleaved
        rc = train.main(paths + ["--input-width", "64", "--input-height",
                         "48", "--arch", "v2", "--steps", "14", "--batch",
                         "2", "--crop", "32x48", "--hidden", "16",
                         "--cosine", "--checkpoint", ckpt])
        assert rc == 0
        import os
        assert os.path.exists(ckpt)

    def test_train_main_bad_first_input_fails_fast(self, tmp_path):
        from tpufg.models import train
        rc = train.main([str(tmp_path / "missing.y4m"), "--steps", "2"])
        assert rc == 1

    def test_train_main_crop_exceeds_scene_fails_fast(self):
        """A synth crop larger than the scene is a config error at
        flag level, not a worker-thread crash swallowed as 'sources
        exhausted' (round-4 review finding)."""
        from tpufg.models import train
        rc = train.main(["synth:0", "--steps", "2",
                         "--crop", "400x400", "--scene-size", "384x640"])
        assert rc == 1

    def test_prefetch_propagates_feed_errors(self):
        """A feed that crashes mid-stream must FAIL the consuming loop,
        not end it cleanly (a swallowed crash saves an untrained
        checkpoint with rc 0)."""
        from tpufg.models.train import _prefetch

        def feed():
            yield 1
            raise ValueError("boom")

        it = _prefetch(feed(), depth=2)
        assert next(it) == 1
        with pytest.raises(ValueError, match="boom"):
            list(it)


class TestIFNet3:
    """v3: the streaming two-stage head (siamese cached per-frame
    encoder, 13-ch stage-2, 8-px coarse warp) — the config-5b head."""

    def test_interpolate_fast_dispatches_v3(self, rng):
        params = rife.init_params3(jax.random.PRNGKey(1), hidden=32)
        assert rife.is_v3(params) and not rife.is_v2(params)
        prev = jnp.asarray(rng.random((4, 32, 64)).astype(np.float32))
        curr = jnp.asarray(rng.random((4, 32, 64)).astype(np.float32))
        out = rife.interpolate_fast(params, prev, curr, 0.5)
        assert out.shape == prev.shape
        assert bool(jnp.all(jnp.isfinite(out)))

    def test_feature_cache_bitwise(self, rng):
        """Precomputed per-frame state (quarter frame + encoder
        features) is bitwise-identical to inline computation — the
        streaming engine's cache contract."""
        params = rife.init_params3(jax.random.PRNGKey(3), hidden=32)
        prev = jnp.asarray(rng.random((4, 32, 64)).astype(np.float32))
        curr = jnp.asarray(rng.random((4, 32, 64)).astype(np.float32))
        inline = rife.interpolate_fast3(params, prev, curr, 0.5)
        p4 = rife._down4_mean(prev[None])[0]
        c4 = rife._down4_mean(curr[None])[0]
        f4p = rife.encode3(params, prev[None], dtype=jnp.bfloat16)[0]
        f4c = rife.encode3(params, curr[None], dtype=jnp.bfloat16)[0]
        cached = rife.interpolate_fast3(params, prev, curr, 0.5, p4=p4,
                                        c4=c4, f4p=f4p, f4c=f4c)
        np.testing.assert_array_equal(np.asarray(inline),
                                      np.asarray(cached))

    def test_coarse_warp8_odd_quarter_rows(self, rng):
        """4K-class frames have 1/4-res heights that are NOT 8-multiples
        (2160 -> 540): the 8-px coarse warp pads frame rows and the flow
        lattice to the block grid and crops back."""
        params = rife.init_params3(jax.random.PRNGKey(4), hidden=32)
        # H=80 -> quarter rows 20, not a multiple of 8
        prev = jnp.asarray(rng.random((4, 80, 128)).astype(np.float32))
        curr = jnp.asarray(rng.random((4, 80, 128)).astype(np.float32))
        out = rife.interpolate_fast(params, prev, curr, 0.5)
        assert out.shape == prev.shape
        assert bool(jnp.all(jnp.isfinite(out)))

    def test_coarse_warp8_odd_quarter_cols(self, rng):
        """720/1360-px-wide streams have 1/4-res WIDTHS that are not
        8-multiples (720 -> 180): columns pad to the block grid too
        (round-4 review finding — height alone was padded)."""
        params = rife.init_params3(jax.random.PRNGKey(5), hidden=32)
        # W=48 -> quarter cols 12; H=64 -> quarter rows 16 (rows aligned,
        # cols not — isolates the width path)
        prev = jnp.asarray(rng.random((4, 64, 48)).astype(np.float32))
        curr = jnp.asarray(rng.random((4, 64, 48)).astype(np.float32))
        out = rife.interpolate_fast(params, prev, curr, 0.5)
        assert out.shape == prev.shape
        assert bool(jnp.all(jnp.isfinite(out)))

    def test_training3_reduces_loss(self, rng):
        # NOT the crossfade target: v3's zero-init flow heads predict
        # exactly 0.5*(prev+curr) at step 0, which would make the first
        # loss ~1e-6 and the "reduces" assertion vacuous-backwards
        init_state, step, _ = rife.make_train_step(3e-3, arch="v3")
        params, opt = init_state(jax.random.PRNGKey(0), 16)
        prev = jnp.asarray(rng.random((2, 4, 32, 64)).astype(np.float32))
        curr = jnp.asarray(np.roll(np.asarray(prev), 2, axis=3))
        target = jnp.asarray(np.roll(np.asarray(prev), 1, axis=3))
        losses = []
        for _ in range(10):
            params, opt, loss = step(params, opt, prev, curr, target)
            losses.append(float(loss))
        assert losses[-1] < losses[0]

    def test_training3_flow_supervised(self, rng):
        init_state, step, _ = rife.make_train_step(1e-3, arch="v3",
                                                   flow_weight=0.1)
        params, opt = init_state(jax.random.PRNGKey(0), 16)
        prev = jnp.asarray(rng.random((1, 4, 32, 64)).astype(np.float32))
        curr = jnp.asarray(rng.random((1, 4, 32, 64)).astype(np.float32))
        target = 0.5 * (prev + curr)
        sup = {"flow4": jnp.zeros((1, 4, 8, 16)),
               "vp4": jnp.ones((1, 1, 8, 16)),
               "vc4": jnp.ones((1, 1, 8, 16)),
               "flow8": jnp.zeros((1, 4, 4, 8)),
               "vp8": jnp.ones((1, 1, 4, 8)),
               "vc8": jnp.ones((1, 1, 4, 8))}
        params, opt, (loss, photo, flow) = step(params, opt, prev, curr,
                                                target, sup)
        assert np.isfinite(float(loss)) and np.isfinite(float(flow))

    def test_checkpoint_roundtrip_infers_v3(self, tmp_path):
        from tpufg.utils.checkpoint import save_pytree
        params = rife.init_params3(jax.random.PRNGKey(2), hidden=32)
        p = str(tmp_path / "v3.npz")
        save_pytree(p, params)
        loaded = rife.load_params(p)
        assert rife.is_v3(loaded) and not rife.is_v2(loaded)
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b)), params, loaded)

    def test_tp_sharded_training3_step(self, rng):
        devs = jax.devices()
        if len(devs) < 8:
            pytest.skip("needs 8 virtual devices")
        from jax.sharding import Mesh
        mesh = Mesh(np.array(devs[:8]).reshape(4, 2),
                    axis_names=("dp", "tp"))
        init_state, train_step, _ = rife.make_train_step(1e-4, mesh=mesh,
                                                         arch="v3")
        with mesh:
            params, opt_state = init_state(jax.random.PRNGKey(0), 32)
            prev = jnp.asarray(rng.random((8, 4, 32, 64)).astype(np.float32))
            curr = jnp.asarray(rng.random((8, 4, 32, 64)).astype(np.float32))
            target = 0.5 * (prev + curr)
            params, opt_state, loss = train_step(params, opt_state, prev,
                                                 curr, target)
        assert np.isfinite(float(loss))

    def test_engine_runs_v3_head(self, rng, tmp_path):
        from tpufg.config import EngineConfig, resolve_sizes
        from tpufg.engine.pipeline import make_interp_step
        params = rife.init_params3(jax.random.PRNGKey(5), hidden=16)
        cfg = resolve_sizes(EngineConfig(
            input_width=64, input_height=48, output_width=128,
            output_height=96, dtype="f32", motion_mode="learned"))
        step = make_interp_step(cfg, model_params=params)
        a = rng.integers(0, 256, (48, 64, 4), dtype=np.uint8)
        b = rng.integers(0, 256, (48, 64, 4), dtype=np.uint8)
        out_i, out_c = step(jnp.asarray(a), jnp.asarray(b))
        assert out_i.shape == (96, 128, 4)


class TestV3Diff:
    """v3d (round 5): stage 2 consumes the signed
    warped difference — a 17-ch r_in — with a zero-pad warm start that
    is bit-identical to the seeding v3 head at step 0."""

    def test_discriminators(self):
        v3 = rife.init_params3(jax.random.PRNGKey(0), hidden=16)
        v3d = rife.init_params3(jax.random.PRNGKey(0), hidden=16,
                                stage2_diff=True)
        assert rife.is_v3(v3d) and rife.has_stage2_diff(v3d)
        assert not rife.has_stage2_diff(v3)
        assert v3d["r_in"]["w"].shape[1] == 17

    def test_expand_warm_start_bitwise(self, rng):
        """expand_v3_stage2_diff(v3) must compute bit-identical outputs
        to the original head (new input channels at weight zero)."""
        params = rife.init_params3(jax.random.PRNGKey(3), hidden=32)
        exp = rife.expand_v3_stage2_diff(params)
        assert rife.has_stage2_diff(exp)
        prev = jnp.asarray(rng.random((4, 32, 64)).astype(np.float32))
        curr = jnp.asarray(rng.random((4, 32, 64)).astype(np.float32))
        a = rife.interpolate_fast(params, prev, curr, 0.5)
        b = rife.interpolate_fast(exp, prev, curr, 0.5)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        # idempotent; and v2/v1 heads are rejected
        assert rife.expand_v3_stage2_diff(exp) is exp
        with pytest.raises(ValueError):
            rife.expand_v3_stage2_diff(
                rife.init_params2(jax.random.PRNGKey(0), hidden=16))

    def test_training_v3d_reduces_loss(self, rng):
        init_state, step, _ = rife.make_train_step(3e-3, arch="v3d")
        params, opt = init_state(jax.random.PRNGKey(0), 16)
        assert rife.has_stage2_diff(params)
        prev = jnp.asarray(rng.random((2, 4, 32, 64)).astype(np.float32))
        curr = jnp.asarray(np.roll(np.asarray(prev), 2, axis=3))
        target = jnp.asarray(np.roll(np.asarray(prev), 1, axis=3))
        losses = []
        for _ in range(10):
            params, opt, loss = step(params, opt, prev, curr, target)
            losses.append(float(loss))
        assert losses[-1] < losses[0]

    def test_checkpoint_roundtrip_infers_v3d(self, tmp_path):
        from tpufg.utils.checkpoint import save_pytree
        params = rife.init_params3(jax.random.PRNGKey(2), hidden=32,
                                   stage2_diff=True)
        p = str(tmp_path / "v3d.npz")
        save_pytree(p, params)
        loaded = rife.load_params(p)
        assert rife.has_stage2_diff(loaded)
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b)), params, loaded)

    def test_v3c_expand_warm_start_bitwise_and_composes(self, rng):
        """expand_v3_coarse_body2: zero-init residual layer => identical
        outputs; composes with the diff expansion (v3dc)."""
        params = rife.init_params3(jax.random.PRNGKey(7), hidden=32)
        prev = jnp.asarray(rng.random((4, 32, 64)).astype(np.float32))
        curr = jnp.asarray(rng.random((4, 32, 64)).astype(np.float32))
        a = rife.interpolate_fast(params, prev, curr, 0.5)
        v3c = rife.expand_v3_coarse_body2(params)
        assert rife.has_coarse_body2(v3c) and not rife.has_stage2_diff(v3c)
        np.testing.assert_array_equal(
            np.asarray(a),
            np.asarray(rife.interpolate_fast(v3c, prev, curr, 0.5)))
        v3dc = rife.expand_v3_stage2_diff(v3c)
        assert rife.has_coarse_body2(v3dc) and rife.has_stage2_diff(v3dc)
        np.testing.assert_array_equal(
            np.asarray(a),
            np.asarray(rife.interpolate_fast(v3dc, prev, curr, 0.5)))

    def test_v3c_checkpoint_roundtrip(self, tmp_path):
        from tpufg.utils.checkpoint import save_pytree
        for sd in (False, True):
            params = rife.init_params3(jax.random.PRNGKey(2), hidden=32,
                                       stage2_diff=sd, coarse_body2=True)
            p = str(tmp_path / f"v3c_{sd}.npz")
            save_pytree(p, params)
            loaded = rife.load_params(p)
            assert rife.has_coarse_body2(loaded)
            assert rife.has_stage2_diff(loaded) == sd
            jax.tree_util.tree_map(
                lambda a, b: np.testing.assert_array_equal(
                    np.asarray(a), np.asarray(b)), params, loaded)

    def test_training_v3c_moves_new_layer(self, rng):
        """arch v3dc trains end to end and the gradient reaches the new
        residual layer (zero-init does not mean zero-grad: the relu
        gates on the pre-activation, whose weight grads are nonzero)."""
        init_state, step, _ = rife.make_train_step(3e-3, arch="v3dc")
        params, opt = init_state(jax.random.PRNGKey(0), 16)
        assert rife.has_coarse_body2(params)
        prev = jnp.asarray(rng.random((2, 4, 32, 64)).astype(np.float32))
        curr = jnp.asarray(np.roll(np.asarray(prev), 2, axis=3))
        target = jnp.asarray(np.roll(np.asarray(prev), 1, axis=3))
        losses = []
        for _ in range(10):
            params, opt, loss = step(params, opt, prev, curr, target)
            losses.append(float(loss))
        assert losses[-1] < losses[0]
        assert float(jnp.abs(params["c_body2"]["w"]).max()) > 0.0

    def test_engine_and_cache_run_v3d(self, rng):
        """The engine's learned path + stream cache work unchanged (the
        cache is encoder-side; v3d only touches stage-2 input)."""
        from tpufg.config import EngineConfig, resolve_sizes
        from tpufg.engine.pipeline import make_interp_step, make_q_init
        params = rife.init_params3(jax.random.PRNGKey(5), hidden=16,
                                   stage2_diff=True)
        cfg = resolve_sizes(EngineConfig(
            input_width=64, input_height=48, output_width=64,
            output_height=48, dtype="f32", motion_mode="learned"))
        step = make_interp_step(cfg, model_params=params, q_feed=True)
        q_init = make_q_init(cfg, model_params=params)
        a = rng.integers(0, 256, (48, 64, 4), dtype=np.uint8)
        b = rng.integers(0, 256, (48, 64, 4), dtype=np.uint8)
        q = q_init(jnp.asarray(a))
        out_i, out_c, q2 = step(jnp.asarray(a), jnp.asarray(b), q)
        assert out_i.shape == (48, 64, 4)
        assert q2[0].shape == q[0].shape and q2[1].shape == q[1].shape


class TestFlowTScaling:
    """k>2 time points: the tails must t-scale the midpoint-trained flows.

    The heads are trained exclusively at t=0.5, so their flow channels are
    the motions FROM the midpoint (fp ≈ −V/2, fc ≈ +V/2 for pair velocity
    V).  A frame at time t needs fp·2t / fc·2(1−t) (rife._flow_t_scales).
    Before the r4 fix every in-between of a k>2 stream warped with the
    midpoint flows (a 3.9 dB learned-row deficit at --mult 3/4 vs k=2 in
    the natural-corpus evaluation).

    The fixture is analytic: a linear ramp translating with constant V,
    crafted trunk output holding the exact midpoint flows, so every tail
    must reproduce the ramp at position −t·V exactly (bilinear sampling
    of a linear function is exact away from clamped edges)."""

    V = (4.0, 2.0)  # (dx, dy) pixels per pair
    H = W = 64

    def _ramp(self, shift=(0.0, 0.0)):
        c = np.arange(4, dtype=np.float32)[:, None, None]
        y = np.arange(self.H, dtype=np.float32)[None, :, None] - shift[1]
        x = np.arange(self.W, dtype=np.float32)[None, None, :] - shift[0]
        return 0.2 + 0.1 * c + 0.002 * x + 0.0015 * y

    def _trunk_out(self):
        hq, wq = self.H // 4, self.W // 4
        out = np.zeros((5, hq, wq), np.float32)
        out[0] = -0.5 * self.V[0] / 4.0   # dxp in quarter-res units
        out[1] = -0.5 * self.V[1] / 4.0
        out[2] = 0.5 * self.V[0] / 4.0
        out[3] = 0.5 * self.V[1] / 4.0
        return jnp.asarray(out)

    def test_t_half_scales_are_exact_unity(self):
        assert rife._flow_t_scales(0.5) == (1.0, 1.0)

    @pytest.mark.parametrize("t", [0.25, 1.0 / 3.0, 0.5, 2.0 / 3.0, 0.75])
    @pytest.mark.parametrize("tail", ["fast", "smooth", "ft"])
    def test_constant_velocity_any_t(self, tail, t):
        prev = jnp.asarray(self._ramp())
        curr = jnp.asarray(self._ramp(self.V))
        truth = self._ramp((t * self.V[0], t * self.V[1]))
        out = self._trunk_out()
        if tail == "fast":
            got = rife.tail_fast({}, out, prev, curr, t,
                                 dtype=jnp.float32, integer_flow=False)
        elif tail == "smooth":
            got = rife._smooth_tail(out[None], prev[None], curr[None],
                                    t)[0]
        else:
            got = rife._ft_tail(out[None], prev[None], curr[None], t,
                                integer_flow=False)[0]
        m = 8  # interior margin beyond every scaled offset + lerp tap
        np.testing.assert_allclose(np.asarray(got)[:, m:-m, m:-m],
                                   truth[:, m:-m, m:-m], atol=5e-5)


class TestTailsFast:
    """tails_fast(ts) must equal [tail_fast(t) for t in ts] bitwise: the
    multi-t form shares the t-independent prep (lattice, mask upsample,
    banded warp prep) across time points but runs the same ops per t."""

    @pytest.mark.parametrize("arch", ["v1", "v3"])
    def test_multi_t_matches_per_t(self, rng, arch):
        init = {"v1": rife.init_params, "v3": rife.init_params3}[arch]
        params = init(jax.random.PRNGKey(3), hidden=16)
        # W=80: not a 128 multiple — exercises the tails-level column pad
        prev = jnp.asarray(rng.random((4, 48, 80)).astype(np.float32))
        curr = jnp.asarray(rng.random((4, 48, 80)).astype(np.float32))
        out = rife.trunk_fast(params, prev, curr)
        ts = (0.25, 0.5, 0.75)
        multi = rife.tails_fast(params, out, prev, curr, ts)
        for t, m in zip(ts, multi):
            single = rife.tail_fast(params, out, prev, curr, t)
            assert np.array_equal(np.asarray(m), np.asarray(single)), t

class TestMultiTTraining:
    """--multi-t: the loss accepts a TRACED time point (trailing step arg)
    and must compute exactly what the static-t loss computes — the scale
    chain (2t, 2(1-t), xSCALE) multiplies only by exactly-representable
    values at the tested t's, so equality is bitwise, not approximate."""

    def _batch(self, rng):
        prev = jnp.asarray(rng.random((1, 4, 32, 64)).astype(np.float32))
        curr = jnp.asarray(np.roll(np.asarray(prev), 3, axis=3))
        target = jnp.asarray(np.roll(np.asarray(prev), 1, axis=3))
        return prev, curr, target

    @pytest.mark.parametrize("t", [0.25, 0.5, 0.75])
    @pytest.mark.parametrize("arch,lf", [("v1", "loss_fn"),
                                         ("v3", "loss_fn3")])
    def test_traced_t_matches_static(self, rng, arch, lf, t):
        init = {"v1": rife.init_params, "v3": rife.init_params3}[arch]
        params = init(jax.random.PRNGKey(1), hidden=16)
        prev, curr, target = self._batch(rng)
        loss = getattr(rife, lf)
        static = jax.jit(lambda p, a, b, c: loss(p, a, b, c, t))(
            params, prev, curr, target)
        traced = jax.jit(lambda p, a, b, c, tt: loss(p, a, b, c, tt))(
            params, prev, curr, target, jnp.float32(t))
        assert np.asarray(static) == np.asarray(traced)

    @pytest.mark.parametrize("t", [0.25, 1.0 / 3.0, 0.75])
    def test_smooth_tail_traced_constant_velocity(self, t):
        fx = TestFlowTScaling()
        prev = jnp.asarray(fx._ramp())
        curr = jnp.asarray(fx._ramp(fx.V))
        truth = fx._ramp((t * fx.V[0], t * fx.V[1]))
        out = fx._trunk_out()
        got = jax.jit(lambda o, p, c, tt: rife._smooth_tail(o, p, c, tt))(
            out[None], prev[None], curr[None], jnp.float32(t))[0]
        m = 8
        np.testing.assert_allclose(np.asarray(got)[:, m:-m, m:-m],
                                   truth[:, m:-m, m:-m], atol=5e-5)

    def test_train_step_trailing_t(self, rng):
        init_state, step, _ = rife.make_train_step(1e-3, arch="v3",
                                                   flow_weight=0.1)
        params, opt = init_state(jax.random.PRNGKey(0), 16)
        prev, curr, target = self._batch(rng)
        sup = {"flow4": jnp.zeros((1, 4, 8, 16)),
               "vp4": jnp.ones((1, 1, 8, 16)),
               "vc4": jnp.ones((1, 1, 8, 16)),
               "flow8": jnp.zeros((1, 4, 4, 8)),
               "vp8": jnp.ones((1, 1, 4, 8)),
               "vc8": jnp.ones((1, 1, 4, 8))}
        # two different t's through ONE compiled program (t is traced)
        for t in (0.3, 0.7):
            params, opt, (loss, photo, flow) = step(
                params, opt, prev, curr, target, sup, jnp.float32(t))
            assert np.isfinite(float(loss))

    def test_corpus_multi_t_feed(self):
        from tpufg.data.corpus import synthetic_triplets
        gen = synthetic_triplets(32, 64, 2, seed=3, scene_w=96, scene_h=64,
                                 t_range=(0.25, 0.75))
        b = next(gen)
        assert b["prev"].shape == (2, 4, 32, 64)
        assert b["flow4"].shape == (2, 4, 8, 16)
        assert b["t"].dtype == np.float32
        assert 0.25 <= float(b["t"]) <= 0.75
        # midpoint-flow invariant: supervision must NOT move with t —
        # same seed without t_range yields different targets but the rng
        # stream shifts, so assert the semantic property instead: flows
        # from a fresh gen with degenerate t_range (0.5, 0.5) equal the
        # midpoint render path (t_target == tm by construction there)
        b5 = next(synthetic_triplets(32, 64, 2, seed=3, scene_w=96,
                                     scene_h=64, t_range=(0.5, 0.5)))
        assert float(b5["t"]) == 0.5

    def test_trainer_cli_multi_t(self, tmp_path):
        from tpufg.models import train
        ck = str(tmp_path / "mt.npz")
        rc = train.main(["synth:5", "--steps", "2", "--batch", "1",
                        "--crop", "32x64", "--hidden", "16", "--arch",
                         "v3", "--flow-weight", "0.1", "--multi-t",
                         "--scene-size", "64x96", "--checkpoint", ck])
        assert rc == 0
        import os
        assert os.path.exists(ck)

    def test_trainer_cli_multi_t_rejects_files(self, tmp_path):
        from tpufg.models import train
        f = tmp_path / "x.raw"
        f.write_bytes(b"\0" * (64 * 64 * 4 * 8))
        rc = train.main([str(f), "--input-width", "64", "--input-height",
                         "64", "--steps", "1", "--multi-t"])
        assert rc == 1
