"""Backend policy, compile-cache location, chip_smoke.py's guard and
result line, and ingest paths that must not depend on the device."""

import json
import os
import shutil
import subprocess
import sys
import types

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestBackendPolicy:
    @pytest.mark.parametrize("backend,interpret", [("cpu", True),
                                                   ("gpu", False)])
    def test_known_backends(self, backend, interpret):
        from tpufg.kernels.common import use_interpret
        assert use_interpret(backend) is interpret

    @pytest.mark.parametrize("backend", ["neuron", "rocm", "METAL"])
    def test_unknown_backend_raises(self, backend):
        from tpufg.kernels.common import use_interpret
        with pytest.raises(RuntimeError, match="no Pallas route"):
            use_interpret(backend)

    def test_tests_run_interpreted(self):
        from tpufg.kernels.common import use_interpret
        assert jax.default_backend() == "cpu" and use_interpret() is True


class TestCompileCache:
    def test_env_var_is_left_to_jax(self, monkeypatch, tmp_path):
        from tpufg.utils import compile_cache
        before = jax.config.jax_compilation_cache_dir
        monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
        assert compile_cache.setup_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before

    def test_default_is_checkout_dot_jax_cache(self, monkeypatch):
        from tpufg.utils import compile_cache
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        before = jax.config.jax_compilation_cache_dir
        try:
            got = compile_cache.setup_compile_cache()
            assert got == os.path.join(REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
        finally:
            jax.config.update("jax_compilation_cache_dir", before)

    def test_default_dir_is_git_ignored(self):
        with open(os.path.join(REPO, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


class TestChipSmoke:
    def test_fails_without_the_repository(self, tmp_path):
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert not any(ln.startswith("{") for ln in r.stdout.splitlines())

    def test_guard_refuses_cpu(self, monkeypatch, capsys):
        sys.path.insert(0, REPO)
        import chip_smoke
        monkeypatch.setattr(chip_smoke, "card", lambda: "test card, 1 W")
        from tpufg.utils import compile_cache
        monkeypatch.setattr(compile_cache, "setup_compile_cache",
                            lambda: compile_cache.DEFAULT_DIR)
        assert chip_smoke.main(["--kernels"]) != 0
        out = capsys.readouterr().out
        assert not any(ln.startswith("{") for ln in out.splitlines())

    def test_result_line_format(self):
        sys.path.insert(0, REPO)
        import chip_smoke
        dev = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100")
        line = chip_smoke.result_line(dev, 1)
        assert "\n" not in line
        assert json.loads(line) == {"ok": True, "device": {
            "platform": "gpu", "kind": "NVIDIA H100", "count": 1}}

    @pytest.mark.parametrize("r", [2, 4])
    def test_plain_site_search_is_the_kernels_field(self, rng, r):
        """--kernels times the Triton search against this competitor; it
        must give the same bits."""
        sys.path.insert(0, REPO)
        import chip_smoke
        from tpufg.kernels.motion import motion_search_sites
        prev = jax.numpy.asarray(rng.random((4, 64, 128)).astype(np.float32))
        curr = jax.numpy.roll(prev, (3, -2), (1, 2))
        np.testing.assert_array_equal(
            np.asarray(chip_smoke.site_search_plain(prev, curr,
                                                    search_radius=r)),
            np.asarray(motion_search_sites(prev, curr, search_radius=r)))

    def test_step_takes_site_search(self, rng):
        """The config-3 step built with the plain search is the default
        (Triton) step, byte for byte."""
        sys.path.insert(0, REPO)
        import chip_smoke
        from tpufg.config import EngineConfig, resolve_sizes
        from tpufg.engine.pipeline import make_interp_step
        cfg = resolve_sizes(EngineConfig(
            input_width=128, input_height=64, output_width=128,
            output_height=64, motion_mode="exhaustive", search_radius=4))
        a = rng.integers(0, 256, (64, 128, 4), dtype=np.uint8)
        b = np.roll(a, (2, -3), (0, 1))
        want = make_interp_step(cfg)(jax.numpy.asarray(a), jax.numpy.asarray(b))
        got = make_interp_step(cfg, site_search=chip_smoke.site_search_plain)(
            jax.numpy.asarray(a), jax.numpy.asarray(b))
        for x, y in zip(got, want):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


class TestIngest:
    def test_native_ring_matches_memmap_source(self, tmp_path):
        """Zero-copy ring slots are reused by later frames: the engine's
        output must not depend on which raw source fed it."""
        from tpufg.config import EngineConfig, resolve_sizes
        from tpufg.engine.runner import run_stream
        from tpufg.io import native
        from tpufg.io.sinks import RawVideoSink
        from tpufg.io.sources import NativeRawSource, RawVideoSource
        assert native.available()
        h, w, n = 64, 128, 5
        rng = np.random.default_rng(0)
        clip = rng.integers(0, 256, (n, h, w, 4), dtype=np.uint8)
        clip[..., 3] = 255
        raw = str(tmp_path / "in.raw")
        clip.tofile(raw)
        cfg = resolve_sizes(EngineConfig(input_width=w, input_height=h,
                                         motion_mode="none"))
        outs = []
        for cls in (RawVideoSource, NativeRawSource):
            path = str(tmp_path / f"{cls.__name__}.raw")
            sink = RawVideoSink(path)
            run_stream(cfg, cls(raw, w, h, "rgba"), sink, paced=False)
            sink.close()
            outs.append(np.fromfile(path, np.uint8))
        np.testing.assert_array_equal(outs[0], outs[1])
        # identity size: the scaled current frames are the input frames
        got = outs[1].reshape(-1, h, w, 4)
        np.testing.assert_array_equal(got[0], clip[0])
        np.testing.assert_array_equal(got[2::2], clip[1:])

    def test_video_source_without_opencv(self, monkeypatch, tmp_path):
        from tpufg.io.sources import SourceError, VideoFileSource
        monkeypatch.setitem(sys.modules, "cv2", None)
        with pytest.raises(SourceError, match="needs OpenCV"):
            VideoFileSource(str(tmp_path / "clip.mp4"))

    def test_video_sink_without_opencv(self, monkeypatch, tmp_path):
        from tpufg.io.sinks import VideoFileSink
        monkeypatch.setitem(sys.modules, "cv2", None)
        with pytest.raises(ValueError, match="needs OpenCV"):
            VideoFileSink(str(tmp_path / "out.mp4"), 64, 32)


class TestDeviceSsim:
    @pytest.mark.parametrize("shape", [(40, 52), (33, 64, 3)])
    def test_matches_host_ssim(self, rng, shape):
        import jax.numpy as jnp
        from tpufg.utils.quality import ssim, ssim_device
        a = rng.random(shape)
        b = np.clip(a + rng.normal(0, 0.03, shape), 0, 1)
        got = float(ssim_device(jnp.asarray(a), jnp.asarray(b)))
        assert abs(got - ssim(a, b)) < 1e-5
