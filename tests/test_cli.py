"""CLI flag surface + end-to-end runs (reference main.cpp parity)."""

import numpy as np
import pytest

from tpufg.cli import build_parser, main
from tpufg.utils.logging import get_logger


class TestParsing:
    def test_reference_flags_accepted(self):
        # the exact reference flag surface (main.cpp:28-54)
        args = build_parser().parse_args([
            "--input-width", "1920", "--input-height", "1080",
            "--output-width", "3840", "--output-height", "2160",
            "--target-fps", "30", "--no-interpolation",
            "--interpolation-factor", "0.25", "in.raw",
        ])
        assert args.input_width == 1920
        assert args.no_interpolation is True
        assert args.interpolation_factor == 0.25
        assert args.input == "in.raw"

    def test_defaults_match_reference(self):
        args = build_parser().parse_args(["x.raw"])
        # target fps defaults to None = auto-detect from source metadata,
        # falling back to the reference's 60 (main.cpp:26) — same derivation
        # spirit as input-size auto-detect
        assert args.target_fps is None
        assert args.no_interpolation is False  # main.cpp:24
        assert args.interpolation_factor == 0.5  # main.cpp:25

    def test_help_exits_zero(self, capsys):
        with pytest.raises(SystemExit) as e:
            build_parser().parse_args(["--help"])
        assert e.value.code == 0
        assert "--interpolation-factor" in capsys.readouterr().out


class TestMainErrors:
    def test_missing_input_exits_one(self, capsys):
        # main.cpp:57-60: no window id -> usage + exit 1
        assert main([]) == 1
        assert get_logger().has_error()
        get_logger().clear_error()

    def test_missing_file_exits_one(self):
        assert main(["/does/not/exist.raw", "--input-width", "8",
                     "--input-height", "8"]) == 1
        get_logger().clear_error()

    def test_bad_factor_exits_one(self):
        assert main(["synthetic:32x32", "--interpolation-factor", "2.0"]) == 1
        get_logger().clear_error()

    def test_raw_without_size_exits_one(self, tmp_path):
        p = tmp_path / "v.raw"
        p.write_bytes(b"\x00" * (8 * 8 * 4))
        assert main([str(p)]) == 1
        get_logger().clear_error()


class TestEndToEnd:
    def test_scale_only_run(self, tmp_path):
        out = tmp_path / "out.raw"
        rc = main(["synthetic:32x32", "--output-width", "64",
                   "--no-interpolation", "--frames", "3", "--no-pacing",
                   "--output", str(out), "--dtype", "f32"])
        assert rc == 0
        assert out.stat().st_size == 3 * 64 * 64 * 4

    def test_interp_crossfade_run(self, tmp_path):
        out = tmp_path / "out.raw"
        rc = main(["synthetic:32x32", "--frames", "3", "--no-pacing",
                   "--motion-mode", "none", "--output", str(out),
                   "--dtype", "f32"])
        assert rc == 0
        # 1 + 2*2 = 5 output frames at input size (passthrough scale)
        assert out.stat().st_size == 5 * 32 * 32 * 4

    def test_aspect_completion_end_to_end(self, tmp_path):
        out = tmp_path / "out.raw"
        rc = main(["synthetic:64x32", "--output-width", "128",
                   "--no-interpolation", "--frames", "2", "--no-pacing",
                   "--output", str(out), "--dtype", "f32"])
        assert rc == 0
        # height completed to 64 by aspect (main.cpp:82-85)
        assert out.stat().st_size == 2 * 128 * 64 * 4


class TestStdoutPipe:
    def test_stdout_y4m_clean_of_log_lines(self, tmp_path, capfdbinary):
        """--output - must put ONLY the y4m payload on stdout (logs go to
        stderr) — the documented '| mpv -' pipe depends on it."""
        rc = main(["synthetic:32x32", "--frames", "3", "--no-pacing",
                   "--motion-mode", "none", "--output", "-",
                   "--dtype", "f32"])
        out, err = capfdbinary.readouterr()
        assert rc == 0
        assert out.startswith(b"YUV4MPEG2")
        assert out.count(b"FRAME") == 5  # 1 + 2*2
        assert b"[INFO]" not in out
        assert b"[INFO]" in err


class TestValidateCLI:
    def test_crossfade_passes_gate(self):
        from tpufg.validate import main as vmain
        rc = vmain(["synthetic:64x64", "--frames", "1",
                    "--motion-mode", "none", "--dtype", "f32"])
        assert rc == 0


class TestQualityPreset:
    """--quality preset: one switch for the measured
    best-quality configuration, with a measured-headroom auto mode."""

    def _captured_cfg(self, monkeypatch, argv):
        import tpufg.engine.runner as runner_mod
        from tpufg.engine.runner import StreamStats
        seen = {}

        def fake_run_stream(cfg, source, sink, **kw):
            seen["cfg"] = cfg
            return StreamStats(frames_in=1, frames_out=1, fps=1.0,
                               latency={})
        monkeypatch.setattr(runner_mod, "run_stream", fake_run_stream)
        assert main(argv) == 0
        return seen["cfg"]

    def test_quality_on_applies_preset(self, monkeypatch):
        cfg = self._captured_cfg(monkeypatch, [
            "--quality", "--no-pacing", "--frames", "2",
            "synthetic:64x64"])
        assert cfg.mv_grid == 1 and cfg.subpel and cfg.mv_filter
        assert cfg.mc_fallback
        assert cfg.mv_bias == pytest.approx(0.1)

    def test_explicit_flags_beat_preset(self, monkeypatch):
        cfg = self._captured_cfg(monkeypatch, [
            "--quality", "--mv-grid", "8", "--mv-bias", "0.3",
            "--no-pacing", "--frames", "2", "synthetic:64x64"])
        assert cfg.mv_grid == 8
        assert cfg.mv_bias == pytest.approx(0.3)
        assert cfg.subpel and cfg.mv_filter  # the rest still applies

    def test_quality_skips_crossfade_mode(self, monkeypatch):
        cfg = self._captured_cfg(monkeypatch, [
            "--quality", "--motion-mode", "none", "--no-pacing",
            "--frames", "2", "synthetic:64x64"])
        assert cfg.mv_grid == 16 and not cfg.subpel  # preset is a no-op

    @pytest.mark.parametrize("rate,expect_quality", [(400.0, True),
                                                     (40.0, False)])
    def test_quality_auto_headroom_decision(self, monkeypatch, rate,
                                            expect_quality):
        import tpufg.engine.runner as runner_mod
        monkeypatch.setattr(runner_mod, "measure_step_rate",
                            lambda cfg, n=6: rate)
        cfg = self._captured_cfg(monkeypatch, [
            "--quality", "auto", "--target-fps", "60", "--no-pacing",
            "--frames", "2", "synthetic:64x64"])
        assert (cfg.mv_grid == 1) is expect_quality
        assert cfg.subpel is expect_quality

    def test_quality_preset_runs_end_to_end(self, tmp_path):
        out = str(tmp_path / "q.raw")
        assert main(["--quality", "--no-pacing", "--frames", "3",
                     "--output", out, "synthetic:64x64"]) == 0
        import os
        assert os.path.getsize(out) == 5 * 64 * 64 * 4  # 1 + 2*2 frames


class TestVideoFileEndToEnd:
    def test_mp4_in_mp4_out(self, tmp_path):
        """Real decoded video through the full CLI: an mp4 is decoded
        (OpenCV/FFmpeg), fps-doubled with motion compensation, and
        re-encoded; the output container reports 2x the source rate and
        2*n-1 frames.  Also exercises the source-fps auto-detect
        (main.cpp:67-74 analog) on container metadata."""
        cv2 = pytest.importorskip("cv2")
        import numpy as np

        src_path = str(tmp_path / "in.mp4")
        wr = cv2.VideoWriter(src_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             12.0, (64, 48))
        assert wr.isOpened()
        ys, xs = np.mgrid[0:48, 0:64].astype(np.float32)
        n_in = 4
        for i in range(n_in):
            bgr = np.stack([
                (128 + 60 * np.sin((xs + ys + 4 * i) / 31)),
                (120 + 80 * np.cos((ys + 2 * i) / 23)),
                (110 + 90 * np.sin((xs + 3 * i) / 17)),
            ], axis=-1).astype(np.uint8)
            wr.write(bgr)
        wr.release()

        out_path = str(tmp_path / "out.mp4")
        rc = main([src_path, "--no-pacing", "--motion-mode", "pyramid",
                   "--output", out_path, "--dtype", "f32"])
        assert rc == 0
        cap = cv2.VideoCapture(out_path)
        assert cap.isOpened()
        assert abs(cap.get(cv2.CAP_PROP_FPS) - 24.0) < 0.5  # 2x detected 12
        n = 0
        while cap.read()[0]:
            n += 1
        cap.release()
        assert n == 2 * n_in - 1
