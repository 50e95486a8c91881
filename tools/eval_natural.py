"""Natural-content quality evaluation (tools/corpus.py renderer).

Protocol: the corpus is rendered at half-steps (t = 0, 0.5, 1, ...); the
engine fps-doubles the integer-t frames and each predicted in-between is
scored against the rendered t+0.5 ground truth — exact analytic truth,
no resampling artifacts (see tools/corpus.py for what makes the content
"natural": 1/f textures, occluding parallax layers, subpixel + divergent
motion, grain, exposure drift).

Reports a PSNR/SSIM table over the interpolation modes plus the
bf16-vs-f32 production-path SSIM gate re-confirmed on this content.
Runs on whatever backend is active (CPU or GPU).

    python tools/eval_natural.py [--width 640 --height 384] [--pairs 8]
        [--grain] [--seed 1] [--modes crossfade,pyramid,quality,learned]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from tools.corpus import NaturalCorpus  # noqa: E402


def run_mode(tag, cfg_kw, frames, truths, model_params=None, mult=2,
             out_mult=1):
    """``out_mult`` > 1 (round 5): run the REAL
    deployment program — interpolation + fused Lanczos upscale to
    out_mult x the input size — and score the upscaled outputs against
    the SAME upscale of the truth frames (make_scale_step, identical
    kernel/settings).  The truth rides the identical resampling, so the
    metric still isolates interpolation error, now measured through the
    exact program the product runs at the north-star shape."""
    import jax.numpy as jnp

    from tpufg.config import EngineConfig, resolve_sizes
    from tpufg.engine.pipeline import make_interp_step, make_scale_step
    from tpufg.utils.quality import psnr, ssim

    h, w = frames[0].shape[:2]
    cfg = resolve_sizes(EngineConfig(
        input_width=w, input_height=h,
        output_width=w * out_mult, output_height=h * out_mult,
        fps_multiplier=mult, **cfg_kw))
    step = make_interp_step(cfg, model_params=model_params)
    scale = make_scale_step(cfg) if out_mult > 1 else None
    # truth upscales are cached per compute dtype: every shipped mode
    # row is bf16, so across a 4-mode table each 4K truth is scaled and
    # read back ONCE instead of once per mode
    tcache = _truth_cache.setdefault(
        (cfg.dtype, out_mult, id(truths)), {})
    ps, ss = [], []
    for i in range(len(frames) - 1):
        outs = step(jnp.asarray(frames[i]), jnp.asarray(frames[i + 1]))
        for j in range(mult - 1):  # outs[-1] is the scaled current frame
            if scale is not None:
                if (i, j) not in tcache:
                    tcache[i, j] = np.asarray(
                        scale(jnp.asarray(truths[i][j])))
                tr = tcache[i, j]
            else:
                tr = truths[i][j]
            t = tr.astype(np.float64) / 255.0
            o = np.asarray(outs[j]).astype(np.float64) / 255.0
            ps.append(psnr(t[..., :3], o[..., :3]))
            ss.append(ssim(t[..., :3], o[..., :3]))
    return float(np.mean(ps)), float(np.mean(ss))


#: (dtype, out_mult, truths-identity) -> {(pair, j): scaled truth}
_truth_cache: dict = {}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--pairs", type=int, default=8)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--grain", action="store_true",
                   help="add film grain (truth then carries independent "
                        "grain: the PSNR ceiling is the grain floor)")
    p.add_argument("--modes", default="crossfade,pyramid,quality,learned")
    p.add_argument("--model-path", default=None,
                   help="learned-head checkpoint (default: the newest "
                        "bundled head, rife.bundled_checkpoint)")
    p.add_argument("--no-gate", action="store_true",
                   help="skip the bf16-vs-f32 gate section (faster sweeps)")
    p.add_argument("--mult", type=int, default=2,
                   help="fps multiplier k: the engine emits k-1 in-betweens "
                        "per pair (t = 1/k .. (k-1)/k, one shared MV field) "
                        "and EVERY one is scored against the analytic truth "
                        "rendered at its exact t (the corpus is analytic in "
                        "float t)")
    p.add_argument("--out-mult", type=int, default=1, dest="out_mult",
                   help="run the deployment program: interpolate + fused "
                        "Lanczos upscale to out_mult x the corpus size, "
                        "scoring against the identically-upscaled truth "
                        "(2 at --width 1920 --height 1080 = the north-star "
                        "1080p->4K shape)")
    p.add_argument("--photo", action="store_true",
                   help="render the round-5 photometric corpus (motion "
                        "blur, fast exposure flicker, sensor-noise "
                        "mismatch, perspective background — Scene "
                        "photo=True); truth frames carry the same "
                        "photometry at their exact t")
    p.add_argument("--codec", default=None, choices=("mp4v", "MJPG", "XVID"),
                   help="route the rendered sequence through a lossy "
                        "encode/decode (OpenCV/FFmpeg) before evaluation: "
                        "the engine then interpolates REAL DECODED VIDEO "
                        "(codec artifacts included) and is scored against "
                        "the decoded half-step truth")
    args = p.parse_args(argv)
    from tpufg.utils.compile_cache import setup_compile_cache
    setup_compile_cache()

    corpus = NaturalCorpus(args.width, args.height, args.seed,
                           photo=args.photo)
    grng = np.random.default_rng(args.seed + 7) if args.grain else None
    grain = 3.0 if args.grain else 0.0
    k = args.mult
    assert k >= 2, k
    frames, truths = [], []
    for i in range(args.pairs + 1):
        frames.append(corpus.frame(float(i), grain_rng=grng, grain=grain))
        if i < args.pairs:
            truths.append([corpus.frame(i + j / k, grain_rng=grng,
                                        grain=grain)
                           for j in range(1, k)])

    if args.codec:
        # lossy round-trip of the WHOLE 1/k-step sequence (inputs and
        # truths alike), so the engine consumes decoder output and the
        # truth carries the same codec character — the metric then
        # isolates interpolation error on real decoded content
        import tempfile

        import cv2
        seq = [None] * (k * args.pairs + 1)
        seq[::k] = frames
        for i, ts in enumerate(truths):
            seq[i * k + 1:i * k + k] = ts
        ext = "mp4" if args.codec == "mp4v" else "avi"
        path = tempfile.mktemp(suffix=f".{ext}", prefix="tpufg_eval_")
        wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*args.codec),
                             30.0, (args.width, args.height))
        assert wr.isOpened(), (args.codec, ext)
        for f in seq:
            wr.write(np.ascontiguousarray(f[..., 2::-1]))
        wr.release()
        from tpufg.io.sources import VideoFileSource
        src = VideoFileSource(path)
        dec = list(src)
        src.close()
        import os as _os
        _os.unlink(path)
        assert len(dec) == len(seq), (len(dec), len(seq))
        frames = dec[::k]
        truths = [dec[i * k + 1:i * k + k] for i in range(args.pairs)]

    modes = {
        "crossfade": dict(motion_mode="none", dtype="bf16"),
        "pyramid": dict(motion_mode="pyramid", dtype="bf16"),
        # "quality" mirrors the --quality preset (config.apply_quality_preset
        # + occlusion_blend); "quality_nofb" is the r3 preset without the
        # adaptive crossfade fallback, kept for attribution
        "quality": dict(motion_mode="pyramid", dtype="bf16", mv_grid=1,
                        subpel=True, mv_bias=0.1, occlusion_blend=True,
                        mv_filter=True, mc_fallback=True),
        "quality_nofb": dict(motion_mode="pyramid", dtype="bf16", mv_grid=1,
                             subpel=True, mv_bias=0.1, occlusion_blend=True,
                             mv_filter=True),
        "pyramid_fb": dict(motion_mode="pyramid", dtype="bf16",
                           mc_fallback=True),
        "exhaustive": dict(motion_mode="exhaustive", dtype="bf16"),
        "learned": dict(motion_mode="learned", dtype="bf16"),
    }
    model_params = None
    sel = [m.strip() for m in args.modes.split(",") if m.strip()]
    if "learned" in sel:
        import os

        from tpufg.models import rife
        ckpt = args.model_path or rife.bundled_checkpoint()
        if ckpt and os.path.exists(ckpt):
            model_params = rife.load_params(ckpt)
        else:
            print("no bundled checkpoint; skipping learned")
            sel.remove("learned")

    tag = "grain" if args.grain else "clean"
    if args.photo:
        tag = "photo+" + tag
    if args.codec:
        # name the codec in the header: mp4v and XVID both select
        # FFmpeg's MPEG-4 ASP encoder in OpenCV, so their tables can be
        # legitimately identical — the tag keeps logs self-describing
        tag += f"+{args.codec}"
    mt = f", {k}x" if k != 2 else ""
    om = (f" -> {args.width * args.out_mult}x{args.height * args.out_mult}"
          if args.out_mult > 1 else "")
    print(f"| mode ({tag}, {args.width}x{args.height}{om}, "
          f"{args.pairs} pairs{mt}) | PSNR dB | SSIM |")
    print("|---|---|---|")
    for m in sel:
        ps, ss = run_mode(m, modes[m], frames, truths,
                          model_params=model_params if m == "learned"
                          else None, mult=k, out_mult=args.out_mult)
        print(f"| {m} | {ps:.2f} | {ss:.4f} |", flush=True)

    if args.no_gate:
        return

    # bf16-vs-f32 production gate on natural content (north-star SSIM).
    # The north-star config upscales (BASELINE.md: 1080p->4K), so the gate
    # is measured at 2x scale; the identity-size config (4K->4K
    # fps-doubling class) is reported as a second data point.
    import jax.numpy as jnp

    from tpufg.config import EngineConfig, resolve_sizes
    from tpufg.engine.pipeline import make_interp_step
    from tpufg.utils.quality import ssim as _ssim
    h, w = args.height, args.width
    print()
    for label, (ow, oh) in (("2x upscale (north star)", (2 * w, 2 * h)),
                            ("identity size", (w, h))):
        outs = {}
        for dt in ("bf16", "f32"):
            cfg = resolve_sizes(EngineConfig(
                input_width=w, input_height=h,
                output_width=ow, output_height=oh,
                motion_mode="pyramid", dtype=dt))
            step = make_interp_step(cfg)
            outs[dt] = np.asarray(step(jnp.asarray(frames[0]),
                                       jnp.asarray(frames[1]))[0])
        s = _ssim(outs["f32"][..., :3].astype(np.float64) / 255,
                  outs["bf16"][..., :3].astype(np.float64) / 255)
        exact = " (bitwise equal)" if (outs["f32"] == outs["bf16"]).all() \
            else ""
        print(f"bf16-vs-f32 interp SSIM, {label}: {s:.5f} "
              f"(gate >= 0.999){exact}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
