"""Sweep the adaptive MC->crossfade fallback constants (FB_LO/FB_HI/
FB_FLOOR, tpufg/kernels/warp_matmul.py) on the rich natural corpus.

The constants are read at trace time, so each combo monkeypatches the
module and rebuilds the engine step; the corpus is rendered once.  Scores
the full --quality preset (the shipping consumer of mc_fallback) on
PSNR/SSIM vs the analytic half-step truth.

    JAX_PLATFORMS=cpu python tools/sweep_fb.py [--width 320 --height 192]
        [--pairs 4] [--grain] [--combos "0.5,1.0,0.015;0.3,0.9,0.015"]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from tools.corpus import NaturalCorpus  # noqa: E402

QUALITY = dict(motion_mode="pyramid", dtype="bf16", mv_grid=1, subpel=True,
               mv_bias=0.1, occlusion_blend=True, mv_filter=True,
               mc_fallback=True)

DEFAULT_COMBOS = (
    "0.5,1.0,0.015;"          # shipping defaults (reference row)
    "0.3,0.9,0.015;0.3,1.2,0.015;"
    "0.5,0.8,0.015;0.5,1.3,0.015;"
    "0.7,1.0,0.015;0.7,1.4,0.015;"
    "0.4,1.0,0.015;0.6,1.1,0.015"
)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=192)
    p.add_argument("--pairs", type=int, default=4)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--grain", action="store_true")
    p.add_argument("--combos", default=DEFAULT_COMBOS,
                   help="semicolon-separated lo,hi,floor triples")
    args = p.parse_args(argv)

    from tpufg.utils.compile_cache import setup_compile_cache
    setup_compile_cache()

    import jax.numpy as jnp

    from tpufg.config import EngineConfig, resolve_sizes
    from tpufg.engine.pipeline import make_interp_step
    from tpufg.kernels import warp_matmul as wm
    from tpufg.utils.quality import psnr, ssim

    grng = np.random.default_rng(args.seed + 7) if args.grain else None
    grain = 3.0 if args.grain else 0.0
    corpus = NaturalCorpus(args.width, args.height, args.seed)
    frames, truths = [], []
    for i in range(args.pairs + 1):
        frames.append(corpus.frame(float(i), grain_rng=grng, grain=grain))
        if i < args.pairs:
            truths.append(corpus.frame(i + 0.5, grain_rng=grng, grain=grain))

    h, w = frames[0].shape[:2]
    cfg = resolve_sizes(EngineConfig(
        input_width=w, input_height=h, output_width=w, output_height=h,
        **QUALITY))

    tag = "grain" if args.grain else "clean"
    print(f"| lo | hi | floor ({tag}, {w}x{h}, {args.pairs} pairs) "
          f"| PSNR dB | SSIM |")
    print("|---|---|---|---|---|")
    for combo in args.combos.split(";"):
        lo, hi, floor = (float(v) for v in combo.split(","))
        wm.FB_LO, wm.FB_HI, wm.FB_FLOOR = lo, hi, floor
        # warp_blend_matmul is itself jit-wrapped: a cached executable
        # would keep the PREVIOUS combo's trace-time constants
        import jax
        jax.clear_caches()
        step = make_interp_step(cfg)
        ps, ss = [], []
        for i in range(len(frames) - 1):
            out = np.asarray(step(jnp.asarray(frames[i]),
                                  jnp.asarray(frames[i + 1]))[0])
            t = truths[i].astype(np.float64) / 255.0
            o = out.astype(np.float64) / 255.0
            ps.append(psnr(t[..., :3], o[..., :3]))
            ss.append(ssim(t[..., :3], o[..., :3]))
        print(f"| {lo} | {hi} | {floor} | {np.mean(ps):.2f} "
              f"| {np.mean(ss):.4f} |", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
