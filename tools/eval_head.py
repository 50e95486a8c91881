"""Evaluate a trained learned-head checkpoint against the analytic paths.

Held-out triplet protocol (same scheme training uses, fresh seed): predict
the middle frame of (f[i-1], f[i+1]) and score PSNR against f[i], for the
learned head, the pyramid+warp path, and plain crossfade.

    python tools/eval_head.py checkpoints/head64.npz [--triplets 8]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("checkpoint")
    ap.add_argument("--source", default="synthetic:256x384:panmix")
    ap.add_argument("--triplets", type=int, default=8)
    ap.add_argument("--seed-skip", type=int, default=11,
                    help="frames to skip so eval content differs from "
                         "training's start-of-stream crops")
    args = ap.parse_args()

    from tpufg.utils.compile_cache import setup_compile_cache
    setup_compile_cache()

    import jax.numpy as jnp

    from tpufg.config import EngineConfig, resolve_sizes
    from tpufg.engine.pipeline import make_interp_step
    from tpufg.io.sources import open_source
    from tpufg.models import rife
    from tpufg.utils.quality import psnr

    params = rife.load_params(args.checkpoint)
    src = open_source(args.source, frames=args.seed_skip
                      + 2 * args.triplets + 3)
    w, h = src.size

    def cfg(mode):
        return resolve_sizes(EngineConfig(
            input_width=w, input_height=h, output_width=w, output_height=h,
            dtype="bf16", motion_mode=mode))

    steps = {
        "learned": make_interp_step(cfg("learned"), model_params=params),
        "pyramid": make_interp_step(cfg("pyramid")),
        "crossfade": make_interp_step(cfg("none")),
    }

    frames = []
    for i, f in enumerate(src):
        if i >= args.seed_skip:
            frames.append(np.array(f))
    scores = {k: [] for k in steps}
    inner = (slice(16, -16), slice(16, -16))
    for i in range(0, 2 * args.triplets, 2):
        prev, mid, curr = frames[i], frames[i + 1], frames[i + 2]
        truth = mid.astype(np.float64)[inner] / 255.0
        for name, step in steps.items():
            out = np.asarray(step(jnp.asarray(prev), jnp.asarray(curr))[0])
            scores[name].append(
                psnr(truth, out.astype(np.float64)[inner] / 255.0))
    print("| path | mid-frame PSNR (dB) |")
    print("|---|---|")
    for name, vals in scores.items():
        print(f"| {name} | {np.mean(vals):.2f} |")


if __name__ == "__main__":
    main()
