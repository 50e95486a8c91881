"""Render the procedural natural-content corpus to a y4m/raw file.

The renderer itself lives in tpufg.data.corpus (it is a framework
component now: the trainer draws infinite fresh-scene triplets with
analytic flow supervision from it); this CLI renders fixed evaluation
sequences.  See tpufg/data/corpus.py for what makes the content
"natural" (1/f textures, occluding parallax layers, rotation, a thin
two-motion bar, an in-block repeated grating, subpixel + divergent
motion, grain, cuts) and for the exact-ground-truth protocol.

Usage:
    python tools/corpus.py out.y4m --width 640 --height 384 --frames 60
        [--half-rate] [--no-grain] [--cut-at 30] [--seed 1] [--fps 30]

``--half-rate`` renders frames at t = 0, 0.5, 1, ... (2N-1 frames) so the
odd frames are ground truth for fps-doubling the even ones.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from tpufg.data.corpus import NaturalCorpus, Scene  # noqa: E402,F401


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("output")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=384)
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--fps", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--half-rate", action="store_true",
                   help="render at t = 0, 0.5, 1, ... (ground-truth "
                        "in-betweens interleaved)")
    p.add_argument("--no-grain", action="store_true")
    p.add_argument("--cut-at", default=None,
                   help="scene-cut time(s) in frame units — a number or "
                        "comma-separated list for multiple cuts")
    p.add_argument("--classic", action="store_true",
                   help="reproduce the r3 corpus (no rotation / thin-bar "
                        "occluder / repeated-grating aperture trap)")
    p.add_argument("--photo", action="store_true",
                   help="round-5 photometric axes: motion blur, fast "
                        "exposure flicker, sensor-noise mismatch, "
                        "perspective background (Scene photo=True)")
    args = p.parse_args(argv)
    from tpufg.utils.compile_cache import setup_compile_cache
    setup_compile_cache()

    from tpufg.io.sinks import open_sink

    cuts = ([float(c) for c in str(args.cut_at).split(",")]
            if args.cut_at is not None else None)
    corpus = NaturalCorpus(args.width, args.height, args.seed,
                           cut_at=cuts, rich=not args.classic,
                           photo=args.photo)
    grain_rng = None if args.no_grain else np.random.default_rng(args.seed)
    grain = 0.0 if args.no_grain else 3.0
    step = 0.5 if args.half_rate else 1.0
    n = args.frames * 2 - 1 if args.half_rate else args.frames
    sink = open_sink(args.output, args.width, args.height, fps=args.fps)
    for i in range(n):
        sink.write(corpus.frame(i * step, grain_rng=grain_rng, grain=grain))
    sink.close()
    print(f"wrote {n} frames to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
