"""Quality validation harness: fast path vs the f32 oracle.

The reference's roadmap left "Evaluate quality and performance metrics"
unchecked (readme.md:89); this tool checks it.  For each frame pair of a
source it runs BOTH the production pipeline (fast path, bf16 or
f32) and the exact oracle pipeline, and reports SSIM / PSNR / max |err| of
the interpolated outputs plus the BASELINE SSIM >= 0.999 verdict.

    python -m tpufg.validate synthetic:256x256 --frames 4 [--dtype bf16]
        [--motion-mode pyramid] [--output-width W ...]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from tpufg.utils.logging import get_logger


def main(argv=None) -> int:
    log = get_logger()
    p = argparse.ArgumentParser(prog="tpufg-validate", description=__doc__)
    p.add_argument("input")
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--dtype", choices=["bf16", "f32"], default="bf16")
    p.add_argument("--motion-mode",
                   choices=["pyramid", "exhaustive", "none"],
                   default="pyramid")
    p.add_argument("--input-width", type=int, default=0)
    p.add_argument("--input-height", type=int, default=0)
    p.add_argument("--output-width", type=int, default=0)
    p.add_argument("--output-height", type=int, default=0)
    p.add_argument("--threshold", type=float, default=0.999)
    args = p.parse_args(argv)

    import jax.numpy as jnp

    from tpufg.config import ConfigError, EngineConfig, resolve_sizes
    from tpufg.engine.pipeline import make_interp_step
    from tpufg.io.sources import SourceError, open_source
    from tpufg.utils.compile_cache import setup_compile_cache
    from tpufg.utils.quality import psnr, ssim

    setup_compile_cache()

    try:
        source = open_source(args.input, args.input_width, args.input_height,
                             frames=args.frames + 1)
        cfg = resolve_sizes(
            EngineConfig(
                input_width=args.input_width, input_height=args.input_height,
                output_width=args.output_width,
                output_height=args.output_height,
                dtype=args.dtype, motion_mode=args.motion_mode,
            ),
            detected_input=source.size,
        )
    except (ConfigError, SourceError, OSError) as e:
        log.error(str(e))
        return 1

    # two comparisons:
    # - precision: fast(bf16) vs fast(f32), same algorithm — this is the
    #   BASELINE bf16 SSIM >= 0.999 gate;
    # - fidelity: fast vs the exact oracle (full per-pixel exhaustive
    #   search) — reported for context; in pyramid mode it also measures
    #   the pyramid's approximation, which is a quality tradeoff, not a
    #   numeric defect.
    f32_cfg = EngineConfig(**{**cfg.__dict__, "dtype": "f32"})
    exact_cfg = EngineConfig(**{**cfg.__dict__, "dtype": "f32"})
    fast = make_interp_step(cfg)
    fast32 = make_interp_step(f32_cfg)
    exact = make_interp_step(exact_cfg, "exact")

    prec_ssims, fid_ssims, psnrs, maxerrs = [], [], [], []
    prev = None
    n_pairs = 0
    for frame in source:
        cur = jnp.asarray(frame)
        if prev is not None:
            # fresh device arrays per call: the fast step donates arg 0
            host_prev = np.asarray(prev)
            f_out = np.asarray(fast(jnp.asarray(host_prev), cur)[0])
            f32_out = np.asarray(fast32(jnp.asarray(host_prev), cur)[0])
            e_out = np.asarray(exact(jnp.asarray(host_prev), cur)[0])
            a = f_out.astype(np.float64) / 255.0
            b = f32_out.astype(np.float64) / 255.0
            e = e_out.astype(np.float64) / 255.0
            prec_ssims.append(ssim(b, a))
            fid_ssims.append(ssim(e, a))
            psnrs.append(psnr(b, a))
            maxerrs.append(float(np.abs(a - b).max()))
            n_pairs += 1
            if n_pairs >= args.frames:
                break
        prev = cur
    source.close()

    if not prec_ssims:
        log.error("source yielded fewer than 2 frames")
        return 1
    mean_ssim = float(np.mean(prec_ssims))
    log.info(f"pairs: {n_pairs}  precision SSIM (vs f32 path) mean "
             f"{mean_ssim:.6f} min {min(prec_ssims):.6f}  PSNR "
             f"{np.mean(psnrs):.2f} dB  max|err| {max(maxerrs):.4f}")
    log.info(f"fidelity SSIM (vs exact oracle, incl. motion-algorithm "
             f"differences): mean {np.mean(fid_ssims):.6f}")
    ok = mean_ssim >= args.threshold
    log.info(f"precision SSIM >= {args.threshold}: "
             f"{'PASS' if ok else 'FAIL'}")
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
