"""Throughput matrix over the BASELINE.json configs on one GPU.

bench.py reports the north-star headline (config 4); this dev tool times
every BASELINE config the same way (N steps enqueued back-to-back, one
``block_until_ready``) plus the step module's device durations from a
profiler trace, and prints a markdown table.  Needs a GPU.

    python tools/bench_matrix.py [-n 30]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _run_config(tag, cfg_kw, n, steps_kind, model_params=None,
                skip_alpha=True):
    import jax
    import jax.numpy as jnp

    from tpufg.config import EngineConfig, resolve_sizes
    from tpufg.engine.pipeline import make_interp_step, make_scale_step

    cfg = resolve_sizes(EngineConfig(**cfg_kw))
    in_h, in_w = cfg.input_height, cfg.input_width
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (in_h + 32, in_w + 32, 4), dtype=np.uint8)
    # real video wires carry one constant alpha (y4m synthesizes 255;
    # capture-class RGBA is constant 0xFF), so bench content does too and
    # the steps take the engine's alpha-skip search path (bitwise MV field)
    base[..., 3] = 255

    def as_i32(x):
        return jnp.asarray(
            np.ascontiguousarray(x).view(np.int32).reshape(x.shape[:2]))

    identity = (cfg.output_height, cfg.output_width) == (in_h, in_w)
    # donation engages at equal size, so every step (1 warmup + n wall
    # + n trace) needs a fresh pair
    n_pairs = (2 * n + 5) if identity else 4
    pairs = []
    for i in range(n_pairs):
        j = i % 16
        pairs.append((as_i32(base[j:in_h + j, 2 * j:in_w + 2 * j]),
                      as_i32(base[j + 1:in_h + 1 + j,
                                  2 * j + 2:in_w + 2 + 2 * j])))
    import itertools
    seq = iter(pairs) if identity else itertools.cycle(pairs)

    if steps_kind == "scale":
        step1 = make_scale_step(cfg, wire="i32")
        step = lambda p, c: (step1(c),)
        outs_per_step = 1
    else:
        step_raw = make_interp_step(cfg, wire="i32",
                                    model_params=model_params,
                                    motion_skip_alpha=skip_alpha,
                                    q_feed=True)
        outs_per_step = max(2, int(cfg.fps_multiplier))
        from tpufg.models import rife
        if model_params is not None and (rife.is_v2(model_params)
                                         or rife.is_v3(model_params)):
            # the bench pairs are a sliding stream (pair i's curr is
            # pair i+1's prev), so thread the v2 quarter cache exactly
            # like the runner does — this times the production
            # streaming behavior (each frame downsampled once)
            from tpufg.engine.pipeline import make_q_init
            qinit = make_q_init(cfg, model_params=model_params)
            qh = {"q": None}

            def step(p, c):
                if qh["q"] is None:
                    qh["q"] = qinit(p)
                *outs, qh["q"] = step_raw(p, c, qh["q"])
                return tuple(outs)
        else:
            step = step_raw

    sync = jax.block_until_ready

    out = step(*next(seq))
    sync(out)
    t0 = time.perf_counter()
    last = None
    for _ in range(n):
        last = step(*next(seq))
    sync(last)
    dt = time.perf_counter() - t0
    ms = dt / n * 1e3

    # device-trace column: p50 of the step module's per-invocation device
    # durations (one per traced step)
    import shutil
    import tempfile

    from tpufg.utils.tracing import module_durations_ms
    trace_dir = tempfile.mkdtemp(prefix="tpufg_matrix_trace_")
    try:
        jax.profiler.start_trace(trace_dir)
        for i in range(n):
            last = step(*next(seq))
            if i % 25 == 24:  # bound the async queue depth
                sync(last)
        sync(last)
        jax.profiler.stop_trace()
        mods = module_durations_ms(trace_dir)
    finally:
        shutil.rmtree(trace_dir, ignore_errors=True)
    dom = [d for name, ds in mods.items() if name.startswith("jit_step")
           for d in ds]
    if len(dom) != n:
        raise RuntimeError(f"{tag}: trace holds {len(dom)} step invocations "
                           f"for {n} traced steps")
    dev = float(np.percentile(np.asarray(dom), 50))
    dev_fps = outs_per_step * 1e3 / float(np.median(dom))
    fps = outs_per_step * n / dt
    print(f"| {tag} | {ms:.3f} | {fps:.1f} | {dev:.3f} | {dev_fps:.1f} |",
          flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=30)
    ap.add_argument("--model-path", default=None,
                    help="checkpoint for config 5b (default: bundled)")
    ap.add_argument("--only", default=None,
                    help="comma-separated config prefixes to run "
                         "(e.g. '3,5b'); default all")
    args = ap.parse_args()

    import jax

    from tpufg.utils.compile_cache import setup_compile_cache
    setup_compile_cache()
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("bench_matrix.py needs a GPU")
    only = ([s.strip() for s in args.only.split(",") if s.strip()]
            if args.only else None)

    def run_config(tag, *a, **kw):
        if only is not None and not any(tag.startswith(p + ":")
                                        for p in only):
            return
        return _run_config(tag, *a, **kw)

    print("| BASELINE config | ms/step | output fps/device "
          "| device ms/step p50 | device fps |")
    print("|---|---|---|---|---|")
    run_config("1: 720p→1440p Lanczos only (scale.comp)",
               dict(input_width=1280, input_height=720, output_width=2560,
                    output_height=1440, dtype="bf16", motion_mode="none",
                    enable_interpolation=False), args.n, "scale")
    run_config("2: 1080p crossfade t=0.5 (interpolate.comp, no motion)",
               dict(input_width=1920, input_height=1080, output_width=1920,
                    output_height=1080, dtype="bf16", motion_mode="none"),
               args.n, "interp")
    run_config("3: 1080p exhaustive motion + warp (motion.comp params)",
               dict(input_width=1920, input_height=1080, output_width=1920,
                    output_height=1080, dtype="bf16",
                    motion_mode="exhaustive"), max(6, args.n // 4), "interp")
    run_config("4: 1080p→4K pyramid+warp+scale (north star)",
               dict(input_width=1920, input_height=1080, output_width=3840,
                    output_height=2160, dtype="bf16", motion_mode="pyramid"),
               args.n, "interp")
    run_config("4q: 1080p→4K --quality preset (per-pixel + subpel + fb)",
               dict(input_width=1920, input_height=1080, output_width=3840,
                    output_height=2160, dtype="bf16", motion_mode="pyramid",
                    mv_grid=1, subpel=True, mv_bias=0.1, mv_filter=True,
                    mc_fallback=True, occlusion_blend=True),
               args.n, "interp")
    run_config("5a: 4K→4K 60→120 fps pyramid",
               dict(input_width=3840, input_height=2160, output_width=3840,
                    output_height=2160, dtype="bf16", motion_mode="pyramid"),
               max(8, args.n // 3), "interp")
    # 5b: the BUNDLED checkpoint (production arch + width)
    from tpufg.models import rife
    ckpt = args.model_path or rife.bundled_checkpoint()
    params = rife.load_params(ckpt)
    arch = ("v3d" if rife.has_stage2_diff(params)
            else "v3" if rife.is_v3(params)
            else "v2" if rife.is_v2(params) else "v1")
    run_config(f"5b: 4K→4K learned head ({arch}, {os.path.basename(ckpt)})",
               dict(input_width=3840, input_height=2160,
                    output_width=3840, output_height=2160, dtype="bf16",
                    motion_mode="learned"),
               max(8, args.n // 3), "interp", model_params=params)

if __name__ == "__main__":
    main()
