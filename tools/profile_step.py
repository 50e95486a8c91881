"""Per-kernel device-time breakdown of the production interp step.

Runs the 1080p->4K pyramid step on the attached GPU under the JAX
profiler and aggregates per-kernel device durations from the trace's
device planes (jax.profiler.ProfileData), so perf work targets the actual
hot kernels rather than guesses.  Dev tool — not part of the shipped
package.
"""

import glob
import os
import sys
import tempfile
import time
from collections import defaultdict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(in_w=1920, in_h=1080, out_mult=2, n=24, mode="pyramid", k=2,
         model_path=None):
    import jax
    import jax.numpy as jnp

    from tpufg.utils.compile_cache import setup_compile_cache
    setup_compile_cache()

    from tpufg.config import EngineConfig, resolve_sizes
    from tpufg.engine.pipeline import make_interp_step

    cfg = resolve_sizes(EngineConfig(
        input_width=in_w, input_height=in_h,
        output_width=in_w * out_mult, output_height=in_h * out_mult,
        dtype="bf16", motion_mode=mode, fps_multiplier=k,
    ))
    model_params = None
    if mode == "learned":
        from tpufg.models import rife
        ckpt = model_path or rife.bundled_checkpoint()
        if not ckpt:
            sys.exit("no --model-path given and no bundled checkpoint "
                     "found under checkpoints/")
        model_params = rife.load_params(ckpt)
    step = make_interp_step(cfg, wire="i32",  # the production wire
                            model_params=model_params, q_feed=True)
    if model_params is not None:
        from tpufg.models import rife
        if rife.is_v2(model_params) or rife.is_v3(model_params):
            # thread the v2 streamed quarter cache like the runner does,
            # so the profile matches production (each frame down4'd once)
            from tpufg.engine.pipeline import make_q_init
            qinit = make_q_init(cfg, model_params=model_params)
            qh = {"q": None}
            raw = step

            def step(p, c):
                if qh["q"] is None:
                    qh["q"] = qinit(p)
                *outs, qh["q"] = raw(p, c, qh["q"])
                return tuple(outs)
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (in_h + 32, in_w + 32, 4), dtype=np.uint8)

    def as_i32(x):
        return np.ascontiguousarray(x).view(np.int32).reshape(x.shape[:2])

    # equal-size configs donate arg 0 — donated buffers cannot be reused,
    # so there every call consumes a distinct pair
    import itertools
    n_pairs = (n + 10) if out_mult == 1 else 4
    pairs = []
    for i in range(n_pairs):
        j = i % 16
        a = base[j:in_h + j, 2 * j:in_w + 2 * j]
        b = base[j + 1:in_h + 1 + j, 2 * j + 2:in_w + 2 + 2 * j]
        pairs.append((jnp.asarray(as_i32(a)), jnp.asarray(as_i32(b))))
    pair_seq = iter(pairs) if out_mult == 1 else itertools.cycle(pairs)

    out = step(*next(pair_seq))
    jax.block_until_ready(out)

    t0 = time.perf_counter()
    last = None
    for i in range(n):
        last = step(*next(pair_seq))
    jax.block_until_ready(last)
    dt = time.perf_counter() - t0
    print(f"steady-state: {dt / n * 1e3:.3f} ms/pair", file=sys.stderr)

    trace_dir = tempfile.mkdtemp(prefix="tpufg_prof_")
    n_tr = 8
    jax.profiler.start_trace(trace_dir)
    for i in range(n_tr):
        last = step(*next(pair_seq))
    jax.block_until_ready(last)
    jax.profiler.stop_trace()

    import re

    from tpufg.utils.tracing import module_durations_ms
    # the device-truth step time: per-invocation module durations (what
    # bench.py's p99 and bench_matrix's device column report); the
    # per-kernel table below locates fusions, not source lines
    mods = module_durations_ms(trace_dir)
    dom = [d for name, ds in mods.items() if name.startswith("jit_step")
           for d in ds]
    if len(dom) != n_tr:
        raise RuntimeError(f"trace holds {len(dom)} step invocations for "
                           f"{n_tr} traced steps")
    print(f"device module p50 {float(np.percentile(dom, 50)):.3f} "
          f"ms/step over {len(dom)} invocations")
    files = glob.glob(f"{trace_dir}/**/*.xplane.pb", recursive=True)
    data = jax.profiler.ProfileData.from_file(sorted(files)[-1])
    agg = defaultdict(float)
    cnt = defaultdict(int)
    total = 0.0
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                name = re.sub(r"[._\d]+$", "", ev.name)
                ms = ev.duration_ns / 1e6
                agg[name] += ms
                cnt[name] += 1
                total += ms
    print(f"kernel time total {total:.3f} ms over 8 steps "
          f"({total / 8:.3f} ms/step)")
    for name, ms in sorted(agg.items(), key=lambda kv: -kv[1])[:30]:
        print(f"{ms / 8:8.3f} ms/step  x{cnt[name] / 8:<6.1f} {name[:100]}")


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--in-w", type=int, default=1920)
    ap.add_argument("--in-h", type=int, default=1080)
    ap.add_argument("--out-mult", type=int, default=2)
    ap.add_argument("--mode", default="pyramid")
    ap.add_argument("-k", type=int, default=2)
    ap.add_argument("-n", type=int, default=24)
    ap.add_argument("--model-path", default=None,
                    help="learned-head checkpoint (default: the newest "
                         "bundled head, rife.bundled_checkpoint)")
    args = ap.parse_args()
    main(args.in_w, args.in_h, args.out_mult, args.n, args.mode, args.k,
         args.model_path)
