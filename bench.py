"""North-star benchmark: 1080p->4K motion-compensated fps doubling on one GPU.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": "fps", "vs_baseline": N/target, ...}

Baseline context (BASELINE.md): the reference publishes no numbers; the
accountable target is sustaining 30->60 fps 1080p->4K interpolation on one
device (i.e. >= 60 interpolated output frames/sec), p99 < 8 ms/output
frame.  vs_baseline is measured output fps / 60.

Methodology: the production pipeline step (pyramid motion + block warp +
2x Lanczos upscale + uint8 conversions, bf16) is enqueued back-to-back over
distinct on-device frame pairs with one ``block_until_ready`` at the end —
steady-state device throughput, the regime the streaming engine's async
pipeline approaches.  Per-step device durations come from a profiler trace
of the step's XLA module; a run whose trace holds none fails.  The run
needs a GPU: on any other backend it exits non-zero.

    python bench.py
"""

import json
import sys
import time

import numpy as np

METRIC = "1080p->4K interpolated output fps/device (pyramid+warp+scale, bf16)"


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def emit(payload):
    print(json.dumps(payload), flush=True)


def main():
    import jax

    from tpufg.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"bench.py needs a GPU; JAX found {dev.platform!r}")
        sys.exit(2)
    run_bench()


def run_bench():
    import jax
    import jax.numpy as jnp

    from tpufg.config import EngineConfig, resolve_sizes
    from tpufg.engine.pipeline import make_interp_step

    cfg = resolve_sizes(EngineConfig(
        input_width=1920, input_height=1080,
        output_width=3840, output_height=2160,
        dtype="bf16", motion_mode="pyramid",
    ))
    # the engine's production wire: packed int32 RGBA lanes (same bytes as
    # uint8 [H, W, 4]; host views are free, device skips bitcast relayouts)
    step = make_interp_step(cfg, wire="i32")

    rng = np.random.default_rng(0)
    pairs = []
    base = rng.integers(0, 256, (1080 + 32, 1920 + 32, 4), dtype=np.uint8)

    def as_i32(x):
        return np.ascontiguousarray(x).view(np.int32).reshape(x.shape[:2])

    for i in range(4):
        a = base[i:1080 + i, 2 * i:1920 + 2 * i]
        b = base[i + 1:1081 + i, 2 * i + 2:1922 + 2 * i]
        pairs.append((jnp.asarray(as_i32(a)), jnp.asarray(as_i32(b))))

    # warm-up / compile
    t0 = time.perf_counter()
    jax.block_until_ready(step(*pairs[0]))
    log(f"compile+first-run: {time.perf_counter() - t0:.1f}s")

    # steady-state throughput: enqueue N steps, one sync.  Reusing the
    # pairs across calls is safe here: the step donates arg 0, but with
    # 1080p inputs and 4K outputs no donation can engage (shape mismatch).
    # Best of two passes.
    n = 40
    dt = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        last = None
        for i in range(n):
            last = step(*pairs[i % len(pairs)])
        jax.block_until_ready(last)
        dt = min(dt, time.perf_counter() - t0)
    per_pair_ms = dt / n * 1e3
    # each step emits 2 output frames (interpolated + scaled current)
    out_fps = 2.0 * n / dt
    per_out_ms = per_pair_ms / 2.0
    log(f"steady-state: {per_pair_ms:.2f} ms/pair -> {per_out_ms:.2f} ms/output "
        f"frame -> {out_fps:.1f} output fps")

    # Paced-mode p99: per-invocation device durations of the step's XLA
    # module from a profiler trace (the paced engine syncs every frame, so
    # its per-output-frame device latency is the step duration / 2), and
    # the host-synced step latency beside it.
    import tempfile

    from tpufg.utils.tracing import module_durations_ms

    trace_dir = tempfile.mkdtemp(prefix="tpufg_bench_trace_")
    n_tr = 200  # >= 200 device samples so p99 is a real percentile
    jax.profiler.start_trace(trace_dir)
    last = None
    for i in range(n_tr):
        last = step(*pairs[i % len(pairs)])
        if i % 25 == 24:  # periodic sync: bound the async queue depth
            jax.block_until_ready(last)
    jax.block_until_ready(last)
    jax.profiler.stop_trace()
    durs = np.array([d for name, ds in module_durations_ms(trace_dir).items()
                     if name.startswith("jit_step") for d in ds])
    if len(durs) != n_tr:
        raise RuntimeError(f"trace holds {len(durs)} jit_step invocations "
                           f"for {n_tr} traced steps")
    # per OUTPUT frame (each step emits 2 frames at once)
    p50d = float(np.percentile(durs, 50)) / 2.0
    p95d = float(np.percentile(durs, 95)) / 2.0
    p99d = float(np.percentile(durs, 99)) / 2.0
    log(f"device step durations from trace: n={len(durs)} "
        f"p50 {p50d:.3f} p95 {p95d:.3f} p99 {p99d:.3f} ms/output frame "
        f"(target < 8 ms)")

    lats = []
    for i in range(12):
        t0 = time.perf_counter()
        jax.block_until_ready(step(*pairs[i % len(pairs)]))
        lats.append(time.perf_counter() - t0)
    lats = np.array(lats) * 1e3
    host_p50 = float(np.percentile(lats, 50))
    log(f"host-synced step latency: p50 {host_p50:.3f} ms")

    e2e_fps, sink_ms = bench_e2e(log)

    dev = jax.devices()[0]
    emit({
        "metric": METRIC,
        "value": out_fps,
        "unit": "fps",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "vs_baseline": out_fps / 60.0,
        "per_output_frame_ms_steady": per_out_ms,
        "paced_p50_ms_device": p50d,
        "paced_p95_ms_device": p95d,
        "paced_p99_ms_device": p99d,
        "p99_trace_samples": int(len(durs)),
        "e2e_y4m_fps": e2e_fps,
        "sink_write_ms_per_4k_frame": sink_ms,
        "host_sync_ms_p50": host_p50,
    })


def bench_e2e(log):
    """Full-pipeline transcode: raw file -> native ingest ring -> device
    (pyramid+warp+2x scale, device-side y4m420 conversion) -> Y4MSink.

    Bounded by min(device step rate, readback, sink write rate); the
    device-side y4m conversion cuts the readback payload vs the RGBA wire
    (1.5 vs 4 bytes/px).  The sink leg is measured separately below (a
    buffer write, since color conversion moved on-device).
    """
    import os
    import tempfile

    from tpufg.config import EngineConfig, resolve_sizes
    from tpufg.engine.runner import StreamingEngine
    from tpufg.io.sinks import AsyncSink, Y4MSink
    from tpufg.io.sources import open_source

    n_in = 24
    rng = np.random.default_rng(7)
    tmp = tempfile.mkdtemp(prefix="tpufg_e2e_")
    raw_path = os.path.join(tmp, "in.raw")
    base = rng.integers(0, 256, (1080 + n_in, 1920 + 2 * n_in, 4),
                        dtype=np.uint8)
    with open(raw_path, "wb") as f:
        for i in range(n_in):  # panning crop: real motion for the search
            f.write(np.ascontiguousarray(
                base[i:1080 + i, 2 * i:1920 + 2 * i]).tobytes())
    out_path = os.path.join(tmp, "out.y4m")

    # sink leg alone, measured FIRST (before the transcode floods the page
    # cache): with the color conversion on-device, egress is a payload
    # buffer write — what a production host pays per 4K output frame
    payload = rng.integers(0, 256, (2160 * 3 // 2, 3840), dtype=np.uint8)
    sink_path = os.path.join(tmp, "sinkonly.y4m")
    sink2 = Y4MSink(sink_path, 3840, 2160, fps=60.0, chroma="420")
    sink2.write(payload)  # open + header
    times = []
    for _ in range(30):
        t0 = time.perf_counter()
        sink2.write(payload)
        times.append(time.perf_counter() - t0)
    sink_ms = float(np.median(times)) * 1e3
    sink2.close()
    os.remove(sink_path)
    log(f"sink leg (4K C420 payload write, median of 30): "
        f"{sink_ms:.2f} ms/frame -> {1e3 / sink_ms:.0f} fps")

    cfg = resolve_sizes(EngineConfig(
        input_width=1920, input_height=1080,
        output_width=3840, output_height=2160,
        dtype="bf16", motion_mode="pyramid"))
    engine = StreamingEngine(cfg)
    # warm the jit cache on the same sink wire so the timed run measures
    # the pipeline, not XLA compilation
    warm_sink = Y4MSink(os.devnull, 3840, 2160, fps=60.0, chroma="420")
    engine.run(open_source(raw_path, 1920, 1080, "rgba"),
               warm_sink, max_frames=3, paced=False)
    warm_sink.close()

    source = open_source(raw_path, 1920, 1080, "rgba")
    sink = AsyncSink(Y4MSink(out_path, 3840, 2160, fps=60.0, chroma="420"))
    t0 = time.perf_counter()
    stats = engine.run(source, sink, paced=False)
    sink.close()
    source.close()
    wall = time.perf_counter() - t0
    e2e_fps = stats.frames_out / wall if wall > 0 else 0.0
    out_mb = os.path.getsize(out_path) / 1e6
    frame_mb = 3840 * 2160 * 1.5 / 1e6
    link_mbs = e2e_fps * frame_mb
    log(f"e2e 1080p->4K y4m420 transcode (warm): {stats.frames_in} in -> "
        f"{stats.frames_out} out in {wall:.3f}s = {e2e_fps:.3f} output fps "
        f"({out_mb:.0f} MB written; {link_mbs:.0f} MB/s of output at "
        f"{frame_mb:.1f} MB per frame)")

    for p in (raw_path, out_path):
        if os.path.exists(p):
            os.remove(p)
    os.rmdir(tmp)
    return e2e_fps, sink_ms


if __name__ == "__main__":
    main()
