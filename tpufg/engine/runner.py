"""Streaming engine: source -> device ring -> jit'd step -> sink.

Replaces the reference's main pacing loop (src/main.cpp:114-131) and the
per-frame orchestration of Scaler::ProcessFrame (scaler.cpp:397-624), with
the reference's structural bottlenecks designed out:

- the reference allocates + frees a staging buffer every frame and fully
  serializes on vkQueueWaitIdle three times per frame (SURVEY.md §2.3.8,
  §5.8); here JAX's async dispatch pipelines host->HBM upload, compute and
  device->host readback across frames — the host only blocks one frame
  behind (a one-slot software pipeline: XLA runs one device's steps in
  order anyway);
- pacing uses float seconds on a monotonic clock instead of the reference's
  integer-millisecond SDL_Delay budget (main.cpp:114 truncates 60 fps to
  16 ms -> 62.5 Hz ceiling; divergence documented);
- stats mirror the reference: a sliding-window FPS estimate
  (scaler.cpp:428-439) and a status log every 60 frames (scaler.cpp:420-426),
  plus p50/p90/p99 step latency (new; the reference publishes no metrics).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import jax
import numpy as np

from tpufg.config import EngineConfig
from tpufg.engine.pipeline import (
    make_exact_scale_step,
    make_interp_step,
    make_scale_step,
)
from tpufg.io.sinks import FrameSink
from tpufg.io.sources import FrameSource
from tpufg.utils.logging import get_logger
from tpufg.utils.stats import FpsWindow, LatencyRecorder


@dataclass
class StreamStats:
    frames_in: int = 0
    frames_out: int = 0
    fps: float = 0.0
    latency: dict = field(default_factory=dict)
    # paced mode: input frames measured against their absolute deadline
    # (compile warmup excluded — the clock re-anchors after it)
    paced_frames: int = 0
    deadline_misses: int = 0

    def as_dict(self):
        return {
            "frames_in": self.frames_in,
            "frames_out": self.frames_out,
            "fps": self.fps,
            "paced_frames": self.paced_frames,
            "deadline_misses": self.deadline_misses,
            **{f"step_{k}": v for k, v in self.latency.items()},
        }


class StreamingEngine:
    def __init__(self, cfg: EngineConfig, precision: str = "fast",
                 model_params=None):
        cfg.validate()
        self.cfg = cfg
        self.precision = precision
        self.model_params = model_params
        self.log = get_logger()
        # fast path speaks the packed-int32 wire: identical bytes, free
        # uint8 views on the host, no u8<->i32 bitcast relayouts on-device
        self._wire = "u8" if precision == "exact" else "i32"
        self._steps_wire = None  # sink wire the built steps target
        self._qfeed = False      # v2 learned quarter-cache threading
        self._q_init = None
        self._fps_win = FpsWindow(cfg.fps_window)
        self._lat = LatencyRecorder()

    def _sink_wire(self, sink: FrameSink) -> str:
        """Negotiate the output wire: y4m sinks take ready FRAME payloads
        converted on-device (kernels/yuv.py — byte-identical to the host
        egress, 2.7x smaller C420 readback) when the fast path runs
        without overlay burn-in (the overlay draws on host RGBA)."""
        wf = getattr(sink, "wire_format", "rgba")
        if (wf in ("y4m420", "y4m444") and self.precision != "exact"
                and not self.cfg.overlay):
            from tpufg.kernels.yuv import y4m_wire_ok
            if y4m_wire_ok(self.cfg.output_height, self.cfg.output_width,
                           wf[3:]):
                return wf
        return "rgba"

    def _build_steps(self, sink_wire: str, skip_alpha: bool = False) -> None:
        if self._steps_wire == (sink_wire, skip_alpha):
            return
        cfg = self.cfg
        if cfg.enable_interpolation:
            self._step2 = make_interp_step(
                cfg, "exact" if self.precision == "exact" else "fast",
                model_params=self.model_params, wire=self._wire,
                sink_wire=sink_wire,
                motion_skip_alpha=skip_alpha and self.precision != "exact",
                q_feed=True)  # v2 learned streams thread the quarter cache
            self._qfeed = (cfg.motion_mode == "learned"
                           and self.precision != "exact"
                           and self.model_params is not None)
            if self._qfeed:
                from tpufg.models import rife
                self._qfeed = (rife.is_v2(self.model_params)
                               or rife.is_v3(self.model_params))
            self._q_init = None
        self._step1 = (make_exact_scale_step(cfg)
                       if self.precision == "exact"
                       else make_scale_step(cfg, wire=self._wire,
                                            sink_wire=sink_wire))
        self._steps_wire = (sink_wire, skip_alpha)

    def run(self, source: FrameSource, sink: FrameSink,
            max_frames: Optional[int] = None, paced: bool = True,
            start_frame: int = 0) -> StreamStats:
        """``start_frame``: skip that many source frames first (resumable
        offline transcode — the reference has no resumable state at all,
        SURVEY.md §5.4).  The stream restarts at that frame: its scaled
        frame is re-emitted (so concatenating segment outputs, drop each
        segment's first frame after the first segment)."""
        cfg = self.cfg
        stats = StreamStats()
        # sources that guarantee one constant alpha across frames let the
        # step drop the zero-contribution alpha term from motion search
        # (bitwise-equal MV field — see interp_planar motion_skip_alpha)
        self._build_steps(self._sink_wire(sink),
                          skip_alpha=getattr(source, "const_alpha", None)
                          is True)
        # zero-copy slot sources (NativeRawSource) need each upload synced
        # before the iterator advances; capture before any re-wrapping
        sync_upload = bool(getattr(source, "zero_copy", False))
        if start_frame > 0:
            it = iter(source)
            for _ in range(start_frame):
                try:
                    next(it)
                except StopIteration:
                    break
            source = it
        if self._wire == "i32":
            # free reinterpretation: uint8 [H, W, 4] -> packed int32 [H, W]
            # (the step's wire format; the device upload moves bytes either
            # way, but the i32 wire skips the on-device bitcast relayout)
            def _i32_view(frames):
                for f in frames:
                    if not f.flags["C_CONTIGUOUS"]:
                        f = np.ascontiguousarray(f)
                    yield f.view(np.int32).reshape(f.shape[0], f.shape[1])
            source = _i32_view(source)
        frame_period = 1.0 / cfg.target_fps if cfg.target_fps > 0 else 0.0
        prev_dev = None
        pending = []  # device arrays whose host copy we delay one frame

        temporal = (cfg.temporal_mv and cfg.enable_interpolation
                    and cfg.motion_mode == "pyramid"
                    and self.precision != "exact")
        mv_state = None
        q_state = None  # v2 learned quarter cache (see _qfeed)
        if temporal:
            import jax.numpy as jnp

            from tpufg.engine.pipeline import mv_lattice_shape
            mv_state = jax.device_put(
                jnp.zeros(mv_lattice_shape(cfg), jnp.float32))

        needs_host = getattr(sink, "needs_host", True)

        def as_u8(a: np.ndarray) -> np.ndarray:
            # packed-int32 wire -> uint8 [H, W, 4]: a free view of the
            # row-major host copy (same bytes, little-endian lanes)
            if a.dtype == np.int32:
                return a.view(np.uint8).reshape(a.shape[0], a.shape[1], 4)
            return a

        def flush_pending():
            # device->host readback via jax.device_get (one transfer per
            # array)
            for arr in pending:
                if not needs_host:
                    # e.g. NullSink benchmarking: frames stay on-device
                    sink.write(arr)
                elif cfg.overlay:
                    from tpufg.engine.overlay import draw_stats
                    # np.array: readback may be read-only; force a copy
                    sink.write(draw_stats(
                        as_u8(np.array(jax.device_get(arr))),
                        self._fps_win.fps,
                        (cfg.input_width, cfg.input_height),
                        (cfg.output_width, cfg.output_height)))
                else:
                    sink.write(as_u8(jax.device_get(arr)))
                stats.frames_out += 1
            pending.clear()

        from tpufg.engine.ring import DeviceIngestRing

        t_start = time.perf_counter()
        next_deadline = t_start
        clock = None
        if paced and frame_period > 0:
            from tpufg.io.native import NativeClock
            clock = NativeClock(float(cfg.target_fps))
        ring = DeviceIngestRing(source, depth=max(1, cfg.ring_slots - 1),
                                sync_upload=sync_upload)
        for i, dev in enumerate(ring):
            if max_frames is not None and i >= max_frames:
                break
            t0 = time.perf_counter()
            from tpufg.utils.tracing import annotate
            with annotate("tpufg.step"):
                if cfg.enable_interpolation and prev_dev is not None:
                    if temporal:
                        # thread the MV predictor between pairs on-device
                        # (the step donates and re-emits it; never copied
                        # to the host)
                        *outs, mv_state = self._step2(
                            prev_dev, dev, mv_state)
                    elif self._qfeed:
                        # thread the v2 quarter-frame cache (donated;
                        # each frame is box-downsampled once per stream)
                        if q_state is None:
                            if self._q_init is None:
                                from tpufg.engine.pipeline import \
                                    make_q_init
                                self._q_init = make_q_init(
                                    cfg, model_params=self.model_params)
                            q_state = self._q_init(prev_dev)
                        *outs, q_state = self._step2(
                            prev_dev, dev, q_state)
                    else:
                        outs = list(self._step2(prev_dev, dev))
                else:
                    outs = [self._step1(dev)]
            # one-slot pipeline: write last frame's results while this
            # frame's step executes asynchronously on-device
            with annotate("tpufg.readback"):
                flush_pending()
            pending.extend(outs)
            prev_dev = dev
            stats.frames_in += 1

            # paced (real-time) mode syncs every frame — the deadline is
            # per frame; throughput mode samples the sync so the async
            # pipeline stays full.  warmup (compile) frames are excluded
            # from the latency distribution.
            if paced or stats.frames_in % 8 == 3:  # sampled sync, skips warmup
                jax.block_until_ready(outs[-1])
                if stats.frames_in > 2:
                    self._lat.record(time.perf_counter() - t0)
            self._fps_win.tick()

            if stats.frames_in % 60 == 0:
                # reference logs every 60 frames (scaler.cpp:420-426)
                self.log.info(
                    f"Processing frame {stats.frames_in}, fps: "
                    f"{self._fps_win.fps:.1f}")
            if clock is not None:
                # drift-free absolute-deadline pacing (native
                # clock_nanosleep when the C library is available).  The
                # first frames carry jit compile; re-anchor the absolute
                # schedule after them so sustained-playback stats measure
                # steady state, not compile repayment
                late = clock.pace()
                if stats.frames_in <= 2:
                    clock.reset()
                else:
                    stats.paced_frames += 1
                    if late > 0:
                        stats.deadline_misses += 1
                    if late > frame_period:
                        # more than a whole frame behind: re-anchor (the
                        # drift-free absolute schedule would otherwise
                        # mark every subsequent frame late while repaying
                        # the backlog — deadline-miss semantics, like any
                        # real-time scheduler, treat the missed slots as
                        # dropped and resume from now)
                        clock.reset()
                if late > 0.1 and stats.frames_in > 2:
                    self.log.warning(
                        f"frame {stats.frames_in} late by {late * 1e3:.1f} ms")
        flush_pending()
        if clock is not None:
            clock.close()
        wall = time.perf_counter() - t_start
        # wall-average input fps (the 60-sample window drives the periodic
        # log, mirroring the reference; the sliding estimate is noisy at
        # end of stream)
        stats.fps = stats.frames_in / wall if wall > 0 else 0.0
        stats.latency = self._lat.summary()
        return stats


def measure_step_rate(cfg: EngineConfig, n: int = 6) -> float:
    """Measured steady-state interpolation-step rate, in frame PAIRS/sec.

    Compiles cfg's production step, runs one synced warmup (compile time
    excluded), then times ``n`` enqueued steps with one device sync —
    bench.py's steady-state methodology at small n.  Used by ``--quality
    auto``'s headroom check.  Each call feeds fresh on-device copies (the
    step donates its inputs in equal-size configs) and threads the MV
    predictor when cfg.temporal_mv is set.
    """
    import jax
    import jax.numpy as jnp

    from tpufg.engine.pipeline import make_interp_step, mv_lattice_shape

    step = make_interp_step(cfg, wire="i32")
    rng = np.random.default_rng(0)
    h, w = cfg.input_height, cfg.input_width
    fr = [jax.device_put(jnp.asarray(
        rng.integers(0, 2**32, (h, w), dtype=np.uint32).view(np.int32)
        .reshape(h, w))) for _ in range(2)]
    temporal = (cfg.temporal_mv and cfg.enable_interpolation
                and cfg.motion_mode == "pyramid")
    mv = (jnp.zeros(mv_lattice_shape(cfg), jnp.float32)
          if temporal else None)

    def one(mv):
        # fresh on-device copies: donated inputs must not be reused
        p, c = fr[0] + 0, fr[1] + 0
        if temporal:
            *outs, mv = step(p, c, mv)
        else:
            outs = step(p, c)
        return outs, mv

    outs, mv = one(mv)  # warmup/compile
    jax.block_until_ready(outs)
    t0 = time.perf_counter()
    for _ in range(max(1, n)):
        outs, mv = one(mv)
    jax.block_until_ready(outs)
    dt = time.perf_counter() - t0
    return max(1, n) / dt if dt > 0 else 0.0


def measure_paced_rate(cfg: EngineConfig, n: int = 12) -> float:
    """p50 HOST-VISIBLE seconds per input frame of the paced loop: one
    step enqueue + full output readback per iteration (no pipelining —
    conservative vs run()'s one-slot overlap, on purpose: the result
    gates a real-time rate choice).

    Paced mode syncs every frame, so its ceiling is host-visible latency
    (step plus readback), NOT the enqueued steady rate
    :func:`measure_step_rate` reports; this picks a rate the paced loop
    can actually hold."""
    import jax
    import jax.numpy as jnp

    from tpufg.engine.pipeline import make_interp_step

    step = make_interp_step(cfg, wire="i32")
    rng = np.random.default_rng(0)
    h, w = cfg.input_height, cfg.input_width
    fr = [jax.device_put(jnp.asarray(
        rng.integers(0, 2**32, (h, w), dtype=np.uint32).view(np.int32)
        .reshape(h, w))) for _ in range(2)]

    def one():
        p, c = fr[0] + 0, fr[1] + 0
        outs = step(p, c)
        return [np.asarray(o) for o in outs]  # full host readback

    one()  # warmup/compile
    durs = []
    for _ in range(max(1, n)):
        t0 = time.perf_counter()
        one()
        durs.append(time.perf_counter() - t0)
    return float(np.percentile(durs, 50))


def run_stream(cfg: EngineConfig, source: FrameSource, sink: FrameSink,
               precision: str = "fast", max_frames: Optional[int] = None,
               paced: bool = True, model_params=None,
               start_frame: int = 0) -> StreamStats:
    return StreamingEngine(cfg, precision, model_params).run(
        source, sink, max_frames, paced, start_frame)


def run_sharded_stream(cfg: EngineConfig, source: FrameSource,
                       sink: FrameSink, devices: int, dp: int = 1,
                       max_frames: Optional[int] = None,
                       start_frame: int = 0,
                       model_params=None) -> StreamStats:
    """Multi-chip offline transcode (SURVEY.md §2.4 DP/TP rows).

    Shards each frame's rows over the mesh's ``sp`` axis (row-halo
    exchange between devices) and batches ``dp`` consecutive frame pairs over ``dp`` —
    the production pipeline math per shard (make_sharded_interp_step).
    Unpaced by design: this is the offline path; the real-time engine is
    single-chip.  Frame heights are edge-padded to the sp*64 shard lattice
    and outputs cropped back.
    """
    import dataclasses

    import jax
    import jax.numpy as jnp

    from tpufg.config import ConfigError
    from tpufg.parallel.spatial import (make_sharded_interp_step,
                                        make_spatial_mesh,
                                        pad_to_shard_lattice)

    cfg.validate()
    log = get_logger()
    mesh = make_spatial_mesh(devices, dp=dp)
    sp = mesh.shape["sp"]
    in_h, in_w = cfg.input_height, cfg.input_width
    out_h = cfg.output_height
    temporal = (cfg.temporal_mv and cfg.enable_interpolation
                and cfg.motion_mode == "pyramid")
    h_pad = pad_to_shard_lattice(in_h, sp, temporal=temporal)
    if (h_pad * out_h) % in_h:
        raise ConfigError(
            f"sharded transcode: padded height {h_pad} must map to whole "
            f"output rows at scale {out_h}/{in_h}")
    out_h_pad = h_pad * out_h // in_h
    pcfg = dataclasses.replace(cfg, input_height=h_pad,
                               output_height=out_h_pad)
    # the learned v2/v3 stream cache threads through the sharded step at
    # dp=1 only: each pair's prev IS the previous pair's curr there,
    # while dp>1 batches consecutive pairs whose prev-caches would come
    # from sibling lanes of the SAME step (circular) — those lanes
    # re-encode, which is what the cache-less step does anyway
    qfeed = False
    if (cfg.enable_interpolation and cfg.motion_mode == "learned"
            and dp == 1 and model_params is not None):
        from tpufg.models import rife
        qfeed = rife.is_v2(model_params) or rife.is_v3(model_params)
    step = make_sharded_interp_step(
        mesh, pcfg, model_params=model_params,
        motion_skip_alpha=getattr(source, "const_alpha", None) is True,
        q_feed=qfeed)
    scale0 = make_scale_step(cfg)  # very first frame: scale-only
    mv_state = None
    q_state = q_init = None
    if qfeed:
        from tpufg.parallel.spatial import make_sharded_q_init
        q_init = make_sharded_q_init(mesh, pcfg, model_params)
    if temporal:
        # row-sharded MV predictor threaded between pairs (dp=1 enforced
        # by make_sharded_interp_step: the state is sequential)
        from tpufg.parallel.spatial import sharded_mv_lattice_shape
        mv_state = jnp.zeros((dp,) + sharded_mv_lattice_shape(pcfg),
                             jnp.float32)
    log.info(f"sharded transcode on mesh dp={dp} sp={sp} "
             f"({devices} devices), rows {in_h}->{h_pad} padded")

    stats = StreamStats()
    # zero-copy slot sources: frames are buffered across iterations here
    # (dp batching), so they must be copied out of the recycled slots
    zero_copy = bool(getattr(source, "zero_copy", False))
    t_start = time.perf_counter()
    it = iter(source)
    for _ in range(start_frame):
        try:
            next(it)
        except StopIteration:
            break

    def pad_rows(f: np.ndarray) -> np.ndarray:
        if h_pad == in_h:
            return f
        return np.pad(f, ((0, h_pad - in_h), (0, 0), (0, 0)), mode="edge")

    fps_win = FpsWindow(cfg.fps_window)

    def emit(arr: np.ndarray) -> None:
        if cfg.overlay:
            # same stats burn-in as the single-chip path (flush_pending)
            from tpufg.engine.overlay import draw_stats
            arr = draw_stats(
                np.array(arr), fps_win.fps,
                (cfg.input_width, cfg.input_height),
                (cfg.output_width, cfg.output_height))
        sink.write(arr)
        stats.frames_out += 1

    def flush(batch: list) -> None:
        nonlocal mv_state, q_state
        n = len(batch)
        if not n:
            return
        full = batch + [batch[-1]] * (dp - n)  # pad ragged tail batch
        pb = jnp.asarray(np.stack([pad_rows(p) for p, _ in full]))
        cb = jnp.asarray(np.stack([pad_rows(c) for _, c in full]))
        if temporal:
            *outs, mv_state = step(pb, cb, mv_state)
        elif qfeed:
            if q_state is None:
                q_state = q_init(pb)  # first pair: encode prev once
            n_st = len(q_state)
            outs = list(step(pb, cb, *q_state))
            outs, q_state = outs[:-n_st], tuple(outs[-n_st:])
        else:
            outs = step(pb, cb)
        # one device_get per array (see flush_pending in
        # StreamingEngine.run)
        outs_np = [jax.device_get(o[:, :out_h]) for o in outs]
        for d in range(n):  # emit in stream order; drop tail padding
            for o in outs_np:
                emit(o[d])

    prev = None
    batch: list = []
    for frame in it:
        if max_frames is not None and stats.frames_in >= max_frames:
            break
        frame = (np.array(frame) if zero_copy
                 else np.ascontiguousarray(frame))
        stats.frames_in += 1
        fps_win.tick()
        if not cfg.enable_interpolation:
            # scale-only transcode: no cross-frame dependence to shard
            emit(jax.device_get(scale0(jnp.asarray(frame))))
            continue
        if prev is None:
            # stream start: no pair yet, emit the scaled first frame
            # (mirrors the single-chip engine's first iteration)
            emit(jax.device_get(scale0(jnp.asarray(frame))))
        else:
            batch.append((prev, frame))
            if len(batch) == dp:
                flush(batch)
                batch = []
        prev = frame
    flush(batch)

    wall = time.perf_counter() - t_start
    stats.fps = stats.frames_in / wall if wall > 0 else 0.0
    return stats
