#!/usr/bin/env python3
"""Smoke test of the whole system on an NVIDIA GPU.

    python chip_smoke.py             # default run, one card
    python chip_smoke.py --kernels   # hand-written kernels vs plain XLA, timed
    python chip_smoke.py --four      # sharded transcode on four cards

Default run, in one process (the GPU test lane is a child that exits
before this process touches JAX, so only one process holds the card):

1. the card's name and power limit (nvidia-smi), then the ``gpu``-marked
   test lane (``pytest tests/ -m gpu``);
2. guard: JAX must report a GPU, else exit non-zero; print the JAX
   version, device kind, compile cache directory and native-ingest status;
3. the main path end to end: a 1080p RGBA raw clip of panning content made
   from ``--seed`` goes through ``tpufg.cli.main`` to a 4K y4m 4:2:0 file
   (pyramid, bf16, unpaced); frame count and content are checked;
4. every configuration of the benchmark matrix at full size: three steps
   each, memory analysis and peak memory, each compared with its plain
   reference at the tolerance stated beside it;
5. exact mode: GPU bytes against the CPU oracle in the same process.

Every phase prints its wall seconds.  Any failure raises, and the script
exits non-zero.  The last line of stdout is one JSON object naming the
device; nothing else is printed on it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# (tag, description, EngineConfig fields, extra)
CONFIGS = [
    ("1", "720p->1440p Lanczos scale",
     dict(input_width=1280, input_height=720, output_width=2560,
          output_height=1440, motion_mode="none",
          enable_interpolation=False), {}),
    ("2", "1080p crossfade (no motion)",
     dict(input_width=1920, input_height=1080, output_width=1920,
          output_height=1080, motion_mode="none"), {}),
    ("3", "1080p exhaustive search b=8 r=16",
     dict(input_width=1920, input_height=1080, output_width=1920,
          output_height=1080, motion_mode="exhaustive", block_size=8,
          search_radius=16), {}),
    ("4", "1080p->4K pyramid (north star)",
     dict(input_width=1920, input_height=1080, output_width=3840,
          output_height=2160, motion_mode="pyramid"), {}),
    ("4q", "1080p->4K pyramid, quality preset",
     dict(input_width=1920, input_height=1080, output_width=3840,
          output_height=2160, motion_mode="pyramid"), {"quality": True}),
    ("5a", "4K->4K pyramid",
     dict(input_width=3840, input_height=2160, output_width=3840,
          output_height=2160, motion_mode="pyramid"), {}),
    ("5b", "4K->4K learned head (bundled checkpoint)",
     dict(input_width=3840, input_height=2160, output_width=3840,
          output_height=2160, motion_mode="learned"), {}),
]

# --- tolerances, each with its reason ---------------------------------------
# bf16 step vs the same step in f32 at HIGHEST precision: the repo's
# production contract (BASELINE.md, PARITY.md).
SSIM_MIN = 0.999
# plain Lanczos (f32) vs the float64 evaluation of the same taps: two
# passes of six products with per-axis normalized weights and no dot (so
# no TF32) stay within a few f32 ulps of the exact value (3.2e-7 measured
# at 480x270->960x540 on the CPU, where the f32 oracle, summing 36
# unnormalized products, is itself 4.6e-6 away).
LANCZOS_ATOL = 1e-6
# learned head, fast path (bf16, 16-px lattice-sampled flows, block warps)
# vs the f32 HIGHEST training path (per-pixel bilinear flows, gather warps)
# on panning content: the two warps differ only where the flow varies
# inside a 16-px block.  Read 43.55 dB at 4K on an H100 (43.49-44.10 dB
# on the CPU at smaller sizes); the floor sits 3.5 dB under that, far
# above a visible difference.
LEARNED_PSNR_MIN = 40.0


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str):
    log(f"== {name}")
    t0 = time.perf_counter()
    yield
    log(f"phase {name}: {time.perf_counter() - t0:.3f} s")


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def gpu_test_lane(timeout_s: int = 600) -> None:
    """The ``gpu``-marked tests in a child process.  They check numerics,
    not speed, so the child skips XLA's GEMM/conv autotuning, which
    otherwise dominates the lane's many small compiles.  A test still
    running after two minutes has its stack dumped to stderr, and the lane
    as a whole is killed (and fails) after ``timeout_s``."""
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_gpu_autotune_level=0").strip()
    env = dict(os.environ, TPUFG_TEST_GPU="1", XLA_FLAGS=flags)
    r = subprocess.run([sys.executable, "-m", "pytest", "tests/", "-m", "gpu",
                        "-v", "-p", "no:cacheprovider", "--durations=8",
                        "-o", "faulthandler_timeout=120"],
                       cwd=REPO, env=env, timeout=timeout_s)
    check(r.returncode == 0, f"gpu test lane failed (exit {r.returncode})")


# --- content -----------------------------------------------------------------

def panning_clip(h: int, w: int, n: int, seed: int, dx: int = 2,
                 dy: int = 1):
    """[n, h, w, 4] uint8 on the device: a smooth random texture plus fine
    detail from ``seed``, alpha 255, panned by (dx, dy) px per frame."""
    import jax
    import jax.numpy as jnp

    H, W = h + n * dy + 8, w + n * dx + 8

    @jax.jit
    def make(key):
        k1, k2 = jax.random.split(key)
        coarse = jax.random.uniform(k1, (H // 24 + 2, W // 24 + 2, 3))
        smooth = jax.image.resize(coarse, (H, W, 3), "cubic")
        tex = jnp.clip(0.85 * smooth + 0.15 * jax.random.uniform(
            k2, (H, W, 3)), 0.0, 1.0)
        frames = jnp.stack([tex[i * dy:i * dy + h, i * dx:i * dx + w]
                            for i in range(n)])
        rgb = jnp.round(frames * 255.0).astype(jnp.uint8)
        alpha = jnp.full((n, h, w, 1), 255, jnp.uint8)
        return jnp.concatenate([rgb, alpha], axis=-1)

    return make(jax.random.PRNGKey(seed))


def to_float(x):
    import jax.numpy as jnp
    return x.astype(jnp.float32) / 255.0


# --- phase 3: the CLI -----------------------------------------------------------

def cli_transcode(seed: int, n_frames: int = 48, size=(1920, 1080),
                  out_size=(3840, 2160)) -> None:
    import jax
    import numpy as np

    from tpufg.cli import main as cli_main

    (w, h), (ow, oh) = size, out_size
    clip = np.asarray(jax.device_get(panning_clip(h, w, n_frames, seed)))
    with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, "in.raw")
        out = os.path.join(tmp, "out.y4m")
        clip.tofile(raw)
        del clip
        t0 = time.perf_counter()
        rc = cli_main([raw, "--input-width", str(w), "--input-height",
                       str(h), "--output-width", str(ow), "--output-height",
                       str(oh), "--motion-mode", "pyramid", "--dtype",
                       "bf16", "--no-pacing", "--output", out,
                       "--y4m-chroma", "420", "--frames", str(n_frames)])
        log(f"cli transcode wall: {time.perf_counter() - t0:.3f} s")
        check(rc == 0, f"tpufg cli exited {rc}")
        frames = read_y4m420(out, ow, oh)
    # first frame: the scaled frame alone; then (interpolated, scaled) per
    # pair at --fps-multiplier 2
    want = 1 + 2 * (n_frames - 1)
    check(len(frames) == want, f"y4m holds {len(frames)} frames, want {want}")
    for i in (0, len(frames) // 2, len(frames) - 1):
        y = frames[i]
        check(y.std() > 10.0, f"output frame {i} is flat (std {y.std():.2f})")
    log(f"cli output: {len(frames)} frames {ow}x{oh} C420, "
        f"luma std {frames[len(frames) // 2].std():.2f}")


def read_y4m420(path: str, w: int, h: int):
    """Luma planes of a C420 y4m file (header and FRAME markers checked)."""
    import numpy as np

    with open(path, "rb") as f:
        header = f.readline().decode()
        check(header.startswith("YUV4MPEG2") and f" W{w} " in header
              and f" H{h} " in header and "C420" in header,
              f"bad y4m header {header!r}")
        size = w * h * 3 // 2
        lumas = []
        while True:
            tag = f.readline()
            if not tag:
                break
            check(tag.startswith(b"FRAME"), f"bad frame tag {tag[:16]!r}")
            buf = f.read(size)
            check(len(buf) == size, "truncated frame")
            lumas.append(np.frombuffer(buf, np.uint8, w * h).reshape(h, w))
    return lumas


# --- phase 4: the configurations -----------------------------------------------

def build_step(cfg, params=None):
    from tpufg.engine.pipeline import make_interp_step, make_scale_step
    if not cfg.enable_interpolation:
        return make_scale_step(cfg)
    return make_interp_step(cfg, model_params=params)


def step_args(cfg, clip, i):
    """Fresh device copies (equal-size steps donate the previous frame)."""
    import jax.numpy as jnp
    if not cfg.enable_interpolation:
        return (jnp.copy(clip[i]),)
    return (jnp.copy(clip[i]), jnp.copy(clip[i + 1]))


def run_steps(tag, cfg, clip, params=None, n=3):
    """Compile once, print memory analysis, run ``n`` steps; returns the
    first step's outputs."""
    import jax

    step = build_step(cfg, params)
    t0 = time.perf_counter()
    compiled = step.lower(*step_args(cfg, clip, 0)).compile()
    log(f"[{tag}] compile: {time.perf_counter() - t0:.3f} s")
    log(f"[{tag}] memory_analysis: {compiled.memory_analysis()}")
    first = None
    for i in range(n):
        args = step_args(cfg, clip, i)
        jax.block_until_ready(args)
        t0 = time.perf_counter()
        outs = jax.block_until_ready(compiled(*args))
        if not isinstance(outs, tuple):
            outs = (outs,)                # the scale step's single frame
        log(f"[{tag}] step {i}: {(time.perf_counter() - t0) * 1e3:.3f} ms")
        if first is None:
            first = outs
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[{tag}] peak_bytes_in_use (process so far): "
        f"{stats.get('peak_bytes_in_use')}")
    return first


def compare_f32(tag, cfg, clip, outs, params=None):
    """The bf16 step's outputs vs the same step at dtype f32, HIGHEST."""
    import dataclasses

    import jax

    from tpufg.utils.quality import ssim_device

    cfg32 = dataclasses.replace(cfg, dtype="f32")
    with jax.default_matmul_precision("highest"):
        ref = build_step(cfg32, params)(*step_args(cfg32, clip, 0))
    if not isinstance(ref, tuple):
        ref = (ref,)
    for k, (a, b) in enumerate(zip(outs, ref)):
        s = float(ssim_device(to_float(a), to_float(b)))
        log(f"[{tag}] output {k}: SSIM bf16 vs f32 = {s:.6f} "
            f"(min {SSIM_MIN})")
        check(s >= SSIM_MIN, f"[{tag}] output {k} SSIM {s} < {SSIM_MIN}")


def on_cpu(fn, *args):
    """``fn`` jitted and run on the CPU device of this process."""
    import jax
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        return jax.jit(fn)(*[jax.device_put(a, cpu) for a in args])


def lanczos_f64(img, out_h: int, out_w: int, a: int = 3):
    """The Lanczos resample of the oracle's taps evaluated in float64 on
    the host: f64 weights of the oracle's f32 tap deltas, out-of-image
    taps dropped, joint normalization (per axis, which is the same in exact
    arithmetic).  ``img``: [H, W, C] numpy; returns float64."""
    import jax
    import numpy as np

    from tpufg.ops import oracle

    def axis(x, ax, n_out):
        n_in = x.shape[ax]
        with jax.default_device(jax.devices("cpu")[0]):
            coords, deltas, valid = (np.asarray(v) for v in
                                     oracle._axis_taps(n_in, n_out, a))
        d = deltas.astype(np.float64)
        px = np.pi * d
        with np.errstate(invalid="ignore", divide="ignore"):
            w = a * np.sin(px) * np.sin(px / a) / (px * px)
        w = np.where(valid, np.where(d == 0, 1.0, w), 0.0)
        w = w / w.sum(axis=1, keepdims=True)                # [n_out, 2a]
        idx = np.clip(coords, 0, n_in - 1)
        shape = [1] * x.ndim
        shape[ax] = n_out
        out = 0.0
        for k in range(2 * a):
            out = out + np.take(x, idx[:, k], axis=ax) * w[:, k].reshape(shape)
        return out

    return axis(axis(np.asarray(img, np.float64), 1, out_w), 0, out_h)


def check_scale_contract(seed: int, size=(1920, 1080), out=(3840, 2160)):
    """Plain Lanczos (GPU) at 1080p->4K in f32 against the float64
    evaluation of the same taps, and its packed bytes against that
    reference quantized (differences only at .5 ties).  The f32 oracle's
    own distance from the float64 values is printed beside it."""
    import jax.numpy as jnp
    import numpy as np

    from tpufg.kernels.lanczos import lanczos_scale_packed, lanczos_scale_planar
    from tpufg.ops import oracle

    (w, h), (ow, oh) = size, out
    frame = panning_clip(h, w, 1, seed + 1)[0]
    planar = jnp.moveaxis(to_float(frame), -1, 0)
    plain = np.moveaxis(np.asarray(
        lanczos_scale_planar(planar, oh, ow)), 0, -1)
    ref64 = lanczos_f64(np.asarray(frame, np.float64) / 255.0, oh, ow)
    orc = np.asarray(on_cpu(lambda x: oracle.lanczos_scale(to_float(x), oh,
                                                           ow), frame))
    err = float(np.max(np.abs(plain - ref64)))
    log(f"[scale] {w}x{h}->{ow}x{oh} f32, max |d| against the float64 "
        f"evaluation: plain (GPU) {err:.3e} (limit {LANCZOS_ATOL}); f32 "
        f"oracle (CPU) {float(np.max(np.abs(orc - ref64))):.3e}; plain vs "
        f"oracle {float(np.max(np.abs(plain - orc))):.3e}")
    check(err <= LANCZOS_ATOL, f"Lanczos error {err} > {LANCZOS_ATOL}")
    got = np.asarray(lanczos_scale_packed(planar, oh, ow))
    codes = np.clip(ref64, 0.0, 1.0) * 255.0
    diff = got.astype(np.int16) - np.round(codes).astype(np.int16)
    near_tie = np.abs(codes - np.floor(codes) - 0.5) <= 255.0 * LANCZOS_ATOL
    log(f"[scale] packed vs the float64 values quantized: "
        f"{int(np.count_nonzero(diff))} of {diff.size} codes differ "
        f"(max |d| {int(np.abs(diff).max())}); {int(near_tie.sum())} values "
        f"lie within 255*{LANCZOS_ATOL} of a .5 tie")
    check(np.abs(diff).max() <= 1, "packed bytes differ by more than 1")
    check(not np.any((diff != 0) & ~near_tie),
          "packed bytes differ away from a quantization tie")


def check_exhaustive_mv(cfg, clip):
    """The Triton site search vs oracle.motion_search on the GPU, at the
    engine's padded 1080p frames: bitwise."""
    import jax.numpy as jnp
    import numpy as np

    from tpufg.engine.pipeline import MV_GRID, PYR_LEVELS, _edge_pad_chw
    from tpufg.kernels.common import round_up
    from tpufg.kernels.convert import frames_to_planar
    from tpufg.kernels.motion import motion_search_sites
    from tpufg.ops import oracle

    mult = MV_GRID * 2 ** (PYR_LEVELS - 1)
    h, w = cfg.input_height, cfg.input_width
    hp, wp = round_up(h, mult), round_up(w, mult)
    pp = _edge_pad_chw(frames_to_planar(clip[0]), hp, wp)
    cp = _edge_pad_chw(frames_to_planar(clip[1]), hp, wp)
    r = cfg.search_radius
    mv = np.asarray(motion_search_sites(pp, cp, search_radius=r))
    ref = oracle.motion_search(jnp.moveaxis(pp, 0, -1),
                               jnp.moveaxis(cp, 0, -1), 8, r)
    ref = np.moveaxis(np.asarray(ref), -1, 0)[:, 8::16, 8::16]
    bad = int(np.count_nonzero(mv != ref))
    log(f"[3] Triton MV field vs oracle ({hp}x{wp}, r={r}): {bad} of "
        f"{ref.size} values differ")
    check(bad == 0, "exhaustive MV field is not bitwise the oracle's")


def check_learned(cfg, clip, outs, params):
    """Fast learned step (bf16) vs the f32 HIGHEST non-fast head, both on
    frames edge-padded to the 16-px lattice and cropped back."""
    import jax
    import jax.numpy as jnp

    from tpufg.engine.pipeline import _edge_pad_chw
    from tpufg.kernels.common import round_up
    from tpufg.kernels.convert import frames_to_planar
    from tpufg.models import rife
    from tpufg.utils.quality import psnr

    h, w = cfg.input_height, cfg.input_width
    hp, wp = round_up(h, 16), round_up(w, 16)

    @jax.jit
    def reference(a, b):
        p = _edge_pad_chw(frames_to_planar(a), hp, wp)[None]
        c = _edge_pad_chw(frames_to_planar(b), hp, wp)[None]
        out1, _ = rife._head3_raw(params, p, c, dtype=jnp.float32,
                                  fast=False)
        pred = rife._smooth_tail(out1, p, c, 0.5)[0, :, :h, :w]
        return jnp.round(jnp.clip(jnp.moveaxis(pred, 0, -1), 0, 1) * 255)

    with jax.default_matmul_precision("highest"):
        ref = reference(clip[0], clip[1])
    fast = outs[0].astype(jnp.float32)
    p = psnr(jax.device_get(fast[..., :3]) / 255.0,
             jax.device_get(ref[..., :3]) / 255.0)
    log(f"[5b] fast bf16 vs f32 HIGHEST non-fast head: PSNR {p:.3f} dB "
        f"(min {LEARNED_PSNR_MIN})")
    check(p >= LEARNED_PSNR_MIN, f"learned head PSNR {p} < {LEARNED_PSNR_MIN}")


def run_configs(seed: int, configs=CONFIGS, scale_check=True) -> None:
    import jax

    from tpufg.config import EngineConfig, apply_quality_preset, resolve_sizes
    from tpufg.models import rife

    params = None
    for tag, desc, kw, extra in configs:
        with phase(f"config {tag}: {desc}"):
            cfg = resolve_sizes(EngineConfig(dtype="bf16", **kw))
            if extra.get("quality"):
                cfg = apply_quality_preset(cfg)
            p = None
            if cfg.motion_mode == "learned":
                if params is None:
                    ckpt = rife.bundled_checkpoint()
                    log(f"[{tag}] checkpoint {os.path.relpath(ckpt, REPO)}")
                    params = rife.load_params(ckpt)
                p = params
            clip = panning_clip(cfg.input_height, cfg.input_width, 4,
                                seed + len(tag))
            outs = run_steps(tag, cfg, clip, p)
            exp_shape = (cfg.output_height, cfg.output_width, 4)
            for o in outs:
                check(o.shape == exp_shape and o.dtype == "uint8",
                      f"[{tag}] output {o.shape} {o.dtype}")
            if tag == "3":
                check_exhaustive_mv(cfg, clip)
            elif tag == "5b":
                check_learned(cfg, clip, outs, p)
            else:
                compare_f32(tag, cfg, clip, outs, p)
            if tag == "1" and scale_check:
                check_scale_contract(seed)
            del clip, outs
            jax.clear_caches()


# --- phase 5: exact mode, GPU vs CPU ------------------------------------------

def check_exact_cpu(seed: int, size=(640, 360), out=(1280, 720)) -> None:
    import jax
    import numpy as np

    from tpufg.config import EngineConfig, resolve_sizes
    from tpufg.engine.pipeline import make_interp_step

    (w, h), (ow, oh) = size, out
    cfg = resolve_sizes(EngineConfig(
        input_width=w, input_height=h, output_width=ow, output_height=oh,
        motion_mode="exhaustive"))
    clip = np.asarray(jax.device_get(panning_clip(h, w, 2, seed + 7)))
    step = make_interp_step(cfg, precision="exact")
    t0 = time.perf_counter()
    gpu = [np.asarray(o) for o in step(clip[0], clip[1])]
    log(f"[exact] GPU step: {time.perf_counter() - t0:.3f} s")
    cpu_dev = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    with jax.default_device(cpu_dev):
        cpu = [np.asarray(o) for o in step(jax.device_put(clip[0], cpu_dev),
                                           jax.device_put(clip[1], cpu_dev))]
    log(f"[exact] CPU step: {time.perf_counter() - t0:.3f} s")
    for k, (a, b) in enumerate(zip(gpu, cpu)):
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        log(f"[exact] output {k}: {int(np.count_nonzero(d))} of {d.size} "
            f"codes differ GPU vs CPU, max |d| {int(d.max())}")


# --- --kernels -------------------------------------------------------------------

def time_fn(fn, args, n: int) -> float:
    """Mean wall ms per call over ``n`` calls, synced at the end."""
    import jax
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = None
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e3


def in_turns(label_a, fa, args_a, label_b, fb, args_b, n: int) -> None:
    """a, b, b, a — compare two versions on one card in turns."""
    ta1 = time_fn(fa, args_a, n)
    tb1 = time_fn(fb, args_b, n)
    tb2 = time_fn(fb, args_b, n)
    ta2 = time_fn(fa, args_a, n)
    log(f"  {label_a}: {ta1:.4f} / {ta2:.4f} ms   "
        f"{label_b}: {tb1:.4f} / {tb2:.4f} ms")


def site_search_plain(prev, curr, block_size: int = 8,
                      search_radius: int = 16, grid: int = 16):
    """The plain-XLA competitor of the Triton site search
    (tpufg.kernels.motion.motion_search_sites), same contract and bits.

    A loop over dy; per iteration one row-shifted band of the edge-padded
    prev frame (clamp-to-edge) and the 2r+1 dx candidates unrolled, each
    a fused site-block cost over the [C, H/g, b, W/g, b] cell view, summed
    in the oracle's y-outer/x-inner order.  Returns f32 [2, H/g, W/g].
    """
    import jax
    import jax.numpy as jnp

    f32 = jnp.float32
    n_ch, h, w = prev.shape
    b, r, g = int(block_size), int(search_radius), int(grid)
    m, n = h // g, w // g
    off = g // 2 - b // 2
    prev_p = jnp.pad(prev.astype(f32), ((0, 0), (r, r), (r, r)), mode="edge")
    cur = curr.astype(f32).reshape(n_ch, m, g, n, g)[
        :, :, off:off + b, :, off:off + b]

    def dy_body(dyi, carry):
        best_cost, best_dx, best_dy = carry
        band = jax.lax.dynamic_slice(prev_p, (0, dyi, 0),
                                     (n_ch, h, w + 2 * r))
        for dxi in range(2 * r + 1):         # dx inner
            sh = band[:, :, dxi:dxi + w].reshape(n_ch, m, g, n, g)[
                :, :, off:off + b, :, off:off + b]
            d = cur[0] - sh[0]
            acc = d * d
            for ci in range(1, n_ch):
                d = cur[ci] - sh[ci]
                acc = acc + d * d
            dist = jnp.sqrt(acc)                      # [m, b, n, b]
            cost = dist[:, 0, :, 0]
            for by in range(b):                       # y outer
                for bx in range(b):                   # x inner
                    if by or bx:
                        cost = cost + dist[:, by, :, bx]
            upd = cost < best_cost       # strict <: first found wins
            best_cost = jnp.where(upd, cost, best_cost)
            best_dx = jnp.where(upd, f32(dxi - r), best_dx)
            best_dy = jnp.where(upd, (dyi - r).astype(f32), best_dy)
        return best_cost, best_dx, best_dy

    init = (jnp.full((m, n), 1e10, f32), jnp.zeros((m, n), f32),
            jnp.zeros((m, n), f32))
    _, best_dx, best_dy = jax.lax.fori_loop(0, 2 * r + 1, dy_body, init)
    return jnp.stack([best_dx, best_dy])


def encode_nhwc(params, frame, dtype):
    """rife.encode3 (two stride-2 3x3 convs, bias, relu) with NHWC
    activations and HWIO kernels: [B, H, W, 4] -> [B, H/4, W/4, h/2]."""
    import jax
    import jax.numpy as jnp

    def conv(x, p):
        w = jnp.transpose(p["w"], (2, 3, 1, 0)).astype(dtype)
        y = jax.lax.conv_general_dilated(
            x.astype(dtype), w, (2, 2), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.float32)
        return jax.nn.relu(y + p["b"])

    return conv(conv(frame, params["enc1"]), params["enc2"])


def run_kernels(seed: int, size=(1920, 1080), big=(3840, 2160), r: int = 16,
                n: int = 10) -> None:
    import functools

    import jax
    import jax.numpy as jnp

    from tpufg.config import EngineConfig, resolve_sizes
    from tpufg.engine.pipeline import _edge_pad_chw, make_interp_step
    from tpufg.kernels.convert import frames_to_planar
    from tpufg.kernels.lanczos import lanczos_scale_packed
    from tpufg.kernels.motion import motion_search_sites
    from tpufg.kernels.resize import box_downsample2
    from tpufg.models import rife

    (w, h), (bw, bh) = size, big
    hp = -(-h // 64) * 64
    clip = panning_clip(h, w, 2, seed)
    with phase(f"kernel: exhaustive site search, {w}x{hp} r={r}"):
        pp = _edge_pad_chw(frames_to_planar(clip[0]), hp, w)
        cp = _edge_pad_chw(frames_to_planar(clip[1]), hp, w)
        tri = jax.jit(functools.partial(motion_search_sites, search_radius=r))
        xla = jax.jit(functools.partial(site_search_plain, search_radius=r))
        same = bool(jnp.all(tri(pp, cp) == xla(pp, cp)))
        log(f"  Triton == plain XLA (bitwise): {same}")
        check(same, "Triton and plain site search disagree")
        in_turns("plain XLA", xla, (pp, cp), "Triton", tri, (pp, cp), n)

    with phase("kernel: config-3 step end to end, plain vs Triton search"):
        cfg = resolve_sizes(EngineConfig(
            input_width=w, input_height=h, output_width=w,
            output_height=h, motion_mode="exhaustive", dtype="bf16",
            search_radius=r))
        step_tri = make_interp_step(cfg)
        step_xla = make_interp_step(cfg, site_search=site_search_plain)
        a, b = clip[0], clip[1]
        same = all(bool(jnp.all(x == y)) for x, y in zip(
            step_xla(jnp.copy(a), jnp.copy(b)),
            step_tri(jnp.copy(a), jnp.copy(b))))
        check(same, "config-3 steps differ between the two searches")
        # the step donates prev: each call gets fresh copies
        fresh = lambda f: (lambda a, b: f(jnp.copy(a), jnp.copy(b)))
        in_turns("step, plain search", fresh(step_xla), (a, b),
                 "step, Triton", fresh(step_tri), (a, b), n)

    with phase("plain XLA stages: scale, box downsample"):
        planar = frames_to_planar(clip[0])
        scale = jax.jit(lambda x: lanczos_scale_packed(x, bh, bw,
                                                       raw_i32=True))
        t = time_fn(scale, (planar,), 2 * n)
        # f32 [4, h, bw] horizontal intermediate written + read back,
        # plus the f32 input read and the packed int32 output
        bytes_min = 4 * h * w * 4 + bw * bh * 4
        bytes_tmp = 2 * 4 * h * bw * 4
        log(f"  Lanczos {w}x{h}->{bw}x{bh} packed: {t:.4f} ms; bytes bound "
            f"{(bytes_min + bytes_tmp) / 3.35e9:.4f} ms at 3.35 TB/s "
            f"({(bytes_min + bytes_tmp) / 1e6:.1f} MB, of which "
            f"{bytes_tmp / 1e6:.1f} MB the f32 intermediate)")
        box = jax.jit(box_downsample2)
        x = jnp.pad(planar, ((0, 0), (0, hp - h), (0, 0)))
        t = time_fn(box, (x,), 2 * n)
        nbytes = x.size * 4 * 5 // 4           # read x, write a quarter
        log(f"  box_downsample2 [4, {hp}, {w}]: {t:.4f} ms; bytes bound "
            f"{nbytes / 3.35e9:.4f} ms at 3.35 TB/s")

    with phase(f"conv layout: learned-head encoder at {bw}x{bh}, bf16"):
        params = rife.load_params(rife.bundled_checkpoint())
        x = frames_to_planar(panning_clip(bh, bw, 1, seed)[0])[None]
        x_nhwc = jnp.moveaxis(x, 1, -1)
        nchw = jax.jit(lambda p, x: rife.encode3(p, x, jnp.bfloat16))
        nhwc = jax.jit(lambda p, x: encode_nhwc(p, x, jnp.bfloat16))
        d = float(jnp.max(jnp.abs(jnp.moveaxis(nchw(params, x), 1, -1)
                                  - nhwc(params, x_nhwc))))
        log(f"  NCHW vs NHWC encoder outputs: max |d| {d:.3e}")
        in_turns("encode3 NCHW", nchw, (params, x), "encode3 NHWC", nhwc,
                 (params, x_nhwc), 2 * n)


# --- --four ----------------------------------------------------------------------

def run_four(seed: int, size=(3840, 2160), n_frames: int = 9) -> None:
    """Config 5a's shape through ``tpufg --devices 4`` at sp=4 and dp=4,
    each compared byte for byte with the single-card run of the same clip.

    The sharded step edge-replicates its halo at the frame's top and
    bottom, where the single-card warp reads past the frame, so the
    outputs may differ in the ``HALO`` rows at those two edges; a
    difference anywhere else (an interior shard seam included) fails."""
    import jax
    import numpy as np

    from tpufg.cli import main as cli_main
    from tpufg.parallel.spatial import HALO

    w, h = size
    check(len(jax.devices()) == 4, f"--four needs 4 devices, found "
          f"{len(jax.devices())}")
    clip = np.asarray(jax.device_get(panning_clip(h, w, n_frames, seed)))
    with tempfile.TemporaryDirectory() as tmp:
        raw = os.path.join(tmp, "in.raw")
        clip.tofile(raw)
        del clip
        outs = {}
        for name, extra in (("single", []),
                            ("sp4", ["--devices", "4", "--dp", "1"]),
                            ("dp4", ["--devices", "4", "--dp", "4"])):
            with phase(f"four: {name}"):
                out = os.path.join(tmp, f"{name}.raw")
                rc = cli_main([raw, "--input-width", str(w),
                               "--input-height", str(h), "--motion-mode",
                               "pyramid", "--dtype", "bf16", "--no-pacing",
                               "--frames", str(n_frames), "--output", out]
                              + extra)
                check(rc == 0, f"{name}: tpufg exited {rc}")
                outs[name] = np.fromfile(out, np.uint8).reshape(-1, h, w, 4)
                os.remove(out)
    ref = outs["single"]
    seams = [k * h // 4 for k in range(1, 4)]
    for name in ("sp4", "dp4"):
        got = outs[name]
        check(got.shape == ref.shape, f"{name}: {got.shape} vs {ref.shape}")
        d = np.abs(got.astype(np.int16) - ref.astype(np.int16))
        rows = np.nonzero(d.max(axis=(0, 2, 3)))[0]
        border = (rows < HALO) | (rows >= h - HALO)
        near_seam = np.array([min(abs(int(r) - s) for s in seams) < HALO
                              for r in rows], bool)
        n_seam = int((near_seam & ~border).sum())
        n_else = int((~near_seam & ~border).sum())
        log(f"[four] {name} vs single card: {int(np.count_nonzero(d))} of "
            f"{d.size} codes differ, max |d| {int(d.max())}; rows with a "
            f"difference: {len(rows)} ({int(border.sum())} within {HALO} px "
            f"of the frame's top/bottom edge, {n_seam} within {HALO} px of "
            f"a shard seam, {n_else} elsewhere)")
        check(n_seam == 0 and n_else == 0,
              f"{name}: outputs differ away from the frame's top/bottom edge")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--kernels", action="store_true",
                      help="time hand-written kernels against plain XLA")
    mode.add_argument("--four", action="store_true",
                      help="sharded transcode on four cards vs one card")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(REPO, "tpufg")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(no tpufg package beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)

    log(card())                  # "name, power.limit" as nvidia-smi says
    if args.four:
        # an equality check, not a timing: skip XLA's autotuning, whose
        # compile time would dominate (same flags for every run compared)
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_gpu_autotune_level=0").strip()
    if not (args.kernels or args.four):
        with phase("gpu test lane"):
            gpu_test_lane()

    with phase("guard"):
        import jax

        from tpufg.io import native
        from tpufg.utils.compile_cache import setup_compile_cache

        cache = setup_compile_cache()
        dev = jax.devices()[0]
        if dev.platform != "gpu":
            print(f"chip_smoke.py needs a GPU; JAX found {dev.platform!r}",
                  file=sys.stderr)
            return 3
        log(f"jax {jax.__version__}; device {dev.device_kind} x "
            f"{len(jax.devices())}")
        log(f"compile cache: {cache}")
        log(f"native ingest library loaded: {native.available()}")

    if args.four:
        run_four(args.seed)
    elif args.kernels:
        run_kernels(args.seed)
    else:
        with phase("main path: tpufg cli 1080p->4K"):
            cli_transcode(args.seed)
        run_configs(args.seed)
        with phase("exact mode: GPU vs CPU oracle, 640x360"):
            check_exact_cpu(args.seed)

    log(card())
    print(result_line(dev, len(jax.devices())), flush=True)
    return 0


def result_line(dev, count: int) -> str:
    """The last line of stdout: the device as JAX reports it, nothing else."""
    return json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}})


if __name__ == "__main__":
    sys.exit(main())
