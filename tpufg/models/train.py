"""Self-supervised training for the learned interpolation head.

Trains on frame triplets from any engine source: predict the middle frame
of (f[i-1], f[i+1]) and take f[i] as ground truth — the standard
frame-interpolation training scheme.  The reference has no training of any
kind (no model code — SURVEY.md §0); this is the config-5 path.

Usage:
    python -m tpufg.models.train INPUT [INPUT ...] [--steps N] [--batch B]
        [--crop HxW] [--lr LR] [--hidden H] [--checkpoint out.npz]
        [--resume ckpt.npz] [--dp N --tp N]

INPUT accepts the same specs as the engine CLI (synthetic:WxH, *.y4m, raw).
Multiple inputs INTERLEAVE batch-by-batch (round-robin): training visits
every source throughout the run instead of fine-tuning through them
sequentially (which forgets earlier sources — the round-4 v2 campaign
trained 4 corpus seeds back-to-back and the last seed dominated).

INPUT ``synth[:SEED]`` trains on the infinite procedural-scene generator
(tpufg.data.corpus.synthetic_triplets): a FRESH randomly-seeded scene per
triplet — nothing to memorize (any fixed file set IS memorized: measured
-4 dB held-out at equal train loss, docs/DESIGN.md 5b) — and, with
``--flow-weight`` > 0, exact analytic flow/occlusion supervision from the
renderer (the privileged teacher).  A background thread prefetches
batches so host-side rendering overlaps the device step.
"""

from __future__ import annotations

import argparse
import re
import sys
import time

import numpy as np

from tpufg.utils.logging import get_logger


def _triplets(source, crop_h, crop_w, batch, seed=0, skip_cuts=0.0):
    """Yield (prev, target, curr) batches of planar f32 crops.

    ``skip_cuts`` > 0: drop triplets whose outer frames differ by more
    than that mean |d| (in [0,1] units) — a triplet straddling a shot
    change has no motion ground truth, and training on it teaches the
    head to blend instead of interpolate (the engine handles real cuts
    with --scene-cut, not the head).  Same detector as the engine's
    scene-cut fallback."""
    rng = np.random.default_rng(seed)
    # zero-copy sources (native prefetch ring) recycle their slots: a
    # frame buffered across iterations must be copied out first
    zero_copy = bool(getattr(source, "zero_copy", False))
    frames = []
    batch_buf = []
    for frame in source:
        frames.append(np.array(frame) if zero_copy else frame)
        if len(frames) > 3:
            frames.pop(0)
        if len(frames) == 3:
            if skip_cuts > 0.0:
                d = np.mean(np.abs(
                    frames[0][..., :3].astype(np.float32)
                    - frames[2][..., :3].astype(np.float32))) / 255.0
                if d > skip_cuts:
                    continue
            h, w = frames[0].shape[:2]
            if h < crop_h or w < crop_w:
                raise ValueError(
                    f"frames {w}x{h} smaller than crop {crop_w}x{crop_h}")
            y = rng.integers(0, h - crop_h + 1)
            x = rng.integers(0, w - crop_w + 1)
            trip = [np.transpose(f[y:y + crop_h, x:x + crop_w], (2, 0, 1))
                    .astype(np.float32) / 255.0 for f in frames]
            batch_buf.append(trip)
            if len(batch_buf) == batch:
                arr = np.asarray(batch_buf)  # [B, 3, C, H, W]
                yield arr[:, 0], arr[:, 1], arr[:, 2]
                batch_buf = []


def _interleaved(specs, open_fn, crop_h, crop_w, batch, skip_cuts, log):
    """Round-robin triplet batches across sources.

    Each source runs its own epoch counter (re-opened when exhausted —
    one-shot sources like the native prefetch ring cannot re-iterate) and
    fresh crop positions per epoch.  A source whose re-opened epoch yields
    no batch (a consumed stream, or every triplet cut-filtered) is retired;
    the generator ends when every source is retired.
    """
    n = len(specs)
    srcs = [None] * n
    gens = [None] * n
    epochs = [0] * n
    got = [0] * n           # batches produced in the current epoch
    live = set(range(n))
    k = -1
    try:
        while live:
            k = (k + 1) % n
            if k not in live:
                continue
            if gens[k] is None:
                try:
                    srcs[k] = open_fn(specs[k])
                except Exception as e:  # SourceError/OSError on re-open
                    log.warning(f"source {specs[k]!r} re-open failed: {e}")
                    live.discard(k)
                    continue
                # distinct crop stream per (source, epoch)
                gens[k] = _triplets(srcs[k], crop_h, crop_w, batch,
                                    seed=epochs[k] * n + k,
                                    skip_cuts=skip_cuts)
                got[k] = 0
            try:
                yield next(gens[k])
                got[k] += 1
            except StopIteration:
                srcs[k].close()
                srcs[k] = gens[k] = None
                if not got[k]:
                    log.warning(f"source {specs[k]!r} exhausted; retiring")
                    live.discard(k)
                else:
                    epochs[k] += 1
    finally:
        for s in srcs:      # caller stopped mid-stream (steps reached)
            if s is not None:
                s.close()


def _prefetch(gen, depth=3):
    """Run a generator in a daemon thread, ``depth`` batches ahead (host
    rendering overlaps the device step; the queue bounds memory)."""
    import queue
    import threading

    q = queue.Queue(maxsize=depth)
    stop = object()
    err = []

    def worker():
        try:
            for item in gen:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            err.append(e)
        finally:
            q.put(stop)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is stop:
            if err:  # a crashed feed must FAIL the run, not end it
                raise err[0]
            return
        yield item


def main(argv=None) -> int:
    log = get_logger()
    p = argparse.ArgumentParser(prog="tpufg-train", description=__doc__)
    p.add_argument("input", nargs="+")
    p.add_argument("--input-width", type=int, default=0,
                   help="raw-file input width (self-describing sources "
                        "auto-detect)")
    p.add_argument("--input-height", type=int, default=0)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--crop", default="128x192")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--cosine", action="store_true",
                   help="cosine lr decay over --steps (peak --lr after a "
                        "5%% linear warmup, ending at lr/20) — constant "
                        "lr otherwise")
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--arch",
                   choices=["v1", "v2", "v3", "v3d", "v3c", "v3dc"],
                   default="v1",
                   help="v1 = single-stage 1/4-res flow; v2/v3 = two-stage "
                        "coarse-to-fine (1/8 flow -> warp -> 1/4 residual); "
                        "v3d = v3 + warped-difference stage-2 input, v3c = "
                        "v3 + residual second coarse-body conv, v3dc = both "
                        "(warm-start from a v3 head via "
                        "rife.expand_v3_stage2_diff / expand_v3_coarse_body2)")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--resume", default=None, metavar="CKPT",
                   help="restore parameters from CKPT; if CKPT's sidecar "
                        "state file (<name>.state.npz: optimizer state + "
                        "step) exists and matches, training CONTINUES from "
                        "the saved step with the optimizer (and so the lr "
                        "schedule — its count lives in the optimizer state) "
                        "intact — pass the original --steps; without the "
                        "sidecar it is a params-only warm restart")
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--save-every", type=int, default=0, metavar="N",
                   help="also write --checkpoint every N steps (0 = only "
                        "at the end) so a bounded/killed run keeps its "
                        "progress — a 6000-step run died at 5540 unsaved "
                        "before this existed")
    p.add_argument("--ft", action="store_true",
                   help="fast-consistent training: the loss runs the "
                        "differentiable replica of the deployed inference "
                        "tail (straight-through integer block flows) — "
                        "use to fine-tune a smooth-trained checkpoint; "
                        "crop dims must be divisible by 16")
    p.add_argument("--skip-cuts", type=float, default=0.0, metavar="T",
                   help="drop triplets whose outer frames differ by mean "
                        "|d| > T (0..1 units): shot-change triplets have "
                        "no motion ground truth (0 = keep all)")
    p.add_argument("--ema", type=float, default=0.0, metavar="DECAY",
                   help="maintain an exponential moving average of the "
                        "parameters (Polyak averaging; e.g. 0.999) and "
                        "write it to <checkpoint>.ema.npz alongside the "
                        "raw checkpoint — evaluate both and ship the "
                        "better (0 = off).  Resuming continues the "
                        "average from the sidecar state when the saving "
                        "run also used --ema")
    p.add_argument("--multi-t", action="store_true", dest="multi_t",
                   help="train at random time points t in [0.25, 0.75] "
                        "(one per batch) instead of only the midpoint: "
                        "the synth renderer supplies the off-midpoint "
                        "target and the loss reaches it through the "
                        "t-scaled tails — the deployed k>2 path.  Raw "
                        "flow semantics stay midpoint (flow supervision "
                        "is unchanged).  Requires the synth input")
    p.add_argument("--flow-weight", type=float, default=0.0,
                   help="analytic flow-supervision weight (synth input "
                        "only — the procedural renderer is the teacher; "
                        "0 = photometric-only)")
    p.add_argument("--photo-p", type=float, default=0.0, metavar="P",
                   dest="photo_p",
                   help="per-triplet probability of drawing the scene "
                        "with the round-5 photometric axes (motion blur, "
                        "flicker, noise mismatch, perspective background "
                        "— data/corpus.py Scene photo=True); synth input "
                        "only, 0 replays existing streams bitwise")
    p.add_argument("--scene-size", default="384x640", metavar="HxW",
                   help="synth input: full scene geometry the crops are "
                        "cut from (matches the eval corpus scale)")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel mesh axis size")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel mesh axis size")
    args = p.parse_args(argv)

    m = re.fullmatch(r"(\d+)x(\d+)", args.crop)
    if not m:
        log.error(f"bad --crop {args.crop!r} (HxW)")
        return 1
    crop_h, crop_w = int(m.group(1)), int(m.group(2))
    two_stage = args.arch != "v1"
    mult = 8 if two_stage else 4  # 1/8 coarse stage
    if args.ft:
        # the ft tail's block lattice (grid = 16); v3's stage-2 replica
        # additionally needs 8-multiple QUARTER dims (8-px coarse warp)
        mult = 32 if args.arch.startswith("v3") else 16
    if crop_h % mult or crop_w % mult:
        log.error(f"crop dims must be divisible by {mult}")
        return 1

    synth = re.fullmatch(r"synth(?::(\d+))?", args.input[0])
    if synth and len(args.input) > 1:
        log.error("synth input cannot be mixed with file sources")
        return 1
    if args.flow_weight > 0 and not synth:
        log.error("--flow-weight needs the synth input (analytic flow "
                  "targets come from the procedural renderer)")
        return 1
    if args.photo_p > 0 and not synth:
        log.error("--photo-p needs the synth input (photometric scenes "
                  "come from the procedural renderer)")
        return 1
    if args.multi_t and not synth:
        log.error("--multi-t needs the synth input (off-midpoint targets "
                  "come from the renderer's arbitrary-t evaluation)")
        return 1
    ms = re.fullmatch(r"(\d+)x(\d+)", args.scene_size)
    if not ms:
        log.error(f"bad --scene-size {args.scene_size!r} (HxW)")
        return 1
    scene_h, scene_w = int(ms.group(1)), int(ms.group(2))
    if synth and (crop_h > scene_h or crop_w > scene_w):
        log.error(f"--crop {crop_h}x{crop_w} exceeds --scene-size "
                  f"{scene_h}x{scene_w}")
        return 1

    import jax
    import jax.numpy as jnp

    from tpufg.utils.compile_cache import setup_compile_cache
    setup_compile_cache()
    from tpufg.io.sources import SourceError, open_source
    from tpufg.models import rife
    from tpufg.utils.checkpoint import load_pytree, save_pytree

    mesh = None
    if args.dp * args.tp > 1:
        from jax.sharding import Mesh
        devs = jax.devices()
        if len(devs) < args.dp * args.tp:
            log.error(f"need {args.dp * args.tp} devices, have {len(devs)}")
            return 1
        mesh = Mesh(np.array(devs[:args.dp * args.tp]).reshape(
            args.dp, args.tp), axis_names=("dp", "tp"))

    if args.cosine:
        import optax
        lr = optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=args.lr,
            warmup_steps=max(1, args.steps // 20),
            decay_steps=args.steps, end_value=args.lr / 20.0)
    else:
        lr = args.lr
    supervised = args.flow_weight > 0
    init_state, train_step, _ = rife.make_train_step(
        lr, mesh=mesh, arch=args.arch, ft=args.ft,
        flow_weight=args.flow_weight, ema_decay=args.ema)
    params, opt_state = init_state(jax.random.PRNGKey(0), args.hidden)
    ema = params if args.ema > 0 else None  # seeded from the init params
    start_step = 0
    if args.resume:
        import os

        params = load_pytree(args.resume, params)
        if args.ema > 0:
            ema = params  # re-seed; sidecar overrides when compatible
        log.info(f"resumed parameters from {args.resume}")
        sp = _state_path(args.resume)
        if os.path.exists(sp):
            try:
                opt_state, start_step, saved_ema = load_state(
                    sp, opt_state, ema_like=params)
            except ValueError as e:
                log.warning(f"train state {sp} incompatible ({e}); "
                            "warm restart (fresh optimizer, step 0)")
            else:
                if args.ema > 0 and saved_ema is not None:
                    ema = saved_ema
                log.info(f"resumed optimizer state at step {start_step} "
                         f"(lr schedule continues; --steps is the TOTAL "
                         f"horizon — pass the original value)")
        else:
            log.info("no sidecar train state; warm restart "
                     "(fresh optimizer, step 0)")
        if start_step >= args.steps:
            log.error(f"checkpoint already at step {start_step} >= "
                      f"--steps {args.steps}; nothing to do")
            return 1

    if synth:
        from tpufg.data.corpus import synthetic_triplets
        # + start_step: a resumed run must not REPLAY the scene sequence
        # it already trained on (the generator is deterministic in seed)
        gen = synthetic_triplets(
            crop_h, crop_w, args.batch,
            seed=(int(synth.group(1)) if synth.group(1) else 0) + start_step,
            scene_w=scene_w, scene_h=scene_h, supervise=supervised,
            t_range=(0.25, 0.75) if args.multi_t else None,
            photo_p=args.photo_p)
        batches = _prefetch(gen)
    else:
        def open_one(spec):
            return open_source(spec, args.input_width, args.input_height,
                               frames=max(args.steps * args.batch + 8, 64))

        # fail fast on a bad spec before entering the interleave (which
        # only warns on RE-open failures)
        try:
            open_one(args.input[0]).close()
        except (SourceError, OSError) as e:
            log.error(str(e))
            return 1
        batches = _interleaved(args.input, open_one, crop_h, crop_w,
                               args.batch, args.skip_cuts, log)

    def save(step_i):
        """Write the params checkpoint plus the sidecar train state
        (optimizer state + step, and the --ema average when on) that
        makes --resume a TRUE resume; --ema also writes the averaged
        parameters to <checkpoint>.ema.npz as a ready-to-eval head."""
        save_pytree(args.checkpoint, run.params)
        state = {"opt": run.opt_state, "step": np.asarray(step_i, np.int64)}
        if run.ema is not None:
            state["ema"] = run.ema
            save_pytree(_ema_path(args.checkpoint), run.ema)
        save_pytree(_state_path(args.checkpoint), state)

    def run():
        t0 = time.perf_counter()
        losses = []
        for step_i, b in enumerate(batches, 1 + start_step):
            if synth:
                prev, target, curr = b["prev"], b["target"], b["curr"]
            else:
                prev, target, curr = b
            step_args = [run.params, run.opt_state, jnp.asarray(prev),
                         jnp.asarray(curr), jnp.asarray(target)]
            if run.ema is not None:
                step_args.insert(2, run.ema)
            if supervised:
                step_args.append({k: jnp.asarray(b[k]) for k in
                                  ("flow4", "vp4", "vc4", "flow8", "vp8",
                                   "vc8") if k in b})
            if synth and "t" in b:  # --multi-t: trailing traced scalar
                step_args.append(jnp.asarray(b["t"]))
            out = train_step(*step_args)
            if run.ema is not None:
                params_, opt_state_, run.ema, loss = out
            else:
                params_, opt_state_, loss = out
            if supervised:
                loss, photo, flow = loss
                losses.append((float(loss), float(photo), float(flow)))
            else:
                losses.append((float(loss),))
            run.params, run.opt_state = params_, opt_state_
            if step_i % args.log_every == 0:
                rate = (step_i - start_step) / (time.perf_counter() - t0)
                win = np.mean(losses[-args.log_every:], axis=0)
                extra = (f"  photo {win[1]:.5f}  flow {win[2]:.5f}"
                         if supervised else "")
                log.info(f"step {step_i}/{args.steps}  loss "
                         f"{win[0]:.5f}{extra}  ({rate:.1f} steps/s)")
            if (args.save_every > 0 and args.checkpoint
                    and step_i % args.save_every == 0
                    and step_i < args.steps):
                save(step_i)
                log.info(f"checkpointed step {step_i} "
                         f"-> {args.checkpoint}")
            if step_i >= args.steps:
                return losses
        log.warning("sources exhausted before --steps; stopping")
        return losses

    run.params, run.opt_state, run.ema = params, opt_state, ema
    ctx = mesh if mesh is not None else _nullcontext()
    with ctx:
        losses = run()

    if losses:
        log.info(f"final loss {losses[-1][0]:.5f} "
                 f"(first {losses[0][0]:.5f})")
    if args.checkpoint:
        save(min(start_step + len(losses), args.steps))
        log.info(f"saved parameters to {args.checkpoint}")
    return 0


def _state_path(ckpt: str) -> str:
    """Sidecar train-state file next to a params checkpoint."""
    import os

    return os.path.splitext(ckpt)[0] + ".state.npz"


def _ema_path(ckpt: str) -> str:
    """The --ema averaged-parameters checkpoint next to the raw one."""
    import os

    return os.path.splitext(ckpt)[0] + ".ema.npz"


def load_state(path: str, opt_like, ema_like=None) -> tuple:
    """Restore a sidecar train state -> (opt_state, step, ema | None).

    ``opt_like`` must come from an optimizer CONFIGURED LIKE the saving
    run's (the state structure differs between a schedule and a constant
    lr); raises ValueError on structure mismatch.  Both sidecar layouts
    (with and without the ``--ema`` average — ``ema_like`` is the params
    template) are tried, so a run can toggle ``--ema`` across resumes
    without losing its optimizer state."""
    from tpufg.utils.checkpoint import load_pytree

    tmpl = {"opt": opt_like, "step": np.asarray(0, np.int64)}
    attempts = ([{**tmpl, "ema": ema_like}] if ema_like is not None else [])
    attempts.append(tmpl)
    err = None
    for t in attempts:
        try:
            st = load_pytree(path, t)
        except ValueError as e:
            err = e
            continue
        return st["opt"], int(st["step"]), st.get("ema")
    raise err


class _nullcontext:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


if __name__ == "__main__":
    sys.exit(main())
