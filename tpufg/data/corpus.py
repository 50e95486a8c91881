"""Procedural natural-content corpus: renderer, analytic flow, trainer feed.

The image ships no video footage and no decoder (no ffmpeg), so natural-
CONTENT evaluation and learned-head training use a renderer built to
exhibit what the synthetic pan/noise family lacks and real video has:

- 1/f-spectrum textures (multi-octave value noise — natural image
  statistics, unlike white noise or pure sinusoids);
- layered parallax: background + two textured foreground objects at
  different velocities -> occlusion and revealed content at the edges;
- NON-INTEGER subpixel motion everywhere, plus a slow zoom on the
  background (divergent flow — no single translation explains any block);
- rotation about a center, a thin two-motion bar occluder, and a
  repeated in-block grating (the aperture trap) — ``rich=True``;
- film grain (temporally uncorrelated sensor noise) and a slow luminance
  drift (auto-exposure);
- hard scene cuts to different layouts (NaturalCorpus ``cut_at``).

Everything is evaluated analytically at arbitrary float time t, so exact
ground-truth middle frames exist at t + 0.5 — the proper interpolation
evaluation protocol — AND exact per-pixel ground-truth FLOW exists
between any two times of a shot (every layer is a closed-form rigid
motion; :meth:`Scene.flow`), which the trainer uses for direct flow
supervision of the learned head (the analytic teacher RIFE distills from
a privileged network, supplied here by the renderer itself).

``window=`` renders any sub-rectangle of a scene at that rectangle's
cost: training crops are crops OF FULL-SCALE SCENE GEOMETRY (same object
sizes / velocities the eval corpus has) without rendering full frames.

The round-4b lesson motivating :func:`synthetic_triplets`: training on 4
fixed pre-rendered corpus files memorizes them (train L1 0.0089 but
-4 dB on the held-out eval seed vs a shorter run — measured, see
docs/DESIGN.md 5b); scenes are cheap, so the trainer now draws a FRESH
procedurally-seeded scene per triplet — infinite data, nothing to
memorize.

CLI rendering lives in tools/corpus.py (reference: the validation corpus
stands in for the real app windows the reference upscales, SURVEY.md §4;
/root/reference/src/scaler.cpp has no test content either).
"""

from __future__ import annotations

import numpy as np


def _lattice(rng, gh, gw, octaves):
    return [rng.random((gh * 2 ** k + 2, gw * 2 ** k + 2))
            .astype(np.float32) for k in range(octaves)]


def _sample_noise(lat, ys, xs, octaves, persistence=0.55):
    """Multi-octave value noise at float coords (bilinear per octave)."""
    out = np.zeros(ys.shape, np.float32)
    amp, norm = 1.0, 0.0
    for k in range(octaves):
        g = lat[k]
        gy = ys * (2 ** k) * 0.05
        gx = xs * (2 ** k) * 0.05
        gy = np.mod(gy, g.shape[0] - 2)
        gx = np.mod(gx, g.shape[1] - 2)
        y0 = gy.astype(np.int32)
        x0 = gx.astype(np.int32)
        fy = gy - y0
        fx = gx - x0
        # smoothstep fade (classic value noise)
        fy = fy * fy * (3 - 2 * fy)
        fx = fx * fx * (3 - 2 * fx)
        v = ((g[y0, x0] * (1 - fx) + g[y0, x0 + 1] * fx) * (1 - fy)
             + (g[y0 + 1, x0] * (1 - fx) + g[y0 + 1, x0 + 1] * fx) * fy)
        out += amp * v
        norm += amp
        amp *= persistence
    return out / norm


def _rot(dy, dx, ang):
    """Apply R(ang) = [[cos, sin], [-sin, cos]] to (dy, dx) vectors."""
    c, s = np.cos(ang), np.sin(ang)
    return c * dy + s * dx, -s * dy + c * dx


class Scene:
    """One shot: background + two occluding movers, all subpixel.

    ``rich=True`` (round 4) adds the motion classes the original corpus
    was thinnest on: the first mover ROTATES about
    its center (non-translational block motion — no single translation
    explains its blocks), a THIN BAR occluder sweeps the frame (blocks
    straddling it see two motions at once), and a REPEATED diagonal
    grating rides the background (the aperture trap: every period-offset
    displacement matches equally well).  All remain analytic in float t.

    ``photo=True`` (round 5) adds the PHOTOMETRIC
    failure axes real video has and the geometric corpus lacked:

    - **motion blur** — box-shutter integration along the analytic
      motion (the frame is the mean of ``blur_taps`` exact renders over
      a 0.35-0.6-frame shutter; every tap is closed-form, so this is
      true shutter integration, not a spatial blur approximation);
    - **exposure flicker** — two incommensurate fast sinusoidal gain
      terms (periods ~2-9 frames) on top of the slow 180-frame drift,
      so consecutive frames no longer share a gain;
    - **sensor-noise mismatch** — the grain STRENGTH itself oscillates
      with a 3-8-frame period (auto-ISO stepping): the two frames of a
      pair carry different noise levels, not just independent noise;
    - **perspective background** — the pan+zoom similarity becomes a
      full time-dependent homography (a perspective row growing with t,
      anchored at the frame center), so background flow is projective,
      not affine; :meth:`flow` stays exact via H(te)^-1 H(tm).

    Default off: ``photo=False`` renders bitwise what round 4 rendered
    (every published table stays reproducible).  Blur softens layer
    edges by up to ~3 px; the flow validity band (alpha 0.1-0.9) already
    excludes the smeared boundary at these shutter/velocity ranges.
    """

    def __init__(self, seed, w, h, rich=True, photo=False):
        rng = np.random.default_rng(seed)
        self.w, self.h = w, h
        self.rich = rich
        self.photo = photo
        self.bg = _lattice(rng, 8, 8, 4)
        self.ob1 = _lattice(rng, 6, 6, 3)
        self.ob2 = _lattice(rng, 6, 6, 3)
        # velocities in px/frame — deliberately non-integer
        self.v_bg = rng.uniform(0.6, 2.4, 2) * rng.choice([-1, 1], 2)
        self.v1 = rng.uniform(1.1, 3.7, 2) * rng.choice([-1, 1], 2)
        self.v2 = rng.uniform(2.2, 5.3, 2) * rng.choice([-1, 1], 2)
        self.zoom = rng.uniform(0.0005, 0.002)     # divergence per frame
        self.c1 = rng.uniform(0.25, 0.75, 2) * [h, w]
        self.c2 = rng.uniform(0.25, 0.75, 2) * [h, w]
        self.r1 = rng.uniform(0.12, 0.2) * min(h, w)
        self.r2 = rng.uniform(0.08, 0.14) * min(h, w)
        # per-channel color transforms of the same luminance texture
        self.tint = rng.uniform(0.5, 1.0, (3, 3)).astype(np.float32)
        if rich:
            # ob1 spin: ~0.5-1.5 px/frame of tangential motion at the rim
            self.omega1 = rng.uniform(0.008, 0.022) * rng.choice([-1, 1])
            # thin bar: 2-5 px half-width, fast sweep, slow tumble
            self.bar_c = rng.uniform(0.3, 0.7, 2) * [h, w]
            self.bar_v = rng.uniform(2.5, 6.0, 2) * rng.choice([-1, 1], 2)
            self.bar_hw = rng.uniform(2.0, 5.0)
            self.bar_hl = rng.uniform(0.25, 0.45) * min(h, w)
            self.bar_phi = rng.uniform(0, np.pi)
            self.bar_omega = rng.uniform(-0.01, 0.01)
            # repeated grating locked to the background flow: period well
            # inside the 16-px block so ±period displacements alias
            self.gr_period = rng.uniform(9.0, 13.0)
            self.gr_angle = rng.uniform(0, np.pi)
            self.gr_c = rng.uniform(0.2, 0.8, 2) * [h, w]
            self.gr_r = rng.uniform(0.18, 0.28) * min(h, w)
        if photo:
            # perspective row growth: over 24 frames and a half-frame of
            # extent this tilts the background scale by a few percent —
            # visible projective flow, still safely invertible
            self.persp = rng.uniform(0.5e-5, 2e-5, 2) * rng.choice([-1, 1], 2)
            self.shutter = rng.uniform(0.35, 0.6)   # fraction of a frame
            self.blur_taps = 5
            # fast flicker: two incommensurate sinusoids (amp, period, phase)
            self.flick = (rng.uniform(0.02, 0.05), rng.uniform(2.2, 3.6),
                          rng.uniform(0, 2 * np.pi),
                          rng.uniform(0.01, 0.04), rng.uniform(5.0, 9.0),
                          rng.uniform(0, 2 * np.pi))
            # grain-strength oscillation (auto-ISO): (amp, period, phase)
            self.noise_mod = (rng.uniform(0.3, 0.6), rng.uniform(3.0, 8.0),
                              rng.uniform(0, 2 * np.pi))

    def _bg_homography(self, t):
        """3x3 H(t) mapping screen [y, x, 1] -> background texture coords
        (projective).  The affine part reproduces the pan+zoom exactly;
        ``photo`` adds the perspective row, anchored at the frame center
        so the divisor is 1.0 there."""
        h, w = self.h, self.w
        s = 1.0 + self.zoom * t
        H = np.array([[s, 0.0, h / 2 - s * h / 2 + self.v_bg[0] * t],
                      [0.0, s, w / 2 - s * w / 2 + self.v_bg[1] * t],
                      [0.0, 0.0, 1.0]])
        py, px = self.persp * t
        H[2] = [py, px, 1.0 - py * h / 2 - px * w / 2]
        return H

    @staticmethod
    def _apply_h(H, ys, xs):
        den = H[2, 0] * ys + H[2, 1] * xs + H[2, 2]
        return ((H[0, 0] * ys + H[0, 1] * xs + H[0, 2]) / den,
                (H[1, 0] * ys + H[1, 1] * xs + H[1, 2]) / den)

    def _grid(self, window):
        """Pixel-coordinate grids for the full frame or a sub-rectangle.

        ``window``: (y0, x0, h, w) in scene coordinates — rendering a
        window of a large scene costs only the window (training crops
        keep full-scale scene geometry)."""
        if window is None:
            return np.mgrid[0:self.h, 0:self.w].astype(np.float32)
        y0, x0, wh, ww = window
        return np.mgrid[y0:y0 + wh, x0:x0 + ww].astype(np.float32)

    def render(self, t, grain_rng=None, grain=3.0, window=None):
        ys, xs = self._grid(window)
        if self.photo:
            # box-shutter integration: the frame is the mean of exact
            # renders across the shutter interval (true motion blur —
            # every tap is the closed-form scene at its own time)
            taps = np.linspace(t - self.shutter / 2, t + self.shutter / 2,
                               self.blur_taps)
            frame = np.mean([self._render_sharp(tt, ys, xs)
                             for tt in taps], axis=0)
        else:
            frame = self._render_sharp(t, ys, xs)
        g = grain
        if self.photo and grain_rng is not None and grain > 0:
            # sensor-noise mismatch: the grain level itself oscillates
            na, period, ph = self.noise_mod
            g = grain * (1.0 + na * np.sin(2 * np.pi * t / period + ph))
        if grain_rng is not None and g > 0:
            frame[..., :3] += grain_rng.normal(0.0, g, ys.shape + (3,))
        frame[..., 3] = 255.0
        return np.clip(np.round(frame), 0, 255).astype(np.uint8)

    def _render_sharp(self, t, ys, xs):
        """One exact render at time t, pre-grain/pre-quantize (f32)."""
        h, w = self.h, self.w
        if self.photo:
            by, bx = self._apply_h(self._bg_homography(t), ys, xs)
        else:
            # background: pan + slow zoom about the frame center (kept as
            # the round-4 formulas verbatim: photo=False stays bitwise)
            s = 1.0 + self.zoom * t
            by = (ys - h / 2) * s + h / 2 + self.v_bg[0] * t
            bx = (xs - w / 2) * s + w / 2 + self.v_bg[1] * t
        lum_bg = _sample_noise(self.bg, by, bx, 4)
        if self.rich:
            # repeated diagonal grating, advected with the background
            # (soft disk region): the classic aperture trap
            u = by * np.sin(self.gr_angle) + bx * np.cos(self.gr_angle)
            grating = 0.5 + 0.5 * np.sin(2 * np.pi * u / self.gr_period)
            gd = np.sqrt((ys - self.gr_c[0]) ** 2 + (xs - self.gr_c[1]) ** 2)
            g_a = np.clip((self.gr_r - gd) / 6.0, 0.0, 1.0) * 0.55
            lum_bg = lum_bg * (1 - g_a) + grating * g_a

        def obj(lat, c, r, v, octs, omega=0.0):
            cy = c[0] + v[0] * t
            cx = c[1] + v[1] * t
            # textured soft-edged disk, texture locked to the object
            dy = ys - cy
            dx = xs - cx
            alpha = np.clip((r - np.sqrt(dy * dy + dx * dx)) / 1.5, 0.0, 1.0)
            if omega:
                # texture sampled in the object's ROTATING frame
                dy, dx = _rot(dy, dx, omega * t)
            lum = _sample_noise(lat, dy, dx, octs)
            return lum, alpha

        l1, a1 = obj(self.ob1, self.c1, self.r1, self.v1, 3,
                     omega=self.omega1 if self.rich else 0.0)
        l2, a2 = obj(self.ob2, self.c2, self.r2, self.v2, 3)
        lum = lum_bg * (1 - a1) + (0.3 + 0.7 * l1) * a1
        lum = lum * (1 - a2) + (0.15 + 0.7 * l2) * a2
        if self.rich:
            # thin tumbling bar occluder (distance to a rotating segment)
            bcy = self.bar_c[0] + self.bar_v[0] * t
            bcx = self.bar_c[1] + self.bar_v[1] * t
            phi = self.bar_phi + self.bar_omega * t
            dy = ys - bcy
            dx = xs - bcx
            along = dy * np.sin(phi) + dx * np.cos(phi)
            across = dy * np.cos(phi) - dx * np.sin(phi)
            a3 = (np.clip((self.bar_hw - np.abs(across)) / 1.0, 0.0, 1.0)
                  * np.clip((self.bar_hl - np.abs(along)) / 3.0, 0.0, 1.0))
            l3 = _sample_noise(self.ob2, along * 0.7, across * 0.7, 2)
            lum = lum * (1 - a3) + (0.55 + 0.45 * l3) * a3

        # slow exposure drift (+ fast flicker on the photo corpus)
        gain = 1.0 + 0.03 * np.sin(2 * np.pi * t / 180.0)
        if self.photo:
            a1, p1, ph1, a2, p2, ph2 = self.flick
            gain *= (1.0 + a1 * np.sin(2 * np.pi * t / p1 + ph1)
                     + a2 * np.sin(2 * np.pi * t / p2 + ph2))
        frame = np.empty(ys.shape + (4,), np.float32)
        for ch in range(3):
            m = self.tint[ch]
            frame[..., ch] = (m[0] * lum + m[1] * lum_bg * 0.3
                              + m[2] * 0.1) * gain
        frame[..., :3] *= 255.0 / 1.4
        return frame

    # -- analytic flow ----------------------------------------------------

    def _alphas(self, t, ys, xs):
        """Layer coverages at float coords: (a1, a2, a3); a3 is 0 for the
        classic corpus.  Same formulas as render (no texture sampling)."""
        cy1 = self.c1[0] + self.v1[0] * t
        cx1 = self.c1[1] + self.v1[1] * t
        a1 = np.clip((self.r1 - np.hypot(ys - cy1, xs - cx1)) / 1.5, 0., 1.)
        cy2 = self.c2[0] + self.v2[0] * t
        cx2 = self.c2[1] + self.v2[1] * t
        a2 = np.clip((self.r2 - np.hypot(ys - cy2, xs - cx2)) / 1.5, 0., 1.)
        if not self.rich:
            return a1, a2, np.zeros_like(a1)
        bcy = self.bar_c[0] + self.bar_v[0] * t
        bcx = self.bar_c[1] + self.bar_v[1] * t
        phi = self.bar_phi + self.bar_omega * t
        dy = ys - bcy
        dx = xs - bcx
        along = dy * np.sin(phi) + dx * np.cos(phi)
        across = dy * np.cos(phi) - dx * np.sin(phi)
        a3 = (np.clip((self.bar_hw - np.abs(across)) / 1.0, 0.0, 1.0)
              * np.clip((self.bar_hl - np.abs(along)) / 3.0, 0.0, 1.0))
        return a1, a2, a3

    def _advect(self, tm, te, ys, xs):
        """Per-layer screen position at te of the material point visible
        at (ys, xs) at tm.  Returns [4] (y', x') pairs for layers
        (bg, ob1, ob2, bar) — every layer is a closed-form rigid motion,
        so each is exact (no integration)."""
        h, w = self.h, self.w
        if self.photo:
            # bg: texture coord H(t)p fixed -> p_e = H(te)^-1 H(tm) p_m
            # (exact projective correspondence, same H as the renderer)
            A = np.linalg.inv(self._bg_homography(te)) \
                @ self._bg_homography(tm)
            bg_y, bg_x = self._apply_h(A, ys, xs)
        else:
            s0 = 1.0 + self.zoom * tm
            s1 = 1.0 + self.zoom * te
            # bg: texture coord fixed -> invert the pan+zoom at both times
            bg_y = ((ys - h / 2) * s0 + self.v_bg[0] * (tm - te)) / s1 + h / 2
            bg_x = ((xs - w / 2) * s0 + self.v_bg[1] * (tm - te)) / s1 + w / 2
        # ob1: translation + rotation about the moving center.
        # Texture coord T = R(omega*t) @ d  =>  d' = R(th_m - th_e) @ d
        om = self.omega1 if self.rich else 0.0
        dy = ys - (self.c1[0] + self.v1[0] * tm)
        dx = xs - (self.c1[1] + self.v1[1] * tm)
        ry, rx = _rot(dy, dx, om * (tm - te))
        o1_y = self.c1[0] + self.v1[0] * te + ry
        o1_x = self.c1[1] + self.v1[1] * te + rx
        # ob2: pure translation
        o2_y = ys + self.v2[0] * (te - tm)
        o2_x = xs + self.v2[1] * (te - tm)
        if self.rich:
            # bar: texture coord T = M(phi) @ d with M a reflection
            # (M(phi)^2 = I); d' = M(phi_e) M(phi_m) d = R(phi_e-phi_m) d
            phi_m = self.bar_phi + self.bar_omega * tm
            phi_e = self.bar_phi + self.bar_omega * te
            dy = ys - (self.bar_c[0] + self.bar_v[0] * tm)
            dx = xs - (self.bar_c[1] + self.bar_v[1] * tm)
            ry, rx = _rot(dy, dx, phi_e - phi_m)
            b_y = self.bar_c[0] + self.bar_v[0] * te + ry
            b_x = self.bar_c[1] + self.bar_v[1] * te + rx
        else:
            b_y, b_x = ys, xs
        return ((bg_y, bg_x), (o1_y, o1_x), (o2_y, o2_x), (b_y, b_x))

    def flow(self, tm, te, ys, xs):
        """Exact backward flow: for the content visible at float coords
        (ys, xs) at time tm, where that material point sits at time te.

        Returns ``(flow, valid)``: flow [2, ...] in (dx, dy) channel
        order (matching models.rife.bilinear_warp), valid [...] bool —
        True where the correspondence is well-defined: the source pixel
        is not on a soft layer edge (alpha in (0.1, 0.9) band), the
        advected point lands in frame, and the SAME layer is visible
        there (not occluded by a higher layer / not revealed content).
        """
        ys = np.asarray(ys, np.float32)
        xs = np.asarray(xs, np.float32)
        a1, a2, a3 = self._alphas(tm, ys, xs)
        # stacking order (topmost first): bar(3) > ob2(2) > ob1(1) > bg(0)
        layer = np.where(a3 >= 0.5, 3,
                         np.where(a2 >= 0.5, 2, np.where(a1 >= 0.5, 1, 0)))
        edge = (((a1 > 0.1) & (a1 < 0.9)) | ((a2 > 0.1) & (a2 < 0.9))
                | ((a3 > 0.1) & (a3 < 0.9)))
        pos = self._advect(tm, te, ys, xs)
        py = np.choose(layer, [p[0] for p in pos])
        px = np.choose(layer, [p[1] for p in pos])
        flow = np.stack([px - xs, py - ys]).astype(np.float32)

        inb = ((py >= 0) & (py <= self.h - 1) & (px >= 0)
               & (px <= self.w - 1))
        b1, b2, b3 = self._alphas(te, py, px)
        # visible at te as the SAME layer: every higher layer clear, own
        # alpha solid (own alpha is rigid-motion invariant, checked anyway)
        vis = np.where(
            layer == 3, b3 >= 0.9,
            np.where(layer == 2, (b2 >= 0.9) & (b3 <= 0.1),
                     np.where(layer == 1,
                              (b1 >= 0.9) & (b2 <= 0.1) & (b3 <= 0.1),
                              (b1 <= 0.1) & (b2 <= 0.1) & (b3 <= 0.1))))
        return flow, (~edge) & inb & vis


class NaturalCorpus:
    """Frame factory with optional scene cuts.

    ``cut_at``: a time, or a LIST of times (multiple cuts — each starts a
    fresh independently-seeded scene).  ``rich=False`` reproduces the r3
    corpus exactly (no rotation/bar/grating); ``photo=True`` adds the
    round-5 photometric axes (motion blur, flicker, noise mismatch,
    perspective background — see Scene)."""

    def __init__(self, w=640, h=384, seed=1, cut_at=None, rich=True,
                 photo=False):
        cuts = ([] if cut_at is None
                else list(cut_at) if hasattr(cut_at, "__iter__")
                else [cut_at])
        self.cuts = sorted(float(c) for c in cuts)
        self.scenes = [Scene(seed + 1000 * k, w, h, rich=rich, photo=photo)
                       for k in range(len(self.cuts) + 1)]
        # back-compat: the single-cut attribute older callers read
        self.cut_at = self.cuts[0] if self.cuts else None

    def _scene(self, t):
        return self.scenes[sum(1 for c in self.cuts if t >= c)]

    def frame(self, t, grain_rng=None, grain=3.0, window=None):
        return self._scene(t).render(t, grain_rng=grain_rng, grain=grain,
                                     window=window)

    def flow(self, tm, te, ys, xs):
        """Analytic flow (see Scene.flow); tm and te must lie in the same
        shot — across a cut there is no correspondence to return."""
        sm, se = self._scene(tm), self._scene(te)
        if sm is not se:
            raise ValueError("flow requested across a scene cut")
        return sm.flow(tm, te, ys, xs)


# ---------------------------------------------------------------------------
# Trainer feed: infinite fresh-scene triplets with analytic supervision.
# ---------------------------------------------------------------------------

def _planar(frame):
    return np.transpose(frame, (2, 0, 1)).astype(np.float32) / 255.0


def synthetic_triplets(crop_h, crop_w, batch, seed=0, scene_w=640,
                       scene_h=384, grain_p=0.25, gap2_p=0.25,
                       rich=True, supervise=True, t_max=24.0,
                       t_range=None, photo_p=0.0):
    """Infinite generator of training batches from FRESH procedural scenes.

    Each triplet draws a new scene (seed stream offset by 10**6 from the
    eval/file-corpus seed ranges), a random time t0 in [0, t_max], a
    random ``crop_h x crop_w`` window of the full ``scene_w x scene_h``
    geometry, frame gap 1 (t0, t0+0.5, t0+1 — exactly the fps-doubling
    deployment/eval condition) or gap 2 with probability ``gap2_p``
    (larger-motion augmentation), and film grain with probability
    ``grain_p``.

    Yields dicts of f32 arrays:
      prev/target/curr  [B, 4, H, W]   planar frames in [0, 1]
      flow4             [B, 4, H/4, W/4]  analytic (dxp,dyp,dxc,dyc) at the
                        head's quarter-res pixel centers, QUARTER-res units
      vp4 / vc4         [B, 1, H/4, W/4]  per-side flow validity
      flow8 / vp8 / vc8 same at the v2 coarse stage's 1/8 centers
    (supervision arrays omitted when ``supervise=False``).

    The quarter-res center of head pixel (i, j) sits at full-res
    (4i + 1.5, 4j + 1.5) — jax.image.resize half-pixel convention, the
    same mapping models/rife.py's closed-form lattice uses — so the
    targets are evaluated exactly where the head's outputs live.

    ``t_range`` (lo, hi): multi-t training — one fractional time point is
    drawn per BATCH (the train step takes a scalar t) and the TARGET
    renders at t0 + gap·t instead of the midpoint; the batch dict gains
    key ``t`` (f32 scalar).  The analytic flow supervision stays the
    MIDPOINT motions (flows FROM t0+gap/2), matching the heads' raw-flow
    semantics — the loss reaches the off-midpoint target through the
    t-scaled tails (rife._flow_t_scales), exactly the deployed k>2 path.
    The k=3/4 deployment time points (1/3..3/4) motivate the default
    campaign range (0.25, 0.75).

    ``photo_p``: per-triplet probability of drawing the scene with the
    photometric axes on (Scene ``photo=True``); 0.0 (default) skips the
    extra RNG draw entirely, so existing training streams replay
    bitwise.
    """
    rng = np.random.default_rng(seed)
    scene_seed = 1_000_000 + 7919 * (seed + 1)

    def sup(corpus_scene, tm, t0, t1, y0, x0, stride):
        n_h, n_w = crop_h // stride, crop_w // stride
        off = stride / 2.0 - 0.5
        ys = (y0 + off + stride * np.arange(n_h, dtype=np.float32))[:, None]
        xs = (x0 + off + stride * np.arange(n_w, dtype=np.float32))[None, :]
        ys = np.broadcast_to(ys, (n_h, n_w))
        xs = np.broadcast_to(xs, (n_h, n_w))
        fp, vp = corpus_scene.flow(tm, t0, ys, xs)
        fc, vc = corpus_scene.flow(tm, t1, ys, xs)
        flow = np.concatenate([fp, fc]) / np.float32(stride)
        return (flow.astype(np.float32), vp.astype(np.float32)[None],
                vc.astype(np.float32)[None])

    while True:
        out = {k: [] for k in ("prev", "target", "curr", "flow4", "vp4",
                               "vc4", "flow8", "vp8", "vc8")}
        tt = (float(rng.uniform(*t_range)) if t_range is not None
              else 0.5)  # one time point per batch (scalar step arg)
        for _ in range(batch):
            photo = bool(photo_p > 0.0 and rng.random() < photo_p)
            sc = Scene(scene_seed, scene_w, scene_h, rich=rich, photo=photo)
            scene_seed += 1
            gap = 2.0 if rng.random() < gap2_p else 1.0
            t0 = float(rng.uniform(0.0, t_max))
            tm, t1 = t0 + gap / 2.0, t0 + gap
            t_target = t0 + gap * tt  # == tm when t_range is None
            y0 = int(rng.integers(0, scene_h - crop_h + 1))
            x0 = int(rng.integers(0, scene_w - crop_w + 1))
            grain_rng = rng if rng.random() < grain_p else None
            win = (y0, x0, crop_h, crop_w)
            for key, t in (("prev", t0), ("target", t_target),
                           ("curr", t1)):
                out[key].append(_planar(sc.render(
                    t, grain_rng=grain_rng, window=win)))
            if supervise:
                f4, vp4, vc4 = sup(sc, tm, t0, t1, y0, x0, 4)
                f8, vp8, vc8 = sup(sc, tm, t0, t1, y0, x0, 8)
                for key, v in (("flow4", f4), ("vp4", vp4), ("vc4", vc4),
                               ("flow8", f8), ("vp8", vp8), ("vc8", vc8)):
                    out[key].append(v)
        batch_out = {k: np.stack(v) for k, v in out.items() if v}
        if t_range is not None:
            batch_out["t"] = np.float32(tt)
        yield batch_out
