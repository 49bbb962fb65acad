"""Procedural photo-domain faces with iBUG-68 landmark ground truth (numpy only).

The port's own copy of ``vface_tpu/preprocess/synthetic_faces.py`` (the port
imports nothing of the JAX package, not even its numpy modules): the same
functions, draw for draw, so that a ``np.random.Generator`` with the same seed
gives the same images bit for bit. The face detector and the landmark net were
distilled on these renders; :func:`render_scene` makes the multi-face scenes
the detector is checked on.

Faces are soft-alpha shaded layers (skin-tone families with spherical
shading, hair with a noisy hairline, sclera/iris/pupil eyes, two-tone lips
with an optional open mouth, nose shadows and nostrils, optional beard and
glasses) over cluttered gradient backgrounds, then photometric augmentation
(directional lighting, blur, sensor noise, gamma/white-balance jitter,
vignette). All feature geometry derives from one jittered shape-parameter
draw, and the 68 points come from the same parameters:

  0-16 jaw · 17-21 / 22-26 brows · 27-35 nose · 36-41 / 42-47 eyes ·
  48-59 outer lip · 60-67 inner lip
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _shape_defaults() -> dict:
    return dict(
        eye_x=0.40, eye_y=-0.26, eye_rx=0.15, eye_ry=0.07,
        brow_y=-0.48, brow_x0=0.18, brow_x1=0.62, brow_arc=0.06,
        mouth_y=0.55, mouth_rx=0.30, mouth_ry=0.13,
        nose_w=0.14, nostril_y=0.22, nose_top=-0.35,
        jaw_w=0.9, jaw_drop=0.1, jaw_h=0.9,
    )


def sample_shape(rng: np.random.Generator | None = None) -> dict:
    """One face-shape draw; ``None`` → the canonical (default) shape."""
    p = _shape_defaults()
    if rng is None:
        return p
    p["eye_x"] *= rng.uniform(0.85, 1.15)
    p["eye_y"] += rng.normal(0.0, 0.03)
    p["eye_rx"] *= rng.uniform(0.8, 1.15)
    p["eye_ry"] *= rng.uniform(0.7, 1.3)
    p["brow_y"] += rng.normal(0.0, 0.035)
    p["mouth_y"] += rng.normal(0.0, 0.04)
    p["mouth_rx"] *= rng.uniform(0.75, 1.2)
    p["mouth_ry"] *= rng.uniform(0.6, 1.25)
    p["nose_w"] *= rng.uniform(0.8, 1.25)
    p["jaw_w"] *= rng.uniform(0.9, 1.1)
    p["jaw_h"] *= rng.uniform(0.92, 1.08)
    return p


def canonical_landmarks(p: dict | None = None) -> np.ndarray:
    """(68, 2) landmark layout in canonical face coords ([-1, 1] box,
    +x right, +y down), derived from shape params ``p`` (default shape
    when None)."""
    p = p or _shape_defaults()
    pts = np.zeros((68, 2), np.float32)
    # jaw 0-16: lower face arc, chin at (0, jaw_drop + jaw_h)
    th = np.linspace(0.0, np.pi, 17)
    pts[0:17, 0] = -p["jaw_w"] * np.cos(th)
    pts[0:17, 1] = p["jaw_drop"] + p["jaw_h"] * np.sin(th)
    # brows 17-21 (image-left) / 22-26 (image-right), slight arc
    bx = np.linspace(-p["brow_x1"], -p["brow_x0"], 5)
    pts[17:22, 0] = bx
    pts[17:22, 1] = p["brow_y"] - p["brow_arc"] * np.sin(np.linspace(0, np.pi, 5))
    pts[22:27, 0] = -bx[::-1]
    pts[22:27, 1] = pts[17:22, 1][::-1]
    # nose bridge 27-30 + nostril line 31-35
    pts[27:31, 0] = 0.0
    pts[27:31, 1] = np.linspace(p["nose_top"], p["nostril_y"] - 0.10, 4)
    pts[31:36, 0] = np.linspace(-p["nose_w"], p["nose_w"], 5)
    pts[31:36, 1] = p["nostril_y"]
    # eyes 36-41 (left in image; 36 outer corner) / 42-47 (42 inner corner)
    ang = np.deg2rad([180.0, 135.0, 45.0, 0.0, -45.0, -135.0])
    eye = np.stack(
        [p["eye_rx"] * np.cos(ang), -p["eye_ry"] * np.sin(ang)], axis=-1
    )
    pts[36:42] = eye + (-p["eye_x"], p["eye_y"])
    pts[42:48] = eye + (p["eye_x"], p["eye_y"])
    # mouth: outer 48-59 (48 left corner, ccw over the top), inner 60-67
    ang12 = np.deg2rad(180.0 - np.arange(12) * 30.0)
    pts[48:60, 0] = p["mouth_rx"] * np.cos(ang12)
    pts[48:60, 1] = p["mouth_y"] - p["mouth_ry"] * np.sin(ang12)
    ang8 = np.deg2rad(180.0 - np.arange(8) * 45.0)
    pts[60:68, 0] = 0.6 * p["mouth_rx"] * np.cos(ang8)
    pts[60:68, 1] = p["mouth_y"] - 0.45 * p["mouth_ry"] * np.sin(ang8)
    return pts


# --------------------------------------------------------------- paint utils


def _soft(q: np.ndarray, softness: float) -> np.ndarray:
    """Quadratic-form field q (1 at the boundary) → alpha in [0, 1] with a
    soft edge ``softness`` wide (in q units)."""
    return np.clip((1.0 - q) / max(softness, 1e-6), 0.0, 1.0)


def _smooth(x: np.ndarray, w: float) -> np.ndarray:
    return np.clip(x / max(w, 1e-6), 0.0, 1.0)


def _blend(img: np.ndarray, alpha: np.ndarray, color) -> None:
    """In-place alpha composite; ``color`` is (3,) or (S, S, 3)."""
    a = alpha[..., None]
    img += a * (np.asarray(color, np.float32) - img)


def _box_blur(img: np.ndarray, r: int) -> np.ndarray:
    """Separable box blur, radius r (edge-clamped)."""
    if r <= 0:
        return img
    for axis in (0, 1):
        pad = [(0, 0)] * img.ndim
        pad[axis] = (r + 1, r)
        c = np.cumsum(np.pad(img, pad, mode="edge"), axis=axis)
        n = 2 * r + 1
        sl_hi = [slice(None)] * img.ndim
        sl_lo = [slice(None)] * img.ndim
        sl_hi[axis] = slice(n, n + img.shape[axis])
        sl_lo[axis] = slice(0, img.shape[axis])
        img = (c[tuple(sl_hi)] - c[tuple(sl_lo)]) / n
    return img


def _skin_tone(rng: np.random.Generator) -> np.ndarray:
    """Realistic skin family: light → deep, slight per-channel jitter."""
    m = rng.uniform(0.0, 1.0)
    base = np.asarray([0.96, 0.80, 0.68], np.float32) * (1.0 - 0.72 * m)
    base += rng.normal(0.0, 0.02, 3).astype(np.float32)
    return np.clip(base, 0.05, 0.98)


def _hair_color(rng: np.random.Generator) -> np.ndarray:
    fam = rng.integers(0, 5)
    c = {
        0: np.asarray([0.08, 0.07, 0.07]),                       # black
        1: np.asarray([0.30, 0.20, 0.12]),                       # brown
        2: np.asarray([0.65, 0.52, 0.30]),                       # blond
        3: np.asarray([0.65, 0.65, 0.65]),                       # gray
        4: np.asarray([0.45, 0.22, 0.12]),                       # auburn
    }[int(fam)]
    return np.clip(
        c.astype(np.float32) + rng.normal(0.0, 0.04, 3).astype(np.float32), 0.0, 1.0
    )


def _background(rng: np.random.Generator, s: int, xx, yy) -> np.ndarray:
    c0 = rng.uniform(0.0, 1.0, 3).astype(np.float32)
    c1 = np.clip(c0 + rng.normal(0.0, 0.25, 3).astype(np.float32), 0.0, 1.0)
    gdir = rng.normal(0.0, 1.0, 2)
    gdir /= np.linalg.norm(gdir) + 1e-6
    t = (xx * gdir[0] + yy * gdir[1]) / s
    t = (t - t.min()) / (np.ptp(t) + 1e-6)
    img = c0 + t[..., None] * (c1 - c0)
    for _ in range(int(rng.integers(0, 5))):  # clutter blobs
        bc = rng.uniform(0.0, 1.0, 3).astype(np.float32)
        bcx, bcy = rng.uniform(0, s, 2)
        brx, bry = rng.uniform(0.05, 0.45, 2) * s
        q = ((xx - bcx) / brx) ** 2 + ((yy - bcy) / bry) ** 2
        _blend(img, _soft(q, rng.uniform(0.3, 1.5)) * rng.uniform(0.3, 1.0), bc)
    return img.astype(np.float32)


# --------------------------------------------------------------- the renderer


def _paint_face(
    img: np.ndarray,
    rng: np.random.Generator,
    xx: np.ndarray,
    yy: np.ndarray,
    cx: float,
    cy: float,
    scale: float,
    theta: float | None = None,
    aspect: float | None = None,
    shape: dict | None = None,
) -> np.ndarray:
    """Paint one randomized face (all soft-alpha layers, no background /
    photometrics) into ``img`` in place; returns the (68, 2) landmark GT.

    ``shape`` overrides the per-call shape draw — a motion sequence re-seeds
    ``rng`` per frame (stable identity/accessories) while morphing the shape
    params per frame (expression)."""
    s = img.shape[0]
    p = dict(shape) if shape is not None else sample_shape(rng)
    if shape is not None:
        sample_shape(rng)  # keep the rng stream aligned with the unshaped call
    if theta is None:
        theta = rng.uniform(-0.35, 0.35)
    if aspect is None:
        aspect = rng.uniform(0.8, 1.1)
    ct, st = np.cos(theta), np.sin(theta)
    rot = np.asarray([[ct, -st], [st, ct]], np.float32)

    def to_px(pts_canon):
        q = pts_canon * np.asarray([scale * aspect, scale], np.float32)
        return q @ rot.T + np.asarray([cx, cy], np.float32)

    lm = to_px(canonical_landmarks(p))

    # canonical-coordinate fields: every feature mask is axis-aligned in
    # (uc, vc), so one inverse transform serves all layers
    dx, dy = xx - cx, yy - cy
    uc = (dx * ct + dy * st) / (scale * aspect)
    vc = (-dx * st + dy * ct) / scale

    def q_el(cx_c, cy_c, rx, ry):
        return ((uc - cx_c) / max(rx, 1e-6)) ** 2 + ((vc - cy_c) / max(ry, 1e-6)) ** 2

    skin = _skin_tone(rng)
    hair_c = _hair_color(rng)

    # clothing / shoulders (behind everything but background; horizontally
    # bounded so one person's torso cannot blanket a multi-face scene)
    cloth = rng.uniform(0.0, 1.0, 3).astype(np.float32)
    shoulders = _smooth(vc - (p["jaw_drop"] + p["jaw_h"] + 0.45), 0.25) * _soft(
        (uc / 2.6) ** 2, 0.35
    )
    _blend(img, shoulders, cloth)
    # neck
    neck = _smooth(vc - (p["jaw_drop"] + p["jaw_h"] * 0.55), 0.3) * _soft(
        (uc / 0.34) ** 2, 0.4
    )
    _blend(img, neck, skin * 0.88)

    # back hair (a bigger ellipse painted under the head)
    has_hair = rng.uniform() < 0.85
    if has_hair:
        q_back = q_el(0.0, -0.05, rng.uniform(1.0, 1.25), rng.uniform(1.1, 1.35))
        _blend(img, _soft(q_back, 0.12), hair_c)

    # head with spherical shading
    q_head = q_el(0.0, 0.05, 0.92 * (0.5 + 0.5 * p["jaw_w"] / 0.9), 1.02 * p["jaw_h"] / 0.9)
    head_a = _soft(q_head, 0.05)
    shade = np.sqrt(np.clip(1.06 - q_head, 0.0, 1.06))
    ldir = rng.normal(0.0, 1.0, 2)
    ldir /= np.linalg.norm(ldir) + 1e-6
    lateral = 1.0 + rng.uniform(0.0, 0.25) * (uc * ldir[0] + vc * ldir[1])
    light = np.clip((0.55 + 0.5 * shade) * lateral, 0.25, 1.25)
    _blend(img, head_a, skin[None, None, :] * light[..., None])

    # front hair with a noisy hairline above the brows
    if has_hair:
        hairline_v = rng.uniform(-0.75, -0.55) + 0.06 * np.sin(
            uc * rng.uniform(3.0, 9.0) + rng.uniform(0, 6.28)
        )
        fringe = _smooth(hairline_v - vc, 0.1) * _soft(q_el(0.0, -0.1, 1.05, 1.15), 0.1)
        if rng.uniform() < 0.4:  # curly: blobby light/dark texture
            tex = 1.0 - 0.45 * rng.uniform(0.3, 1.0) * (
                0.5 + 0.5 * np.sin(uc * rng.uniform(15, 35))
                * np.sin(vc * rng.uniform(15, 35) + rng.uniform(0, 6.28))
            )
        else:  # straight: sinusoidal striping
            tex = 1.0 - 0.25 * rng.uniform(0.0, 1.0) * np.abs(
                np.sin(uc * 40.0 + vc * rng.uniform(-8, 8))
            )
        _blend(img, fringe, hair_c[None, None, :] * tex[..., None])

    feat_shade = light[..., None]

    # brows: arcs following the landmark curve, hair-colored
    for sgn in (-1.0, 1.0):
        bu = sgn * (p["brow_x0"] + p["brow_x1"]) * 0.5
        bl = (p["brow_x1"] - p["brow_x0"]) * 0.62
        bv = p["brow_y"] - p["brow_arc"] * 0.6
        q_b = q_el(bu, bv, bl, 0.045)
        _blend(img, _soft(q_b, 0.5) * 0.9, (hair_c * 0.8)[None, None, :] * feat_shade)

    # eyes: sclera + iris + pupil + lid shadow. Sclera brightness ranges down
    # to dim (painted portraits / deep-set shadowed eyes, e.g. the MetFaces
    # examples) so eye channels don't depend on a bright-white sclera cue.
    sclera = np.asarray([0.93, 0.92, 0.90], np.float32) * rng.uniform(0.55, 1.0)
    iris_c = {
        0: np.asarray([0.25, 0.15, 0.08]),  # brown
        1: np.asarray([0.25, 0.35, 0.45]),  # blue-gray
        2: np.asarray([0.22, 0.32, 0.18]),  # green
    }[int(rng.integers(0, 3))].astype(np.float32)
    gaze = rng.normal(0.0, 0.015, 2)
    for sgn in (-1.0, 1.0):
        ecx, ecy = sgn * p["eye_x"], p["eye_y"]
        q_s = q_el(ecx, ecy, p["eye_rx"], p["eye_ry"])
        a_s = _soft(q_s, 0.15)
        _blend(img, a_s, sclera[None, None, :] * feat_shade)
        r_i = p["eye_ry"] * rng.uniform(0.85, 1.15)
        q_i = q_el(ecx + gaze[0], ecy + gaze[1], r_i, r_i)
        _blend(img, _soft(q_i, 0.3) * a_s, iris_c)
        q_p = q_el(ecx + gaze[0], ecy + gaze[1], 0.45 * r_i, 0.45 * r_i)
        _blend(img, _soft(q_p, 0.5) * a_s, np.asarray([0.03, 0.03, 0.03], np.float32))
        # upper lid shadow
        lid = a_s * _smooth((ecy - 0.25 * p["eye_ry"]) - vc, 0.04)
        _blend(img, lid * 0.5, skin * 0.55)
        # deep-set socket shadow (30%): a soft dark halo over the whole eye
        # region — painted/moody portraits where eyes read as dark patches
        if rng.uniform() < 0.3:
            q_so = q_el(ecx, ecy - 0.02, p["eye_rx"] * 1.5, p["eye_ry"] * 2.2)
            _blend(img, _soft(q_so, 0.8) * rng.uniform(0.25, 0.5), skin * 0.45)

    # nose: bridge side-shadows, nostrils, tip highlight
    for sgn in (-1.0, 1.0):
        q_n = q_el(sgn * p["nose_w"] * 0.55, 0.0, 0.035, 0.20)
        _blend(img, _soft(q_n, 1.2) * 0.45, (skin * 0.8)[None, None, :] * feat_shade)
    for sgn in (-1.0, 1.0):
        q_no = q_el(sgn * p["nose_w"] * 0.8, p["nostril_y"], 0.045, 0.025)
        _blend(img, _soft(q_no, 0.5) * 0.85, (skin * 0.45)[None, None, :] * feat_shade)
    q_tip = q_el(0.0, p["nostril_y"] - 0.07, 0.05, 0.04)
    _blend(img, _soft(q_tip, 1.0) * 0.35, np.clip(skin * 1.15, 0, 1))

    # mouth: two-tone lips, lip line, optional open mouth with teeth
    lip = np.clip(skin * np.asarray([1.0, 0.55, 0.55]) + rng.uniform(0.0, 0.12), 0.02, 1.0)
    q_m = q_el(0.0, p["mouth_y"], p["mouth_rx"], p["mouth_ry"])
    a_m = _soft(q_m, 0.2)
    upper = _smooth(p["mouth_y"] - vc, 0.02)
    _blend(img, a_m * upper, (lip * 0.78)[None, None, :] * feat_shade)
    _blend(img, a_m * (1.0 - upper), lip[None, None, :] * feat_shade)
    if rng.uniform() < 0.35:  # open mouth
        q_in = q_el(0.0, p["mouth_y"], 0.6 * p["mouth_rx"], 0.45 * p["mouth_ry"])
        a_in = _soft(q_in, 0.25)
        teeth = np.asarray([0.88, 0.85, 0.80], np.float32)
        _blend(img, a_in * upper, teeth[None, None, :] * feat_shade)
        _blend(img, a_in * (1.0 - upper), np.asarray([0.15, 0.05, 0.05], np.float32))
    line = a_m * np.clip(1.0 - np.abs(vc - p["mouth_y"]) / 0.015, 0.0, 1.0)
    _blend(img, line * 0.8, lip * 0.4)

    # beard (30%): noisy dark lower-face cover, lips kept visible
    if rng.uniform() < 0.3:
        bw = _smooth(vc - (p["nostril_y"] + 0.06), 0.15) * head_a
        tex = 0.55 + 0.45 * rng.uniform(0.0, 1.0, (s, s)).astype(np.float32)
        bw = bw * tex * (1.0 - a_m) * rng.uniform(0.55, 0.95)
        _blend(img, bw, hair_c * 0.8)

    # glasses (25%): rims + bridge
    if rng.uniform() < 0.25:
        rim = np.asarray([0.08, 0.08, 0.1], np.float32) if rng.uniform() < 0.7 else (
            hair_c * 0.6
        )
        for sgn in (-1.0, 1.0):
            q_g = q_el(sgn * p["eye_x"], p["eye_y"], p["eye_rx"] * 1.6, p["eye_ry"] * 2.6)
            ring = np.clip(1.0 - np.abs(q_g - 1.0) / 0.22, 0.0, 1.0)
            _blend(img, ring * 0.85, rim)
        bridge = (
            np.clip(1.0 - np.abs(vc - p["eye_y"]) / 0.025, 0, 1)
            * (np.abs(uc) < p["eye_x"] - p["eye_rx"] * 1.2).astype(np.float32)
        )
        _blend(img, bridge * 0.85, rim)

    return lm.astype(np.float32)


def _photometrics(
    img: np.ndarray, rng: np.random.Generator, xx: np.ndarray, yy: np.ndarray
) -> np.ndarray:
    """Camera/sensor augmentation: white balance, grayscale, blur, noise,
    gamma, vignette."""
    s = img.shape[0]
    if rng.uniform() < 0.25:  # foreground occluders (arms, mics, props)
        yy2, xx2 = np.meshgrid(np.arange(s, dtype=np.float32),
                               np.arange(s, dtype=np.float32), indexing="ij")
        for _ in range(int(rng.integers(1, 3))):
            oc = rng.uniform(0.0, 0.6, 3).astype(np.float32)
            ocx, ocy = rng.uniform(0, s, 2)
            orx, ory = rng.uniform(0.04, 0.22, 2) * s
            th = rng.uniform(0, np.pi)
            du = (xx2 - ocx) * np.cos(th) + (yy2 - ocy) * np.sin(th)
            dv = -(xx2 - ocx) * np.sin(th) + (yy2 - ocy) * np.cos(th)
            q = (du / orx) ** 2 + (dv / ory) ** 2
            _blend(img, _soft(q, rng.uniform(0.1, 0.6)), oc)
    if rng.uniform() < 0.25:  # contrast crush (flat / dark scenes)
        mid = img.mean()
        img = mid + rng.uniform(0.45, 0.9) * (img - mid)
    gain = 1.0 + rng.normal(0.0, 0.06, 3).astype(np.float32)  # white balance
    img = img * gain
    if rng.uniform() < 0.18:  # grayscale photos/paintings (e.g. 10076-00.png)
        img = np.repeat(img.mean(axis=-1, keepdims=True), 3, axis=-1)
    r_blur = int(rng.integers(0, 3))
    if r_blur:
        img = _box_blur(img, r_blur * max(1, s // 128))
    img = img + rng.normal(0.0, rng.uniform(0.005, 0.035), img.shape).astype(np.float32)
    img = np.clip(img, 1e-3, 1.0) ** rng.uniform(0.75, 1.3)
    if rng.uniform() < 0.3:  # vignette
        rr = ((xx - s / 2) ** 2 + (yy - s / 2) ** 2) / (s / 2) ** 2
        img = img * (1.0 - rng.uniform(0.1, 0.35) * rr[..., None])
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def render_face(
    rng: np.random.Generator, size: int = 128
) -> Tuple[np.ndarray, np.ndarray]:
    """One randomized photo-domain face → (image01 (S, S, 3), landmarks
    (68, 2) px)."""
    s = size
    yy, xx = np.meshgrid(np.arange(s, dtype=np.float32),
                         np.arange(s, dtype=np.float32), indexing="ij")
    img = _background(rng, s, xx, yy)
    # pose: the half-size range covers the real operating points — small
    # faces in wide frames (yanlecun.jpeg ≈ 0.16·s) through close-cropped
    # FFHQ/MetFaces-style portraits (face spans most of the frame, ≈ 0.5·s).
    lm = _paint_face(
        img, rng, xx, yy,
        cx=rng.uniform(0.34, 0.66) * s,
        cy=rng.uniform(0.34, 0.66) * s,
        scale=rng.uniform(0.13, 0.55) * s,
    )
    return _photometrics(img, rng, xx, yy), lm


def landmark_face_box(lm: np.ndarray) -> np.ndarray:
    """(…, 68, 2) landmarks → (…, 4) [cx, cy, w, h] dlib-style face box
    (brow line to chin, jaw extent)."""
    x0 = lm[..., :, 0].min(axis=-1)
    x1 = lm[..., :, 0].max(axis=-1)
    y0 = lm[..., 17:27, 1].min(axis=-1)   # brow line
    y1 = lm[..., 0:17, 1].max(axis=-1)    # chin
    return np.stack(
        [(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], axis=-1
    ).astype(np.float32)


def render_scene(
    rng: np.random.Generator,
    size: int = 256,
    max_faces: int = 4,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Multi-face scene → (image01 (S, S, 3), boxes (max_faces, 4) [cx, cy,
    w, h] px, valid (max_faces,) bool).  Supervision for `FaceDetector`
    distillation (`scripts/distill_detector.py`): 1..max_faces faces with
    disjoint head regions, painted back-to-front over one cluttered
    background, shared photometrics."""
    s = size
    yy, xx = np.meshgrid(np.arange(s, dtype=np.float32),
                         np.arange(s, dtype=np.float32), indexing="ij")
    img = _background(rng, s, xx, yy)
    n = int(rng.integers(1, max_faces + 1))
    boxes = np.zeros((max_faces, 4), np.float32)
    valid = np.zeros((max_faces,), bool)
    placed: list[tuple[float, float, float]] = []  # (cx, cy, scale)
    for i in range(n):
        for _ in range(12):  # rejection-sample a non-overlapping pose
            scale = rng.uniform(0.10, 0.30 if n > 1 else 0.5) * s
            cx = rng.uniform(0.18, 0.82) * s
            cy = rng.uniform(0.18, 0.82) * s
            if all(
                np.hypot(cx - px, cy - py) > 1.35 * (scale + ps)
                for px, py, ps in placed
            ):
                break
        else:
            continue
        placed.append((cx, cy, scale))
        lm = _paint_face(img, rng, xx, yy, cx=cx, cy=cy, scale=scale)
        boxes[i] = landmark_face_box(lm)
        valid[i] = True
    return _photometrics(img, rng, xx, yy), boxes, valid


def render_batch(
    rng: np.random.Generator, n: int, size: int = 128
) -> Tuple[np.ndarray, np.ndarray]:
    imgs, lms = zip(*(render_face(rng, size) for _ in range(n)))
    return np.stack(imgs), np.stack(lms)


def render_motion_sequence(
    rng: np.random.Generator,
    n_frames: int,
    size: int = 128,
    pose_amp: float = 1.0,
    expr_amp: float = 1.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """NON-RIGID face video: one identity under smooth pose motion
    (translation + in-plane rotation + zoom — spatially-VARYING image flow,
    unlike the rigid pan) and per-frame expression morphs (jaw drop, mouth
    open/width, brow raise, eye squint — true feature-level non-rigidity).

    The regime FGATS/flow-warping exists for (`scripts/temporal_flow.py:
    223-237`): adjacent frames differ by a deformation a static blend cannot
    explain. Returns (frames01 (F, S, S, 3), landmarks (F, 68, 2) px,
    pose (F, 4) = [cx, cy, scale·aspect? no — cx, cy, scale, theta]).

    The face-region GT correspondence between frames i→j is the similarity
    map px_j = R(θj)·S(sj)·R(θi)⁻¹·S(si)⁻¹·(px_i − c_i) + c_j composed from
    the returned pose rows (exact for the rigid-pose component; expression
    morphs move landmarks on top of it — their GT lives in the landmark
    tracks). Identity, accessories, lighting and photometrics are held
    fixed by re-seeding the identity rng per frame.
    """
    ident_seed = int(rng.integers(0, 2**31))
    base_shape = sample_shape(np.random.default_rng(ident_seed + 1))
    s = size
    # smooth pose trajectory: random low-frequency sinusoids
    t = np.arange(n_frames, dtype=np.float32)
    ph = rng.uniform(0, 2 * np.pi, 6)
    w = rng.uniform(0.2, 0.6, 6) * (2 * np.pi / max(n_frames, 2))
    cx = (0.5 + pose_amp * 0.06 * np.sin(w[0] * t * n_frames / 6 + ph[0])) * s
    cy = (0.5 + pose_amp * 0.05 * np.sin(w[1] * t * n_frames / 6 + ph[1])) * s
    scale = (0.30 + pose_amp * 0.045 * np.sin(w[2] * t * n_frames / 6 + ph[2])) * s
    theta = pose_amp * 0.16 * np.sin(w[3] * t * n_frames / 6 + ph[3])
    # expression tracks: jaw/mouth on one rhythm (speech-like), brows/eyes
    # on another (slower)
    jaw = expr_amp * np.clip(np.sin(w[4] * t * n_frames / 2 + ph[4]), 0, 1)
    brow = expr_amp * 0.5 * np.sin(w[5] * t * n_frames / 4 + ph[5])

    yy, xx = np.meshgrid(np.arange(s, dtype=np.float32),
                         np.arange(s, dtype=np.float32), indexing="ij")
    frames, lms, poses = [], [], []
    for i in range(n_frames):
        r_i = np.random.default_rng(ident_seed)
        img = _background(r_i, s, xx, yy)
        p = dict(base_shape)
        p["jaw_drop"] = base_shape["jaw_drop"] + 0.10 * jaw[i]
        p["jaw_h"] = base_shape["jaw_h"] * (1.0 + 0.06 * jaw[i])
        p["mouth_ry"] = base_shape["mouth_ry"] * (1.0 + 0.9 * jaw[i])
        p["mouth_rx"] = base_shape["mouth_rx"] * (1.0 - 0.15 * jaw[i])
        p["mouth_y"] = base_shape["mouth_y"] + 0.05 * jaw[i]
        p["brow_y"] = base_shape["brow_y"] - 0.06 * max(brow[i], 0)
        p["eye_ry"] = base_shape["eye_ry"] * (1.0 + 0.35 * brow[i])
        lm = _paint_face(
            img, r_i, xx, yy, cx=float(cx[i]), cy=float(cy[i]),
            scale=float(scale[i]), theta=float(theta[i]), aspect=0.95,
            shape=p,
        )
        frames.append(_photometrics(img, r_i, xx, yy))
        lms.append(lm)
        poses.append([cx[i], cy[i], scale[i], theta[i]])
    return np.stack(frames), np.stack(lms), np.asarray(poses, np.float32)


def motion_pair_flow(
    pose_i: np.ndarray, pose_j: np.ndarray, size: int, aspect: float = 0.95
) -> np.ndarray:
    """Dense GT backward flow (S, S, 2) of the POSE component for a motion-
    sequence pair: for every pixel of frame j, the offset to its source pixel
    in frame i (the `compute_flow` backward-direction contract). Exact on the
    face region where expression is static; the background is static (flow 0
    there is the truth, this returns the face-map everywhere — mask by the
    face region when comparing)."""
    cxi, cyi, si, thi = (float(v) for v in pose_i)
    cxj, cyj, sj, thj = (float(v) for v in pose_j)
    yy, xx = np.meshgrid(np.arange(size, dtype=np.float32),
                         np.arange(size, dtype=np.float32), indexing="ij")
    # px_j → canonical (undo pose j), canonical → px_i (apply pose i)
    dxj, dyj = xx - cxj, yy - cyj
    ct, st = np.cos(thj), np.sin(thj)
    uc = (dxj * ct + dyj * st) / (sj * aspect)
    vc = (-dxj * st + dyj * ct) / sj
    ct, st = np.cos(thi), np.sin(thi)
    qx = uc * (si * aspect)
    qy = vc * si
    xi = qx * ct - qy * st + cxi
    yi = qx * st + qy * ct + cyi
    return np.stack([xi - xx, yi - yy], axis=-1).astype(np.float32)


def render_pan_sequence(
    rng: np.random.Generator, n_frames: int, size: int = 128, step_px: float = 1.0
) -> Tuple[np.ndarray, np.ndarray]:
    """One face translated ``step_px`` per frame — the crop-stability probe
    (quad jitter between adjacent frames must track the pan, < 2 px)."""
    img0, lm0 = render_face(rng, size)
    imgs, lms = [img0], [lm0]
    for i in range(1, n_frames):
        shift = int(round(i * step_px))
        img = np.roll(img0, shift, axis=1)
        imgs.append(img)
        lm = lm0.copy()
        lm[:, 0] += shift
        lms.append(lm)
    return np.stack(imgs), np.stack(lms)
