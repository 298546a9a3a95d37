"""Procedural equirectangular sky textures.

The reference ships five binary panoramas under images/backgrounds/ (SURVEY.md
C17; default milky-way-equirec.jpg, reference config.py:8).  Binary assets
don't belong in this repo, so equivalent celestial-sphere backgrounds are
generated procedurally and deterministically.  Any CLI `--background` flag
also accepts the scheme `procedural:<name>[:seed]`, e.g.
`--background procedural:starfield`.

All generators return (height, width, 3) uint8 arrays in equirectangular
layout: row 0 = theta 0 (north pole), column 0 = phi 0, matching the
texture-lookup convention in engine/classify.py (reference
raytracing.py:241-246).
"""
from __future__ import annotations

import numpy as np


def starfield(height: int = 1024, width: int = 2048, *, density: float = 3e-4,
              band: bool = True, seed: int = 0) -> np.ndarray:
    """Milky-way-like panorama: point stars + a diffuse galactic band.

    density: stars per pixel.  band: add an equatorial luminous band with
    large-scale mottling (a stand-in for the galactic plane of the
    reference's milky-way-equirec.jpg).
    """
    rng = np.random.default_rng(seed)
    img = np.zeros((height, width, 3), dtype=np.float32)

    # stars uniform on the sphere: phi uniform, cos(theta) uniform
    n_stars = int(density * height * width)
    u = rng.random(n_stars)
    th = np.arccos(1.0 - 2.0 * u)                 # [0, pi]
    ph = rng.random(n_stars) * 2.0 * np.pi
    i = np.clip((th / np.pi * height).astype(int), 0, height - 1)
    j = np.clip((ph / (2 * np.pi) * width).astype(int), 0, width - 1)
    mag = rng.power(3.0, n_stars)                 # few bright, many dim
    tint = rng.random(n_stars)                    # blue-white .. orange
    col = np.stack([0.75 + 0.25 * tint, 0.78 + 0.15 * tint,
                    1.0 - 0.35 * tint], axis=-1)
    np.add.at(img, (i, j), (255.0 * mag)[:, None] * col)

    if band:
        thetas = np.linspace(0.0, np.pi, height, endpoint=False)[:, None]
        # diffuse glow around the equator (the "galactic plane")
        glow = np.exp(-((thetas - np.pi / 2) / 0.22) ** 2)
        # large-scale mottling from smoothed noise, periodic in phi
        k = 8
        coarse = rng.random((k, 2 * k))
        ii = np.linspace(0, k, height, endpoint=False)
        jj = np.linspace(0, 2 * k, width, endpoint=False)
        i0 = ii.astype(int) % k
        j0 = jj.astype(int) % (2 * k)
        fi = (ii - ii.astype(int))[:, None]
        fj = (jj - jj.astype(int))[None, :]
        c00 = coarse[np.ix_(i0, j0)]
        c01 = coarse[np.ix_(i0, (j0 + 1) % (2 * k))]
        c10 = coarse[np.ix_((i0 + 1) % k, j0)]
        c11 = coarse[np.ix_((i0 + 1) % k, (j0 + 1) % (2 * k))]
        mottle = (c00 * (1 - fi) * (1 - fj) + c01 * (1 - fi) * fj
                  + c10 * fi * (1 - fj) + c11 * fi * fj)
        lum = 60.0 * glow * (0.45 + 0.55 * mottle)
        img += lum[..., None] * np.array([1.0, 0.93, 0.82], np.float32)

    return np.clip(img, 0.0, 255.0).astype(np.uint8)


def graticule(height: int = 1024, width: int = 2048, *, n_theta: int = 18,
              n_phi: int = 36, line_px: int = 2,
              bg=(8, 12, 24), line=(90, 200, 255)) -> np.ndarray:
    """Coordinate-grid sky: theta/phi lines every (180/n_theta, 360/n_phi)
    degrees — the sharpest texture for seeing lensing distortion."""
    img = np.empty((height, width, 3), dtype=np.uint8)
    img[:] = np.asarray(bg, np.uint8)
    for t in range(n_theta + 1):
        r = min(int(round(t * height / n_theta)), height - 1)
        img[max(0, r - line_px // 2):r + (line_px + 1) // 2, :] = line
    for p in range(n_phi):
        c = int(round(p * width / n_phi))
        img[:, max(0, c - line_px // 2):c + (line_px + 1) // 2] = line
    return img


def checker(height: int = 1024, width: int = 2048, *, n_theta: int = 12,
            n_phi: int = 24, a=(200, 60, 40), b=(240, 230, 210)) -> np.ndarray:
    """Checkerboard sky (classic lensing test pattern)."""
    ti = (np.arange(height)[:, None] * n_theta // height)
    pj = (np.arange(width)[None, :] * n_phi // width)
    mask = ((ti + pj) % 2).astype(bool)
    img = np.where(mask[..., None], np.asarray(a, np.uint8),
                   np.asarray(b, np.uint8))
    return img.astype(np.uint8)


GENERATORS = {
    "starfield": starfield,
    "milky-way": starfield,     # alias for the reference's default asset name
    "graticule": graticule,
    "checker": checker,
}


def from_spec(spec: str, size=None) -> np.ndarray:
    """Parse 'procedural:<name>[:seed]' into a texture array.

    size: optional (h, w) override — mirrors load_background's resize
    (the reference resizes the texture to the output resolution,
    raytracing.py:36; generating at the right size beats resampling).
    """
    parts = spec.split(":")
    if parts[0] != "procedural" or len(parts) < 2:
        raise ValueError(f"not a procedural texture spec: {spec!r}")
    name = parts[1]
    if name not in GENERATORS:
        raise ValueError(f"unknown procedural texture {name!r}; "
                         f"options: {sorted(GENERATORS)}")
    kwargs = {}
    if len(parts) > 2 and name in ("starfield", "milky-way"):
        kwargs["seed"] = int(parts[2])
    h, w = (size if size is not None else (1024, 2048))
    return GENERATORS[name](h, w, **kwargs)


def is_procedural(spec) -> bool:
    return isinstance(spec, str) and spec.startswith("procedural:")
