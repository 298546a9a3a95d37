"""The port's u-v observables (`engine/visibility.py`), the hot spot's
closure-phase series and the subrings' per-order signatures against the
JAX package on the same seeded inputs, on the CPU.

Tolerances, with their reasons:
  * |V| (float64 FFT) and everything computed from it on the host (the
    radial profile, the first null, the ring diameters): 1e-12;
  * the complex visibility is complex64 in both packages (JAX casts the
    luminance so), and their FFT libraries round differently: 1e-6
    absolute (V(0,0) = 1; about 8e-8 seen); closure phases of it within
    1e-4 rad, and on the same complex map (JAX's) both packages'
    closure_phases agree exactly;
  * JAX's pins carried over: closure phases invariant under an image
    shift (1e-5) and 0 or pi for a point-symmetric source; a triangle
    that does not close raises.
"""
import numpy as np
import pytest
import torch

from grtrace.engine import hotspot as jhot
from grtrace.engine import subring as jsub
from grtrace.engine import visibility as jvis
from grtrace_torch.engine import hotspot as thot
from grtrace_torch.engine import subring as tsub
from grtrace_torch.engine import visibility as tvis

torch.set_num_threads(1)

PIX = 1e-10


def _ring(n=64, r=12.0, width=1.5):
    yy, xx = np.indices((n, n)) - (n - 1) / 2.0
    rr = np.hypot(xx, yy)
    ring = np.exp(-0.5 * ((rr - r) / width) ** 2)
    return ring, ring * (1.0 + 0.5 * np.tanh(xx / 10.0))


def _triangles(du, legs=(((6, 2), (-2, 5)), ((10, 0), (0, 7)),
                         ((3, 9), (4, -4)))):
    tris = []
    for a, b in legs:
        l1 = (a[0] * du, a[1] * du)
        l2 = (b[0] * du, b[1] * du)
        tris.append([l1, l2, (-(a[0] + b[0]) * du, -(a[1] + b[1]) * du)])
    return np.array(tris)


@pytest.mark.parametrize("pad", [2, 4])
def test_visibility_map_and_profile_match_jax(pad):
    """A seeded RGB frame and a thin ring: |V|, the axes, the radial
    profile, the first null and the ring diameter equal JAX's (the ring
    has a null)."""
    rng = np.random.default_rng(2)
    rgb = rng.integers(0, 256, (24, 20, 3), dtype=np.uint8)
    ring, _ = _ring()
    for img, ring_like in ((rgb, False), (ring, True)):
        ja, ju, jv = jvis.visibility_map(img, PIX, pad=pad)
        ta, tu, tv = tvis.visibility_map(img, PIX, pad=pad)
        np.testing.assert_allclose(ta, ja, rtol=0, atol=1e-12)
        np.testing.assert_array_equal(tu, ju)
        np.testing.assert_array_equal(tv, jv)
        b_max = min(ju.max(), jv.max()) / 4.0
        jb, jp = jvis.radial_profile(ja, ju, jv, n_bins=80, b_max=b_max)
        tb, tp = tvis.radial_profile(ta, tu, tv, n_bins=80, b_max=b_max)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-12)
        jn, tn = jvis.first_null(jb, jp), tvis.first_null(tb, tp)
        assert np.isfinite(tn) == np.isfinite(jn)
        assert np.isfinite(tn) or not ring_like
        if np.isfinite(jn):
            assert tn == pytest.approx(jn, rel=1e-12)
            assert tvis.ring_diameter_from_null(tn) == pytest.approx(
                jvis.ring_diameter_from_null(jn), rel=1e-12)
    assert tvis.camera_to_earth(30.0, 1.0, 6.5e9, 16.8) == \
        jvis.camera_to_earth(30.0, 1.0, 6.5e9, 16.8)
    assert tvis.PRESETS == jvis.PRESETS


def test_complex_visibility_and_closure_phases_match_jax():
    ring, asym = _ring()
    jc, ju, jv = jvis.complex_visibility(asym, PIX, pad=2)
    tc, tu, tv = tvis.complex_visibility(asym, PIX, pad=2)
    assert tc.dtype == np.complex64 and tc.shape == jc.shape
    assert np.abs(tc - jc).max() < 1e-6
    tris = _triangles(tu[1] - tu[0])
    np.testing.assert_array_equal(tvis.closure_phases(jc, ju, jv, tris),
                                  jvis.closure_phases(jc, ju, jv, tris))
    ph = tvis.closure_phases(tc, tu, tv, tris)
    np.testing.assert_allclose(ph, jvis.closure_phases(jc, ju, jv, tris),
                               rtol=0, atol=1e-4)
    assert np.abs(ph).max() > 1e-3                   # asymmetric: nonzero

    # JAX's pins: shift invariance, point symmetry, a triangle that does
    # not close
    shifted = np.roll(np.roll(asym, 9, axis=0), -13, axis=1)
    ph_s = tvis.closure_phases(tvis.complex_visibility(shifted, PIX,
                                                       pad=2)[0], tu, tv,
                               tris)
    np.testing.assert_allclose(np.angle(np.exp(1j * (ph - ph_s))), 0.0,
                               atol=1e-5)
    ph_r = tvis.closure_phases(tvis.complex_visibility(ring, PIX, pad=2)[0],
                               tu, tv, tris)
    assert np.abs(np.sin(ph_r)).max() < 1e-5
    bad = tris.copy()
    bad[0, 2, 0] += 3 * (tu[1] - tu[0])
    with pytest.raises(ValueError, match="close"):
        tvis.closure_phases(tc, tu, tv, bad)


def test_closure_phase_series_matches_jax():
    """Three frames of a ring with a moving bright spot: the series
    agrees with JAX's within the complex64 bound, and on a torch movie
    the FFTs run on the frames' device."""
    n = 40
    yy, xx = np.indices((n, n)) - (n - 1) / 2.0
    ring, _ = _ring(n, r=9.0)
    frames = []
    for k in range(3):
        ang = 2.0 * np.pi * k / 3.0
        spot = np.exp(-0.5 * ((xx - 9 * np.cos(ang)) ** 2
                              + (yy - 9 * np.sin(ang)) ** 2) / 2.0)
        lum = 120.0 * ring + 130.0 * spot
        frames.append(np.repeat(lum[..., None], 3, axis=-1).astype(np.uint8))
    frames = np.stack(frames)
    du = 1.0 / (2 * n * PIX)
    tris = _triangles(du, (((3, 1), (1, 3)), ((6, -1), (-1, 6))))
    want = jhot.closure_phase_series(frames, PIX, tris)
    got = thot.closure_phase_series(frames, PIX, tris)
    assert got.shape == want.shape == (3, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.ptp(got, axis=0).max() > 1e-2          # the spot swings them
    np.testing.assert_array_equal(
        thot.closure_phase_series(torch.from_numpy(frames), PIX, tris), got)


def test_subring_visibilities_match_jax():
    """tests/test_subring.py's synthetic layers (a null-free Gaussian in
    layer 0, a thin ring of radius 20 px in layer 1, an empty layer 2):
    the port's per-order signatures equal JAX's, and the ring's diameter
    is its own within 2%."""
    size, fov = 96, np.deg2rad(60.0)
    yy, xx = np.mgrid[0:size, 0:size] - (size - 1) / 2.0
    rho = np.hypot(xx, yy)
    inten = np.zeros((3, size, size))
    inten[0] = np.exp(-0.5 * (rho / 6.0) ** 2)
    inten[1] = np.exp(-0.5 * ((rho - 20.0) / 0.7) ** 2)
    want = jsub.subring_visibilities({"intensity": inten}, fov)
    got = tsub.subring_visibilities({"intensity": inten}, fov)
    for w, g in zip(want, got):
        assert g["order"] == w["order"]
        for k in ("b_null", "ring_diameter_rad"):
            assert np.isnan(g[k]) == np.isnan(w[k])
            if np.isfinite(w[k]):
                assert g[k] == pytest.approx(w[k], rel=1e-12)
        if w["baselines"] is None:
            assert g["baselines"] is None and g["profile"] is None
        else:
            np.testing.assert_array_equal(g["baselines"], w["baselines"])
            np.testing.assert_allclose(g["profile"], w["profile"], rtol=0,
                                       atol=1e-12)
    assert np.isnan(got[0]["ring_diameter_rad"])
    pixel_cam = 2.0 * np.tan(fov / 2.0) / size
    assert got[1]["ring_diameter_rad"] == pytest.approx(2 * 20.0 * pixel_cam,
                                                        rel=0.02)
