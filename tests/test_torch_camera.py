"""The port's folded pinhole camera (and its coordinate, metric and
null-condition helpers) against the JAX package on the same inputs.

float64 throughout: the two packages evaluate the same formulas in the
same association, so they agree to a few float64 ulps (bound 1e-10).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.engine import classify as jcls
from grtrace.physics import camera as jcam
from grtrace.physics import coords as jco
from grtrace.physics import metric as jmet
from grtrace.physics import nullcond as jnull
from grtrace_torch.engine import classify as tcls
from grtrace_torch.physics import camera as tcam
from grtrace_torch.physics import coords as tco
from grtrace_torch.physics import metric as tmet
from grtrace_torch.physics import nullcond as tnull

torch.set_num_threads(1)

TOL = 1e-10
OBS = np.array([30.0, 0.0, 0.0])
FOV = np.radians(80.0)
CAMERA_OUTPUTS = ("q0", "p0", "alpha0", "heading", "beta")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def cameras():
    j = jcam.camera_rays(OBS, FOV, 16, 16, dtype=jnp.float64)
    t = tcam.camera_rays(OBS, FOV, 16, 16, dtype=torch.float64)
    return dict(zip(CAMERA_OUTPUTS, map(_np, j))), \
        dict(zip(CAMERA_OUTPUTS, map(_np, t)))


@pytest.mark.parametrize("name", CAMERA_OUTPUTS)
def test_camera_rays_f64(cameras, name):
    j, t = cameras
    assert t[name].shape == j[name].shape
    np.testing.assert_allclose(t[name], j[name], rtol=0, atol=TOL)


def test_camera_rays_are_folded(cameras):
    """Every ray is in the equatorial plane: theta = pi/2, p_theta = 0."""
    _, t = cameras
    np.testing.assert_allclose(t["q0"][..., 2], np.pi / 2, rtol=0, atol=1e-15)
    assert np.all(t["p0"][..., 2] == 0.0)


@pytest.mark.parametrize("size", [(5, 7), (16, 16)])
def test_pixel_grid(size):
    h, w = size
    j = _np(jcam.pixel_grid(OBS, FOV, h, w, dtype=jnp.float64))
    t = _np(tcam.pixel_grid(OBS, FOV, h, w, dtype=torch.float64))
    np.testing.assert_allclose(t, j, rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def rng_angles():
    rng = np.random.default_rng(7)
    return (rng.uniform(0.0, np.pi, 64), rng.uniform(-1.0, 1.0, 64),
            rng.uniform(4.0, 30.0, 64))


def test_angles_to_p_sph(rng_angles):
    a, b, r = rng_angles
    j = _np(jcam.angles_to_p_sph(jnp.asarray(a), jnp.asarray(b),
                                 jnp.asarray(r)))
    t = _np(tcam.angles_to_p_sph(torch.tensor(a), torch.tensor(b),
                                 torch.tensor(r)))
    np.testing.assert_allclose(t, j, rtol=0, atol=TOL)


@pytest.mark.parametrize("future", [True, False])
def test_null_p_t(rng_angles, future):
    a, b, r = rng_angles
    p = np.asarray(jcam.angles_to_p_sph(jnp.asarray(a), jnp.asarray(b),
                                        jnp.asarray(r)))
    th = np.full_like(r, np.pi / 3)
    j = _np(jnull.null_p_t(jnp.asarray(p), jnp.asarray(r), jnp.asarray(th),
                           future=future))
    t = _np(tnull.null_p_t(torch.tensor(p), torch.tensor(r),
                           torch.tensor(th), future=future))
    np.testing.assert_allclose(t, j, rtol=1e-13, atol=0)


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(11)
    return (rng.uniform(2.5, 40.0, 128), rng.uniform(0.05, np.pi - 0.05, 128),
            rng.uniform(-np.pi, np.pi, 128), rng.uniform(-1.5, 1.5, 128))


def test_spherical_cartesian_round_trip(points):
    r, th, ph, _ = points
    j = [_np(x) for x in jco.spherical_to_cartesian(r, th, ph)]
    t = [_np(x) for x in tco.spherical_to_cartesian(
        *map(torch.tensor, (r, th, ph)))]
    np.testing.assert_allclose(t, j, rtol=0, atol=TOL)
    j2 = [_np(x) for x in jco.cartesian_to_spherical(*map(jnp.asarray, j))]
    t2 = [_np(x) for x in tco.cartesian_to_spherical(*map(torch.tensor, j))]
    np.testing.assert_allclose(t2, j2, rtol=0, atol=TOL)
    np.testing.assert_allclose(t2, [r, th, ph], rtol=0, atol=TOL)


def test_rotate_x(points):
    r, th, ph, ang = points
    xyz = jco.spherical_to_cartesian(r, th, ph)
    j = [_np(x) for x in jco.rotate_x(*xyz, jnp.asarray(ang))]
    t = [_np(x) for x in tco.rotate_x(*[torch.tensor(_np(x)) for x in xyz],
                                      torch.tensor(ang))]
    np.testing.assert_allclose(t, j, rtol=0, atol=TOL)


@pytest.mark.parametrize("fn", ["contravariant_diag", "dcontravariant_dr",
                                "dcontravariant_dth"])
def test_metric(points, fn):
    r, th, _, _ = points
    j = getattr(jmet, fn)(jnp.asarray(r), jnp.asarray(th), 2.0)
    t = getattr(tmet, fn)(torch.tensor(r), torch.tensor(th), 2.0)
    j = j if isinstance(j, tuple) else (j,)
    t = t if isinstance(t, tuple) else (t,)
    for a, b in zip(t, j):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-13, atol=0)


def test_unfold_hit(points):
    r, th, ph, beta = points
    q = np.stack([np.zeros_like(r), r, th, ph], axis=-1)
    j = [_np(x) for x in jcls.unfold_hit(jnp.asarray(q), jnp.asarray(beta))]
    t = [_np(x) for x in tcls.unfold_hit(torch.tensor(q), torch.tensor(beta))]
    np.testing.assert_allclose(t, j, rtol=0, atol=TOL)


# --- the inclined look-at grid of the disk renderer ------------------------

LOOKAT_OBSERVERS = [(30.0, 0.0, 0.0),                       # equatorial
                    (25.0, 0.0, 8.0),                       # inclined
                    (29.343, 0.0, 6.237),                   # the disk camera
                    (1e-9, 0.0, 30.0),                      # polar fallback
                    (-12.0, 18.0, -9.0)]


@pytest.mark.parametrize("obs", LOOKAT_OBSERVERS)
def test_pixel_grid_lookat_matches_jax(obs):
    j = _np(jcam.pixel_grid_lookat(jnp.asarray(obs), jnp.radians(60.0), 9, 7,
                                   dtype=jnp.float64))
    t = _np(tcam.pixel_grid_lookat(obs, np.radians(60.0), 9, 7,
                                   dtype=torch.float64))
    assert t.shape == (9, 7, 3)
    np.testing.assert_allclose(t, j, rtol=0, atol=TOL)
    jf = jcam._lookat_frame(jnp.asarray(obs), jnp.radians(60.0), 9, 7,
                            jnp.float64)
    tf = tcam._lookat_frame(obs, np.radians(60.0), 9, 7, torch.float64)
    for a, b in zip(tf, jf):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=TOL)


def test_pixel_grid_lookat_is_pixel_grid_on_axis():
    """For the reference's +x observer the look-at grid is the reference
    grid (right = +y, up = +z)."""
    a = _np(tcam.pixel_grid(OBS, FOV, 7, 5, dtype=torch.float64))
    b = _np(tcam.pixel_grid_lookat(OBS, FOV, 7, 5, dtype=torch.float64))
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-13)


def test_pixel_grid_lookat_inclined_geometry():
    """The optical axis passes through the origin, the frame is orthogonal
    and +z stays up in the image."""
    obs = np.array([25.0, 0.0, 8.0])
    g = _np(tcam.pixel_grid_lookat(obs, np.radians(60.0), 9, 9,
                                   dtype=torch.float64))
    np.testing.assert_allclose(g[4, 4], obs * 0.8, atol=1e-12)
    axis = -obs / np.linalg.norm(obs)
    dr, du = g[4, 5] - g[4, 4], g[5, 4] - g[4, 4]
    assert abs(dr @ axis) < 1e-12 and abs(du @ axis) < 1e-12
    assert abs(dr @ du) < 1e-12 and du[2] > 0.0
