"""The port's photon-shell theory (physics/photon_shell.py), its KS -> BL
time offsets (engine/hotspot.py) and its copy of the spectrum module
against the JAX package, in float64 on the CPU.

* For a = 0.5 and 0.9, JAX's `critical_curve_observables` runs once per
  spin under one `jax.jit` (its many fori_loops, compiled one by one,
  would cost minutes), with its own `shell_visible_range` and
  `polar_shell_radius` results recorded on the way; the port computes the
  same three.  The curve's gamma, delta_t, delta_phi, xi and eta at JAX's
  radii are `critical_parameters` there, so the port's
  `critical_parameters` is held to them at those radii.  Tolerance 1e-10
  relative (measured up to 3e-12: both bisect the same brackets 60 times
  and integrate the same 64-node quadrature; the sums run in another
  order); beta = sqrt(Theta) goes to 0 at the curve's ends, so it is held
  to 1e-10 absolute.
* a = 0: the spherical branch (the photon sphere and its constant
  triple), with gamma = pi within 1e-6 and delta_t = pi sqrt(27) M within
  1e-5, as tests/test_subring.py holds the JAX CLI's theory block.  The
  shell is one sphere there, so polar_shell_radius and shell_visible_range
  have no range to find and are compared at a != 0 only.
* bl_time_azimuth_offsets within 1e-13 relative; engine/spectrum.py is a
  copy of numpy code, so its outputs are compared bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.engine import hotspot as jhs
from grtrace.engine import spectrum as jspec
from grtrace.physics import photon_shell as jps
from grtrace_torch.engine import hotspot as ths
from grtrace_torch.engine import spectrum as tspec
from grtrace_torch.physics import photon_shell as tps

torch.set_num_threads(1)

THETA_OBS = 0.26     # radians from the spin axis (the subring CLI: 75 deg)
N_CURVE = 4
SPINS = (0.0, 0.5, 0.9)


def _recording(module, names, seen):
    """Context that wraps module.<name> for each name so that its first
    result is kept in seen[name]."""
    mp = pytest.MonkeyPatch()
    for name in names:
        fn = getattr(module, name)
        mp.setattr(module, name,
                   lambda *a, _fn=fn, _n=name, **k:
                   seen.setdefault(_n, _fn(*a, **k)))
    return mp


def _jax_curve(spin):
    """JAX's curve, visible range and polar radius at one spin, one jit."""
    params = np.array([1.0, spin, 0.0])

    def run(theta):
        seen = {}
        mp = _recording(jps, ("shell_visible_range", "polar_shell_radius"),
                        seen)
        try:
            curve = jps.critical_curve_observables(params, theta, n=N_CURVE)
        finally:
            mp.undo()
        return curve, seen.get("shell_visible_range"), \
            seen.get("polar_shell_radius")

    curve, vis, polar = jax.jit(run)(jnp.float64(THETA_OBS))
    out = {k: np.asarray(v) for k, v in curve.items()}
    return out, (None if vis is None else tuple(map(float, vis))), \
        (None if polar is None else float(polar))


def _port_curve(spin):
    params = (1.0, spin, 0.0)
    seen = {}
    mp = _recording(tps, ("shell_visible_range", "polar_shell_radius"), seen)
    try:
        curve = tps.critical_curve_observables(params, THETA_OBS, n=N_CURVE)
    finally:
        mp.undo()
    out = {k: v.numpy() for k, v in curve.items()}
    vis = seen.get("shell_visible_range")
    polar = seen.get("polar_shell_radius")
    return out, (None if vis is None else tuple(map(float, vis))), \
        (None if polar is None else float(polar))


@pytest.fixture(scope="module")
def curves():
    return {a: (_jax_curve(a), _port_curve(a)) for a in SPINS}


@pytest.mark.parametrize("spin", SPINS)
def test_critical_curve_matches_jax(curves, spin):
    (j, _, _), (t, _, _) = curves[spin]
    assert set(t) == set(j)
    for k in j:
        if k == "beta":
            np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-10)
        else:
            np.testing.assert_allclose(t[k], j[k], rtol=1e-10, atol=1e-12,
                                       err_msg=k)


@pytest.mark.parametrize("spin", SPINS)
def test_critical_parameters_match_jax(curves, spin):
    (j, _, _), _ = curves[spin]
    params = (1.0, spin, 0.0)
    for i in range(N_CURVE):
        out = tps.critical_parameters(torch.tensor(j["r"][i],
                                                   dtype=torch.float64),
                                      params)
        got = [float(x) for x in out]
        want = [j[k][i] for k in ("gamma", "delta_t", "delta_phi", "xi",
                                  "eta")]
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("spin", [0.5, 0.9])
def test_polar_radius_and_visible_range_match_jax(curves, spin):
    (_, j_vis, j_polar), (_, t_vis, t_polar) = curves[spin]
    assert t_polar == pytest.approx(j_polar, rel=1e-10)
    np.testing.assert_allclose(t_vis, j_vis, rtol=1e-10)
    assert t_vis[0] < t_polar < t_vis[1]
    # called on its own, as the port's users call it
    assert float(tps.polar_shell_radius((1.0, spin, 0.0))) == t_polar


def test_schwarzschild_triple(curves):
    (_, _, _), (t, vis, polar) = curves[0.0]
    assert vis is None and polar is None      # the spherical branch
    assert np.abs(t["gamma"] - np.pi).max() < 1e-6
    assert np.abs(t["delta_t"] - np.pi * np.sqrt(27.0)).max() < 1e-5
    assert np.abs(t["r"] - 3.0).max() < 1e-9
    rho = np.hypot(t["alpha"], t["beta"])
    assert np.abs(rho - np.sqrt(27.0)).max() < 1e-8


@pytest.mark.parametrize("params", [(1.0, 0.9, 0.0), (1.0, 0.6, 0.5),
                                    (1.0, 0.0, 0.0), (2.0, -0.7, 0.3)])
def test_bl_time_azimuth_offsets_match_jax(params):
    r = np.linspace(1.02 * (params[0] + np.sqrt(params[0] ** 2
                                                - params[1] ** 2
                                                - params[2] ** 2)),
                    60.0, 97)
    jt, jp = jhs.bl_time_azimuth_offsets(jnp.asarray(r), jnp.asarray(params))
    tt, tp = ths.bl_time_azimuth_offsets(torch.tensor(r), params)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-13,
                               atol=1e-13)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-13,
                               atol=1e-13)


def test_spectrum_is_the_same_numpy_code():
    rng = np.random.default_rng(7)
    inten = rng.uniform(0.0, 1.0, (3, 9, 11))
    inten[:, :2] = 0.0                        # off-disk pixels
    for x in (inten, inten[0]):
        jn, js = jspec.disk_sed(x, 9000.0)
        tn, ts = tspec.disk_sed(x, 9000.0)
        assert np.array_equal(tn, jn) and np.array_equal(ts, js)
    grid = tspec.default_nu_grid(6500.0, n=33)
    assert np.array_equal(grid, jspec.default_nu_grid(6500.0, n=33))
    assert np.array_equal(tspec.spectral_cube(inten, 7000.0, grid),
                          jspec.spectral_cube(inten, 7000.0, grid))
    assert np.array_equal(tspec.planck_nu(grid, 0.0),
                          jspec.planck_nu(grid, 0.0))
    assert not tspec.planck_nu(grid, 0.0).any()
