"""The static beyond-Kerr theory layer of the port (physics/static_metrics.py
and physics/static_orbits.py) against the JAX package, float64.

Each family at parameter 0 and at one sub-critical value, and Bardeen and
Hayward at one super-critical (horizonless) value.  Tolerances, with their
reasons:
  * f, and the closed-form f' of the static chart (static_chart.lapse,
    the arithmetic of kernel G1s, with the family constant rounded as the
    engine rounds it) against JAX's f and `jax.grad`: 1e-12 relative
    (closed form against autodiff: the same algebra, other operations;
    Bardeen's x sqrt(x) against jnp.power);
  * photon sphere, b_crit, shadow angle, the horizons, the capture radius
    and the Lyapunov exponent: 1e-12 relative (the same Newton and
    bisection counts from the same brackets; the grids are torch's
    linspace, within an ulp of jnp's);
  * the orbits (ISCO, OSCO, epicyclic frequencies, the Page-Thorne flux,
    the redshift): 1e-10 relative (a bisection on a derivative of a
    derivative, and the flux's trapezoid sum over 64 points).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.physics import static_metrics as jsm
from grtrace.physics import static_orbits as jso
from grtrace_torch.engine import integrate_generic as tig
from grtrace_torch.physics import static_chart as tsc
from grtrace_torch.physics import static_metrics as tsm
from grtrace_torch.physics import static_orbits as tso

F64 = torch.float64
SUB = {"Kottler": 1e-3, "Bardeen": 0.5, "Hayward": 0.6}
_JITTED = {}


def _j(fn, static):
    """JAX's fn jitted once, its lapse (or metric name) argument `static`
    (eager, each of its Newton and bisection steps would trace anew)."""
    key = (fn, static)
    if key not in _JITTED:
        _JITTED[key] = jax.jit(fn, static_argnums=static)
    return _JITTED[key]
CASES = [(m, 0.0) for m in SUB] + list(SUB.items())


def _close(t, j, rel):
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    assert np.array_equal(np.isnan(t), np.isnan(j))
    m = ~np.isnan(j)
    assert np.all(np.abs(t[m] - j[m]) <= rel * np.maximum(np.abs(j[m]),
                                                          1e-300)), (t, j)


@pytest.mark.parametrize("metric,param", CASES)
def test_lapse_and_closed_form_derivative(metric, param):
    """f on r in [0.3, 60] and the closed-form f' against `jax.grad`."""
    rs = np.geomspace(0.3, 60.0, 97)
    p = [1.0, param, 0.0]
    jf = np.asarray(jsm.STATIC_F[metric](jnp.asarray(rs), jnp.asarray(p)))
    tf = tsm.STATIC_F[metric](torch.tensor(rs), torch.tensor(p, dtype=F64))
    _close(tf, jf, 1e-12)
    jfp = np.asarray(jax.vmap(jax.grad(jsm.STATIC_F[metric]),
                              in_axes=(0, None))(jnp.asarray(rs),
                                                 jnp.asarray(p)))
    k, code = tig.static_constants(metric, torch.tensor(1.0, dtype=F64),
                                   torch.tensor(param, dtype=F64))
    tf2, tfp, _ = tsc.lapse(torch.tensor(rs), 1.0, float(k), int(code))
    _close(tf2, jf, 1e-12)
    _close(tfp, jfp, 1e-12)


@pytest.mark.parametrize("metric,param", CASES + [("Bardeen", 0.9),
                                                  ("Hayward", 0.9)])
def test_theory_layer(metric, param):
    """Photon sphere, b_crit, shadow angle at r_obs 30, the outer horizon
    (NaN past the critical parameter), Kottler's cosmological horizon, the
    capture radius (1.1 r_+ or the 1e-2 M floor) and the Lyapunov
    exponent."""
    jp, tp = jnp.asarray([1.0, param, 0.0]), torch.tensor([1.0, param, 0.0],
                                                          dtype=F64)
    jf, tf = jsm.STATIC_F[metric], tsm.STATIC_F[metric]
    for jfn, tfn in ((jsm.photon_sphere, tsm.photon_sphere),
                     (jsm.b_critical, tsm.b_critical),
                     (jsm.outer_horizon, tsm.outer_horizon),
                     (jsm.lyapunov_static, tsm.lyapunov_static)):
        _close(tfn(tf, tp), _j(jfn, 0)(jf, jp), 1e-12)
    _close(tsm.shadow_angle(tf, tp, 30.0),
           _j(jsm.shadow_angle, 0)(jf, jp, 30.0), 1e-12)
    _close(tsm.static_capture_radius(metric, tp),
           _j(jsm.static_capture_radius, 0)(metric, jp), 1e-12)
    alpha = np.linspace(0.05, 1.2, 7)
    _close(tsm.impact_parameter_cam(torch.tensor(alpha), tf, tp, 30.0),
           jsm.impact_parameter_cam(jnp.asarray(alpha), jf, jp, 30.0), 1e-12)
    if metric == "Kottler":
        _close(tsm.cosmological_horizon(tp),
               jax.jit(jsm.cosmological_horizon)(jp), 1e-12)
    if param == 0.9:
        assert math.isnan(float(tsm.outer_horizon(tf, tp)))
        assert float(tsm.static_capture_radius(metric, tp)) == 1e-2


@pytest.mark.parametrize("metric,param", list(SUB.items()))
def test_static_orbits(metric, param):
    """ISCO (and Kottler's OSCO), the epicyclic frequencies and QPO
    frequencies, the signed radial stability, the Page-Thorne flux and the
    static-observer redshift."""
    jp, tp = jnp.asarray([1.0, param, 0.0]), torch.tensor([1.0, param, 0.0],
                                                          dtype=F64)
    jf, tf = jsm.STATIC_F[metric], tsm.STATIC_F[metric]
    isco_j = _j(jso.isco_static, 0)(jf, jp)
    _close(tso.isco_static(tf, tp), isco_j, 1e-10)
    if metric == "Kottler":
        r_hi = 0.98 * (3.0 / param) ** (1 / 3)
        _close(tso.osco_static(tf, tp, r_hi=r_hi),
               _j(jso.osco_static, 0)(jf, jp, r_hi), 1e-10)
    r = 1.5 * float(isco_j)
    for tv, jv in zip(tso.epicyclic_static(r, tf, tp),
                      _j(jso.epicyclic_static, 1)(r, jf, jp)):
        _close(tv, jv, 1e-10)
    _close(tso.radial_stability_static(r, tf, tp),
           _j(jso.radial_stability_static, 1)(r, jf, jp), 1e-10)
    tq = tso.qpo_frequencies_static_hz(r, tf, tp, 10.0)
    jq = _j(jso.qpo_frequencies_static_hz, 1)(r, jf, jp, 10.0)
    for k in jq:
        _close(tq[k], jq[k], 1e-10)
    grid = np.geomspace(float(isco_j) * (1 + 1e-5), 14.0, 64)
    _close(tso.page_thorne_flux_static(torch.tensor(grid), tf, tp),
           _j(jso.page_thorne_flux_static, 1)(jnp.asarray(grid), jf, jp),
           1e-10)
    e, ln = np.array([1.0, 1.0, -2.0]), np.array([0.5, -3.0, 1.0])
    r_em = np.array([r, r * 1.3, r * 2.0])
    jz = jax.vmap(lambda a, b, c: jso.redshift_factor_static(
        a, b, c, 30.0, jf, jp))(jnp.asarray(e), jnp.asarray(ln),
                                jnp.asarray(r_em))
    _close(tso.redshift_factor_static(torch.tensor(e), torch.tensor(ln),
                                      torch.tensor(r_em), 30.0, tf, tp), jz,
           1e-12)
