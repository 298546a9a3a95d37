"""The moving camera's rate and the Walker-Penrose polarization of the port
against the JAX package, function by function, on seeded float64 inputs
(the boosted camera's rays are held in tests/test_torch_moving_camera_jax.py,
inside its renders).

Tolerances, with their reasons (the same closed forms in both packages;
only the summation order of the 4x4 contractions differs):
  * zamo_omega and the camera rate: atol 1e-12;
  * the KS -> BL map, Walker-Penrose constants, the field vectors and
    emission_polarization: rtol 1e-12 (atol 1e-12 near zero);
  * observer_evpa: the circular distance min(d, pi - d) of the EVPA
    (an angle mod pi) <= 1e-10, the screen-solve norm within 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace import IntegratorConfig, SceneConfig
from grtrace.engine import disk as jdisk
from grtrace.physics import orbits as jorb
from grtrace.physics import polarization as jpol
import grtrace_torch
from grtrace_torch.engine import disk as tdisk
from grtrace_torch.physics import orbits as torb
from grtrace_torch.physics import polarization as tpol

PARAMS = np.array([1.0, 0.9, 0.1])
N = 6
EL = 0.21                     # camera elevation (rad)
THETAS = (0.3, np.pi / 2)
OMEGAS = (0.0, 0.009)
BFIELDS = ("vertical", "toroidal", "radial")


def T(a):
    return torch.tensor(np.asarray(a, np.float64))


def _close(t, j, rtol=1e-12, atol=1e-12):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol,
                               atol=atol)


def _inputs():
    """Seeded float64 inputs: equatorial KS crossing events (q, covariant
    p) in the annulus, transported vectors, camera rays at an inclined
    camera and WP constants."""
    rng = np.random.default_rng(7)
    r = rng.uniform(3.0, 14.0, N)
    ph = rng.uniform(0.0, 2 * np.pi, N)
    a = PARAMS[1]
    q = np.stack([rng.uniform(-60.0, 0.0, N),
                  r * np.cos(ph) - a * np.sin(ph),
                  r * np.sin(ph) + a * np.cos(ph),
                  rng.uniform(-1e-3, 1e-3, N)], axis=-1)
    p = np.stack([rng.uniform(0.5, 1.5, N)]
                 + [rng.normal(size=N) for _ in range(3)], axis=-1)
    obs = np.array([30 * np.cos(EL), 0.0, 30 * np.sin(EL)])
    p0 = np.stack([rng.uniform(0.9, 1.1, N)]
                  + [rng.normal(size=N) * 0.3 - (1.0 if i == 0 else 0.0)
                     for i in range(3)], axis=-1)
    return {"q": q, "p": p, "f": rng.normal(size=(N, 4)),
            "u": rng.normal(size=(N, 4)), "b": rng.normal(size=(N, 4)),
            "r": np.linspace(2.5, 60.0, N), "obs": obs,
            "q0": np.tile(np.r_[0.0, obs], (N, 1)), "p0": p0,
            "kappa": rng.normal(size=(2, N)),
            "up": np.array([-np.sin(EL), 0.0, np.cos(EL)]),
            "right": np.array([0.0, 1.0, 0.0])}


def _per_point(f, *args):
    """JAX's per-event function run eagerly on each point (op by op: the
    few scalar-shaped primitives compile once and serve every function),
    stacked over the batch."""
    outs = [f(*(a[i] for a in args)) for i in range(args[0].shape[0])]
    return jax.tree_util.tree_map(lambda *v: np.stack(v), *outs)


def _jax_reference(x):
    """Every JAX value the tests compare with."""
    par = jnp.asarray(PARAMS)
    out = {}
    out["zamo"] = [_per_point(lambda r: jorb.zamo_omega(r, par, th),
                              x["r"]) for th in THETAS]
    q_bl, p_bl = _per_point(lambda a, b: jpol.bl_from_ks(a, b, par),
                            x["q"], x["p"])
    out["bl"] = (q_bl, p_bl)
    k_up = _per_point(lambda a, b: jpol.raise_bl(a, b, par), q_bl, p_bl)
    out["k_up"] = k_up
    out["wp"] = _per_point(lambda a, b, c: jpol.walker_penrose(
        a, b, c, par[1]), q_bl, k_up, x["f"])
    out["eps"] = _per_point(lambda a, b, c, d: jpol._eps_contract(
        a, b, c, d, par), q_bl, x["u"], p_bl, x["b"])
    out["ks_raise"] = _per_point(lambda a: jpol._ks_raise_matrix(a, par),
                                 x["q"])
    u_t, om = _per_point(lambda r: jorb.circular_u_t(r, par), q_bl[:, 1])
    z = np.zeros_like(u_t)
    u_up = np.stack([u_t, z, z, u_t * om], axis=-1)
    out["field"] = {bf: _per_point(lambda a, b: jpol.disk_field_b(
        a, b, par, bf), q_bl, u_up) for bf in BFIELDS}
    out["emission"] = {bf: _per_point(
        lambda a, b: jpol.emission_polarization(a, b, par, True, bf),
        q_bl, p_bl) for bf in BFIELDS}
    out["evpa"] = [_per_point(lambda k1, k2, a, b: jpol.observer_evpa(
        k1, k2, a, b, x["up"], x["right"], par, omega_obs=w),
        x["kappa"][0], x["kappa"][1], x["q0"], x["p0"]) for w in OMEGAS]
    return out


@pytest.fixture(scope="module")
def ref():
    x = _inputs()
    return x, jax.tree_util.tree_map(np.asarray, _jax_reference(x))


def test_bl_map_and_walker_penrose_match_jax(ref):
    x, j = ref
    q_bl, p_bl = tpol.bl_from_ks(T(x["q"]), T(x["p"]), T(PARAMS))
    _close(q_bl, j["bl"][0])
    _close(p_bl, j["bl"][1])
    jq, jp = (T(v) for v in j["bl"])
    _close(tpol.raise_bl(jq, jp, T(PARAMS)), j["k_up"])
    for t, jv in zip(tpol.walker_penrose(jq, T(j["k_up"]), T(x["f"]),
                                         PARAMS[1]), j["wp"]):
        _close(t, jv)
    _close(tpol._eps_contract(jq, T(x["u"]), jp, T(x["b"]), T(PARAMS)),
           j["eps"])
    _close(tpol._ks_raise_matrix(T(x["q"]), T(PARAMS)), j["ks_raise"])


@pytest.mark.parametrize("bfield", BFIELDS)
def test_emission_polarization_matches_jax(ref, bfield):
    x, j = ref
    jq, jp = (T(v) for v in j["bl"])
    u_t, om = torb.circular_u_t(jq[:, 1], T(PARAMS))
    z = torch.zeros_like(u_t)
    u_up = torch.stack([u_t, z, z, u_t * om], dim=-1)
    _close(tpol.disk_field_b(jq, u_up, T(PARAMS), bfield),
           j["field"][bfield])
    got = tpol.emission_polarization(jq, jp, T(PARAMS), True, bfield)
    for t, jv in zip(got, j["emission"][bfield]):
        _close(t, jv)


def test_observer_evpa_matches_jax(ref):
    x, j = ref
    for w, (je, jc) in zip(OMEGAS, j["evpa"]):
        te, tc = tpol.observer_evpa(
            T(x["kappa"][0]), T(x["kappa"][1]), T(x["q0"]), T(x["p0"]),
            T(x["up"]), T(x["right"]), T(PARAMS), omega_obs=w)
        d = np.abs(te.numpy() - je)
        assert np.minimum(d, np.pi - d).max() <= 1e-10
        assert ((te >= 0) & (te < np.pi)).all()
        _close(tc, jc, rtol=0)


def test_camera_rate_matches_jax(ref):
    """zamo_omega, and the camera rate ('keplerian', 'zamo', a float) in
    float64 on the host, 'zamo' equal to its explicit value, and a
    superluminal rate refused by both packages."""
    x, j = ref
    for th, jz in zip(THETAS, j["zamo"]):
        _close(torb.zamo_omega(T(x["r"]), T(PARAMS), th), jz, rtol=0)
    scene = SceneConfig(size=4, metric="kerr", spin=0.9, n_samples=0,
                        integrator=IntegratorConfig(dtype="float64"))
    tscene = grtrace_torch.from_jax_scene(scene)
    for spec in ("keplerian", "zamo", 0.0, -0.004):
        dc = jdisk.DiskConfig(camera_omega=spec)
        jm, jw = jdisk.resolve_camera_omega(scene, dc)
        tm, tw = tdisk.resolve_camera_omega(tscene,
                                            grtrace_torch.from_jax_disk(dc))
        assert tm is jm is True
        assert abs(tw - jw) <= 1e-15
    zamo = tdisk.resolve_camera_omega(tscene, tdisk.DiskConfig(
        camera_omega="zamo"))[1]
    assert tdisk.resolve_camera_omega(tscene, tdisk.DiskConfig(
        camera_omega=zamo)) == (True, zamo)
    assert tdisk.resolve_camera_omega(tscene, tdisk.DiskConfig()) == \
        (False, 0.0)
    for mod in (jdisk, tdisk):
        with pytest.raises(ValueError, match="superluminal"):
            s = scene if mod is jdisk else tscene
            mod.resolve_camera_omega(s, mod.DiskConfig(camera_omega=0.5))
