"""The generic engine's host pieces against the JAX package: the
closed-form Boyer-Lindquist flows (physics/kerr_bl.py), the autodiff flows
(`spacetime.make_flows` through torch.func), the unfolded camera, the
Boyer-Lindquist Bardeen predicate and rescue, the engine's scalars and
tables, and the routing of engine/integrate_generic.py.

Tolerances, with their reasons (float64):
  * the closed-form kick and drift against `jax.grad` of
    `grtrace.physics.spacetime.hamiltonian` with `kerr_g_inv`, and against
    the port's own torch.func gradient: 1e-12 relative, component by
    component.  The closed form is the same algebra as the autodiff graph
    but not the same operations, so they differ at roundoff; the radial
    kick cancels its large terms, which leaves it the worst (measured
    6.6e-13 in the bulk, 4.1e-13 within 1e-3 of 1.1 r_+, 1.8e-15 at
    sin theta < 1e-2: the poles and the capture shell need no looser
    tolerance, ROADMAP Queue C);
  * the unfolded camera: 1e-12 (the same formulas, last-ulp rounding);
  * the predicate and the rescue: exact.
The integrators against JAX are in tests/test_torch_generic_jax.py; the
kernels' source, built for the CPU, against the twins in
tests/test_torch_gen_host.py.
"""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.engine import integrate_generic as jig
from grtrace.engine import integrate_ks as jks
from grtrace.physics import camera as jcam
from grtrace.physics import spacetime as jsp
from grtrace_torch.engine import integrate_cuda as tc
from grtrace_torch.engine import integrate_generic as tig
from grtrace_torch.engine import integrate_generic_cuda as tigc
from grtrace_torch.engine import integrate_ks as tks
from grtrace_torch.kernels import build as tbuild
from grtrace_torch.physics import camera as tcam
from grtrace_torch.physics import kerr_bl
from grtrace_torch.physics import kerr_schild as tksf
from grtrace_torch.physics import spacetime as tsp
from grtrace_torch.physics.hamiltonian import pack_state

torch.set_num_threads(1)

PARAMS = (1.0, 0.9, 0.3)
R_PLUS = 1.0 + np.sqrt(1.0 - 0.81 - 0.09)
# (r, theta) regions: the bulk, the poles, the capture shell
REGIONS = {"bulk": ((1.2 * R_PLUS, 40.0), (0.05, np.pi - 0.05)),
           "pole": ((2.0, 30.0), (1e-4, 1e-2)),
           "shell": ((1.1 * R_PLUS * (1 - 1e-3), 1.1 * R_PLUS * (1 + 1e-3)),
                     (0.1, 3.0))}


def _points(region, n=150, seed=0):
    """Random phase points (n, 4) q and p in a region, numpy float64."""
    rng = np.random.default_rng(seed)
    (r0, r1), (t0, t1) = REGIONS[region]
    q = np.stack([rng.uniform(-5, 5, n), rng.uniform(r0, r1, n),
                  rng.uniform(t0, t1, n), rng.uniform(0, 6, n)], 1)
    p = rng.normal(size=(n, 4)) * np.array([1.0, 1.0, 5.0, 5.0])
    return q, p


def _jax_grads(q, p, g_inv_fn):
    # jitted: JAX's eager dispatch compiles every primitive on first use
    grads = [jax.jit(jax.vmap(jax.grad(jsp.hamiltonian, argnums=k),
                              in_axes=(0, 0, None, None)), static_argnums=3)
             for k in (0, 1)]
    return [np.asarray(g(jnp.asarray(q), jnp.asarray(p),
                         jnp.asarray(PARAMS), g_inv_fn)) for g in grads]


def _closed_form(q, p):
    t = [torch.tensor(x) for x in (q[:, 1], q[:, 2], *p.T)]
    k_r, k_th, *drift = kerr_bl._kick_drift(*t, *PARAMS)
    zero = torch.zeros_like(k_r)
    return (torch.stack([zero, k_r, k_th, zero], 1).numpy(),
            torch.stack(drift, 1).numpy())


def test_bl_kick_drift_match_autodiff():
    """dH/dq and dH/dp in closed form against jax.grad and against the
    port's torch.func gradient, 1e-12 relative per component, in the
    bulk, at the poles and at the capture shell; the kick on p_t and
    p_phi is exactly 0 in all three."""
    q, p = (np.concatenate(x) for x in zip(*(_points(r) for r in REGIONS)))
    jk, jd = _jax_grads(q, p, jsp.kerr_g_inv)
    grads = [torch.func.vmap(torch.func.grad(tsp.hamiltonian, argnums=k),
                             in_dims=(0, 0, None, None)) for k in (0, 1)]
    tk, td = [g(torch.tensor(q), torch.tensor(p),
                torch.tensor(PARAMS, dtype=torch.float64),
                tsp.kerr_g_inv).numpy() for g in grads]
    ck, cd = _closed_form(q, p)
    for ref_k, ref_d in ((jk, jd), (tk, td)):
        assert not ref_k[:, [0, 3]].any()
        np.testing.assert_allclose(ck, ref_k, rtol=1e-12, atol=0)
        np.testing.assert_allclose(cd, ref_d, rtol=1e-12, atol=0)


@pytest.mark.parametrize("metric", ["Kerr", "KerrSchild"])
def test_closed_form_step_matches_make_step(metric):
    """One composed step of the closed-form flows (the engine's
    `make_generic_step`, guard included: no ray trips it here) against
    the port's torch.func `make_step`, 1e-12, at 16 camera rays of each
    chart (the flows themselves are held against jax.grad above)."""
    q0, p0 = _camera(metric, 4)
    vec = tig.gen_params(metric, 0.1, PARAMS, 31.0, 1.0, 2, torch.float64)
    _, opening, step = tig.make_generic_step(metric, vec)
    state = pack_state(torch.tensor(q0), torch.tensor(p0))
    bad, new, _ = step(state, opening(state))
    assert not bad.any()
    _, subs = tig.split_params(vec)
    t = [torch.tensor(x) for x in (q0, p0, q0, p0)]
    auto = tsp.make_step(tsp.METRICS[metric])(
        *t, torch.tensor(PARAMS, dtype=torch.float64), subs)
    np.testing.assert_allclose(torch.stack(new, 1).numpy(),
                               torch.cat(auto, 1).numpy(), rtol=1e-12,
                               atol=1e-12)


def _camera(metric, n, spin=0.9, charge=0.3):
    """The n x n camera of the chart as numpy (n^2, 4) q0, p0 (JAX's)."""
    q0, p0, _ = _jax_camera(metric, n, spin, charge)
    return (np.asarray(q0).reshape(-1, 4), np.asarray(p0).reshape(-1, 4))


def _jax_camera(metric, n, spin, charge, width=None):
    """JAX's camera of the chart (jitted), (n, width or n, 4) arrays."""
    cam = (jcam.camera_rays_cartesian if metric == "KerrSchild"
           else jcam.camera_rays_unfolded)
    return jax.jit(lambda obs, params: cam(
        obs, jnp.radians(80.0), n, width or n, params=params,
        g_inv_fn=jsp.METRICS[metric], dtype=jnp.float64))(
            jnp.array([30.0, 0.0, 0.0]), jnp.asarray([1.0, spin, charge]))


@pytest.mark.parametrize("spin,charge", [(0.9, 0.0), (0.5, 0.3)])
def test_unfolded_camera_matches_jax(spin, charge):
    params = [1.0, spin, charge]
    jq, jp, ja = _jax_camera("Kerr", 12, spin, charge, width=10)
    tq, tp, ta = tcam.camera_rays_unfolded(
        torch.tensor([30.0, 0.0, 0.0], dtype=torch.float64),
        torch.tensor(np.radians(80.0), dtype=torch.float64), 12, 10,
        params=params, g_inv_fn=tsp.kerr_g_inv, dtype=torch.float64)
    for t, j in ((tq, jq), (tp, jp), (ta, ja)):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12,
                                   atol=1e-12)
    # p_t closes the null condition, frame-dragging term included
    h = torch.func.vmap(tsp.hamiltonian, in_dims=(0, 0, None, None))(
        tq.reshape(-1, 4), tp.reshape(-1, 4),
        torch.tensor(params, dtype=torch.float64), tsp.kerr_g_inv)
    assert float(h.abs().max()) < 1e-12


@pytest.mark.parametrize("metric", ["Schwarzschild", "Kerr"])
def test_null_covector_matches_jax(metric):
    """`build_null_4momentum` and both roots of `null_p_t` against JAX's,
    with the metric tables' spherical-chart entries, 1e-12."""
    rng = np.random.default_rng(5)
    pos = np.stack([rng.uniform(3, 30, 32), rng.uniform(0.2, 2.9, 32),
                    rng.uniform(0, 6, 32)], 1)
    p_sp = rng.normal(size=(32, 3))
    params = PARAMS if metric == "Kerr" else (1.0, 0.0, 0.0)
    jfn = jax.jit(jax.vmap(lambda p, x, fut: jsp.build_null_4momentum(
        p, x, jnp.asarray(params), jsp.METRICS[metric], future=fut),
        in_axes=(0, 0, None)), static_argnums=2)
    for future in (True, False):
        t = tsp.build_null_4momentum(
            torch.tensor(p_sp), torch.tensor(pos),
            torch.tensor(params, dtype=torch.float64), tsp.METRICS[metric],
            future=future)
        np.testing.assert_allclose(t.numpy(), np.asarray(jfn(
            jnp.asarray(p_sp), jnp.asarray(pos), future)), rtol=1e-12,
            atol=1e-12)


def test_bardeen_pred_and_rescue_bl_match_jax():
    """The predicate on the camera's rays, and the rescue of a mix of
    parked (negative counts) and unparked rays, exactly."""
    q0, p0 = _camera("Kerr", 12)
    mass, a, charge = PARAMS
    jpred = np.asarray(jax.jit(jks.bardeen_escape_pred_bl)(
        jnp.asarray(q0), jnp.asarray(p0), mass, a, charge))
    tpred = tks.bardeen_escape_pred_bl(torch.tensor(q0), torch.tensor(p0),
                                       mass, a, charge)
    assert np.array_equal(tpred.numpy(), jpred) and 0 < jpred.sum() < 144
    rng = np.random.default_rng(3)
    fq = q0 + rng.normal(size=q0.shape)
    fq[:, 1] = rng.uniform(1.0, 40.0, len(fq))
    fp = p0 + rng.normal(size=p0.shape)
    q2 = q0 + rng.normal(size=q0.shape)
    ns = rng.integers(1, 500, len(fq)) * rng.choice([-1, 1], len(fq))
    r_cap, r_max = 1.1 * R_PLUS, 31.0
    j = jax.jit(jks.apply_bardeen_rescue_bl)(
        *(jnp.asarray(x) for x in (fq, fp, ns.astype(np.int32), q2, q0,
                                   p0)), mass, a, charge, r_cap, r_max)
    t = tks.apply_bardeen_rescue_bl(
        *(torch.tensor(x) for x in (fq, fp, ns.astype(np.int32), q2, q0,
                                    p0)), mass, a, charge, r_cap, r_max)
    for tx, jx in zip(t, j):
        assert np.array_equal(tx.numpy(), np.asarray(jx))
    assert set(np.asarray(j[2]).tolist()) == {0, 1, 2}


@pytest.mark.parametrize("metric", ["Kerr", "KerrSchild"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gen_params_match_the_jax_domain(metric, dtype):
    """The scalar vector rounds each radius as JAX's `_domain_tools`
    does, in the rays' dtype; the substeps are the schedule's."""
    from grtrace.physics.hamiltonian import substep_schedule as jsubs
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    params = jnp.asarray(PARAMS, jdt)
    vec = tig.gen_params(metric, 0.02, PARAMS, 31.0, 1.0, 4, dtype)
    assert vec.dtype == dtype and vec.numel() == tig.N_SCAL + 3 * 3
    (mass, a, charge, r_cap, r_max, r_plus, plunge, jump, cap_park,
     err_park), subs = tig.split_params(vec)
    assert (mass, a, charge, r_max) == tuple(
        float(jdt(x)) for x in PARAMS + (31.0,))
    jr_cap = jnp.asarray(jig._capture_radius(metric, params), jdt)
    assert r_cap == float(jr_cap)
    ks = metric == "KerrSchild"
    assert r_plus == float(jr_cap / (1.05 if ks else 1.1))
    assert cap_park == float((0.5 if ks else 0.99) * jr_cap)
    assert err_park == 150.0
    if ks:
        jz = 2.0 * params[0] * (1.0 + jnp.cos((2.0 / 3.0) * jnp.arccos(
            jnp.abs(params[1]) / params[0])))
        assert abs(plunge - float(jz)) <= 2 * float(jnp.finfo(jdt).eps)
    else:
        assert plunge == float(jr_cap + 0.5 * params[0])
        assert jump == 5.0
    js = jsubs(jdt(0.02), jdt(1.0), 4)
    assert subs == tuple(tuple(float(x) for x in s) for s in js)


def test_metric_tables_and_capture_radius():
    """METRICS / COORDS hold Schwarzschild, Kerr, KerrSchild, the static
    and the rotating regular families and Kerr-de Sitter, unknown names
    KeyError; the capture radii equal JAX's (the static and rotating
    families' and Kerr-de Sitter's within 1e-12 relative: one float64
    bisection each)."""
    for name in ("Kottler", "Bardeen", "Hayward"):
        assert tsp.COORDS[name] == jsp.COORDS[name]
        for p in ((1.0, 1e-3 if name == "Kottler" else 0.5),
                  (1.0, 0.0)):
            j = float(jig._capture_radius(name, jnp.asarray(p)))
            t = float(tig._capture_radius(name, torch.tensor(
                p, dtype=torch.float64)))
            assert abs(t - j) <= 1e-12 * j
    for name in ("Schwarzschild", "Kerr", "KerrSchild"):
        assert tsp.COORDS[name] == jsp.COORDS[name]
        p = PARAMS if name != "Schwarzschild" else (1.0,)
        j = float(jig._capture_radius(name, jnp.asarray(p)))
        t = float(tig._capture_radius(name, torch.tensor(
            p, dtype=torch.float64)))
        assert t == j
    assert float(tsp.horizon_radius("Schwarzschild", 1.5)) == 3.0
    for name in ("RotatingBardeen", "RotatingHayward"):
        assert tsp.COORDS[name] == jsp.COORDS[name] == "cartesian"
        for p in ((1.0, 0.9, 0.2), (1.0, 0.6, 0.75)):
            j = float(jig._capture_radius(name, jnp.asarray(p)))
            t = float(tig._capture_radius(name, torch.tensor(
                p, dtype=torch.float64)))
            assert abs(t - j) <= 1e-12 * j
    assert tsp.COORDS["KerrDS"] == jsp.COORDS["KerrDS"] == "spherical"
    for p in ((1.0, 0.8, 1e-3), (1.0, 0.5, 0.0)):
        j = float(jax.jit(lambda x: jig._capture_radius("KerrDS", x))(
            jnp.asarray(p)))
        t = float(tig._capture_radius("KerrDS", torch.tensor(
            p, dtype=torch.float64)))
        assert abs(t - j) <= 1e-12 * j
    with pytest.raises(KeyError):
        tsp.COORDS["Minkowski"]
    with pytest.raises(NotImplementedError, match="Kerr-Newman charts"):
        tig.gen_params("Schwarzschild", 0.1, (1.0,), 31.0, 1.0, 2,
                       torch.float64)


def test_dispatch_routes(monkeypatch):
    """CPU rays take the twins; backend 'cuda' sends the frame to G1 (its
    wrapper refuses CPU tensors: no fallback); the Kerr-Schild frame goes
    to integrate_dispatch_ks; an unknown backend raises, and the sampler
    raises for any device but CUDA (S2) and the CPU (its twin)."""
    q0, p0 = (torch.tensor(x) for x in _camera("Kerr", 2))
    args = (10, 0.1, PARAMS, 31.0, 1.0)
    calls = []
    for mod, name in ((tigc, "integrate_batch_generic_cuda"),
                      (tigc, "trajectory_batch_decimated_cuda"),
                      (tig, "integrate_dispatch_ks")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **k:
                            calls.append(_n))
    tig.integrate_dispatch_generic(q0, p0, *args)
    tig.trajectory_dispatch_generic(q0, p0, *args, n_keep=4)
    assert calls == []
    tig.integrate_dispatch_generic(q0, p0, *args, metric="KerrSchild")
    tig.integrate_dispatch_generic(q0, p0, *args, backend="cuda")
    assert calls == ["integrate_dispatch_ks", "integrate_batch_generic_cuda"]
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA tensor"):
        tig.integrate_dispatch_generic(q0, p0, *args, backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        tig.integrate_dispatch_generic(q0, p0, *args, backend="pallas")
    with pytest.raises(ValueError, match="no trajectory sampler"):
        tig.trajectory_dispatch_generic(q0.to("meta"), p0.to("meta"), *args)


def test_gen_entries_registered():
    """G1, S2 and T2's entries, and those of their static-chart modes G1s,
    S2s, T2s and of D1, of the mass-function chart's G1r, S2r, T2r and
    D2, and of the Carter chart's G1d, S2d, T2d and D3, are built from
    fantasy_gen.cu: G1, G1s, G1r and G1d take (q0, p0, out, ns, params,
    n, n_sub, steps, stream), S2, S2s, S2r and S2d the trajectory
    signature, T2, T2s, T2r and T2d the trace one (q0, p0, out, params, n,
    n_sub, steps, stream), D1, D2 and D3 (q0, p0, disk, out, ns, hit,
    params, n, n_sub, steps, stream; D2's and D3's disk null); so are
    T1's from fantasy_schw16.cu."""
    p, i = ctypes.c_void_p, ctypes.c_int
    names = tbuild.ENTRIES["fantasy_gen"]
    assert set(names) == {tigc.entry(mode, chart, dt)
                          for mode, chart in tigc.KERNELS
                          for dt in (torch.float32, torch.float64)}
    assert len(names) == 2 * len(tigc.KERNELS) == 32
    for mode, metric, chart in (("gen", "Kerr", "bl"),
                                ("traj", "KerrSchild", "ks"),
                                ("trace", "Hayward", "static"),
                                ("disk", "RotatingHayward", "rot"),
                                ("gen", "KerrDS", "kds"),
                                ("disk", "KerrDS", "kds")):
        assert tigc.chart_of(mode, metric) == chart
    with pytest.raises(ValueError, match="no gen kernel"):
        tigc.chart_of("gen", "KerrSchild")
    src = (tbuild.CSRC_DIR / "fantasy_gen.cu").read_text()
    for name in names:
        assert f"{name}" in src
        if "_disk_" in name:
            want = [p] * 7 + [i] * 3 + [p]
        elif "_trace_" in name:
            want = [p] * 4 + [i] * 3 + [p]
        else:
            want = [p] * 5 + [i] * (5 if "_traj_" in name else 3) + [p]
        assert tbuild.argtypes(name) == want
    src = (tbuild.CSRC_DIR / "fantasy_schw16.cu").read_text()
    for name in tc.TRACE_ENTRIES.values():
        assert name in tbuild.ENTRIES["fantasy_schw16"]
        assert f'extern "C" int {name}(' in src
        assert tbuild.argtypes(name) == [p] * 4 + [i] * 3 + [p]


def test_ks_flows_match_make_flows():
    """The Kerr-Schild closed-form flow A and flow B that S2 runs
    unstaggered, against the port's torch.func flows, 1e-12."""
    q0, p0 = _camera("KerrSchild", 6)
    state = pack_state(torch.tensor(q0), torch.tensor(p0 * 1.3))
    fa, fb, _ = tsp.make_flows(tsp.kerr_schild_g_inv)
    params = torch.tensor(PARAMS, dtype=torch.float64)
    for closed, auto in ((tksf._flow_a_ks, fa), (tksf._flow_b_ks, fb)):
        got = torch.stack(closed(state, 0.05, *PARAMS), 1)
        want = torch.func.vmap(auto, in_dims=(0, 0, 0, 0, None, None))(
            *(torch.stack(state[4 * k:4 * k + 4], 1) for k in range(4)),
            0.05, params)
        np.testing.assert_allclose(got.numpy(), torch.cat(want, 1).numpy(),
                                   rtol=1e-12, atol=1e-13)
