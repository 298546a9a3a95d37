"""The compensated twin at the full 200k-step headline budget against the
float64 oracle golden, the compensated float64 layout against the plain
one, SchwarzschildIntegrator against JAX's, and the CPU float32 dispatch
(part of tests/test_torch_integrate.py).

At most six tests a file: pytest-xdist's --dist loadfile hands out
the files with the most tests first, so a file this small runs after
the suite's long few-test files instead of ahead of them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.engine import integrate as ji
from grtrace_torch.engine import integrate as ti
from test_torch_integrate import ARGS, _ics, _np, golden, probes_f32

torch.set_num_threads(1)


def test_compensated_twin_meets_oracle_at_headline_budget(golden, probes_f32):
    """The kernel's arithmetic at the full 200k-step budget: every probe
    escapes at the oracle's step, escape directions within 1e-5 (median
    2e-6), theta within 1e-6 — test_f32_accuracy.py's bounds."""
    g = golden
    q0, p0 = probes_f32
    fq, fp, st, ns = _np(ti.integrate_batch_compensated(
        torch.tensor(q0), torch.tensor(p0), int(g["steps"]),
        float(g["delta"]), 2.0 * float(g["mass"]), float(g["rmax"]),
        float(g["omega"])))
    oq = g["final_q"]
    dth = np.abs(fq[:, 2] - oq[:, 2])
    dph = np.abs((fq[:, 3] - oq[:, 3] + np.pi) % (2 * np.pi) - np.pi)
    assert (st == ti.STATUS_ESCAPED).all()
    assert np.array_equal(ns, g["n_steps"])
    assert dph.max() < 1e-5, f"max dphi {dph.max():.2e}"
    assert np.median(dph) < 2e-6
    assert dth.max() < 1e-6


def test_compensated_f64_matches_plain_f64():
    """Compensation changes rounding, not physics: in float64 the
    compensated twin tracks the plain 16-row integrator on weak-field
    rays (impact parameters ~9..14)."""
    from grtrace_torch.physics.camera import angles_to_p_sph
    from grtrace_torch.physics.nullcond import null_p_t
    r0 = torch.tensor(30.0, dtype=torch.float64)
    alpha = torch.tensor(np.linspace(0.3, 0.5, 16))
    p_sp = angles_to_p_sph(alpha, 0.0, r0)
    p_t = null_p_t(p_sp, r0, torch.tensor(np.pi / 2, dtype=torch.float64))
    q0 = torch.tensor(np.tile([0.0, 30.0, np.pi / 2, 0.0], (16, 1)))
    p0 = torch.cat([p_t[:, None], p_sp], dim=-1)
    args = (4000, 0.05, 2.0, 31.0, 1.0)
    qc, _, sc, _ = ti.integrate_batch_compensated(q0, p0, *args)
    qp, _, sp, _ = ti.integrate_batch(q0, p0, *args)
    assert torch.equal(sc, sp)
    np.testing.assert_allclose(qc.numpy(), qp.numpy(), rtol=1e-12, atol=1e-12)


def test_schwarzschild_integrator_matches_jax():
    q0, p0 = _ics(6)
    kw = dict(steps=800, delta=0.05, mass=1.0, omega=1.0, r_max=31.0)
    j = _np(ji.SchwarzschildIntegrator(**kw, dtype=jnp.float64)
            .integrate_batch(q0, p0))
    t = _np(ti.SchwarzschildIntegrator(**kw, dtype=torch.float64,
                                       device="cpu").integrate_batch(q0, p0))
    assert np.array_equal(t[2], j[2]) and np.array_equal(t[3], j[3])
    # backend 'cuda' is kernel B3, which refuses CPU rays: no fallback
    with pytest.raises(ValueError, match="CUDA"):
        ti.SchwarzschildIntegrator(**kw, backend="cuda", dtype=torch.float64,
                                   device="cpu").integrate_batch(q0, p0)


def test_dispatch_cpu_float32_is_the_twin():
    q0, p0 = map(torch.tensor, _ics(6, jnp.float32))
    a = ti.integrate_dispatch(q0, p0, *ARGS, equatorial=True)
    b = ti.integrate_batch_compensated(q0, p0, *ARGS)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
