"""The escape-predicate fault that both packages share (ROADMAP Queue C)
and the Schwarzschild shadow error through the integrators against JAX's
(part of tests/test_torch_integrate_schw.py).

At most six tests a file: pytest-xdist's --dist loadfile hands out
the files with the most tests first, so a file this small runs after
the suite's long few-test files instead of ahead of them.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.engine import integrate as ji
from grtrace.engine import validate as jv
from grtrace_torch.engine import integrate as ti
from grtrace_torch.engine import validate as tv
from grtrace_torch.physics.camera import angles_to_p_sph
from grtrace_torch.physics.nullcond import null_p_t
from test_torch_integrate_schw import _np

torch.set_num_threads(1)


def _fault_rays():
    """Three launch states at r0 = 30 on the equator with b = |p_phi / p_t|
    = 2.49, 9.49 and 16.64, and the same rays turned into the polar plane
    (p_theta <- p_phi, p_phi <- 0)."""
    r0 = torch.tensor(30.0, dtype=torch.float64)
    f = 1.0 - 2.0 / 30.0
    b = np.array([2.49, 9.49, 16.64])
    alpha = torch.tensor(np.arcsin(b * np.sqrt(f) / 30.0))
    p_sp = angles_to_p_sph(alpha, 0.0, r0)
    p_t = null_p_t(p_sp, r0, torch.tensor(math.pi / 2, dtype=torch.float64))
    q0 = np.tile([0.0, 30.0, np.pi / 2, 0.0], (3, 1))
    p0 = torch.cat([p_t[:, None], p_sp], dim=-1).numpy()
    polar = p0.copy()
    polar[:, 2], polar[:, 3] = p0[:, 3], 0.0
    return q0, p0, polar


def test_escape_predicate_fault_is_shared():
    """schw_true_escape_pred takes b = |p_phi / p_t|, the z-part of the
    angular momentum only: turned into the polar plane, the same three rays
    take the same steps, but the rescue turns the two true escapes into
    captures parked at r = rs.  Both packages do so; the port keeps the
    reference behaviour."""
    q0, p0, polar = _fault_rays()
    args = (1500, 0.05, 2.0, 31.0, 1.0)
    out = {}
    for name, p in (("equatorial", p0), ("polar", polar)):
        j = _np(ji.integrate_batch(jnp.asarray(q0), jnp.asarray(p), *args))
        t = _np(ti.integrate_batch(torch.tensor(q0), torch.tensor(p), *args))
        assert np.array_equal(t[2], j[2]) and np.array_equal(t[3], j[3])
        out[name] = t
    eq, po = out["equatorial"], out["polar"]
    assert eq[2].tolist() == [1, 2, 2]
    assert po[2].tolist() == [1, 1, 1]
    assert np.array_equal(eq[3], po[3])
    assert (po[0][:, 1] == 2.0).all()


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.float64, jnp.float64)])
def test_shadow_error_through_the_integrators_matches_jax(dtype, jdtype):
    """The whole check with real integration on the CPU (B1's twin for
    float32, the 16-row integrate_batch for float64; the JAX package's XLA
    path beside it) at a short budget that every bisection ray finishes
    in: the same boundary per azimuth and the same error, which stays
    inside 0.01 px of the closed form."""
    port = tv.schwarzschild_shadow_error(steps=1500, delta=0.1,
                                         backend="torch", dtype=dtype,
                                         device="cpu")
    ref = jv.schwarzschild_shadow_error(steps=1500, delta=0.1,
                                        backend="xla", dtype=jdtype)
    assert port["rho_num"] == ref["rho_num"]
    assert port["bracket_px"] == ref["bracket_px"]
    assert port["px_err"] == pytest.approx(ref["px_err"], abs=1e-12)
    assert port["px_err"] < 0.01
