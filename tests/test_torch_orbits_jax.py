"""The Page-Thorne flux against the JAX package (part of
tests/test_torch_orbits.py, whose docstring states the tolerance).

At most six tests a file: pytest-xdist's --dist loadfile hands out
the files with the most tests first, so a file this small runs after
the suite's long few-test files instead of ahead of them.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.physics import orbits as jo
from grtrace_torch.physics import orbits as to
from test_torch_orbits import HOLES

torch.set_num_threads(1)


@pytest.mark.parametrize("prograde", [True, False])
@pytest.mark.parametrize("params", HOLES[:2])
def test_page_thorne_flux_matches_jax(params, prograde):
    """Autodiff derivatives (torch.func.grad under vmap against jax.grad)
    and the trapezoid integral, on a geometric grid from the ISCO (a fixed
    7 M edge for the charged hole)."""
    r0 = float(jo.isco_radius(1.0, params[1], prograde)) if not params[2] \
        else 7.0
    r = r0 * (1 + 1e-9) * (300.0 / r0) ** np.linspace(0.0, 1.0, 512)
    j = np.asarray(jo.page_thorne_flux(jnp.asarray(r), jnp.asarray(params),
                                       prograde))
    t = to.page_thorne_flux(torch.tensor(r), params, prograde).numpy()
    assert t[0] == 0.0 and j.max() > 0.0
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-12 * j.max())
    far = r > 1.05 * r0
    np.testing.assert_allclose(t[far], j[far], rtol=1e-10, atol=0)
