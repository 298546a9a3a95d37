"""The generic engine against the JAX package (part of
tests/test_torch_kerr_bl.py, which holds its host pieces): the
Boyer-Lindquist integrator's twin (kernel G1's) against
`integrate_batch_generic(metric='Kerr')`, the trajectory sampler's twin
(kernel S2's) against `trajectory_batch_decimated` in both charts, the
16x16 'kerr-bl' render against `grtrace.render`, and the CLI's Kerr
samples against the JAX CLI's.

Tolerances, with their reasons (float64): the closed-form flows are not
the autodiff graph, and XLA contracts multiply-adds into FMAs where torch
does not (ROADMAP Queue C), so the two engines differ at roundoff, which
a ray's hundreds of steps grow:
  * the integrator, 64 rays x 600 steps: statuses equal; the rays that
    are not captured with equal step counts and final q and p within 1e-9
    relative; the captured ones within 2 steps (the Kerr-Schild entry of
    Queue C: a plunge amplifies the roundoff, p_r by 1.4e-9 here) and
    parked at the same radius;
  * the trajectories, 4 rays x 2000 steps, n_keep 64, in the
    Boyer-Lindquist chart: within 1e-8 relative, zero rows in the same
    places (the Kerr-Schild chart's are the CLI test's samples);
  * the render: the class map pixel for pixel, numerical_error 0, the
    counts summing to 256;
  * the CLI's sampled_rays.csv within 1e-8.

At most six tests a file: pytest-xdist's --dist loadfile hands out
the files with the most tests first, so a file this small runs after
the suite's long few-test files instead of ahead of them.
"""
import io
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import torch

import grtrace
import grtrace_torch
from grtrace import IntegratorConfig, PatchConfig, SceneConfig
from grtrace.engine import integrate_generic as jig
from grtrace_torch.engine import integrate_generic as tig
from grtrace_torch.physics.camera import camera_rays_unfolded
from grtrace_torch.physics.spacetime import kerr_g_inv
from test_torch_kerr_bl import PARAMS, _camera
from torch_cli_common import read_csv

torch.set_num_threads(1)


def test_integrate_twin_matches_jax():
    """G1's twin with the rescue against the JAX engine: the 8x8
    unfolded camera at r0 = 12 (fov 90 deg, boundary 13, delta 0.1), where
    600 steps capture 6 rays through the guard's park and the rescue and
    let 58 escape."""
    q0, p0 = (x.reshape(-1, 4).numpy() for x in camera_rays_unfolded(
        torch.tensor([12.0, 0.0, 0.0], dtype=torch.float64),
        torch.tensor(np.radians(90.0), dtype=torch.float64), 8, 8,
        params=PARAMS, g_inv_fn=kerr_g_inv, dtype=torch.float64)[:2])
    args = (600, 0.1, PARAMS, 13.0, 1.0)
    j = [np.asarray(x) for x in jig.integrate_batch_generic(
        jnp.asarray(q0), jnp.asarray(p0), *args[:2], jnp.asarray(PARAMS),
        *args[3:], metric="Kerr")]
    vec = tig.gen_params("Kerr", 0.1, PARAMS, 13.0, 1.0, 2, torch.float64)
    tq0, tp0 = torch.tensor(q0), torch.tensor(p0)
    state, ns = tig.integrate_generic_twin(tq0, tp0, 600, vec)
    # integrate_batch_generic(metric='Kerr') is this twin and this rescue
    t = [x.numpy() for x in tig.finish_generic_bl(state, ns, tq0, tp0, vec)]
    assert np.array_equal(t[2], j[2])
    assert np.bincount(j[2], minlength=3).tolist() == [0, 6, 58]
    assert int((ns < 0).sum()) == 6  # the captures went through the park
    dn = np.abs(t[3] - j[3])
    free = j[2] != 1
    assert (dn[free] == 0).all() and dn.max() <= 2
    for a, b in ((t[0], j[0]), (t[1], j[1])):
        np.testing.assert_allclose(a[free], b[free], rtol=1e-9, atol=1e-12)
    # the rescue parks every capture at 0.99 r_cap (XLA folds 0.99 * 1.1
    # into one constant, which rounds the float64 radius 1 ulp apart)
    np.testing.assert_allclose(t[0][~free, 1], j[0][~free, 1], rtol=1e-15,
                               atol=0)


def test_trajectories_bl_match_jax():
    """S2's twin against `trajectory_batch_decimated` in the
    Boyer-Lindquist chart: 4 rays of the 8x8 unfolded camera, 2000 steps,
    delta 0.1, n_keep 64 (stride 32)."""
    q0, p0 = _camera("Kerr", 8)
    q0, p0 = q0[[9, 27, 28, 54]], p0[[9, 27, 28, 54]]
    j = np.asarray(jig.trajectory_batch_decimated(
        jnp.asarray(q0), jnp.asarray(p0), 2000, 0.1, jnp.asarray(PARAMS),
        31.0, 1.0, metric="Kerr", n_keep=64))
    t = tig.trajectory_batch_decimated(
        torch.tensor(q0), torch.tensor(p0), 2000, 0.1, PARAMS, 31.0, 1.0,
        metric="Kerr", n_keep=64).numpy()
    assert t.shape == j.shape == (4, 63, 4)
    dead = (j == 0).all(-1)
    assert np.array_equal((t == 0).all(-1), dead) and dead.any()
    np.testing.assert_allclose(t, j, rtol=1e-8, atol=1e-12)


def test_kerr_bl_render_matches_jax():
    """The 16x16 Boyer-Lindquist frame (a = 0.9, 3000 steps, delta 0.05)
    through the port's render and grtrace.render: the class map pixel for
    pixel, no numerical-error pixel after the rescue, every pixel in a
    real class."""
    scene = SceneConfig(size=16, metric="kerr-bl", spin=0.9,
                        background=None, n_samples=0, patch=PatchConfig(),
                        integrator=IntegratorConfig(steps=3000, delta=0.05,
                                                    backend="xla",
                                                    dtype="float64"))
    j = grtrace.render(scene)
    t = grtrace_torch.render(grtrace_torch.from_jax_scene(scene),
                             device="cpu")
    assert t.counts == j.counts
    assert np.array_equal(t.cls, np.asarray(j.cls))
    assert np.array_equal(t.status, np.asarray(j.status))
    c = t.counts
    assert c["numerical_error"] == 0 and c["captured"] > 0
    assert c["captured"] + c["escaped"] + c["in_domain"] == 256
    np.testing.assert_allclose(t.q0, np.asarray(j.q0), rtol=0, atol=1e-12)


def test_cli_kerr_samples_match_jax(tmp_path):
    """`cli.main --metric kerr --n-samples 4 --dtype float64` at 16x16,
    2000 steps, delta 0.1: the port (--device cpu: B5's and S2's twins)
    and the JAX CLI sample the same pixels, and their sampled_rays.csv
    (the Kerr-Schild sampler's q1 rows, decimated to 1000 of the 2000
    steps, zero past each exit) agree within 1e-8."""
    from grtrace.cli.main import main as jax_main
    from grtrace_torch.cli import main as tmain
    argv = ["--size", "16", "--steps", "2000", "--delta", "0.1",
            "--metric", "kerr", "--spin", "0.9", "--n-samples", "4",
            "--dtype", "float64", "--backend", "xla", "--no-plots",
            "--no-flat-trajectories"]
    jout, tout = tmp_path / "jax", tmp_path / "port"
    jres = jax_main(argv + ["--out-dir", str(jout)])
    with redirect_stdout(io.StringIO()):
        tres = tmain.main(argv + ["--out-dir", str(tout), "--device", "cpu"])
    assert tres.counts == jres.counts
    assert np.array_equal(tres.sampled_indices, jres.sampled_indices)
    jh, jrows = read_csv(jout / "sampled_rays.csv")
    th, trows = read_csv(tout / "sampled_rays.csv")
    assert th == jh and trows.shape == jrows.shape == (4 * 1000, len(jh))
    np.testing.assert_allclose(trows.astype(float), jrows.astype(float),
                               rtol=1e-8, atol=1e-12)

