"""The static families' render (engine/render_generic.py's static branch,
routed by engine/render.py) against the JAX package's `render` on the same
scenes, on the CPU: the folded camera, the twin of kernel G1s, the
classifier with the fold angles, the 20-sample sampler (the twin of S2s)
rotated back by beta, and the adaptive antialiasing pass.

Float64 scenes.  Tolerances, with their reasons: class maps, counts, step
counts, images and AA masks equal; the final (r, theta, phi) within 1e-5
(the few rays that wind near the photon sphere amplify roundoff by
e^(gamma phi); measured 6.6e-8 at g = 0.5, 2.1e-6 at g = 0, the rest
1e-11), the final coordinate time within 1e-6 relative (it grows without
bound as a captured ray nears the horizon, and along the winders; measured
1.3e-8 at g = 0.5, 2.3e-7 at g = 0) and the sampled trajectories
within 1e-9 (the closed-form flows against JAX's autodiff, roundoff grown
along the rays); the fold angles within 1e-14 and alpha0 within 1e-12
(torch's and XLA's atan2 and arccos differ in the last ulp).
"""
import numpy as np
import pytest
import torch

import grtrace as g
import grtrace_torch as gt
from grtrace_torch.cli import args as targs
from grtrace_torch.cli import main as tmain
from grtrace_torch.io.textures import checker

torch.set_num_threads(1)
BG = checker(48, 96)


def _scenes(metric, param, size, steps, n_samples=0, delta=0.05):
    kw = dict(size=size, metric=metric, metric_param=param, background=None,
              n_samples=n_samples)
    return (gt.SceneConfig(integrator=gt.IntegratorConfig(
                steps=steps, delta=delta, dtype="float64"), **kw),
            g.SceneConfig(integrator=g.IntegratorConfig(
                steps=steps, delta=delta, dtype="float64"), **kw))


def _same(tr, jr, samples=False):
    assert tr.counts == jr.counts
    assert np.array_equal(tr.cls, np.asarray(jr.cls))
    assert np.array_equal(tr.image, np.asarray(jr.image))
    assert np.array_equal(tr.n_steps, np.asarray(jr.n_steps))
    jq = np.asarray(jr.final_q)
    np.testing.assert_allclose(tr.final_q[..., 1:], jq[..., 1:], atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tr.final_q[..., 0], jq[..., 0], rtol=1e-6)
    np.testing.assert_allclose(tr.beta, np.asarray(jr.beta), atol=1e-14,
                               rtol=0)
    if samples:
        assert np.array_equal(tr.sampled_indices, jr.sampled_indices)
        for a, b in zip(tr.sampled_trajectories, jr.sampled_trajectories):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-9, rtol=0)


@pytest.mark.parametrize("metric,param", [("bardeen", 0.5),
                                          ("kottler", 1e-3)])
def test_static_render_matches_jax(metric, param):
    """render(metric='bardeen' | 'kottler') at 24x24, 2000 steps, with a
    checker background: the class map, counts, image and step counts equal
    JAX's, the shadow and the background both present; Bardeen with 20
    sampled rays, rotated back by their fold angles as JAX rotates them."""
    n = 20 if metric == "bardeen" else 0
    ts, js = _scenes(metric, param, 24, 2000, n_samples=n)
    tr = gt.render(ts, bg_array=BG, device="cpu")
    jr = g.render(js, bg_array=BG)
    _same(tr, jr, samples=bool(n))
    assert tr.counts["captured"] > 0 and tr.counts["background"] > 0
    if n:
        assert len(tr.sampled_trajectories) == 20
        # samples off the central row leave the x-y plane once rotated back
        assert max(np.abs(t[:, 2]).max() for t in
                   tr.sampled_trajectories) > 1.0


def test_static_aa_pass_matches_jax():
    """The AA pass at s = 2 on the 24x24 Bardeen (g = 0.5) frame of the
    first test (JAX compiles its frame once for both): the refined pixels
    and the averaged image equal JAX's, the class map and counts those of
    the base render."""
    ts, js = _scenes("bardeen", 0.5, 24, 2000)
    tr = gt.render(ts, bg_array=BG, device="cpu", aa_samples=2)
    jr = g.render(js, bg_array=BG, aa_samples=2)
    _same(tr, jr)
    assert np.array_equal(tr.aa_mask, np.asarray(jr.device("aa_mask")))
    assert int(tr.aa_mask.sum()) > 0


def test_metric_param_zero_matches_jax_generic_engine():
    """--metric bardeen --metric-param 0 (Schwarzschild in the static
    chart) goes through the generic engine, not the headline path, as in
    JAX: the CLI's scene renders JAX's frame, 24x24 as in the first test,
    through G1s's twin."""
    argv = ["--metric", "bardeen", "--metric-param", "0", "--size", "24",
            "--steps", "2000", "--delta", "0.05", "--dtype", "float64",
            "--n-samples", "0", "--device", "cpu"]
    args = targs.parse_args(argv)
    scene = targs.scene_from_args(args)
    tmain.check_ported(args, scene)
    assert scene.metric == "bardeen" and scene.metric_param == 0.0
    assert tmain.roofline_kernel(scene) == "fantasy_gen_static"
    _, js = _scenes("bardeen", 0.0, 24, 2000)
    tr = gt.render(scene, bg_array=BG, device="cpu")
    jr = g.render(js, bg_array=BG)
    _same(tr, jr)
    # the static chart's fold, not the headline path's analytic shortcut
    np.testing.assert_allclose(tr.alpha0, np.asarray(jr.alpha0), atol=1e-12,
                               rtol=0)
