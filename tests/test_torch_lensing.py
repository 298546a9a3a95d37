"""The lensing observables of the port (engine/lensing.py, cli/magnify.py)
against the JAX package's, on the CPU (kernel B5's eager twin renders; the
card runs `cli.magnify` through B5 in chip_smoke.py phase 46).

The magnification map is host float64 numpy on a render's escape angles
and launch states, with JAX's arithmetic: on the same render (the port's
24x24 Kerr-Schild frame) the two packages' maps, valid masks and
flipped-pixel counts are equal exactly.  How the port's render itself
matches JAX's is held by tests/test_torch_render_kerr_jax.py.

At most six tests a file: pytest-xdist's --dist loadfile hands out the
files with the most tests first, so a file this small runs after the
suite's long few-test files instead of ahead of them.
"""
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import grtrace_torch
from grtrace.engine import lensing as jl
from grtrace_torch.cli import magnify as mag_cli
from grtrace_torch.engine import lensing as tl
from grtrace_torch.engine.render_generic import render_generic

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ks_render():
    """The port's 24x24 Kerr-Schild frame at a = 0.9 (delta 0.1: every
    escaping ray reaches the boundary within 1500 steps)."""
    scene = grtrace_torch.SceneConfig(
        size=24, metric="kerr", spin=0.9, n_samples=0, background=None,
        integrator=grtrace_torch.IntegratorConfig(steps=1500, delta=0.1))
    return scene, render_generic(scene, metric="KerrSchild", device="cpu")


def test_magnification_map_matches_jax_on_the_same_render(ks_render):
    scene, res = ks_render
    mu, valid = tl.inverse_magnification_map(res, scene.boundary_radius)
    jmu, jvalid = jl.inverse_magnification_map(res, scene.boundary_radius)
    assert np.array_equal(valid, jvalid) and valid.sum() > 100
    assert np.array_equal(mu, jmu, equal_nan=True)
    flipped = int((mu[valid] < 0).sum())
    assert flipped == int((jmu[jvalid] < 0).sum()) and flipped > 0
    # the spherical chart's flat twin, on a Boyer-Lindquist launch state
    q0 = np.array([[[0.0, 30.0, 1.5, 0.1]]])
    p0 = np.array([[[-1.0, -0.9, 0.3, 2.0]]])
    fake = SimpleNamespace(q0=q0, p0=p0)
    for a, b in zip(tl._flat_escape_angles(fake, 31.0, "spherical"),
                    jl._flat_escape_angles(fake, 31.0, "spherical")):
        assert np.array_equal(a, b)


def test_cli_magnify_writes_the_map(tmp_path, monkeypatch):
    """cli.magnify --device cpu --no-plots at 16x16: magnification.csv with
    one row per valid pixel, no figure, one JSON line; the figure without
    matplotlib exits with a message."""
    out = str(tmp_path)
    m = mag_cli.main(["--size", "16", "--steps", "1500", "--delta", "0.1",
                      "--metric", "kerr", "--spin", "0.9", "--device", "cpu",
                      "--no-plots", "--out-dir", out])
    assert m["valid_pixels"] > 0 and m["flipped_pixels"] >= 0
    json.dumps(m)
    rows = np.loadtxt(os.path.join(out, "magnification.csv"), delimiter=",",
                      skiprows=1, ndmin=2)
    assert rows.shape == (m["valid_pixels"], 4)
    assert not os.path.exists(os.path.join(out, "magnification.png"))
    from grtrace_torch.viz import plots
    monkeypatch.setattr(plots, "available", lambda: False)
    with pytest.raises(SystemExit, match="matplotlib"):
        mag_cli.main(["--device", "cpu", "--out-dir", out])
    with pytest.raises(SystemExit, match="--metric kerr"):
        mag_cli.main(["--spin", "0.5", "--device", "cpu", "--no-plots"])
