"""The reverberation observables of the port (engine/echo.py,
cli/echo.py) against the JAX package's, on the CPU (kernel B6's float64
16-row twin traces the fan; the card holds B6 against it on cli.echo's fan
in chip_smoke.py phase 47).

Tolerances: the fans (64 rays, h = 10, a = 0 and a = 0.5, the escape
sphere at 30 M) hit on the same
rays, with r, t_src and g_sd within 1e-9 (JAX's XLA disk engine contracts
multiply-adds into FMAs, the twin does not: ROADMAP Queue C); the transfer
function of one disk render and fan (the port's, fed to both packages) is
host float64 on the same arithmetic, within 1e-9 relative.  Non-hitting
rays carry zero hit rows in the port (B6 and its twins) where JAX's XLA
engine carries the launch state (Queue C): every crossing quantity is
masked by `hit`, and the unmasked energy of a non-hitting ray reads 0
here (pinned below).

At most six tests a file: pytest-xdist's --dist loadfile hands out the
files with the most tests first, so a file this small runs after the
suite's long few-test files instead of ahead of them.
"""
import json
import os

import numpy as np
import pytest
import torch

import grtrace_torch
from grtrace.engine import echo as je
from grtrace_torch.cli import echo as echo_cli
from grtrace_torch.engine import echo as te

torch.set_num_threads(1)
H = 10.0
# 64 rays, the escape sphere at 30 M (JAX's default 60 M doubles the
# twin's loop)
FAN = dict(n_rays=64, steps=2000, delta=0.05, r_max=30.0)


@pytest.fixture(scope="module")
def fans():
    """{spin: (the port's fan, JAX's)} at a = 0 and a = 0.5."""
    return {a: (te.trace_lamppost(H, [1.0, a, 0.0], device="cpu", **FAN),
                je.trace_lamppost(H, [1.0, a, 0.0], **FAN))
            for a in (0.0, 0.5)}


def test_fan_matches_jax(fans):
    for a, (fan, jfan) in fans.items():
        hit = fan["hit"]
        assert np.array_equal(hit, jfan["hit"]) and hit.sum() > 20, a
        for k in ("r", "t_src", "g_sd", "g_sd_static"):
            np.testing.assert_allclose(fan[k][hit], jfan[k][hit], rtol=1e-9,
                                       err_msg=f"{k}, a = {a}")
            assert np.isnan(fan[k][~hit]).all()
        np.testing.assert_allclose(fan["psi"], jfan["psi"], rtol=1e-15)
        np.testing.assert_allclose(fan["alpha0"], jfan["alpha0"],
                                   atol=1e-12)
        np.testing.assert_allclose(fan["energy"][hit], jfan["energy"][hit],
                                   rtol=1e-9)
        # the deliberate divergence: zero hit rows where no crossing was
        assert (fan["energy"][~hit] == 0.0).all()
        assert fan["r_plus"] == pytest.approx(jfan["r_plus"], rel=1e-15)


def test_schwarzschild_anchors(fans):
    """tests/test_echo.py's exact anchors on the port's a = 0 fan: |E| =
    sqrt(f(h)) and L_z = 0 on every crossing ray, alpha0 = psi, the static
    receiver's shift sqrt(f(h) / f(r)), and every source time longer than
    the straight line."""
    fan, _ = fans[0.0]
    hit = fan["hit"]
    np.testing.assert_allclose(fan["energy"][hit], np.sqrt(1.0 - 2.0 / H),
                               rtol=1e-12)
    assert np.abs(fan["l_z"]).max() == 0.0
    np.testing.assert_allclose(fan["alpha0"], fan["psi"], atol=1e-10)
    r = fan["r"][hit]
    np.testing.assert_allclose(fan["g_sd_static"][hit],
                               np.sqrt((1.0 - 2.0 / H) / (1.0 - 2.0 / r)),
                               rtol=1e-10)
    assert (fan["t_src"][hit] > np.sqrt(H * H + r * r)).all()


def test_transfer_function_matches_jax(fans):
    """Psi(tau, g) of a 24x24 disk render (a = 0.5, 30 deg above the disk)
    and the a = 0.5 fan, the port's against JAX's on the same inputs, and
    the emissivity profile the same."""
    fan, _ = fans[0.5]
    scene = grtrace_torch.SceneConfig(
        size=24, metric="kerr", spin=0.5, n_samples=0,
        integrator=grtrace_torch.IntegratorConfig(steps=1000, delta=0.15))
    res = grtrace_torch.render_disk(
        scene, grtrace_torch.DiskConfig(r_out=20.0, elevation_deg=30.0,
                                        show_background=False),
        device="cpu")
    tf = te.transfer_function(res, fan, t_direct=25.0)
    raw = {k: res.device(k).cpu().numpy()
           for k in ("hit_q", "status", "redshift")}
    jtf = je.transfer_function(raw, fan, t_direct=25.0)
    assert tf["pixels"] == jtf["pixels"] > 0
    for k in ("psi_tau_g", "tau", "g", "lag_profile"):
        np.testing.assert_allclose(tf[k], jtf[k], rtol=1e-9, atol=1e-300)
    for k in ("tau_peak", "tau_centroid", "response_total"):
        assert tf[k] == pytest.approx(jtf[k], rel=1e-9)
    for a, b in zip(te.emissivity_profile(fan, fan["params"]),
                    je.emissivity_profile(fan, fan["params"])):
        np.testing.assert_allclose(a, b, rtol=1e-12)


def test_cli_echo(tmp_path, monkeypatch):
    """cli.echo --device cpu --no-plots on a small frame and fan, with the
    charged hole's inner edge (Q = 0.4: the autodiff ISCO): the CSVs and
    the summary, one JSON line; the figures without matplotlib exit with
    a message."""
    out = str(tmp_path)
    m = echo_cli.main(["--size", "8", "--fan-rays", "32", "--steps", "1000",
                       "--delta", "0.15",
                       "--spin", "0.5", "--charge", "0.4", "--device", "cpu",
                       "--no-plots", "--out-dir", out])
    json.dumps(m)
    assert m["files"] == 3 and m["fan_hits"] >= 8 and m["pixels"] > 0
    for name in ("echo_emissivity.csv", "echo_lag_profile.csv",
                 "echo_summary.json"):
        assert os.path.exists(os.path.join(out, name))
    from grtrace_torch.viz import plots
    monkeypatch.setattr(plots, "available", lambda: False)
    with pytest.raises(SystemExit, match="matplotlib"):
        echo_cli.main(["--device", "cpu", "--out-dir", out])
