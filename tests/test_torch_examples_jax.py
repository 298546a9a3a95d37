"""The port's examples (grtrace_torch/examples/) against the JAX examples
at the sizes of tests/test_examples.py, on the CPU.

  * analyze_photon_data: the default scene's photon_data.csv (64 x 64,
    5,000 steps of 0.05) through the JAX example's own summarize and the
    port's: the same class counts and the same per-class alpha0 minimum,
    median and maximum within 1e-6 rad (the camera's float32 rounding).
  * observables_workflow at size 40, 2,000 steps of 0.1: the JAX
    example's main at those sizes runs once (a module-scoped fixture,
    each stage's return recorded, its figures not drawn) and the port's
    run is held to the numbers it prints, unrounded: the counts equal;
    the shadow's mean diameter and circularity within 1e-12 relative
    (the same float64 bisection of the closed-form predicate); the first
    visibility null within 1e-9 relative (the FFT of images that agree
    byte for byte); the hot spot's radius and period within 1e-12
    relative (the family's ISCO and Keplerian period in float64); every
    product the JAX test lists but the figures is written;
  * polarized_disk at 24 x 24 and the face-on disk at 24 x 24, 1,000
    steps of 0.05 (the example's scenes at a test's size, every disk
    crossing made; the example runs 96 x 96 and 64 x 64 at 4,000 on the
    card, chip_smoke.py phase 61), its float32 rays, against the same
    scenes through the JAX package's render_disk in float64 and the JAX
    example's two inline checks: equal counts, the disk pixels' g range,
    outer pitch weight and face-on closed-form error within 1e-5 (the
    port's float32 g is 1.2e-6 from the float64 one; JAX's own float32
    path on the CPU is 3.8e-4 from it, so float64 is the reference).
"""
import importlib.util
import os

import matplotlib.figure

import numpy as np
import pandas as pd
import pytest
import torch

from grtrace_torch.examples import analyze_photon_data as t_analyze
from grtrace_torch.examples import observables_workflow as t_workflow
from grtrace_torch.examples import polarized_disk as t_polarized

EXAMPLES = os.path.join(os.path.dirname(__file__), os.pardir, "examples")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        "jax_" + name, os.path.join(EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stats(df):
    return {k: (grp["alpha0"].min(), grp["alpha0"].median(),
                grp["alpha0"].max()) for k, grp in df.groupby("collision")}


def test_analyze_photon_data_matches_jax(tmp_path, capsys, monkeypatch):
    """The port's analyze_photon_data renders the default scene (B1's twin
    on the CPU) and summarizes it as the JAX example summarizes its own
    render: equal class counts, alpha0 statistics within 1e-6 rad; the
    printed summary has the notebook's sections."""
    jmod = _load("analyze_photon_data")
    jdf = pd.read_csv(jmod.render_default(str(tmp_path)))
    want = jmod.summarize(jdf)
    capsys.readouterr()
    path = t_analyze.render_default(str(tmp_path), device="cpu")
    got = t_analyze.main([path])
    out = capsys.readouterr().out
    assert "Photon summary" in out and "Shadow edge" in out
    assert got == want
    assert got.get("bh", 0) > 0 and got.get("escape_bg", 0) > 0
    ours, theirs = _stats(pd.read_csv(path)), _stats(jdf)
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert np.abs(np.subtract(ours[k], theirs[k])).max() <= 1e-6, k
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        t_analyze.main([])  # the card is the default


@pytest.fixture(scope="module")
def jax_workflow(tmp_path_factory):
    """The JAX example's main(out, size=40, steps=2000, delta=0.1) once,
    with the returns of the stages whose numbers it prints recorded (the
    figures' drawing skipped: they are not compared)."""
    from grtrace.engine import disk as jdisk
    from grtrace.engine import shadow as jshadow
    from grtrace.engine import visibility as jvis
    from grtrace.io import transfer as jtransfer
    out = str(tmp_path_factory.mktemp("jax_workflow"))
    rec = {}

    def recorded(fn, name):
        def call(*args, **kw):
            rec[name] = fn(*args, **kw)
            return rec[name]
        return call
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((jdisk, "render_disk"),
                          (jshadow, "shadow_metrics"),
                          (jvis, "first_null"),
                          (jtransfer, "hotspot_from_transfer")):
            mp.setattr(mod, name, recorded(getattr(mod, name), name))
        mp.setattr(jshadow, "overlay_png", lambda *a, **k: None)
        mp.setattr(matplotlib.figure.Figure, "savefig",
                   lambda *a, **k: None)
        _load("observables_workflow").main(out, size=40, steps=2000,
                                           delta=0.1)
    return {"counts": rec["render_disk"].counts,
            "image": np.asarray(rec["render_disk"].image),
            "metrics": rec["shadow_metrics"],
            "first_null": rec["first_null"],
            "r_blob": float(rec["hotspot_from_transfer"]["r_blob"]),
            "period": float(rec["hotspot_from_transfer"]["period"])}


def test_observables_workflow_matches_jax_printed_numbers(tmp_path,
                                                          jax_workflow):
    """The port's observables_workflow at the JAX test's size (40, 2,000
    steps of 0.1) against the JAX example's run on the same scene: the
    counts and the disk image equal, the shadow metrics, first null, blob
    radius and period within the tolerances above; its products written
    (the figures aside: plots=False)."""
    want = jax_workflow
    out = t_workflow.run(str(tmp_path), size=40, steps=2000, delta=0.1,
                         device="cpu", plots=False)
    assert out["counts"] == want["counts"] and want["counts"]["disk"] > 0
    from PIL import Image
    image = np.asarray(Image.open(os.path.join(out["out_dir"], "disk.png")))
    assert np.array_equal(image[..., :3], want["image"])

    def close(got, ref, rtol):
        assert abs(got - ref) <= rtol * abs(ref), (got, ref)
    close(out["mean_diameter_px"], want["metrics"]["mean_diameter_px"],
          1e-12)
    close(out["circularity_deviation"],
          want["metrics"]["circularity_deviation"], 1e-12)
    assert np.isfinite(want["first_null"])
    close(out["first_null"], want["first_null"], 1e-9)
    close(out["r_blob"], want["r_blob"], 1e-12)
    close(out["period"], want["period"], 1e-12)
    for f in ("scene.transfer.npz", "disk.png", "disk_nt.png",
              "redshift_map.csv", "line_profile.csv", "shadow_metrics.json",
              "visibility_profile.csv",
              os.path.join("hotspot", "lightcurve.csv")):
        assert os.path.exists(os.path.join(out["out_dir"], f)), f


def _jax_polarized(size, steps, face_size, dtype):
    """The JAX example's scenes and inline checks at a test's size."""
    from grtrace import DiskConfig, IntegratorConfig, SceneConfig
    from grtrace.engine.disk import render_disk
    scene = SceneConfig(size=size, metric="kerr", spin=0.9, n_samples=0,
                        integrator=IntegratorConfig(steps=steps, delta=0.05,
                                                    dtype=dtype))
    res = render_disk(scene, DiskConfig(profile="novikov", bfield="vertical",
                                        emissivity_index=3.0))
    dm = np.asarray(res.cls) == 5
    g = np.asarray(res.device("redshift"))[dm]
    w = np.asarray(res.device("pol_weight"))[dm]
    hq = np.asarray(res.device("hit_q"))[dm]
    outer = np.sqrt((hq[:, 1:] ** 2).sum(axis=-1)) > 11.0
    scene0 = SceneConfig(size=face_size, metric="kerr", spin=0.0,
                         n_samples=0,
                         integrator=IntegratorConfig(steps=steps,
                                                     delta=0.05,
                                                     dtype=dtype))
    res0 = render_disk(scene0, DiskConfig(elevation_deg=89.9,
                                          show_background=False))
    dm0 = np.asarray(res0.cls) == 5
    g0 = np.asarray(res0.device("redshift"))[dm0]
    hq0 = np.asarray(res0.device("hit_q"))[dm0]
    r0 = np.sqrt((hq0[:, 1:] ** 2).sum(axis=-1))
    expect = np.sqrt(1 - 3 / r0) / np.sqrt(1 - 2 / 30.0)
    return {"counts": res.counts, "disk_pixels": int(dm.sum()),
            "g_min": float(g.min()), "g_max": float(g.max()),
            "pitch_outer": float(np.median(w[outer])),
            "faceon_err": float(np.abs(g0 / expect - 1).max()),
            "faceon_pixels": int(dm0.sum())}


def test_polarized_disk_matches_jax(tmp_path, monkeypatch):
    """The port's polarized_disk (run at 24 x 24, face-on 24 x 24, 1,000
    steps; B6's twin on the CPU, float32) against the JAX example's scenes
    and checks at that size in float64: counts, disk and face-on pixel
    counts equal, the g range, outer pitch weight and face-on error within
    1e-5; the three CSVs written; main refuses without a card unless
    --device cpu."""
    got = t_polarized.run(str(tmp_path), size=24, steps=1000, face_size=24,
                          device="cpu", plots=False)
    want = _jax_polarized(24, 1000, 24, "float64")
    for k in ("counts", "disk_pixels", "faceon_pixels"):
        assert got[k] == want[k], k
    assert want["disk_pixels"] > 0 and want["faceon_pixels"] > 0
    for k in ("g_min", "g_max", "pitch_outer", "faceon_err"):
        assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
    assert sorted(os.listdir(tmp_path)) == [
        "line_profile.csv", "polarization_map.csv", "redshift_map.csv"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        t_polarized.main([str(tmp_path), "--no-plots"])
