"""The disk product line of the port against the JAX package, on the CPU:
the README's polarized disk command through both command-line drivers
(`cli.main --disk --metric kerr --spin 0.9 --disk-bfield vertical
--save-transfer`, at 16x16, 1500 steps, delta 0.05, float64, with the
default --n-samples), then the transfer maps both drivers wrote, their
reshades (`io.transfer.reshade`, `cli.reshade`) and the hot-spot movie
(`engine.hotspot`, `cli.hotspot --transfer`).  Each driver runs once, in
one module fixture.

Tolerances, with their reasons:
  * counts and status exact; image channels at most 1 apart (the last ulp
    of a color can round either way);
  * EVPA: the circular distance min(d, pi - d) <= 1e-8 on disk pixels (an
    angle mod pi); pol_weight and pol_check within 1e-10 (the crossings
    themselves agree to ~1e-12: XLA contracts multiply-adds into FMAs and
    torch does not, ROADMAP Queue C);
  * the CSVs: the same rows, numbers within 1e-7 relative (they are
    printed with 8 significant digits);
  * a transfer map loads in the other package with every field equal;
  * a port reshade with the trace-time knobs equals the port's render
    byte for byte; a port reshade of the JAX map is within 1 per channel
    and 1e-10 on redshift of JAX's reshade;
  * the hot-spot movie on the same invariants: frames at most 1 apart,
    flux, weighted g and centroid within rtol 1e-10; on the port's own
    render, weighted g within rtol 1e-8 of JAX's (the crossings agree to
    ~1e-12).
"""
import io
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.engine import hotspot as jhot
from grtrace.io import transfer as jtr
import grtrace_torch
from grtrace_torch.cli import hotspot as thot_cli
from grtrace_torch.cli import main as tmain
from grtrace_torch.cli import reshade as treshade_cli
from grtrace_torch.engine import hotspot as thot
from grtrace_torch.io import transfer as ttr
from torch_cli_common import read_csv

torch.set_num_threads(1)

DISK_ARGS = ["--size", "16", "--metric", "kerr", "--spin", "0.9", "--disk",
             "--steps", "1500", "--delta", "0.05", "--dtype", "float64",
             "--backend", "xla", "--disk-bfield", "vertical",
             "--background", "", "--no-plots"]
RESHADE_ARGS = ["--disk-profile", "novikov", "--disk-bfield", "toroidal",
                "--disk-emissivity", "2", "3"]
HOT = dict(n_frames=6, sigma=0.6)


def _circ(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, np.pi - d)


def _csv_close(path_t, path_j):
    th, t = read_csv(path_t)
    jh, j = read_csv(path_j)
    assert th == jh and t.shape == j.shape and len(t) > 0
    np.testing.assert_allclose(t.astype(np.float64), j.astype(np.float64),
                               rtol=1e-7, atol=1e-12)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from grtrace.cli.main import main as jax_main
    jout = tmp_path_factory.mktemp("jax_disk")
    tout = tmp_path_factory.mktemp("port_disk")
    jres = jax_main(DISK_ARGS + ["--out-dir", str(jout), "--save-transfer",
                                 str(jout / "map.npz")])
    buf = io.StringIO()
    with redirect_stdout(buf):
        tres = tmain.main(DISK_ARGS + ["--out-dir", str(tout),
                                       "--save-transfer",
                                       str(tout / "map.npz"),
                                       "--device", "cpu"])
    return jout, jres, tout, tres


def test_polarized_disk_cli_matches_jax(runs):
    """The README's command, default --n-samples included, runs the disk
    path on Kerr; the polarized render equals JAX's."""
    _, jres, _, tres = runs
    assert tres.counts == {k: int(v) for k, v in jres.counts.items()}
    assert tres.counts["disk"] > 0 and tres.counts["numerical_error"] == 0
    assert np.array_equal(tres.status, np.asarray(jres.status))
    dm = tres.status == 3
    t = {k: tres.device(k).numpy() for k in ("evpa", "pol_weight",
                                             "pol_check")}
    j = {k: np.asarray(jres.device(k)) for k in t}
    assert _circ(t["evpa"], j["evpa"])[dm].max() <= 1e-8
    for k in ("pol_weight", "pol_check"):
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=1e-10)
    assert np.abs(tres.image.astype(int)
                  - np.asarray(jres.image).astype(int)).max() <= 1


def test_disk_cli_csvs_match_jax(runs):
    jout, _, tout, _ = runs
    for name in ("redshift_map.csv", "line_profile.csv",
                 "polarization_map.csv"):
        _csv_close(tout / name, jout / name)
    th, t = read_csv(tout / "photon_data.csv")
    jh, j = read_csv(jout / "photon_data.csv")
    assert th == jh and np.array_equal(t[:, :2], j[:, :2])
    assert np.array_equal(t[:, 5], j[:, 5])          # the collision class


def test_transfer_maps_load_across_packages(runs, tmp_path):
    jout, _, tout, _ = runs
    for path in (jout / "map.npz", tout / "map.npz"):
        a, b = jtr.TransferMap.load(path), ttr.TransferMap.load(path)
        for f in ("status", "hit_q", "hit_p", "image", "params", "obs_pos"):
            ja, tb = np.asarray(getattr(a, f)), getattr(b, f)
            assert ja.dtype == tb.dtype and np.array_equal(ja, tb), f
        for f in ("fov", "r_in", "r_out", "prograde", "meta"):
            assert getattr(a, f) == getattr(b, f), f
    tm = ttr.TransferMap.load(tout / "map.npz")
    assert tm.meta["bfield"] == "vertical" and not tm.meta["camera_moving"]
    tm.meta["format"] = ttr._FORMAT_VERSION + 1
    tm.save(tmp_path / "newer.npz")
    for mod in (ttr, jtr):
        with pytest.raises(ValueError, match="newer"):
            mod.TransferMap.load(tmp_path / "newer.npz")


def test_reshade_matches_render_and_jax(runs, tmp_path):
    jout, _, tout, tres = runs
    # the trace-time knobs reproduce the port's render byte for byte (the
    # off-disk redshift is NaN in both: rays that never hit carry zero hit
    # rows, ROADMAP Queue C)
    re = grtrace_torch.reshade(ttr.TransferMap.load(tout / "map.npz"),
                               device="cpu")
    assert re.counts["disk"] == tres.counts["disk"]
    for k in ("image", "redshift", "evpa", "pol_weight", "pol_check"):
        assert (re.device(k).numpy().tobytes()
                == tres.device(k).numpy().tobytes()), k
    # new knobs on JAX's map: the port's reshade against JAX's
    kw = dict(profile="novikov", bfield="toroidal", t_peak=12000.0)
    jm = jtr.TransferMap.load(jout / "map.npz")
    j = jtr.reshade(jm, **kw)
    t = grtrace_torch.reshade(ttr.TransferMap.load(jout / "map.npz"),
                              device="cpu", **kw)
    dm = jm.status == 3
    assert np.abs(t.device("image").numpy().astype(int)
                  - np.asarray(j.device("image")).astype(int)).max() <= 1
    np.testing.assert_allclose(t.device("redshift").numpy()[dm],
                               np.asarray(j.device("redshift"))[dm],
                               rtol=1e-10, atol=0)
    assert _circ(t.device("evpa").numpy(),
                 np.asarray(j.device("evpa")))[dm].max() <= 1e-8
    # the reshade drivers on their own maps
    from grtrace.cli.reshade import main as jax_reshade
    jax_reshade(["--transfer", str(jout / "map.npz"), "--out-dir",
                 str(tmp_path / "j")] + RESHADE_ARGS)
    with redirect_stdout(io.StringIO()):
        treshade_cli.main(["--transfer", str(tout / "map.npz"),
                           "--out-dir", str(tmp_path / "t"), "--device",
                           "cpu", "--no-plots"] + RESHADE_ARGS)
    for sub in ("", "q3/"):
        for name in ("redshift_map.csv", "line_profile.csv",
                     "polarization_map.csv"):
            _csv_close(tmp_path / "t" / (sub + name),
                       tmp_path / "j" / (sub + name))


def test_hotspot_movie_on_the_same_invariants(runs, tmp_path):
    jout, jres, _, tres = runs
    jm = jtr.TransferMap.load(jout / "map.npz")
    args = (np.asarray(jres.device("image")), np.asarray(jres.device(
        "hit_q")), np.asarray(jres.device("status")),
        np.asarray(jres.device("redshift")), jm.params, jm.r_in, jm.r_out)
    j = jhot.hotspot_movie(*(jnp.asarray(a) for a in args[:4]), *args[4:],
                           hotspot=jhot.HotspotConfig(**HOT))
    t = thot.hotspot_movie(*(torch.tensor(a) for a in args[:4]),
                           *args[4:], hotspot=thot.HotspotConfig(**HOT),
                           frames_per_chunk=4)
    assert t["frames"].shape == (6, 16, 16, 3) and t["flux"].max() > 0
    assert np.abs(t["frames"].astype(int)
                  - j["frames"].astype(int)).max() <= 1
    for k in ("flux", "weighted_g", "centroid", "times"):
        np.testing.assert_allclose(t[k], j[k], rtol=1e-10, atol=1e-300)
    for k in ("period", "omega", "r_blob"):
        assert t[k] == pytest.approx(j[k], rel=1e-14)
    # the port's own render carries zero hit rows (a NaN redshift) off the
    # disk, as kernel B6 writes them: the light curve stays finite
    own = thot.hotspot_movie(
        tres.device("image"), tres.device("hit_q"), tres.device("status"),
        tres.device("redshift"), jm.params, jm.r_in, jm.r_out,
        hotspot=thot.HotspotConfig(**HOT))
    assert torch.isnan(tres.device("redshift")).any()
    for k in ("flux", "weighted_g", "centroid"):
        assert np.isfinite(own[k]).all(), k
    np.testing.assert_allclose(own["weighted_g"], j["weighted_g"],
                               rtol=1e-8)
    # the drivers' --transfer path (no geodesic step) on JAX's map
    from grtrace.cli.hotspot import main as jax_hotspot
    cli = ["--transfer", str(jout / "map.npz"), "--frames", "6",
           "--blob-sigma", "0.6", "--no-gif"]
    jax_hotspot(cli + ["--out-dir", str(tmp_path / "j")])
    with redirect_stdout(io.StringIO()):
        out = thot_cli.main(cli + ["--out-dir", str(tmp_path / "t"),
                                   "--device", "cpu", "--no-plots",
                                   "--bench"])
    assert out["bench"]["metric"] == "hotspot_16_shading_frames_per_s"
    _csv_close(tmp_path / "t" / "lightcurve.csv",
               tmp_path / "j" / "lightcurve.csv")
    assert len(list((tmp_path / "t" / "frames").iterdir())) == 6
    # --closure runs now (item 8a); on this 16x16 map JAX's triangle fan
    # does not fit the 32-point u-v grid, and both drivers refuse it alike
    # (the series at 20x20: tests/test_torch_subring_cli.py)
    for main, extra in ((jax_hotspot, []),
                        (thot_cli.main, ["--device", "cpu", "--no-plots"])):
        with pytest.raises(ValueError, match="do not close"):
            main(cli + ["--closure", "--out-dir", str(tmp_path / "c")]
                 + extra)


def test_new_entry_points_default_to_the_card(runs, monkeypatch, tmp_path):
    """Without a GPU, the disk line's entry points raise (or, the drivers,
    exit with a message) unless asked for the CPU."""
    _, _, tout, _ = runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tm = ttr.TransferMap.load(tout / "map.npz")
    scene = grtrace_torch.SceneConfig(size=4, metric="kerr", spin=0.9,
                                      n_samples=0)
    for call in (lambda: grtrace_torch.reshade(tm),
                 lambda: grtrace_torch.hotspot_from_transfer(tm),
                 lambda: grtrace_torch.render_hotspot(scene)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    for cli in ((treshade_cli, ["--transfer", str(tout / "map.npz")]),
                (thot_cli, ["--transfer", str(tout / "map.npz")]),
                (tmain, DISK_ARGS)):
        with pytest.raises(SystemExit) as exc:
            cli[0].main(cli[1] + ["--out-dir", str(tmp_path)])
        assert "--device cpu" in str(exc.value.code)
