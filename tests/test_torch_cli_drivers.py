"""The parts of the port's command-line drivers, on the CPU: the flags and
the unported options, the refusals (no card, no matplotlib), the flat
renderer and the Euler integrator against the JAX package's, the CSV and
PNG writers against grtrace's, the backgrounds, the small drivers (single
ray, band sweep, probe), the plots and the metrics.  Tolerances are stated
in each test.  The pipeline against grtrace.cli.main is in
tests/test_torch_cli.py.
"""
import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from PIL import Image

from grtrace.cli import args as jargs
from grtrace.engine import flat as jflat
from grtrace.io import artifacts as jart
from grtrace.io.scene import SceneConfig as JScene
from grtrace_torch.cli import args as targs
from grtrace_torch.cli import band_sweep, probe, single_ray
from grtrace_torch.cli import main as tmain
from grtrace_torch.engine import flat as tflat
from grtrace_torch.io import artifacts as tart
from grtrace_torch.io.scene import SceneConfig as TScene
from torch_cli_common import CLI_ARGS, background, read_csv  # noqa: F401

torch.set_num_threads(1)


def test_cli_refuses_without_a_card(background, tmp_path):
    """No GPU and no --device cpu: the CLI exits non-zero with a message."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as exc:
        tmain.main(CLI_ARGS + ["--background", background, "--out-dir",
                               str(tmp_path)])
    assert "--device cpu" in str(exc.value.code)


@pytest.mark.parametrize("flags,item", [
    (["--disk", "--metric", "kottler"], None), (["--aa", "2"], None),
    (["--disk", "--aa", "2"], None),
    (["--disk", "--camera-omega", "0.1", "--metric", "hayward"],
     "the Kerr-Schild disk path"),
    (["--metric", "kottler"], None), (["--metric", "kerr-ds"], None),
    (["--metric", "kerr-ds", "--spin", "0.5", "--disk"], None),
    (["--metric", "kerr-bl", "--n-samples", "0"], None),
    (["--metric", "kerr", "--spin", "0.5"], None),
    (["--metric", "rotating-bardeen", "--spin", "0.5"], None),
    (["--disk", "--metric", "rotating-hayward", "--spin", "0.9",
      "--metric-param", "0.2"], None)])
def test_unported_options_raise(flags, item):
    """Each unported option raises NotImplementedError naming its ROADMAP
    item, before any work runs; the options items 5b, 8 and 9's static
    family ported (item None: --metric kerr-bl, --metric kerr with the
    default --n-samples, --aa on the headline and disk paths, --metric
    kottler with and without --disk) now pass; an orbiting camera around a
    static family raises as JAX's render_disk_static does, naming the
    Kerr-Schild disk path; --metric kerr runs with --n-samples 0, and with
    the default --n-samples on the disk path (which samples no
    trajectories); the rotating regular families and Kerr-de Sitter (item
    9) pass with and without --disk."""
    args = targs.parse_args(flags + ["--device", "cpu"])
    if item is None:
        tmain.check_ported(args, targs.scene_from_args(args))
    else:
        match = f"item {item}\\)" if item.isdigit() else item
        with pytest.raises(NotImplementedError, match=match):
            tmain.check_ported(args, targs.scene_from_args(args))
    for argv in (["--metric", "kerr", "--spin", "0.5", "--n-samples", "0"],
                 ["--disk", "--metric", "kerr", "--spin", "0.9",
                  "--camera-omega", "zamo", "--save-transfer", "t.npz"]):
        ok = targs.parse_args(argv)
        tmain.check_ported(ok, targs.scene_from_args(ok))


def test_aa_with_save_transfer_exits():
    """--aa with --save-transfer exits with a message before any work, as
    the JAX CLI does (a reshade would undo the antialiased pixels)."""
    args = targs.parse_args(["--disk", "--metric", "kerr", "--spin", "0.9",
                             "--aa", "2", "--save-transfer", "t.npz",
                             "--device", "cpu"])
    with pytest.raises(SystemExit, match="--save-transfer with --aa"):
        tmain.check_ported(args, targs.scene_from_args(args))


def test_flag_parity():
    """Every flag of grtrace/cli/args.py by the same name, with the same
    default; --backend also takes the port's names, and --device is
    new."""
    jp, tp = jargs.build_parser(), targs.build_parser()
    jact = {a.dest: a for a in jp._actions if a.dest != "help"}
    tact = {a.dest: a for a in tp._actions if a.dest != "help"}
    assert set(tact) == set(jact) | {"device"}
    for dest, a in jact.items():
        assert tact[dest].option_strings == a.option_strings, dest
        assert tact[dest].default == a.default, dest
        if dest != "backend":
            assert tact[dest].choices == a.choices, dest
    assert set(tact["backend"].choices) == {"auto", "cuda", "torch",
                                            "pallas", "xla"}
    assert tact["device"].default == "cuda"
    a = targs.parse_args(["--backend", "pallas"])
    assert targs.scene_from_args(a).integrator.backend == "cuda"


def test_flat_render_matches_jax():
    """The flat renderer on the CLI's scene: pixels equal; trajectories
    within 1e-5 (a few float32 ulps at r ~ 30: XLA contracts the camera's
    multiply-adds, Queue C)."""
    bg = np.random.default_rng(1).integers(0, 255, (48, 48, 3),
                                           dtype=np.uint8)
    kw = dict(boundary_radius=31.0, patch_center_theta=np.pi / 2,
              patch_center_phi=np.pi, patch_size_theta=np.pi,
              patch_size_phi=np.deg2rad(300), flip_theta=True,
              flip_phi=True, n_sampled=10, seed=0)
    ji, jt = jflat.flat_render_scene(JScene(size=48).observer(), bg, **kw)
    ti_, tt = tflat.flat_render_scene(TScene(size=48).observer(), bg,
                                      device="cpu", **kw)
    assert ti_.dtype == np.uint8 and np.array_equal(ti_, np.asarray(ji))
    assert ti_.any()
    np.testing.assert_allclose(np.array(tt), np.array(jt), rtol=0,
                               atol=1e-5)


def _photon_arrays(rng, h=3, w=4):
    n = h * w
    return (h, w, rng.normal(size=n) * 30, rng.normal(size=n),
            rng.normal(size=n), rng.integers(0, 5, n).astype(np.int32),
            rng.normal(size=(n, 3)), rng.normal(size=(n, 4)),
            np.abs(rng.normal(size=n)))


def test_csv_writers_match_the_reference(tmp_path):
    """The port's native writers byte for byte against grtrace's native
    ones on the same arrays; the pure-Python writers give the same text
    (so the same parsed values)."""
    from grtrace import native as jnative
    from grtrace_torch import native as tnative
    rng = np.random.default_rng(3)
    arrays = _photon_arrays(rng)
    xyz, heading = rng.normal(size=(3, 5, 3)) * 20, rng.normal(size=(3, 3))
    files = {}
    for tag, photon, sampled in (
            ("jax", jnative.write_photon_csv, jnative.write_sampled_csv),
            ("native", tnative.write_photon_csv, tnative.write_sampled_csv)):
        assert photon(str(tmp_path / f"{tag}_p.csv"), *arrays)
        assert sampled(str(tmp_path / f"{tag}_s.csv"), xyz, heading)
    tart.write_photon_csv_python(tmp_path / "python_p.csv", *arrays)
    tart.write_sampled_csv_python(tmp_path / "python_s.csv", xyz, heading)
    for tag in ("jax", "native", "python"):
        files[tag] = [(tmp_path / f"{tag}_{k}.csv").read_bytes()
                      for k in "ps"]
    assert files["native"] == files["jax"]
    assert files["python"] == files["jax"]


def test_png_writer_matches_the_reference(tmp_path):
    """The standard-library PNG writer decodes (Pillow) to the array that
    grtrace.io.artifacts.save_image writes; the port's reader agrees."""
    img = np.random.default_rng(4).integers(0, 256, (7, 5, 3), np.uint8)
    jart.save_image(img, str(tmp_path / "j.png"))
    tart.save_image(img, str(tmp_path / "t.png"))
    t = np.array(Image.open(tmp_path / "t.png"))
    assert np.array_equal(t, np.array(Image.open(tmp_path / "j.png")))
    assert np.array_equal(t, img)
    assert np.array_equal(tart.read_png(str(tmp_path / "t.png")), img)


def test_single_ray_cpu(tmp_path):
    """The single-ray driver's default ray (float64, every step kept) at a
    cut budget: the launch state equals the JAX driver's, the record
    starts there and the CSV holds it in degrees."""
    from grtrace.physics.nullcond import build_null_4momentum as jbuild
    out_csv = tmp_path / "ray.csv"
    with redirect_stdout(io.StringIO()):
        traj = single_ray.main(["--steps", "600", "--device", "cpu",
                                "--no-plots", "--out-csv", str(out_csv)])
    args = single_ray.build_parser().parse_args([])
    q0, p0 = single_ray.initial_state(args)
    want = np.asarray(jbuild(np.array(single_ray.DEFAULT_P_DIR),
                             np.array([35.0, np.pi / 2, 0.0])))
    np.testing.assert_allclose(p0[0].numpy(), want, rtol=0, atol=1e-15)
    assert traj.shape == (600, 4) and traj.dtype == np.float64
    assert np.array_equal(traj[0], q0[0].numpy())
    header, rows = read_csv(out_csv)
    assert header == ["t", "r", "theta", "phi"] and rows.shape == (600, 4)
    np.testing.assert_allclose(rows.astype(float)[:, 2],
                               np.degrees(traj[:, 2]), rtol=1e-15)


def test_band_sweep_cpu(tmp_path):
    """The band sweep at 16x16 and 400 steps with 4 rays: the render's
    image and the rays' records, which start at the observer."""
    with redirect_stdout(io.StringIO()):
        res, traj = band_sweep.main(
            ["--size", "16", "--steps", "400", "--n-rays", "4", "--device",
             "cpu", "--no-plots", "--out-dir", str(tmp_path)])
    assert res.image.shape == (16, 16, 3)
    assert (tmp_path / "theta_band_image.png").exists()
    assert traj.shape == (4, 400, 4) and traj.dtype == np.float32
    np.testing.assert_allclose(traj[:, 0, 1], band_sweep.OBS_X)


def test_probe(capsys):
    """The probe's CPU check passes; the card's probe fails without a
    card, saying so."""
    assert probe.probe("cpu")
    if not torch.cuda.is_available():
        assert not probe.probe("cuda")
        assert "no CUDA device" in capsys.readouterr().out


def test_plots_topdown_writes_its_file(tmp_path):
    """The plots import matplotlib when they draw: the top-down view
    writes its file."""
    from grtrace_torch.viz import plots
    scene = TScene(size=8)
    path = tmp_path / "top.png"
    with redirect_stdout(io.StringIO()):
        plots.plot_scene_topdown(scene.black_hole(), scene.observer(),
                                 scene.image_size, scene.boundary_radius,
                                 out_path=str(path))
    assert path.exists()
    assert os.path.getsize(path) > 0


def test_cli_refuses_plots_without_matplotlib(monkeypatch, background,
                                              tmp_path):
    """Without matplotlib and without --no-plots the CLI exits with a
    message before it renders anything."""
    from grtrace_torch.viz import plots
    monkeypatch.setattr(plots, "available", lambda: False)
    argv = [a for a in CLI_ARGS if a != "--no-plots"]
    with pytest.raises(SystemExit) as exc:
        tmain.main(argv + ["--background", background, "--out-dir",
                           str(tmp_path), "--device", "cpu"])
    assert "--no-plots" in str(exc.value.code)
    assert not any(tmp_path.iterdir())


def test_backgrounds(monkeypatch, tmp_path, background):
    """A relative background is found through GRTRACE_ASSET_PATH; a
    procedural one needs nothing; a file one needs Pillow and says so."""
    rel = os.path.basename(background)
    monkeypatch.chdir(tmp_path)
    assert tart.resolve_background(rel) == rel  # not found: unchanged
    assert not tart.background_available(rel)
    monkeypatch.setenv("GRTRACE_ASSET_PATH", os.path.dirname(background))
    assert tart.resolve_background(rel) == background
    assert tart.load_background(rel, size=(8, 6)).shape == (6, 8, 3)
    assert tart.load_background("procedural:checker",
                                size=(8, 6)).shape == (6, 8, 3)
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    with pytest.raises(RuntimeError, match="Pillow"):
        tart.load_background(rel)


def test_euler_matches_jax():
    """The legacy Euler integrator (and the index raising that feeds it
    FANTASY momenta) against the JAX package's on the same float64 rays:
    within 1e-10 after 200 steps (XLA's FMAs, Queue C)."""
    import jax.numpy as jnp
    from grtrace.engine import euler as je
    from grtrace_torch.engine import euler as te
    from grtrace_torch.physics.camera import camera_rays
    obs = torch.tensor([30.0, 0.0, 0.0], dtype=torch.float64)
    q0, p0, *_ = camera_rays(obs, np.radians(80.0), 2, 2,
                             dtype=torch.float64)
    q0, p0 = q0.reshape(-1, 4), p0.reshape(-1, 4)
    pu = te.raise_index(q0, p0, 2.0)
    jpu = je.raise_index(jnp.asarray(q0.numpy()), jnp.asarray(p0.numpy()),
                         2.0)
    np.testing.assert_allclose(pu.numpy(), np.asarray(jpu), rtol=1e-15)
    got = te.euler_integrate_batch(q0, pu, 200, 0.05, 2.0)
    want = je.euler_integrate_batch(jnp.asarray(q0.numpy()),
                                    jnp.asarray(pu.numpy()), 200, 0.05, 2.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-10)
    traj = te.euler_integrate_batch_full(q0, pu, 200, 0.05, 2.0)
    assert traj.shape == (4, 200, 4) and torch.equal(traj[:, 0], q0)


def test_metrics_table_roofline_and_trace(tmp_path):
    """The one operations table (chip_smoke.py reads it too), a roofline
    that reports no share without a card, the summary's keys as the JAX
    package's, and the profiler's Chrome trace."""
    from grtrace.engine.metrics import RenderMetrics as JMetrics
    from grtrace_torch.engine import metrics as tm
    assert tm.flops_per_ray_step("fantasy_eqc") == 218
    assert tm.flops_per_ray_step("fantasy_traj", order=4) == 3 * 255 + 2
    assert tm.flops_per_ray_step("fantasy_gen", order=4) == 3 * 532 + 2
    assert tm.KERNEL_OPS["fantasy_gen_traj_bl"] == tm.KERNEL_OPS["fantasy_gen"]
    # S1 steps as B3 does; its single-chain floor on the CLI's longest ray
    assert (tm.KERNEL_OPS["fantasy_traj"][:2]
            == tm.KERNEL_OPS["fantasy_schw16"][:2])
    assert tm.chain_floor_ms("fantasy_traj", 6701, 2, 1.98e9) == \
        pytest.approx(257 * 6701 / 1.98e9 * 1e3)
    rep = tm.roofline_report(1e9, "fantasy_traj")
    assert rep["sustained_flops"] == 1e9 * 257
    if not torch.cuda.is_available():
        assert rep["share_of_peak"] is None and "not measured" in rep["card"]
    rm = tm.RenderMetrics(rays=10, geodesic_steps=100)
    with rm.stage("device_pipeline"):
        pass
    assert set(rm.summary()) == set(JMetrics().summary())
    with tm.trace(str(tmp_path)) as prof:
        (torch.arange(4.0) * 2).sum()
    assert (tmp_path / "trace.json").exists()
    assert tm.device_summary(prof, 1.0)["device_ms"] == 0 or \
        torch.cuda.is_available()


@pytest.mark.parametrize("flags,kernel", [
    ([], "fantasy_eqc"), (["--dtype", "float64"], "fantasy_eq"),
    (["--metric", "kerr", "--spin", "0.5"], "fantasy_ks"),
    (["--metric", "kerr", "--spin", "0.5", "--dtype", "float64"],
     "fantasy_ks_plain")])
def test_roofline_counts_the_layout_the_render_runs(flags, kernel):
    """--print-metrics takes the operation counts of the layout that the
    render dispatches on: B1 or B2 on the headline path; for Kerr rays
    B5's 32-row compensated layout in float32 and its 16-row plain one in
    float64, which skips the Kahan adds (3 flows x 7 rows x 3 and the
    compensated mixing's 24 per substep, 2 x 21 per ray)."""
    from grtrace_torch.engine import metrics as tm
    args = targs.parse_args(flags + ["--n-samples", "0"])
    assert tmain.roofline_kernel(targs.scene_from_args(args)) == kernel
    comp = tm.KERNEL_OPS["fantasy_ks"]
    plain = tm.KERNEL_OPS["fantasy_ks_plain"]
    assert plain == (comp[0] - 3 * 7 * 3 - 24, comp[1], comp[2] - 2 * 21)
    assert tm.kernel_ops(kernel, 1000, 7) == \
        1000 * tm.flops_per_ray_step(kernel) + 7 * tm.KERNEL_OPS[kernel][2]
