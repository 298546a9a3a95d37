"""sharding/mesh.py and sharding/grid.py on torch.distributed: the sharded
renderers and sweeps at world sizes 1 (no process group), 2 (a 1 x 2
mesh) and 4 (2 x 2), gloo ranks on the CPU spawned once for the module
(torch.multiprocessing, file:// stores), against each other and against
the JAX package's sharded functions on a 2 x 2 mesh of its virtual CPU
devices.

Tolerances:
  * across world sizes: the images, classes and step counts bit for bit
    (a pixel's result does not depend on the launch it rides in or the
    rank that traces it); the reduced line-profile and subring rows
    within 1e-12 relative in float64 and 1e-5 in float32 of the largest
    (the rays' partial sums are added in another order); the Fisher rows
    bit for bit (each point is computed whole on one rank);
  * against JAX (XLA contracts multiply-adds into FMAs and runs the
    unstaggered autodiff step where the port runs the kernels' staggered
    layouts): equal classes, images equal but for texels at a boundary
    (at most 1% of the background pixels), step counts within 6 of
    captured rays (ROADMAP Queue C: the count near the horizon); the
    float64 sweeps within 1e-10 of the largest bin, the Fisher errors and
    correlation within 1e-8 relative; the float32 sweep (the compensated
    32-row layout of kernel B6, both emissivities) on the same bins as
    JAX's float32 sweep and within 5e-4 of its largest bin, and within
    1e-5 of JAX's float64 sweep (emissivity 3): JAX's float32 sweep on
    the CPU is itself 1.4e-4 of its largest bin from its float64 one,
    where the port's is 8e-7 from it (a 1 x 1 mesh, the same inputs);
  * the rotating regular families' frames equal their single-device
    frames bit for bit, and in float64 JAX's (its XLA autodiff engine on
    the 2 x 2 mesh): classes, images and step counts equal; Kerr-de
    Sitter's spherical chart is refused, as JAX's assertion refuses it.

At most six tests a file: pytest-xdist's --dist loadfile hands out
the files with the most tests first, so a file this small runs after
the suite's long few-test files instead of ahead of them.
"""
import math
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from grtrace_torch.sharding import grid as tg
from grtrace_torch.sharding import mesh as tm

SIZE, F = 16, 2
BG = np.random.default_rng(7).integers(0, 256, (8, 8, 3), dtype=np.uint8)
OBS_X = np.full(F, 30.0)
PHIS = np.pi + np.array([0.0, 0.5])
PATCH = (math.pi / 2, PHIS, math.pi, math.radians(350.0))
SPINS4 = np.array([0.5, 0.5, 0.9, 0.9])
ELEVS4 = np.deg2rad([30.0, 60.0, 30.0, 60.0])
FISHER = dict(size=10, steps=400, delta=0.2, n_bins=24)
GRID = (30.0, math.radians(80.0), 1.0, 0.0, 31.0, 500, 0.1, 1.0, 12.0)
# the renders' budget: every ray escapes or falls in but a few Kerr ones
RENDER = (500, 0.15, 1.0)
# the rotating-Bardeen frames (a = 0.9, g = 0.2): mass, spin, boundary,
# steps, delta, omega
ROT = (1.0, 0.9, 31.0, 300, 0.2, 1.0)


def _run_all(mesh):
    """Every sharded function on `mesh`, on the CPU; host tensors."""
    out = {}
    r = tm.render_frames_sharded(
        mesh, BG, OBS_X, math.radians(80.0), 1.0, 31.0, *RENDER,
        *PATCH, height=SIZE, width=SIZE, device="cpu")
    out["schw"] = r
    out["kerr"] = tm.render_kerr_sharded(
        mesh, BG, OBS_X, math.radians(80.0), 1.0, 0.9, 31.0, *RENDER,
        *PATCH, height=SIZE, width=SIZE, charge=0.3, dtype=torch.float64,
        device="cpu")
    out["disk"] = tm.render_disk_sharded(
        mesh, BG, OBS_X, math.radians(80.0), 1.0, 0.9, 31.0, *RENDER,
        math.radians(12.0), 2.32, 14.0, 9000.0, 2.5, *PATCH,
        height=SIZE, width=SIZE, dtype=torch.float64, profile="novikov",
        device="cpu")
    out["line32"] = tg.line_profile_grid_sharded(
        mesh, SPINS4, ELEVS4, *GRID, height=SIZE, width=SIZE, n_bins=24,
        emissivity=(3.0, 2.0), device="cpu")
    out["line64"] = tg.line_profile_grid_sharded(
        mesh, SPINS4, ELEVS4, *GRID, height=SIZE, width=SIZE, n_bins=24,
        dtype=torch.float64, device="cpu")
    out["subring"] = tg.subring_grid_sharded(
        mesh, SPINS4[1:3], ELEVS4[1:3], *GRID, height=SIZE, width=SIZE,
        dtype=torch.float64, device="cpu")
    out["fisher"] = tg.fisher_grid_sharded(
        mesh, SPINS4[1:3], ELEVS4[1:3], 0.01, device="cpu", **FISHER)
    return out


def _worker(rank, tmp):
    """World 4 on every rank, then world 2 on ranks 0 and 1 while rank 3
    computes the one-rank reference (no process group)."""
    torch.set_num_threads(1)
    results = {}
    for world, shape in ((4, (2, 2)), (2, (1, 2))):
        if rank >= world:
            break
        dist.init_process_group("gloo", init_method=f"file://{tmp}/s{world}",
                                rank=rank, world_size=world)
        try:
            results[world] = _run_all(tm.make_mesh(*shape))
        finally:
            dist.destroy_process_group()
    if rank == 3:
        results[1] = _run_all(tm.make_mesh(1, 1))
    if rank in (0, 3):
        torch.save(results, os.path.join(tmp, f"rank{rank}.pt"))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{1: no process group, 2: 1 x 2 mesh, 4: 2 x 2 mesh} -> results."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("gloo")
    mp.spawn(_worker, args=(str(tmp),), nprocs=4, join=True)
    results = torch.load(tmp / "rank0.pt")
    results[1] = torch.load(tmp / "rank3.pt")[1]
    return results


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's sharded functions on a 2 x 2 mesh of its CPU devices (once)."""
    import jax
    import jax.numpy as jnp

    from grtrace.sharding import grid as jg
    from grtrace.sharding import mesh as jm
    mesh = jm.make_mesh(2, 2, devices=jax.devices()[:4])
    bg = jnp.asarray(BG)
    out = {"schw": jm.render_frames_sharded(
        mesh, bg, OBS_X, np.radians(80.0), 1.0, 31.0, *RENDER, *PATCH,
        height=SIZE, width=SIZE)}
    out["kerr"] = jm.render_kerr_sharded(
        mesh, bg, OBS_X, np.radians(80.0), 1.0, 0.9, 31.0, *RENDER,
        *PATCH, height=SIZE, width=SIZE, charge=0.3, dtype=jnp.float64)
    out["disk"] = jm.render_disk_sharded(
        mesh, bg, OBS_X, np.radians(80.0), 1.0, 0.9, 31.0, *RENDER,
        np.radians(12.0), 2.32, 14.0, 9000.0, 2.5, *PATCH, height=SIZE,
        width=SIZE, dtype=jnp.float64, profile="novikov")
    out["line32"] = jg.line_profile_grid_sharded(
        mesh, SPINS4, ELEVS4, *GRID, height=SIZE, width=SIZE, n_bins=24,
        emissivity=(3.0, 2.0))
    out["line64"] = jg.line_profile_grid_sharded(
        mesh, SPINS4, ELEVS4, *GRID, height=SIZE, width=SIZE, n_bins=24,
        dtype=jnp.float64)
    out["subring"] = jg.subring_grid_sharded(
        mesh, SPINS4[1:3], ELEVS4[1:3], *GRID, height=SIZE, width=SIZE,
        dtype=jnp.float64)
    out["fisher"] = jg.fisher_grid_sharded(
        jm.make_mesh(2, 1, devices=jax.devices()[:2]), SPINS4[1:3],
        ELEVS4[1:3], 0.01, **FISHER)
    out["rot"] = jm.render_kerr_sharded(
        mesh, bg, OBS_X, np.radians(80.0), *ROT, *PATCH, height=4, width=4,
        metric="RotatingBardeen", charge=0.2, dtype=jnp.float64)
    return jax.tree_util.tree_map(np.asarray, out)


def test_renders_do_not_depend_on_the_mesh(worlds):
    """The three renderers at world sizes 1, 2 and 4: every output bit for
    bit, frames of their own (the patch rotates)."""
    for name in ("schw", "kerr", "disk"):
        one = worlds[1][name]
        assert one["image"].shape == (F, SIZE, SIZE, 3)
        assert one["cls"].shape == one["n_steps"].shape == (F, SIZE, SIZE)
        for world in (2, 4):
            for key in ("image", "cls", "n_steps"):
                assert torch.equal(worlds[world][name][key], one[key]), \
                    (name, world, key)
    assert not torch.equal(worlds[1]["schw"]["image"][0],
                           worlds[1]["schw"]["image"][1])
    assert int((worlds[1]["disk"]["cls"] == 5).sum()) > 20


def test_renders_match_jax(worlds, jax_ref):
    """The world-4 renders against JAX's on its 2 x 2 mesh."""
    for name in ("schw", "kerr", "disk"):
        got = {k: v.numpy() for k, v in worlds[4][name].items()}
        want = jax_ref[name]
        np.testing.assert_array_equal(got["cls"], want["cls"])
        differ = (got["image"] != want["image"]).any(-1)
        assert differ.sum() <= max(1, 0.01 * (want["cls"] == 2).sum()), name
        assert not differ[want["cls"] == 5].any(), name  # disk pixels exact
        escaped = want["cls"] != 0
        np.testing.assert_array_equal(got["n_steps"][escaped],
                                      want["n_steps"][escaped])
        assert np.abs(got["n_steps"] - want["n_steps"]).max() <= 6, name


def test_grids_do_not_depend_on_the_mesh(worlds):
    """The line-profile and subring sweeps within rounding across world
    sizes; the Fisher map bit for bit."""
    for name, rtol in (("line32", 1e-5), ("line64", 1e-12)):
        one = worlds[1][name]
        assert one.shape == ((4, 2, 24) if name == "line32" else (4, 1, 24))
        assert float(one.min()) >= 0.0 and float(one.max()) > 0.0
        for world in (2, 4):
            np.testing.assert_allclose(worlds[world][name].numpy(),
                                       one.numpy(), rtol=0,
                                       atol=rtol * float(one.max()))
    for world in (2, 4):
        for got, one in zip(worlds[world]["subring"], worlds[1]["subring"]):
            np.testing.assert_allclose(got.numpy(), one.numpy(), rtol=1e-12,
                                       atol=1e-12)
        assert torch.equal(worlds[world]["fisher"], worlds[1]["fisher"])


def test_grids_match_jax(worlds, jax_ref):
    """The float64 and float32 sweeps and the Fisher map against JAX's."""
    got = worlds[4]["line64"].numpy()
    np.testing.assert_allclose(got, jax_ref["line64"], rtol=0,
                               atol=1e-10 * np.abs(jax_ref["line64"]).max())
    line32 = worlds[4]["line32"].numpy()
    assert line32.dtype == jax_ref["line32"].dtype == np.float32
    np.testing.assert_array_equal(line32 > 0, jax_ref["line32"] > 0)
    np.testing.assert_allclose(line32, jax_ref["line32"], rtol=0,
                               atol=5e-4 * np.abs(jax_ref["line32"]).max())
    np.testing.assert_allclose(line32[:, :1], jax_ref["line64"], rtol=0,
                               atol=1e-5 * np.abs(jax_ref["line64"]).max())
    for g, w in zip(worlds[4]["subring"], jax_ref["subring"]):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9, atol=1e-12)
    fisher = worlds[4]["fisher"].numpy()
    assert fisher.dtype == np.float64 and fisher.shape == (2, 3)
    assert (fisher[:, :2] > 0).all() and (np.abs(fisher[:, 2]) < 1).all()
    np.testing.assert_allclose(fisher, jax_ref["fisher"], rtol=1e-8)


def test_rotating_regular_frames_raise_item_9(jax_ref):
    """render_kerr_sharded's rotating regular branch (ported; named when
    it raised) gives, on a mesh of one, each frame's classes and step
    counts bit for bit as the single-device render_pixels_generic at the
    same patch, and in float64 JAX's sharded frames on its 2 x 2 mesh
    (image, classes, step counts equal); Kerr-de Sitter's spherical chart
    raises ValueError where JAX's assertion refuses it."""
    from grtrace_torch.engine.render_generic import render_pixels_generic
    mesh = tm.make_mesh(1, 1)
    args = (mesh, BG, OBS_X, math.radians(80.0), *ROT, *PATCH)
    got = tm.render_kerr_sharded(*args, height=4, width=4,
                                 metric="RotatingBardeen", charge=0.2,
                                 dtype=torch.float64, device="cpu")
    for key in ("image", "cls", "n_steps"):
        np.testing.assert_array_equal(got[key].numpy(), jax_ref["rot"][key])
    assert len(np.unique(jax_ref["rot"]["cls"])) >= 2
    out = tm.render_kerr_sharded(*args, height=4, width=4,
                                 metric="RotatingBardeen", charge=0.2,
                                 device="cpu")
    for k in range(F):
        one = render_pixels_generic(
            torch.as_tensor(BG), 30.0, math.radians(80.0), 1.0, 0.9, 31.0,
            300, 0.2, 1.0, PATCH[0], float(PHIS[k]), PATCH[2], PATCH[3],
            height=4, width=4, metric="RotatingBardeen", charge=0.2)
        assert torch.equal(out["cls"][k].cpu(), one["cls"])
        assert torch.equal(out["n_steps"][k].cpu(), one["n_steps"])
    with pytest.raises(ValueError, match="Cartesian chart"):
        tm.render_kerr_sharded(*args, height=4, width=4, metric="KerrDS",
                               charge=1e-3, device="cpu")
    from grtrace.sharding import mesh as jm
    with pytest.raises(AssertionError, match="Cartesian chart"):
        jm.render_kerr_sharded(None, BG, OBS_X, math.radians(80.0), *ROT,
                               *PATCH, height=4, width=4, metric="KerrDS",
                               charge=1e-3)
    with pytest.raises(ValueError, match="ranks"):
        tm.make_mesh(2, 1)
    assert tm.rank_device("cpu") == torch.device("cpu")
    assert tm.rank_device("cuda") == torch.device("cuda", 0)
