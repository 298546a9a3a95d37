"""The adaptive antialiasing helpers of the port (`engine/aa.py`) and its
fractional-pixel cameras (`physics/camera.py`) against the JAX package on
the same seeded inputs, on the CPU.

Tolerances, with their reasons:
  * edge scores, the pick budget, the picks (in order), the subring labels
    and the scattered image: exact (integer arithmetic; the picks follow
    JAX's top_k order, ties to the lower index, even where a frame has
    more edge pixels than the budget);
  * the sub-pixel offsets: bit for bit (the same division in the same
    dtype);
  * the fractional cameras against JAX's: within 1 ulp per component (the
    port sums the two image-plane offsets before adding the plane centre,
    as its pixel_grid does; JAX adds them to the centre one by one);
    against the port's own pixel grids: bit for bit, integer centres at
    size N and, with s = 2, the sub-pixels at the 2N grid's pixels.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.engine import aa as jaa
from grtrace.physics import camera as jcam
from grtrace_torch.engine import aa as taa
from grtrace_torch.physics import camera as tcam

torch.set_num_threads(1)

FOV = math.radians(80.0)
ELEV = math.radians(12.0)
DTYPES = [(torch.float32, jnp.float32), (torch.float64, jnp.float64)]


def _class_maps():
    rng = np.random.default_rng(11)
    disc = np.zeros((24, 20), np.int32)
    ii, jj = np.mgrid[0:24, 0:20]
    disc[(ii - 11.5) ** 2 + (jj - 9.5) ** 2 < 36] = 4
    disc[:, 16:] = 1
    return {"disc": disc,
            "noise": rng.integers(0, 5, (40, 40)).astype(np.int32),
            "flat": np.full((8, 12), 2, np.int32),
            "strip": rng.integers(0, 2, (1, 30)).astype(np.int32)}


@pytest.mark.parametrize("name", sorted(_class_maps()))
def test_edge_scores_and_picks_match_jax(name):
    """Scores equal JAX's; the picks equal JAX's top_k picks that score,
    in its order.  'noise' has more edge pixels than the budget, so only
    the tie rule decides which of them are picked."""
    cls = _class_maps()[name]
    h, w = cls.shape
    score = taa.edge_scores(torch.from_numpy(cls))
    np.testing.assert_array_equal(score.numpy(),
                                  np.asarray(jaa.edge_scores(jnp.asarray(cls))))
    k_edge = taa.default_k_edge(h, w)
    assert k_edge == jaa.default_k_edge(h, w)
    idx, valid, _, _ = jaa._select_edges(jnp.asarray(cls), w, k_edge,
                                         jnp.float64)
    want = np.asarray(idx)[np.asarray(valid)]
    got = taa._select_edges(torch.from_numpy(cls), k_edge).numpy()
    np.testing.assert_array_equal(got, want)
    if name == "noise":
        assert (score.numpy() > 0).sum() > k_edge == len(got)
    if name == "flat":
        assert len(got) == 0


@pytest.mark.parametrize("hw", [(1, 1), (16, 16), (20, 20), (400, 400),
                                (1024, 1024), (33, 70)])
def test_default_k_edge(hw):
    assert taa.default_k_edge(*hw) == jaa.default_k_edge(*hw)


@pytest.mark.parametrize("samples", [2, 3, 4])
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_subpixel_indices_bitwise(samples, dt):
    tdt, jdt = dt
    idx = np.array([0, 5, 17, 399, 123], np.int64)
    w = 20
    ji, jj = jaa._subpixel_indices(jnp.asarray(idx // w, jdt),
                                   jnp.asarray(idx % w, jdt), samples, jdt)
    ti, tj = taa._subpixel_indices(torch.from_numpy(idx), w, samples, tdt)
    assert ti.dtype == tdt
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tj.numpy(), np.asarray(jj))


def _sub_grid(n, dtype):
    """The s = 2 sub-pixels of every pixel of an n x n frame, and the
    permutation that lays them out as the 2n x 2n grid's pixels."""
    idx = torch.arange(n * n)
    i_f, j_f = taa._subpixel_indices(idx, n, 2, dtype)

    def as_grid(p):
        return p.reshape(n, n, 2, 2, 3).permute(0, 2, 1, 3, 4).reshape(
            2 * n, 2 * n, 3)
    return i_f, j_f, as_grid


@pytest.mark.parametrize("n", [20, 400])
@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_fractional_cameras(n, dt):
    """Both fractional cameras: integer centres give the N grid's bits,
    the s = 2 sub-pixels the 2N grid's bits, and every position is within
    1 ulp of JAX's."""
    tdt, jdt = dt
    eps = float(torch.finfo(tdt).eps)
    fov = torch.tensor(FOV, dtype=tdt)
    eq = torch.tensor([30.0, 0.0, 0.0], dtype=tdt)
    incl = torch.tensor([30.0 * math.cos(ELEV), 0.0, 30.0 * math.sin(ELEV)],
                        dtype=tdt)
    ii, jj = torch.meshgrid(torch.arange(n, dtype=tdt),
                            torch.arange(n, dtype=tdt), indexing="ij")
    i_f, j_f, as_grid = _sub_grid(n, tdt)
    for frac, grid, jfrac, obs in (
            (tcam.pixel_positions_fractional, tcam.pixel_grid,
             jcam.pixel_positions_fractional, eq),
            (tcam.pixel_positions_fractional_lookat, tcam.pixel_grid_lookat,
             jcam.pixel_positions_fractional_lookat, incl)):
        centre = frac(obs, fov, n, n, ii.reshape(-1), jj.reshape(-1),
                      dtype=tdt)
        assert torch.equal(centre.reshape(n, n, 3),
                           grid(obs, fov, n, n, dtype=tdt))
        sub = frac(obs, fov, n, n, i_f, j_f, dtype=tdt)
        assert torch.equal(as_grid(sub), grid(obs, fov, 2 * n, 2 * n,
                                              dtype=tdt))
        want = np.asarray(jfrac(jnp.asarray(obs.numpy()), jnp.asarray(
            FOV, jdt), n, n, jnp.asarray(i_f.numpy()),
            jnp.asarray(j_f.numpy()), dtype=jdt))
        ulp = eps * np.maximum(np.abs(want), 1.0)
        assert (np.abs(sub.numpy() - want) <= ulp).all()


def test_subring_labels_and_scatter_match_jax():
    """subring_edge_labels, _scatter_averaged and _scatter_averaged_stack
    equal JAX's on seeded maps (the picks are the ones that score)."""
    rng = np.random.default_rng(5)
    h = w = 12
    n_orders, s = 3, 2
    cls = rng.integers(0, 6, (h, w)).astype(np.int32)
    count = rng.integers(0, 5, (h, w)).astype(np.int32)
    valid = rng.random((n_orders, h, w)) < 0.3
    jl = np.asarray(jaa.subring_edge_labels(jnp.asarray(cls),
                                            jnp.asarray(count),
                                            jnp.asarray(valid)))
    tl = taa.subring_edge_labels(torch.from_numpy(cls),
                                 torch.from_numpy(count),
                                 torch.from_numpy(valid))
    np.testing.assert_array_equal(tl.numpy(), jl)

    k_edge = jaa.default_k_edge(h, w)
    idx, ok, _, _ = jaa._select_edges(jnp.asarray(jl), w, k_edge,
                                      jnp.float64)
    image = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    colors = rng.integers(0, 256, (k_edge * s * s, 3)).astype(np.uint8)
    maps = rng.random((n_orders, h, w))
    vals = rng.random((n_orders, k_edge * s * s))
    j_img, j_mask = jaa._scatter_averaged(jnp.asarray(image), idx, ok,
                                          jnp.asarray(colors), k_edge, s, h,
                                          w)
    j_maps = jaa._scatter_averaged_stack(jnp.asarray(maps), idx, ok,
                                         jnp.asarray(vals), k_edge, s)
    t_idx = taa._select_edges(tl, k_edge)
    n = len(t_idx)
    assert n == int(np.asarray(ok).sum()) > 0
    t_img, t_mask = taa._scatter_averaged(torch.from_numpy(image), t_idx,
                                          torch.from_numpy(colors[:n * s * s]),
                                          s)
    np.testing.assert_array_equal(t_img.numpy(), np.asarray(j_img))
    np.testing.assert_array_equal(t_mask.numpy(), np.asarray(j_mask))
    t_maps = taa._scatter_averaged_stack(
        torch.from_numpy(maps), t_idx,
        torch.from_numpy(vals.reshape(n_orders, k_edge, s * s)[:, :n]
                         .reshape(n_orders, -1)), s)
    np.testing.assert_allclose(t_maps.numpy(), np.asarray(j_maps),
                               rtol=1e-15)


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_boosted_subrays_are_the_2n_camera_rays(dt):
    """The disk and subring passes' sub-rays on the zero-angular-momentum
    camera: q0 and p0 equal, bit for bit, the boosted rays of the 2N
    look-at grid (what the 2N render launches)."""
    from grtrace_torch.physics.spacetime import kerr_schild_g_inv
    tdt = dt[0]
    n, omega = 12, 0.0123
    obs = [30.0 * math.cos(ELEV), 0.0, 30.0 * math.sin(ELEV)]
    q0, p0 = taa._lookat_subrays(
        torch.arange(n * n), obs, FOV, 1.0, 0.9, 0.0, height=n, width=n,
        samples=2, dtype=tdt, camera_moving=True, camera_omega=omega)[:2]
    params = torch.tensor([1.0, 0.9, 0.0], dtype=tdt)
    obs_t = torch.tensor(obs, dtype=tdt)
    pix = tcam.pixel_grid_lookat(obs_t, torch.tensor(FOV, dtype=tdt), 2 * n,
                                 2 * n, dtype=tdt)
    q2, p2, _ = tcam.boosted_ics_from_pixels(
        obs_t, pix, params=params, g_inv_fn=kerr_schild_g_inv,
        omega_cam=torch.tensor(omega, dtype=tdt))

    def as_grid(x):
        return x.reshape(n, n, 2, 2, 4).permute(0, 2, 1, 3, 4).reshape(
            2 * n, 2 * n, 4)
    assert torch.equal(as_grid(q0), q2)
    assert torch.equal(as_grid(p0), p2)
