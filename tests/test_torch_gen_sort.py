"""Kernel G1's cost sort (engine/integrate_generic_cuda.py), on the CPU:
the Boyer-Lindquist cost key, the wrappers' sort and un-sort around the
launch, and `launch_order`, the launch rule of every chart.  G1 itself
runs only on the card (chip_smoke.py phases 34-36 hold it against its
twin there; the launch order cannot change a ray's bits).

At most six tests a file: pytest-xdist's --dist loadfile hands out the
files with the most tests first, so a file this small runs after the
suite's long few-test files instead of ahead of them.
"""
import math

import numpy as np
import pytest
import torch

from grtrace_torch.engine import integrate_generic as tig
from grtrace_torch.engine import integrate_generic_cuda as tgc
from grtrace_torch.physics.camera import camera_rays_unfolded
from grtrace_torch.physics.spacetime import kerr_g_inv

B_CRIT = 3.0 * math.sqrt(3.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bl_cost_key_is_finite_at_the_pole(dtype):
    """Rays on and beside the chart's pole (sin theta 0, subnormal, 1e-8)
    with p_phi != 0 get finite keys; on the equator the key is |b -
    3 sqrt(3) M| with b = sqrt(p_theta^2 + p_phi^2) / |p_t|."""
    theta = [0.0, 1e-30, 1e-8, math.pi - 1e-8, math.pi, math.pi / 2]
    q = torch.tensor([[0.0, 30.0, th, 0.3] for th in theta], dtype=dtype)
    p = torch.tensor([[-1.0, -0.9, 2.0, 5.0]] * len(theta), dtype=dtype)
    key = tgc._cost_sort_key_bl(q, p, 1.0)
    assert key.dtype == torch.float64 and torch.isfinite(key).all()
    assert (key[:5] > 1e3).all()  # p_phi / sin(theta) dominates there
    assert key[5].item() == pytest.approx(abs(math.hypot(2.0, 5.0) - B_CRIT),
                                          rel=1e-6)


def test_bl_cost_key_clusters_the_photon_ring():
    """On the 24x24 unfolded camera at a = 0.9 (the twin integrates it,
    delta 0.1), the tenth of the rays that take the most steps, those that
    wind near the photon ring, all fall in the first sixth of the launch
    order."""
    params = (1.0, 0.9, 0.0)
    q0, p0, _ = camera_rays_unfolded(
        torch.tensor([30.0, 0.0, 0.0], dtype=torch.float64),
        torch.tensor(np.radians(80.0), dtype=torch.float64), 24, 24,
        params=params, g_inv_fn=kerr_g_inv, dtype=torch.float64)
    q0, p0 = q0.reshape(-1, 4), p0.reshape(-1, 4)
    *_, ns = tig.integrate_batch_generic(q0, p0, 3000, 0.1, params, 31.0,
                                         1.0)
    order, q_s, p_s = tgc._sorted_rays(q0, p0, 1.0)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel())
    longest = torch.argsort(ns.abs(), descending=True)[:ns.numel() // 10]
    assert int(rank[longest].max()) < ns.numel() // 6
    assert torch.equal(q_s, q0[order]) and torch.equal(p_s, p0[order])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sort_and_unsort_are_inverse(dtype):
    """`_unsorted` puts G1's (12, N) rows and step counts, launched in the
    order `_sorted_rays` gives, back in the caller's order, bit for bit,
    with duplicate rays (equal keys) among them."""
    rng = np.random.default_rng(3)
    q0 = torch.tensor(rng.uniform(0.0, 3.0, (500, 4)), dtype=dtype)
    p0 = torch.tensor(rng.normal(size=(500, 4)), dtype=dtype)
    q0[250:300], p0[250:300] = q0[:50], p0[:50]
    order, q_s, p_s = tgc._sorted_rays(q0, p0, 1.0)
    assert torch.equal(torch.sort(order).values, torch.arange(500))
    steps = torch.tensor(rng.integers(-9, 9, 500), dtype=torch.int32)
    out, ns = tgc._unsorted(order, torch.cat([q_s.T, p_s.T, q_s.T]),
                            steps[order])
    assert torch.equal(out, torch.cat([q0.T, p0.T, q0.T]))
    assert torch.equal(ns, steps)


def test_launch_order_is_a_permutation_the_unsort_inverts():
    """`launch_order`, the one rule of G1's and the 20-row disk kernels'
    wrappers, in the Boyer-Lindquist (Kerr, Kerr-de Sitter, a static
    family with its b_crit) and the Cartesian (rotating Bardeen) charts:
    a permutation of the rays, the stable argsort of the chart's cost
    key, and `_unsorted` puts rows launched in it back in the caller's
    order bit for bit."""
    rng = np.random.default_rng(5)
    n = 777
    cases = {"Kerr": None, "KerrDS": None, "Bardeen": 5.1,
             "RotatingBardeen": None}
    for metric, b_crit in cases.items():
        q0 = torch.tensor(rng.uniform(0.5, 3.0, (n, 4)), dtype=torch.float64)
        p0 = torch.tensor(rng.normal(size=(n, 4)), dtype=torch.float64)
        q0[400:450], p0[400:450] = q0[:50], p0[:50]   # equal keys
        order = tgc.launch_order(q0, p0, 1.0, metric, b_crit)
        assert torch.equal(torch.sort(order).values, torch.arange(n))
        key = (tgc._cost_sort_key_ks(q0, p0, 1.0)
               if metric == "RotatingBardeen"
               else tgc._cost_sort_key_bl(q0, p0, 1.0, b_crit))
        assert torch.equal(order, torch.argsort(key, stable=True))
        steps = torch.tensor(rng.integers(-9, 9, n), dtype=torch.int32)
        rows = torch.cat([q0.T, p0.T, q0.T])
        out, ns = tgc._unsorted(order, rows[:, order], steps[order])
        assert torch.equal(out, rows) and torch.equal(ns, steps)
