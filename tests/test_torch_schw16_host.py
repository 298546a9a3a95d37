"""Kernel B3's source (the integrate mode of grtrace_torch/csrc/
fantasy_schw16.cu) built for the CPU with g++ and held bit for bit against
its eager twin's loop `fused_cores` (the loop of `integrate_batch_fused`);
and the trajectory sampler's twin `integrate_batch_full` (kernel S1's, the
record mode of the same source) held against `fused_cores`: the two twins
take the same steps.

The shim and its build are tests/test_torch_traj.py's (`build_host`): the
source compiles on the CPU as it stands (its CUDA include and launch
functions sit under __CUDACC__), a shim stands in for CUDA's keywords and
runs the kernel one thread at a time, with -ffp-contract=off so that g++
contracts no multiply-add, as nvcc's -fmad=false.  The card's own rounding
is held on the card (chip_smoke.py phases 21b and 23 for B3, 26 and 27 for
S1).

At most six tests a file: pytest-xdist's --dist loadfile hands out
the files with the most tests first, so a file this small runs after
the suite's long few-test files instead of ahead of them.
"""
import numpy as np
import pytest
import torch

from grtrace_torch.engine import integrate as ti
from grtrace_torch.physics.camera import camera_rays
from grtrace_torch.physics.hamiltonian import pack_state
from test_torch_traj import build_host

torch.set_num_threads(1)

# steps, delta, rs, r_max, omega: every ray of the 3x3 headline camera
# exits inside the budget, one of them parked by the horizon guard
ARGS = (400, 0.2, 2.0, 31.0, 1.0)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return build_host(tmp_path_factory)


def _rays(dtype):
    """The 3x3 headline camera's (9, 4) launch states."""
    obs = torch.tensor([30.0, 0.0, 0.0], dtype=dtype)
    q0, p0, *_ = camera_rays(obs, np.radians(80.0), 3, 3, dtype=dtype)
    return q0.reshape(-1, 4).contiguous(), p0.reshape(-1, 4).contiguous()


def _bits(t):
    return t.contiguous().view(torch.int32 if t.dtype == torch.float32
                               else torch.int64)


def _vec(dtype, order):
    _, delta, rs, r_max, omega = ARGS
    return ti.substep_params(delta, rs, r_max, omega, order, dtype,
                             compensated=False, staggered=False)


def _b3(host, state_in, vec, steps):
    """B3's source on a (16, n) state: (state_out, ns)."""
    state_out = torch.empty_like(state_in)
    ns = torch.zeros(state_in.shape[1], dtype=torch.int32)
    host["b3", state_in.dtype](state_in.data_ptr(), state_out.data_ptr(),
                               ns.data_ptr(), vec.data_ptr(),
                               state_in.shape[1], (vec.numel() - 3) // 3,
                               steps)
    return state_out, ns


@pytest.mark.parametrize("dtype,order", [(torch.float32, 2),
                                         (torch.float64, 4)],
                         ids=["f32-ord2", "f64-ord4"])
def test_b3_source_bitwise_equal_to_twin(host, dtype, order):
    """B3's integrate mode against `fused_cores` (the loop of
    integrate_batch_fused) on the 3x3 headline camera at delta 0.2: all 16
    rows and the step counts bit for bit, the guard's park reached; and
    two launches (150 steps, then the rest) equal to one, so the metric
    that a launch forms afresh is the one that the carry would have held."""
    q0, p0 = _rays(dtype)
    vec = _vec(dtype, order)
    steps = ARGS[0]
    state_in = torch.stack(pack_state(q0, p0)).contiguous()
    want, want_ns = ti.fused_cores(pack_state(q0, p0), steps, vec)
    got, ns = _b3(host, state_in, vec, steps)
    assert torch.equal(ns, want_ns) and int(ns.max()) < steps
    assert torch.equal(_bits(got), _bits(torch.stack(want)))
    assert bool((got[1] == ARGS[2]).any())  # a ray parked at r == rs
    half, ns1 = _b3(host, state_in, vec, 150)
    rest, ns2 = _b3(host, half, vec, steps - 150)
    assert torch.equal(ns1 + ns2, ns)
    assert torch.equal(_bits(rest), _bits(got))


@pytest.mark.parametrize("dtype,order", [(torch.float32, 2),
                                         (torch.float64, 2),
                                         (torch.float32, 4)],
                         ids=["f32-ord2", "f64-ord2", "f32-ord4"])
def test_sampler_twin_takes_b3_twins_steps(dtype, order):
    """The sampler's twin `integrate_batch_full` (every step kept) and B3's
    twin `fused_cores` on the 3x3 headline camera: each ray's last
    recorded q1, at slot n_steps (the step on which it was found inactive),
    bit for bit equal to fused_cores' q1 after n_steps steps, and nothing
    recorded past it."""
    q0, p0 = _rays(dtype)
    steps = ARGS[0]
    traj = ti.integrate_batch_full(q0, p0, *ARGS, order=order)
    state, ns = ti.fused_cores(pack_state(q0, p0), steps,
                               _vec(dtype, order))
    assert int(ns.max()) < steps  # every ray exits inside the budget
    rows = torch.arange(q0.shape[0])
    last = traj[rows, ns.long()]
    assert torch.equal(_bits(last), _bits(torch.stack(state[:4], -1)))
    live = (traj != 0).any(-1)
    assert torch.equal(live.sum(1), ns.long() + 1)


def _first_bad(rec):
    """Per ray, the first step whose (q1, p1) has a non-finite value
    (steps where there is none)."""
    bad = ~torch.isfinite(rec).all(-1)
    return torch.where(bad.any(-1), bad.int().argmax(-1),
                       torch.full(bad.shape[:1], rec.shape[1]))


def test_t1_source_bitwise_equal_to_twin(host):
    """T1 (the trace mode) against its twin `trajectory_unmasked` on the 3x3
    headline camera at delta 0.2, 400 steps, float32 at order 2 and
    float64 at order 4: every step's (q1, p1) bit for bit up to each ray's
    first non-finite value (if any), whose step agrees.  Nothing stops a
    ray, so the captured one falls through the horizon (r < rs) and is
    flung out to r of order -1e3, as JAX's scan lets it; the others pass
    the boundary sphere and run on for the whole budget."""
    steps, delta, rs, _, omega = ARGS
    for dtype, order in ((torch.float32, 2), (torch.float64, 4)):
        q0, p0 = _rays(dtype)
        want = ti.trajectory_unmasked(q0, p0, steps, delta, rs, omega,
                                      order=order)
        vec = ti.trace_params(delta, rs, omega, order, dtype)
        got = torch.full_like(want, 7.0)
        host["t1", dtype](q0.data_ptr(), p0.data_ptr(), got.data_ptr(),
                          vec.data_ptr(), q0.shape[0],
                          (vec.numel() - 3) // 3, steps)
        first = _first_bad(want)
        assert torch.equal(_first_bad(got), first)
        inside = (want[..., 1] < rs).any(-1)
        assert bool(inside.any()) and not bool(inside.all())
        for k in range(q0.shape[0]):
            n = int(first[k])
            assert torch.equal(_bits(got[k, :n]), _bits(want[k, :n])), k
