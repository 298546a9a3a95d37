"""The mass-function Kerr-Schild chart of kernels G1r, S2r, T2r and D2
(`Chart::kKSMass` of grtrace_torch/csrc/fantasy_gen.cu) built for the CPU
with g++ and held bit for bit against their eager twins in float64
(`integrate_generic_twin`, `trajectory_generic_twin`,
`trajectory_generic_unmasked`, `integrate_disk_spin_twin`).

The shim is test_torch_static_host.py's for the new chart: CUDA's keywords
stand in, the kernel runs one thread at a time, -ffp-contract=off keeps
g++ from contracting a multiply-add (nvcc's -fmad=false), and the source's
sincos and sqrt go to torch's sin, cos and sqrt of a one-element tensor
(sqrt through one preallocated tensor: the chart takes several roots a
step, and torch's CPU sqrt is not the C library's correctly rounded one,
so it cannot go straight to libm).
The float32 kernels and the card's own rounding are held on the card
(chip_smoke.py phases 57-60).
"""
import ctypes
import math
import shutil
import subprocess

import numpy as np
import pytest
import torch

from grtrace_torch.engine import integrate as ti
from grtrace_torch.engine import integrate_generic as tig
from grtrace_torch.physics import rotating_chart
from grtrace_torch.physics.camera import camera_rays_cartesian
from grtrace_torch.physics.kerr_schild import ks_radius_c
from grtrace_torch.physics.spacetime import METRICS

from test_torch_gen_host import CSRC, _SINCOS, _SQRT, _bits, _torch_sincos
from test_torch_static_host import SHIM as STATIC_SHIM

torch.set_num_threads(1)

SHIM = STATIC_SHIM.replace("Chart::kStatic", "Chart::kKSMass").replace(
    "host_g1s", "host_g1r").replace("host_s2s", "host_s2r").replace(
    "host_t2s", "host_t2r").replace("host_d1", "host_d2")

_SQRT_IN, _SQRT_OUT = np.zeros(1), np.zeros(1)
_SQRT_T = (torch.from_numpy(_SQRT_IN), torch.from_numpy(_SQRT_OUT))


def _torch_sqrt(x):
    """torch.sqrt of x as a one-element float64 tensor, through buffers
    allocated once."""
    _SQRT_IN[0] = x
    torch.sqrt(_SQRT_T[0], out=_SQRT_T[1])
    return float(_SQRT_OUT[0])


# (family, spin, parameter): sub-critical Bardeen and Hayward at a = 0.9,
# and a horizonless Bardeen (a = 0.6, g = 0.75)
CASES = [("RotatingBardeen", 0.9, 0.2), ("RotatingHayward", 0.9, 0.2),
         ("RotatingBardeen", 0.6, 0.75)]


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """fantasy_gen.cu's mass-function chart built for the CPU: {'g1r',
    's2r', 't2r', 'd2'} -> entry (float64)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this machine to build the host emulation")
    d = tmp_path_factory.mktemp("rotating_host")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "librotating_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", CSRC, "-o", str(lib), str(d / "shim.cpp")],
                   check=True, capture_output=True, text=True)
    so = ctypes.CDLL(str(lib))
    out = {"math": (_SINCOS(_torch_sincos), _SQRT(_torch_sqrt))}
    so.set_math(*out["math"])
    for name in ("g1r", "s2r", "t2r", "d2"):
        fn = getattr(so, f"host_{name}")
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 2)
        fn.restype = None
        out[name] = fn
    return out


def _rays(metric, spin, param, idx, obs=(15.0, 0.0, 0.0), fov_deg=60.0):
    """Rays `idx` of the Cartesian 8x8 camera at `obs`, float64."""
    q0, p0, _ = camera_rays_cartesian(
        torch.tensor(obs, dtype=torch.float64),
        torch.tensor(math.radians(fov_deg), dtype=torch.float64), 8, 8,
        params=(1.0, spin, param), g_inv_fn=METRICS[metric],
        dtype=torch.float64)
    return (q0.reshape(-1, 4)[idx].contiguous(),
            p0.reshape(-1, 4)[idx].contiguous())


def _n_sub(vec):
    return (vec.numel() - tig.N_SCAL) // 3


@pytest.mark.parametrize("metric,spin,param", CASES)
def test_g1r_source_bitwise_equal_to_twin(host, metric, spin, param):
    """G1r against `integrate_generic_twin(metric=...)` on every other ray
    of the 8x8 camera at r0 = 15 (fov 60 deg, boundary 16, delta 0.08,
    800 steps, order 2): q1, p1, q2 and the signed step counts bit for
    bit, with captures and escapes."""
    q0, p0 = _rays(metric, spin, param, list(range(0, 64, 2)))
    steps = 800
    vec = tig.gen_params(metric, 0.08, (1.0, spin, param), 16.0, 1.0, 2,
                         torch.float64)
    out = torch.zeros((12, 32), dtype=torch.float64)
    ns = torch.zeros(32, dtype=torch.int32)
    host["g1r"](q0.data_ptr(), p0.data_ptr(), out.data_ptr(), ns.data_ptr(),
                vec.data_ptr(), 32, _n_sub(vec), steps, 1, 0, None, None)
    state, ns_t = tig.integrate_generic_twin(q0, p0, steps, vec, metric)
    assert torch.equal(ns_t, ns)
    assert torch.equal(_bits(out), _bits(torch.stack(state[:12])))
    _, _, status, _ = tig.finish_generic_rotating(
        tuple(out), ns, q0, p0, vec, metric, (1.0, spin, param))
    assert bool((status == ti.STATUS_ESCAPED).any())
    assert bool((status == ti.STATUS_CAPTURED).any())


def test_s2r_t2r_order4_source_bitwise_equal_to_twins(host):
    """S2r (q1 every 4th step, 200 steps, n_keep 50) and T2r (every step's
    (q1, p1), 100 steps) at order 4 in each family against
    `trajectory_generic_twin` and `trajectory_generic_unmasked`: every slot
    and every row bit for bit, the zero slots past an exit included."""
    for metric, spin, param in CASES:
        q0, p0 = _rays(metric, spin, param, [9, 27, 28])
        vec = tig.gen_params(metric, 0.1, (1.0, spin, param), 16.0, 1.0, 4,
                             torch.float64)
        steps, (stride, n_keep) = 200, ti.traj_layout(200, 50)
        traj = torch.zeros((3, n_keep, 4), dtype=torch.float64)
        ns = torch.zeros(3, dtype=torch.int32)
        host["s2r"](q0.data_ptr(), p0.data_ptr(), traj.data_ptr(),
                    ns.data_ptr(), vec.data_ptr(), 3, _n_sub(vec), steps,
                    stride, n_keep, None, None)
        want, ns_t = tig.trajectory_generic_twin(q0, p0, steps, vec, metric,
                                                 stride, n_keep)
        assert torch.equal(ns_t, ns)
        assert torch.equal(_bits(traj), _bits(want))
        got = torch.full((3, 100, 8), 7.0, dtype=torch.float64)
        host["t2r"](q0.data_ptr(), p0.data_ptr(), got.data_ptr(), None,
                    vec.data_ptr(), 3, _n_sub(vec), 100, 1, 0, None, None)
        want = tig.trajectory_generic_unmasked(q0, p0, 100, vec, metric)
        fin = torch.isfinite(want).all(-1)
        assert torch.equal(torch.isfinite(got).all(-1), fin)
        assert torch.equal(_bits(got[fin]), _bits(want[fin]))


@pytest.mark.parametrize("metric,spin,param", CASES[:2])
def test_d2_source_bitwise_equal_to_twin(host, metric, spin, param):
    """D2 against `integrate_disk_spin_twin` on every ray of the 8x8
    camera 20 deg above the plane at r0 = 15 (disk [2, 12], 800 steps,
    delta 0.08): q1, p1, the hit rows (zero where no hit), the hit flags
    and the signed step counts bit for bit, with hits, escapes and
    captures among them; D2's q2 rows (the rescue's escape direction)
    too."""
    el = math.radians(20.0)
    q0, p0 = _rays(metric, spin, param, list(range(64)),
                   obs=(15.0 * math.cos(el), 0.0, 15.0 * math.sin(el)))
    vec = tig.gen_params(metric, 0.08, (1.0, spin, param), 16.0, 1.0, 2,
                         torch.float64)
    dvec = tig.disk_spin_params(vec, 2.0, 12.0)
    steps = 800
    out = torch.full((20, 64), 7.0, dtype=torch.float64)
    ns = torch.zeros(64, dtype=torch.int32)
    hit = torch.zeros(64, dtype=torch.int32)
    host["d2"](q0.data_ptr(), p0.data_ptr(), out.data_ptr(), ns.data_ptr(),
               dvec.data_ptr(), 64, _n_sub(vec), steps, 1, 0, None,
               hit.data_ptr())
    state, ns_t, hit_t, hq, hp = tig.integrate_disk_spin_twin(
        q0, p0, steps, dvec, metric)
    assert torch.equal(ns, ns_t)
    assert torch.equal(hit.bool(), hit_t)
    assert torch.equal(_bits(out[:8].T), _bits(torch.stack(state[:8], -1)))
    assert torch.equal(_bits(out[8:12].T), _bits(hq))
    assert torch.equal(_bits(out[12:16].T), _bits(hp))
    assert torch.equal(_bits(out[16:20].T),
                       _bits(torch.stack(state[8:12], -1)))
    assert not bool(out[8:16, ~hit.bool()].any())  # zeros where no hit
    assert 0 < int(hit.sum()) < 64



def test_guard_parks_source_bitwise_equal_to_twins(host):
    """The Kerr-Schild guard's two parks against the twins, rotating
    Hayward (a = 0.9, l = 0.2), 600 steps of 0.08 at order 2.  Its
    captures park on the invariant before they cross r_plus, so the
    vector's r_plus is raised to 2.5 (above r_cap): two central rays of
    the 8x8 camera take a finite step inside it that keeps the invariant
    (crossed); a corner ray escapes; the central ray with its momentum
    scaled by 1e155, a null ray whose first step overflows, explodes on
    a step that is not finite.  G1r, S2r recording every step (the slot
    after each park holds its park point, where the ray stops) and D2
    (disk [2, 12]) bit for bit; the unguarded trace confirms each park's
    kind."""
    metric, spin, param = "RotatingHayward", 0.9, 0.2
    q0, p0 = _rays(metric, spin, param, [0, 27, 36])
    q0 = torch.cat([q0, q0[1:2]]).contiguous()
    p0 = torch.cat([p0, 1e155 * p0[1:2]]).contiguous()
    n, steps = q0.shape[0], 600
    vec = tig.gen_params(metric, 0.08, (1.0, spin, param), 16.0, 1.0, 2,
                         torch.float64)
    vec[5] = 2.5
    (mass, a, k, _, _, r_plus, _, family, cap_park, _), _ = \
        tig.split_params(vec)
    out = torch.zeros((12, n), dtype=torch.float64)
    ns = torch.zeros(n, dtype=torch.int32)
    host["g1r"](q0.data_ptr(), p0.data_ptr(), out.data_ptr(), ns.data_ptr(),
                vec.data_ptr(), n, _n_sub(vec), steps, 1, 0, None, None)
    state, ns_t = tig.integrate_generic_twin(q0, p0, steps, vec, metric)
    assert torch.equal(ns_t, ns)
    assert torch.equal(_bits(out), _bits(torch.stack(state[:12])))
    # the kind of each park, from the unguarded step it refused
    trace = tig.trajectory_generic_unmasked(q0, p0, steps, vec, metric)
    assert int(ns[0]) > 0 and bool((ns[1:] < 0).all())
    kinds = []
    for j in range(1, n):
        new = trace[j, -int(ns[j]) - 1]
        if not bool(torch.isfinite(new).all()):
            kinds.append("not finite")
            continue
        h = rotating_chart.hamiltonian(*new[1:8], mass, a, k, int(family))
        p2 = float(new[5] ** 2 + new[6] ** 2 + new[7] ** 2) + 1.0
        r = float(ks_radius_c(*new[1:4], a))
        kinds.append("exploded" if abs(float(h)) > 3e-2 * p2
                     else "crossed" if r < r_plus else "?")
    assert kinds == ["crossed", "crossed", "not finite"]
    assert int(ns[3]) == -1
    # S2r, every step recorded: the slot after a park is its park point
    traj = torch.zeros((n, steps, 4), dtype=torch.float64)
    ns = torch.zeros(n, dtype=torch.int32)
    host["s2r"](q0.data_ptr(), p0.data_ptr(), traj.data_ptr(),
                ns.data_ptr(), vec.data_ptr(), n, _n_sub(vec), steps, 1,
                steps, None, None)
    want, ns_t = tig.trajectory_generic_twin(q0, p0, steps, vec, metric, 1,
                                             steps)
    assert torch.equal(ns_t, ns)
    assert torch.equal(_bits(traj), _bits(want))
    for j in range(1, n):
        m = int(ns[j])
        assert traj[j, m, 1:].tolist() == [0.0, 0.0, cap_park]
        assert not bool(traj[j, m + 1:].any())   # the ray stopped there
    # D2 on the same rays
    dvec = tig.disk_spin_params(vec, 2.0, 12.0)
    out = torch.zeros((20, n), dtype=torch.float64)
    ns = torch.zeros(n, dtype=torch.int32)
    hit = torch.zeros(n, dtype=torch.int32)
    host["d2"](q0.data_ptr(), p0.data_ptr(), out.data_ptr(), ns.data_ptr(),
               dvec.data_ptr(), n, _n_sub(vec), steps, 1, 0, None,
               hit.data_ptr())
    state, ns_t, hit_t, hq, hp = tig.integrate_disk_spin_twin(
        q0, p0, steps, dvec, metric)
    assert torch.equal(ns, ns_t) and torch.equal(hit.bool(), hit_t)
    assert torch.equal(_bits(out[:8].T), _bits(torch.stack(state[:8], -1)))
    assert torch.equal(_bits(out[16:20].T),
                       _bits(torch.stack(state[8:12], -1)))
    assert int(ns[3]) == -1
