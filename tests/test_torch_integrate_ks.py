"""The port's Kerr-Schild integrators (the eager twins of kernel B5) against
the JAX package on the same launch states.

* integrate_batch_ksc (32 rows, float32) vs JAX's XLA twin
  integrate_batch_ksc: 10x10 Kerr-Schild camera rays, 600 steps at
  delta 0.1, orders 2 and 4, charge 0 and 0.3.  Statuses and step counts
  equal; finals within 5e-5 absolute plus 2e-5 relative: XLA:CPU contracts
  a*b + c into FMAs and torch eager does not (ROADMAP Queue C), and 600
  steps walk that last-ulp difference (ulp 3.8e-6 at t ~ 60) to some ten
  ulps.  Captured rays' momenta, which blueshift toward the horizon and
  amplify it, are held to 1e-3.
* integrate_batch_ks (16 rows, float64) vs JAX's Pallas kernel in interpret
  mode with compensated=False, as tests/test_pallas_ks.py runs it:
  statuses and step counts equal, finals to 1e-9 relative (captured rays'
  momenta blueshift to |p| ~ 20, so the tolerance scales with |p|).
* The scalar vector, the Bardeen predicate and rescue, the status rule and
  the cost-sort key against JAX's; the dispatch rules with mocks, nothing
  launched.

The CUDA kernel itself is compared with these twins on the card by
chip_smoke.py (this machine has neither a GPU nor nvcc).

The comparisons that take seconds are in
tests/test_torch_integrate_ks_jax.py and
tests/test_torch_integrate_ks_rescue.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.engine import integrate_ks as jks
from grtrace.physics import camera as jcam
from grtrace.physics import spacetime as jsp
from grtrace_torch.engine import integrate_ks as tks
from grtrace_torch.engine import integrate_ks_cuda as tkc
from grtrace_torch.kernels import build as tbuild

torch.set_num_threads(1)

SPIN = 0.9


STEPS, DELTA, R_MAX, OMEGA = 600, 0.1, 31.0, 1.0


def _np(xs):
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in xs]


def _ics(size=10, dtype=np.float64, charge=0.0, obs=(30.0, 0.0, 0.0)):
    """JAX Cartesian-camera launch states, (N, 4) numpy arrays."""
    jdt = jnp.float32 if dtype == np.float32 else jnp.float64
    q0, p0, _ = jcam.camera_rays_cartesian(
        jnp.asarray(obs, jdt), jnp.radians(80.0).astype(jdt), size, size,
        params=jnp.asarray([1.0, SPIN, charge], jdt),
        g_inv_fn=jsp.kerr_schild_g_inv, dtype=jdt)
    return (np.asarray(q0).reshape(-1, 4).astype(dtype),
            np.asarray(p0).reshape(-1, 4).astype(dtype))


def test_zero_steps_is_noop():
    q0, p0 = map(torch.tensor, _ics(4, np.float32))
    fq, fp, st, ns = tks.integrate_batch_ksc(q0, p0, 0, DELTA, (1.0, SPIN),
                                             R_MAX, OMEGA)
    assert torch.equal(fq, q0) and torch.equal(fp, p0)
    assert (ns == 0).all() and (st == 0).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("order,compensated", [(2, True), (4, True),
                                               (2, False), (4, False)])
def test_ks_params_match_the_pallas_smem_vector(dtype, order, compensated):
    """The layout and values of integrate_batch_pallas_ks's SMEM vector."""
    jdt = jnp.float32 if dtype == np.float32 else jnp.float64
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    params = (1.0, SPIN, 0.3)
    scal = list(jks.ks_scene_scalars(jnp.asarray(params, jdt), jdt))
    scal.insert(4, jnp.asarray(R_MAX, jdt))
    scal = scal[:6]
    mass, a, charge, r_cap, r_max, plunge = scal
    jvec = [mass, a, charge, r_cap, r_max, plunge]
    for sub in jks.ks_substeps(jnp.asarray(0.02, jdt), jnp.asarray(1.0, jdt),
                               order, compensated=compensated):
        jvec += list(sub)
    jvec = np.asarray(jnp.stack([jnp.asarray(x, jdt) for x in jvec]))
    tvec = tks.ks_params(0.02, params, R_MAX, 1.0, order, compensated, tdt)
    assert tvec.dtype == tdt and tvec.numel() == len(jvec)
    np.testing.assert_allclose(tvec.numpy(), jvec,
                               rtol=2 * np.finfo(dtype).eps, atol=0)
    (m, a_, q, rc, rm, pz), subs = tks.split_params(tvec)
    assert (m, a_, q, rm) == (1.0, float(dtype(SPIN)), float(dtype(0.3)),
                              R_MAX)
    assert len(subs) == (1 if order == 2 else 3)
    # at a = 0.9 the photon region's outer edge is 3.91 M
    assert abs(pz - 3.91) < 0.01 and abs(rc / 1.05 - 1.0 - np.sqrt(
        1.0 - SPIN ** 2 - 0.09)) < 1e-6


# --- dispatch rules: pure logic and mocks, nothing is launched -----------

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.mark.parametrize("backend,device,dtype,path", [
    ("auto", CUDA, torch.float32, ("kernel", True)),
    ("auto", CUDA, torch.float64, ("kernel", False)),
    ("cuda", CUDA, torch.float32, ("kernel", True)),
    ("auto", CPU, torch.float32, ("twin", True)),
    ("auto", CPU, torch.float64, ("twin", False)),
    ("torch", CUDA, torch.float32, ("twin", True)),
    ("torch", CUDA, torch.float64, ("twin", False)),
])
def test_select_path_ks(backend, device, dtype, path):
    assert tks.select_path_ks(backend, device, dtype) == path


def test_select_path_ks_rejects():
    with pytest.raises(ValueError, match="backend"):
        tks.select_path_ks("pallas", CPU, torch.float32)
    with pytest.raises(ValueError, match="float32 or float64"):
        tks.select_path_ks("auto", CUDA, torch.float16)


@pytest.mark.parametrize("dtype,compensated", [(torch.float32, True),
                                               (torch.float64, False)])
def test_dispatch_routes_cuda_rays_to_the_kernel(monkeypatch, dtype,
                                                 compensated):
    """CUDA float32 -> the 32-row kernel, CUDA float64 -> the 16-row
    kernel; the twins are never called on that path."""
    calls = []
    monkeypatch.setattr(tks, "select_path_ks",
                        lambda *a: ("kernel", compensated))
    monkeypatch.setattr(tkc, "integrate_batch_ks_cuda",
                        lambda *a, **k: calls.append(k) or "kernel")
    for twin in ("integrate_batch_ksc", "integrate_batch_ks"):
        monkeypatch.setattr(tks, twin, pytest.fail)
    q0 = torch.zeros((3, 4), dtype=dtype)
    assert tks.integrate_dispatch_ks(q0, q0, 10, 0.02, (1.0, SPIN), 31.0,
                                     1.0) == "kernel"
    assert calls == [{"order": 2, "compensated": compensated}]


@pytest.mark.parametrize("dtype,twin", [(np.float32, "integrate_batch_ksc"),
                                        (np.float64, "integrate_batch_ks")])
def test_dispatch_cpu_rays_take_the_twins(dtype, twin):
    q0, p0 = map(torch.tensor, _ics(4, dtype))
    args = (200, DELTA, (1.0, SPIN), R_MAX, OMEGA)
    a = tks.integrate_dispatch_ks(q0, p0, *args)
    b = getattr(tks, twin)(q0, p0, *args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_kernel_wrapper_raises_for_cpu_tensors():
    before = tkc.launches
    q0 = torch.zeros((4, 4), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tkc.integrate_batch_ks_cuda(q0, q0, 10, DELTA, (1.0, SPIN), R_MAX,
                                    OMEGA)
    with pytest.raises(ValueError, match="CUDA"):
        tkc.launch_fantasy_ks(torch.zeros((32, 4)),
                              tks.ks_params(DELTA, (1.0, SPIN), R_MAX, 1.0,
                                            2, True), 10)
    assert tkc.launches == before


def test_build_registers_the_ks_entries():
    assert (set(tkc.ENTRIES.values()) | set(tkc.DISK_ENTRIES.values())
            | set(tkc.SUB_ENTRIES.values())
            | set(tkc.TANGENT_ENTRIES.values())
            == set(tbuild.ENTRIES["fantasy_ks"]))
    names = {p.stem for p in tbuild._sources()}
    assert {"fantasy_eqc", "fantasy_ks"} <= names
    paths = {tbuild.library_path(p) for p in tbuild._sources()}
    assert len(paths) == len(names)  # one library per source
    log = ("ptxas info    : Compiling entry function "
           "'_ZN12_GLOBAL__N_117fantasy_ks_kernelIfLb1EEEvPKT_PS1_PiS3_iii'"
           " for 'sm_90a'\n"
           "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill "
           "loads\nptxas info    : Used 112 registers, 392 bytes cmem[0]\n")
    assert tbuild.ptxas_summary(log) == [{
        "kernel": "fantasy_ks_kernel<f,1>", "registers": 112,
        "spill_stores": 8, "spill_loads": 12}]
