"""The port's disk integrators (the eager twins of kernel B6, the disk mode
of csrc/fantasy_ks.cu) against the JAX package on the same launch states.

* integrate_batch_disk_ks (16 rows, float64) vs JAX's Pallas disk kernel
  `integrate_batch_pallas_disk(compensated=False, interpret=True)`, as
  tests/test_disk.py runs it: 12x12 rays of the inclined disk camera (a =
  0.9, 12 deg above the plane, fov 80 deg), 1,500 steps at delta 0.05,
  the annulus [ISCO, 14].  Statuses, step counts and hit flags equal;
  hit_q and hit_p within 1e-9 relative (measured ~1e-13), finals within
  1e-9 as in tests/test_torch_integrate_ks.py.
* integrate_batch_disk_ksc (32 rows, float32) vs the same kernel with
  compensated=True in float32: statuses, step counts and hit flags equal
  (no ray's hit flips at this size); hit_q within 2e-5 and hit_p within
  2e-6 absolute (measured 1.9e-6 and 1.2e-7): XLA:CPU contracts a*b + c
  into FMAs and torch eager does not (ROADMAP Queue C).  The finals keep
  the 32-row twin's stated gap of tests/test_torch_integrate_ks.py.
* steps = 0 is an exact no-op; the recorder is pure observation for rays
  that never hit; the scalar vector, read-out, dispatch and wrapper rules
  with mocks, nothing launched.

The CUDA kernel is held bitwise to these twins on the card by
chip_smoke.py (this machine has neither a GPU nor nvcc).

The comparisons that take seconds are in tests/test_torch_disk_pallas.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.engine import integrate_ks as jks
from grtrace.physics import camera as jcam
from grtrace.physics import orbits as jorb
from grtrace.physics import spacetime as jsp
from grtrace_torch.engine import integrate_ks as tks
from grtrace_torch.engine import integrate_ks_cuda as tkc
from grtrace_torch.kernels import build as tbuild

torch.set_num_threads(1)

SPIN = 0.9
STEPS, DELTA, R_MAX, OMEGA = 1500, 0.05, 31.0, 1.0
R_IN = float(jorb.isco_radius(1.0, SPIN))
R_OUT = 14.0
DISK = 3  # STATUS_DISK


def _disk_ics(size=12, dtype=np.float64, elev_deg=12.0):
    """JAX look-at camera launch states of the disk scene, (N, 4) numpy."""
    e = np.deg2rad(elev_deg)
    obs = jnp.array([30.0 * np.cos(e), 0.0, 30.0 * np.sin(e)])
    params = jnp.array([1.0, SPIN, 0.0])
    pix = jcam.pixel_grid_lookat(obs, jnp.radians(80.0), size, size,
                                 dtype=jnp.float64)
    q0, p0, _ = jcam.cartesian_ics_from_pixels(
        obs, pix, params=params, g_inv_fn=jsp.kerr_schild_g_inv)
    return (np.asarray(q0).reshape(-1, 4).astype(dtype),
            np.asarray(p0).reshape(-1, 4).astype(dtype))


@pytest.mark.parametrize("compensated", [True, False])
def test_zero_steps_is_noop(compensated):
    dtype = np.float32 if compensated else np.float64
    q0, p0 = map(torch.tensor, _disk_ics(4, dtype))
    twin = (tks.integrate_batch_disk_ksc if compensated
            else tks.integrate_batch_disk_ks)
    fq, fp, st, ns, hq, hp = twin(q0, p0, 0, DELTA, (1.0, SPIN), R_MAX,
                                  OMEGA, R_IN, R_OUT)
    assert torch.equal(fq, q0) and torch.equal(fp, p0)
    assert not (st == DISK).any() and (ns == 0).all()
    assert not hq.any() and not hp.any()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("compensated", [True, False])
def test_ks_params_disk_matches_the_pallas_smem_vector(dtype, compensated):
    """integrate_batch_pallas_disk's SMEM vector: the plain layout, then
    r_in and r_out in the ray dtype."""
    jdt = jnp.float32 if dtype == np.float32 else jnp.float64
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    params = (1.0, SPIN, 0.2)
    mass, a, charge, r_cap, plunge = jks.ks_scene_scalars(
        jnp.asarray(params, jdt), jdt)
    jvec = [mass, a, charge, r_cap, jnp.asarray(R_MAX, jdt), plunge]
    for sub in jks.ks_substeps(jnp.asarray(0.02, jdt), jnp.asarray(1.0, jdt),
                               2, compensated=compensated):
        jvec += list(sub)
    jvec += [jnp.asarray(R_IN, jdt), jnp.asarray(R_OUT, jdt)]
    jvec = np.asarray(jnp.stack([jnp.asarray(x, jdt) for x in jvec]))
    tvec = tks.ks_params(0.02, params, R_MAX, 1.0, 2, compensated, tdt,
                         disk=(R_IN, R_OUT))
    assert tvec.dtype == tdt and tvec.numel() == len(jvec) == 12
    np.testing.assert_allclose(tvec.numpy(), jvec,
                               rtol=2 * np.finfo(dtype).eps, atol=0)
    assert tks.n_substeps(tvec) == 1
    assert tks.disk_annulus(tvec) == (float(dtype(R_IN)), R_OUT)
    plain = tks.ks_params(0.02, params, R_MAX, 1.0, 2, compensated, tdt)
    assert tks.split_params(tvec) == tks.split_params(plain)
    with pytest.raises(ValueError, match="disk"):
        tks.disk_annulus(plain)


def test_finish_disk_reads_the_recorder_rows():
    q0, p0 = map(torch.tensor, _disk_ics(2))
    vec = tks.ks_params(DELTA, (1.0, SPIN), R_MAX, OMEGA, 2, False,
                        torch.float64, disk=(R_IN, R_OUT))
    state = tuple(torch.cat([q0, p0, q0, p0], dim=1).T)
    ns = torch.tensor([5, -3, 7, 2], dtype=torch.int32)
    rows = torch.zeros((9, 4), dtype=torch.float64)
    rows[0, 2] = 1.0
    rows[1:, 2] = torch.arange(1.0, 9.0, dtype=torch.float64)
    fq, fp, st, n, hq, hp = tks.finish_disk(state, ns, rows, q0, p0, vec,
                                            False)
    ref = tks.finish_ks(state, ns, q0, p0, vec, False)
    assert torch.equal(fq, ref[0]) and torch.equal(n, ref[3])
    assert st[2] == DISK and torch.equal(st[[0, 1, 3]], ref[2][[0, 1, 3]])
    assert hq[2].tolist() == [1, 2, 3, 4] and hp[2].tolist() == [5, 6, 7, 8]


# --- dispatch and wrapper rules: mocks, nothing is launched ----------------

@pytest.mark.parametrize("dtype,compensated", [(torch.float32, True),
                                               (torch.float64, False)])
def test_dispatch_disk_routes_cuda_rays_to_the_kernel(monkeypatch, dtype,
                                                      compensated):
    """CUDA float32 -> B6's 32-row layout, CUDA float64 -> its 16-row one;
    the twins are never called on that path."""
    calls = []
    monkeypatch.setattr(tks, "select_path_ks",
                        lambda *a: ("kernel", compensated))
    monkeypatch.setattr(tkc, "integrate_batch_disk_cuda",
                        lambda *a, **k: calls.append((a[-2:], k)) or "B6")
    for twin in ("integrate_batch_disk_ksc", "integrate_batch_disk_ks"):
        monkeypatch.setattr(tks, twin, pytest.fail)
    q0 = torch.zeros((3, 4), dtype=dtype)
    assert tks.integrate_dispatch_disk(q0, q0, 10, 0.02, (1.0, SPIN), 31.0,
                                       1.0, R_IN, R_OUT) == "B6"
    assert calls == [((R_IN, R_OUT), {"order": 2,
                                      "compensated": compensated})]


@pytest.mark.parametrize("dtype,twin", [
    (np.float32, "integrate_batch_disk_ksc"),
    (np.float64, "integrate_batch_disk_ks")])
def test_dispatch_disk_cpu_rays_take_the_twins(dtype, twin):
    q0, p0 = map(torch.tensor, _disk_ics(3, dtype))
    args = (60, DELTA, (1.0, SPIN), R_MAX, OMEGA, R_IN, R_OUT)
    a = tks.integrate_dispatch_disk(q0, p0, *args)
    b = getattr(tks, twin)(q0, p0, *args)
    assert len(a) == 6
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    c = tks.integrate_dispatch_disk(q0, p0, *args, backend="torch")
    assert all(torch.equal(x, y) for x, y in zip(a, c))


def test_disk_wrapper_raises_for_cpu_tensors():
    before = tkc.disk_launches, tkc.launches
    q0 = torch.zeros((4, 4), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tkc.integrate_batch_disk_cuda(q0, q0, 10, DELTA, (1.0, SPIN), R_MAX,
                                      OMEGA, R_IN, R_OUT)
    vec = tks.ks_params(DELTA, (1.0, SPIN), R_MAX, 1.0, 2, True,
                        disk=(R_IN, R_OUT))
    with pytest.raises(ValueError, match="CUDA"):
        tkc.launch_fantasy_ks_disk(torch.zeros((32, 4)), vec, 10)
    assert (tkc.disk_launches, tkc.launches) == before


def test_build_registers_the_disk_entries():
    names = set(tbuild.ENTRIES["fantasy_ks"])
    assert set(tkc.DISK_ENTRIES.values()) <= names
    assert set(tkc.DISK_ENTRIES) == set(tkc.ENTRIES)
    for name in tkc.DISK_ENTRIES.values():
        assert len(tbuild.argtypes(name)) == 9
    for name in tkc.ENTRIES.values():
        assert len(tbuild.argtypes(name)) == 8
    src = (tbuild.CSRC_DIR / "fantasy_ks.cu").read_text()
    for name in names:
        assert f'extern "C" int {name}(' in src
    log = ("ptxas info    : Compiling entry function "
           "'_ZN12_GLOBAL__N_117fantasy_ks_kernelIfLb1ELb1EEEvPKT_PS1_PiS2_"
           "S3_iii' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\nptxas info    : Used 124 registers, 400 bytes cmem[0]\n")
    assert tbuild.ptxas_summary(log) == [{
        "kernel": "fantasy_ks_kernel<f,1,1>", "registers": 124,
        "spill_stores": 0, "spill_loads": 0}]
