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
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.engine import integrate_ks as jks
from grtrace.engine import integrate_pallas_ks as jpks
from grtrace.physics import camera as jcam
from grtrace.physics import spacetime as jsp
from grtrace_torch.engine import integrate_ks as tks
from grtrace_torch.engine import integrate_ks_cuda as tkc
from grtrace_torch.kernels import build as tbuild

torch.set_num_threads(1)

SPIN = 0.9
STEPS, DELTA, R_MAX, OMEGA = 600, 0.1, 31.0, 1.0


def _ics(size=10, dtype=np.float64, charge=0.0, obs=(30.0, 0.0, 0.0)):
    """JAX Cartesian-camera launch states, (N, 4) numpy arrays."""
    jdt = jnp.float32 if dtype == np.float32 else jnp.float64
    q0, p0, _ = jcam.camera_rays_cartesian(
        jnp.asarray(obs, jdt), jnp.radians(80.0).astype(jdt), size, size,
        params=jnp.asarray([1.0, SPIN, charge], jdt),
        g_inv_fn=jsp.kerr_schild_g_inv, dtype=jdt)
    return (np.asarray(q0).reshape(-1, 4).astype(dtype),
            np.asarray(p0).reshape(-1, 4).astype(dtype))


def _np(xs):
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in xs]


@pytest.mark.parametrize("order,charge", [(2, 0.0), (2, 0.3), (4, 0.0),
                                          (4, 0.3)])
def test_ksc_twin_matches_jax(order, charge):
    q0, p0 = _ics(dtype=np.float32, charge=charge)
    f32 = jnp.float32
    params = (1.0, SPIN, charge)
    j = _np(jks.integrate_batch_ksc(
        jnp.asarray(q0), jnp.asarray(p0), STEPS, f32(DELTA),
        jnp.asarray(params, f32), f32(R_MAX), f32(OMEGA), order=order))
    t = _np(tks.integrate_batch_ksc(torch.tensor(q0), torch.tensor(p0),
                                    STEPS, DELTA, params, R_MAX, OMEGA,
                                    order=order))
    assert np.array_equal(t[2], j[2]) and np.array_equal(t[3], j[3])
    # captured, escaped and still-running rays all occur
    assert set(np.unique(t[2])) == {0, 1, 2}
    np.testing.assert_allclose(t[0], j[0], rtol=2e-5, atol=5e-5)
    free = j[2] != 1
    np.testing.assert_allclose(t[1][free], j[1][free], rtol=2e-5, atol=5e-5)
    # a captured ray's momentum blueshifts exponentially toward the past
    # horizon, which amplifies the same last-ulp differences
    np.testing.assert_allclose(t[1][~free], j[1][~free], rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("order", [2, 4])
def test_ks_twin_matches_pallas_interpret_f64(order):
    q0, p0 = _ics()
    j = _np(jpks.integrate_batch_pallas_ks(
        jnp.asarray(q0), jnp.asarray(p0), STEPS, DELTA,
        jnp.asarray([1.0, SPIN]), R_MAX, OMEGA, order=order,
        interpret=True, compensated=False))
    t = _np(tks.integrate_batch_ks(torch.tensor(q0), torch.tensor(p0),
                                   STEPS, DELTA, (1.0, SPIN), R_MAX, OMEGA,
                                   order=order))
    assert np.array_equal(t[2], j[2]) and np.array_equal(t[3], j[3])
    assert (t[2] == 1).any() and (t[2] == 2).any()
    np.testing.assert_allclose(t[0], j[0], rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(t[1], j[1], rtol=1e-9, atol=1e-9)


def test_compensated_f32_tracks_f64():
    """The point of the 32-row layout: float32 escaped finals stay near
    the float64 16-row result, closer than the plain float32 flows."""
    q0, p0 = _ics()
    args = (STEPS, DELTA, (1.0, SPIN), R_MAX, OMEGA)
    q64, _, s64, _ = tks.integrate_batch_ks(torch.tensor(q0),
                                            torch.tensor(p0), *args)
    q32, p32 = torch.tensor(q0, dtype=torch.float32), torch.tensor(
        p0, dtype=torch.float32)
    qc, _, sc, _ = tks.integrate_batch_ksc(q32, p32, *args)
    qp, _, sp, _ = tks.integrate_batch_ks(q32, p32, *args)
    assert torch.equal(sc, s64)
    esc = s64 == 2
    assert int(esc.sum()) > 20
    err_comp = float((qc.double() - q64)[esc, 1:].abs().max())
    err_plain = float((qp.double() - q64)[esc, 1:].abs().max())
    assert err_comp < 1e-5 and err_comp < err_plain


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


def _random_launch_states(n=600, seed=7):
    """Camera-like launch states off the equator: unit spatial covectors
    from random points at r ~ 20..30, p_t from the null quadratic."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3))
    pos *= rng.uniform(20.0, 30.0, (n, 1)) / np.linalg.norm(
        pos, axis=1, keepdims=True)
    aim = -pos + rng.normal(size=(n, 3)) * 6.0
    p_sp = aim / np.linalg.norm(aim, axis=1, keepdims=True)
    q0 = np.concatenate([np.zeros((n, 1)), pos], axis=1)
    params = jnp.asarray([1.0, SPIN, 0.3])
    import jax
    p_t = np.asarray(jax.vmap(lambda p, q: jsp.null_p_t(
        p, q, params, jsp.kerr_schild_g_inv))(jnp.asarray(p_sp),
                                              jnp.asarray(q0)))
    return q0, np.concatenate([p_t[:, None], p_sp], axis=1)


@pytest.mark.parametrize("charge", [0.0, 0.3])
def test_bardeen_escape_pred_matches_jax(charge):
    q0, p0 = _random_launch_states()
    j = np.asarray(jks.bardeen_escape_pred(jnp.asarray(q0), jnp.asarray(p0),
                                           1.0, SPIN, charge))
    t = tks.bardeen_escape_pred(torch.tensor(q0), torch.tensor(p0), 1.0,
                                SPIN, charge).numpy()
    assert 0.05 < j.mean() < 0.95  # both fates occur
    assert np.array_equal(t, j)
    # the 64-point grid of jnp.linspace, exactly
    g = tks._unit_grid(64, torch.float32, "cpu").numpy()
    assert np.array_equal(g, np.asarray(jnp.linspace(0.0, 1.0, 64,
                                                     dtype=jnp.float32)))


def test_apply_bardeen_rescue_and_status_match_jax():
    q0, p0 = _random_launch_states(200, seed=9)
    rng = np.random.default_rng(10)
    n = len(q0)
    fq = np.concatenate([rng.uniform(0, 50, (n, 1)),
                         rng.normal(size=(n, 3)) * 12.0], axis=1)
    fp = rng.normal(size=(n, 4))
    q2 = rng.normal(size=(n, 3)) * 3.0
    ns = rng.integers(1, 900, n).astype(np.int32)
    ns[::3] *= -1  # guard-parked rays
    r_cap = 1.05 * (1.0 + np.sqrt(1.0 - SPIN ** 2))
    j = _np(jks.apply_bardeen_rescue(
        jnp.asarray(fq), jnp.asarray(fp), jnp.asarray(ns), jnp.asarray(q2),
        jnp.asarray(q0), jnp.asarray(p0), 1.0, SPIN, 0.0, r_cap, R_MAX))
    t = _np(tks.apply_bardeen_rescue(
        torch.tensor(fq), torch.tensor(fp), torch.tensor(ns),
        torch.tensor(q2), torch.tensor(q0), torch.tensor(p0), 1.0, SPIN,
        0.0, r_cap, R_MAX))
    np.testing.assert_allclose(t[0], j[0], rtol=1e-14, atol=1e-14)
    assert np.array_equal(t[1], j[1])
    assert np.array_equal(t[2], j[2]) and np.array_equal(t[3], j[3])
    assert set(np.unique(t[2])) == {0, 1, 2}
    js = np.asarray(jks.ks_status(jnp.asarray(fq), SPIN, r_cap, R_MAX))
    ts = tks.ks_status(torch.tensor(fq), SPIN, r_cap, R_MAX).numpy()
    assert np.array_equal(ts, js)


def test_cost_sort_key_matches_jax():
    q0, p0 = _ics(8)
    j = np.asarray(jpks._cost_sort_key_ks(jnp.asarray(q0), jnp.asarray(p0),
                                          1.0))
    t = tkc._cost_sort_key_ks(torch.tensor(q0), torch.tensor(p0), 1.0)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-12, atol=1e-12)


def test_make_ks_step_disk_and_subrings_not_ported():
    """Both recorder modes are ported now: the disk mode (B6) and the
    subring mode (B7) steps carry their recorders (tests/test_torch_disk.py
    and tests/test_torch_subring.py hold them to JAX)."""
    args = (((0.1, 0.0, 0.0, 0.1),), 1.0, SPIN, 0.0, 2.0, 31.0, 3.9)
    q0, p0 = map(torch.tensor, _ics(2))
    _, sub_step, _, _ = tks.make_ks_step(*args, subrings=3,
                                         dtype=torch.float64)
    state = tuple(torch.cat([q0, p0, q0, p0], dim=1).T)
    out = sub_step(state, torch.zeros(4, dtype=torch.int32),
                   torch.zeros(4, dtype=torch.int32),
                   torch.zeros((3, 8, 4), dtype=torch.float64))
    assert len(out) == 4 and len(out[0]) == 16 and (out[1] == 1).all()
    assert out[3].shape == (3, 8, 4)
    _, step, _, _ = tks.make_ks_step(*args, disk=(6.0, 20.0),
                                     dtype=torch.float64)
    state = tuple(torch.cat([q0, p0, q0, p0], dim=1).T)
    ns = torch.zeros(4, dtype=torch.int32)
    hit = torch.zeros(4, dtype=torch.bool)
    zeros = (torch.zeros(4, dtype=torch.float64),) * 4
    out = step(state, ns, hit, zeros, zeros)
    assert len(out) == 5 and len(out[0]) == 16 and (out[1] == 1).all()


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
