"""The port's subring path (kernel B7's eager twins, `render_subrings`,
`subring_summary`) against the JAX package on the same inputs, on the CPU.

* integrate_batch_subrings_ks (16 rows, float64) vs JAX's Pallas subring
  kernel `integrate_batch_pallas_subrings(compensated=False,
  interpret=True)`, on 14x14 rays of the JAX tests' look-at camera
  (`_subring_batch_ics`: a = 0.9, 20 M out, 0.3 rad above the plane), 900
  steps at delta 0.05, 2 orders (some rays fill both, some neither):
  statuses, crossing counts and step counts equal; filled slots within
  1e-9 relative (1e-12 absolute; measured 1.7e-12 absolute on t ~ -30);
  unfilled slots +0.0 on both sides.
* integrate_batch_subrings_ksc (32 rows, float32) vs JAX's XLA twin
  `integrate_batch_subrings_ksc` on the same rays in float32, 900 steps:
  statuses, counts and step counts equal (no ray's count differs at this
  size); filled slots within 5e-5 (q) and 1e-5 (p) absolute, the FMA gap
  of ROADMAP Queue C (XLA:CPU contracts a*b + c, torch eager does not;
  measured 3.8e-6 and 1.9e-6).
* render_subrings(device='cpu') of a 16x16 scene (a = 0.9, camera 75 deg
  above the plane, 1,500-step budget at delta 0.1, float64, 3 orders)
  against JAX's render_subrings, which on the CPU runs its unstaggered
  XLA engine: class, count, valid and status maps equal pixel for pixel;
  intensity within rtol 2e-3 (as tests/test_subring.py holds the kernel;
  measured 1.5e-13); steps equal except that a captured ray may trip the
  guard up to 2 steps apart (the staggered composition, as
  tests/test_torch_render_kerr.py records).  subring_summary on JAX's
  arrays equals JAX's own.
* steps = 0, one slot, the recorder as pure observation, the parts left
  out, dispatch and wrapper rules, and the kernel-vs-twin parity check of
  the subring mode held, with stand-ins for the kernel and its twins (each
  twin run once per layout), to seeing a one-ulp, one-count or one-slot
  difference.

The CUDA kernel is held bitwise to these twins on the card by
chip_smoke.py (this machine has neither a GPU nor nvcc).

The comparisons that take seconds are in tests/test_torch_subring_jax.py.
"""
from dataclasses import replace

import numpy as np
import pytest
import torch

import grtrace_torch
from grtrace_torch.engine import integrate_ks as tks
from grtrace_torch.engine import integrate_ks_cuda as tkc
from grtrace_torch.engine import subring as tsub
from grtrace_torch.engine import validate as tval
from grtrace_torch.kernels import build as tbuild

torch.set_num_threads(1)

SPIN = 0.9
PARAMS = (1.0, SPIN, 0.0)
DELTA, R_MAX, OMEGA = 0.05, 31.0, 1.0


def _rays(size, dtype):
    """The same camera through the port's own functions (no JAX compile
    per shape): (N, 4) tensors, for the tests that hold the port to
    itself."""
    elev, dist = 0.3, 20.0
    obs = torch.tensor([dist * np.cos(elev), 0.0, dist * np.sin(elev)],
                       dtype=torch.float64)
    pix = tsub.pixel_grid_lookat(obs, torch.tensor(np.deg2rad(80.0),
                                                   dtype=torch.float64),
                                 size, size, dtype=torch.float64)
    q0, p0, _ = tsub.cartesian_ics_from_pixels(
        obs, pix.reshape(-1, 3), params=PARAMS,
        g_inv_fn=tsub.kerr_schild_g_inv)
    return q0.to(dtype).contiguous(), p0.to(dtype).contiguous()


@pytest.mark.parametrize("compensated", [True, False])
def test_zero_steps_is_noop(compensated):
    q0, p0 = _rays(4, torch.float32 if compensated else torch.float64)
    twin = (tks.integrate_batch_subrings_ksc if compensated
            else tks.integrate_batch_subrings_ks)
    fq, fp, st, ns, hq, hp, cnt = twin(q0, p0, 0, DELTA, PARAMS, R_MAX,
                                       OMEGA, n_orders=2)
    assert torch.equal(fq, q0) and torch.equal(fp, p0)
    assert (ns == 0).all() and (cnt == 0).all()
    assert hq.shape == (2, 16, 4) and not hq.any() and not hp.any()


def test_n_orders_below_one_raises():
    q0 = torch.zeros((2, 4), dtype=torch.float64)
    for fn in (tks.integrate_batch_subrings_ks,
               tks.integrate_dispatch_subrings):
        with pytest.raises(ValueError, match="n_orders"):
            fn(q0, q0, 10, DELTA, PARAMS, R_MAX, OMEGA, n_orders=0)


def test_finish_subrings_reads_the_slot_rows():
    q0, p0 = _rays(2, torch.float64)
    vec = tks.ks_params(DELTA, PARAMS, R_MAX, OMEGA, 2, False, torch.float64)
    state = tuple(torch.cat([q0, p0, q0, p0], dim=1).T)
    ns = torch.tensor([5, -3, 7, 2], dtype=torch.int32)
    cnt = torch.tensor([0, 1, 4, 2], dtype=torch.int32)
    rows = torch.arange(16 * 4, dtype=torch.float64).reshape(16, 4)
    out = tks.finish_subrings(state, ns, cnt, rows, q0, p0, vec, False)
    ref = tks.finish_ks(state, ns, q0, p0, vec, False)
    for a, b in zip(out[:4], ref):
        assert torch.equal(a, b)
    hq, hp = out[4], out[5]
    assert hq.shape == hp.shape == (2, 4, 4) and torch.equal(out[6], cnt)
    # ray 2, slot 1: q1 rows 8..11, p2 rows 12..15 of the slot rows
    assert hq[1, 2].tolist() == rows[8:12, 2].tolist()
    assert hp[1, 2].tolist() == rows[12:16, 2].tolist()


# --- the parts left out, and the card as the default -----------------------

@pytest.mark.parametrize("change,kw,match", [
    ({"bfield": "vertical"}, {"aa_samples": 2}, None),
    ({"camera_omega": "zamo"}, {"charge": 0.3}, "item 8"),
    ({"camera_omega": 0.01, "bfield": "radial"}, {"charge": 0.3}, "item 8"),
    ({}, {"aa_samples": 2}, None),
    ({}, {"charge": 0.3}, "item 8"),
])
def test_subring_options_not_ported_raise(change, kw, match):
    """The subring options the port does not have raise
    NotImplementedError naming their ROADMAP item; aa_samples (item 8b;
    match None) refines the 8x8 frame, polarized or not: the intensities
    of the refined pixels change, total_intensity stays their sum, and
    the crossing counts keep the centre sample; a charged hole (item 8,
    its 8d: the autodiff ISCO) renders its subrings."""
    scene = replace(grtrace_torch.SceneConfig(size=8, metric="kerr",
                                              spin=SPIN, n_samples=0),
                    **{k: v for k, v in kw.items() if k != "aa_samples"})
    if match == "item 8":
        scene = replace(scene, integrator=grtrace_torch.IntegratorConfig(
            steps=600, delta=0.2, dtype="float64"))
        res = grtrace_torch.render_subrings(
            scene, grtrace_torch.DiskConfig(elevation_deg=75.0, **change),
            device="cpu")
        assert res.count.shape == (8, 8) and int(res.count.max()) > 0
        return
    if match is None:
        scene = replace(scene, integrator=grtrace_torch.IntegratorConfig(
            steps=600, delta=0.2, dtype="float64"))
        res, base = (grtrace_torch.render_subrings(
            scene, grtrace_torch.DiskConfig(elevation_deg=75.0, **change),
            device="cpu", aa_samples=aa) for aa in (kw["aa_samples"], None))
        m = res.aa_mask
        assert m.any() and np.array_equal(res.count, base.count)
        assert np.array_equal(res.intensity[:, ~m], base.intensity[:, ~m])
        np.testing.assert_allclose(res.total_intensity,
                                   res.intensity.sum(axis=0), rtol=1e-12)
        return
    with pytest.raises(NotImplementedError, match=match):
        grtrace_torch.render_subrings(
            scene, grtrace_torch.DiskConfig(elevation_deg=75.0, **change),
            device="cpu", aa_samples=kw.get("aa_samples"))


def test_render_subrings_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = grtrace_torch.SceneConfig(size=8, metric="kerr", spin=SPIN,
                                      n_samples=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        grtrace_torch.render_subrings(scene)


# --- dispatch and wrapper rules: mocks, nothing is launched ----------------

@pytest.mark.parametrize("dtype,compensated", [(torch.float32, True),
                                               (torch.float64, False)])
def test_dispatch_subrings_routes_cuda_rays_to_the_kernel(monkeypatch, dtype,
                                                          compensated):
    """CUDA float32 -> B7's 32-row layout, CUDA float64 -> its 16-row one;
    the twins are never called on that path."""
    calls = []
    monkeypatch.setattr(tks, "select_path_ks",
                        lambda *a: ("kernel", compensated))
    monkeypatch.setattr(tkc, "integrate_batch_subrings_cuda",
                        lambda *a, **k: calls.append(k) or "B7")
    for twin in ("integrate_batch_subrings_ksc",
                 "integrate_batch_subrings_ks"):
        monkeypatch.setattr(tks, twin, pytest.fail)
    q0 = torch.zeros((3, 4), dtype=dtype)
    assert tks.integrate_dispatch_subrings(q0, q0, 10, 0.02, PARAMS, 31.0,
                                           1.0, n_orders=2) == "B7"
    assert calls == [{"n_orders": 2, "order": 2,
                      "compensated": compensated}]


@pytest.mark.parametrize("dtype,twin", [
    (torch.float32, "integrate_batch_subrings_ksc"),
    (torch.float64, "integrate_batch_subrings_ks")])
def test_dispatch_subrings_cpu_rays_take_the_twins(dtype, twin):
    q0, p0 = _rays(3, dtype)
    args = (60, DELTA, PARAMS, R_MAX, OMEGA)
    a = tks.integrate_dispatch_subrings(q0, p0, *args, n_orders=2)
    b = getattr(tks, twin)(q0, p0, *args, n_orders=2)
    c = tks.integrate_dispatch_subrings(q0, p0, *args, n_orders=2,
                                        backend="torch")
    assert len(a) == 7
    assert all(torch.equal(x, y) and torch.equal(x, z)
               for x, y, z in zip(a, b, c))


def test_subring_wrapper_raises_for_cpu_tensors():
    before = tkc.subring_launches, tkc.disk_launches, tkc.launches
    q0 = torch.zeros((4, 4), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tkc.integrate_batch_subrings_cuda(q0, q0, 10, DELTA, PARAMS, R_MAX,
                                          OMEGA)
    vec = tks.ks_params(DELTA, PARAMS, R_MAX, OMEGA, 2, True)
    with pytest.raises(ValueError, match="CUDA"):
        tkc.launch_fantasy_ks_subrings(torch.zeros((32, 4)), vec, 10, 3)
    assert (tkc.subring_launches, tkc.disk_launches, tkc.launches) == before


def test_build_registers_the_subring_entries():
    names = set(tbuild.ENTRIES["fantasy_ks"])
    assert set(tkc.SUB_ENTRIES.values()) <= names
    assert set(tkc.SUB_ENTRIES) == set(tkc.ENTRIES)
    for name in tkc.SUB_ENTRIES.values():
        # 6 pointers, n, n_sub, steps, n_orders, the stream
        assert len(tbuild.argtypes(name)) == 11
    src = (tbuild.CSRC_DIR / "fantasy_ks.cu").read_text()
    for name in names:
        assert f'extern "C" int {name}(' in src
    log = ("ptxas info    : Compiling entry function "
           "'_ZN12_GLOBAL__N_117fantasy_ks_kernelIfLb1ELNS_4ModeE2EEEvPKT_"
           "PS2_PiS3_S4_PKS2_iiii' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\nptxas info    : Used 124 registers, 400 bytes cmem[0]\n")
    assert tbuild.ptxas_summary(log) == [{
        "kernel": "fantasy_ks_kernel<f,1,2>", "registers": 124,
        "spill_stores": 0, "spill_loads": 0}]


# --- the kernel-vs-twin parity check of the subring mode ------------------

# 150 steps at delta 0.2 take each of these rays across the plane at most
# once, so both filled and unfilled slots occur
PARITY_STEPS, PARITY_DELTA = 150, 0.2
PARITY_LAYOUTS = [(True, torch.float32), (False, torch.float32),
                  (False, torch.float64)]


@pytest.fixture(scope="module")
def parity_runs():
    """Each subring twin once on the parity rays (6x6), per layout:
    {(compensated, dtype): (q0, p0, outputs)}."""
    runs = {}
    for compensated, dtype in PARITY_LAYOUTS:
        q0, p0 = _rays(6, dtype)
        twin = (tks.integrate_batch_subrings_ksc if compensated
                else tks.integrate_batch_subrings_ks)
        runs[compensated, dtype] = q0, p0, twin(
            q0, p0, PARITY_STEPS, PARITY_DELTA, PARAMS, R_MAX, OMEGA,
            n_orders=2)
    return runs


def _stub_parity(monkeypatch, runs, change, calls):
    """Points ks_kernel_parity at stand-ins on CPU rays.  The B7 wrapper's
    stand-in returns the twin's recorded outputs with one element of one
    slot changed by the least step, one ray's count changed, or a value
    written into an unfilled slot (change None: unchanged); each twin's
    returns its recorded outputs.  calls gets (who, compensated, n_orders)
    for every call."""
    def recorded(q0, p0, steps, delta, compensated):
        rq0, rp0, out = runs[compensated, q0.dtype]
        assert torch.equal(q0, rq0) and torch.equal(p0, rp0)
        assert (steps, delta) == (PARITY_STEPS, PARITY_DELTA)
        return out

    def kernel(q0, p0, steps, delta, params, r_max, omega, n_orders=3,
               order=2, compensated=True):
        calls.append(("kernel", compensated, n_orders))
        out = [t.clone() for t in recorded(q0, p0, steps, delta,
                                           compensated)]
        ray = int((out[6] > 0).nonzero()[0, 0])
        if change in ("hits_q", "hits_p"):
            row = out[4 if change == "hits_q" else 5][0, ray]
            row[2] = torch.nextafter(row[2], row.new_tensor(float("inf")))
        elif change == "count":
            out[6][ray] += 1
        elif change == "unfilled":
            empty = int((out[6] < n_orders).nonzero()[0, 0])
            out[4][n_orders - 1, empty, 1] = 1.0
        return tuple(out)

    def twin(name, compensated):
        def run(q0, p0, steps, delta, params, r_max, omega, n_orders=3,
                order=2):
            calls.append((name, compensated, n_orders))
            return recorded(q0, p0, steps, delta, compensated)
        return run

    monkeypatch.setattr(tkc, "integrate_batch_subrings_cuda", kernel)
    monkeypatch.setattr(tval, "integrate_batch_subrings_ksc",
                        twin("integrate_batch_subrings_ksc", True))
    monkeypatch.setattr(tval, "integrate_batch_subrings_ks",
                        twin("integrate_batch_subrings_ks", False))


@pytest.mark.parametrize("compensated,dtype", PARITY_LAYOUTS)
def test_subring_kernel_parity_holds_the_kernel_to_its_twin(
        monkeypatch, parity_runs, compensated, dtype):
    calls = []
    _stub_parity(monkeypatch, parity_runs, None, calls)
    q0, p0, _ = parity_runs[compensated, dtype]
    kern, res = tval.ks_kernel_parity(q0, p0, PARITY_STEPS, PARITY_DELTA,
                                      PARAMS, compensated=compensated,
                                      subrings=2)
    twin = ("integrate_batch_subrings_ksc" if compensated
            else "integrate_batch_subrings_ks")
    assert calls == [("kernel", compensated, 2), (twin, compensated, 2)]
    assert len(kern) == 7 and (kern[6] > 0).any()
    assert res["status_mismatch"] == res["n_steps_mismatch"] == 0
    assert res["count_mismatch"] == 0 and res["max_abs_err"] == 0.0
    assert all(res[k] for k in ("q_bitwise_equal", "p_bitwise_equal",
                                "hits_q_bitwise_equal",
                                "hits_p_bitwise_equal"))


@pytest.mark.parametrize("change", ["hits_q", "hits_p", "count", "unfilled"])
def test_subring_kernel_parity_sees_one_difference(monkeypatch, parity_runs,
                                                   change):
    _stub_parity(monkeypatch, parity_runs, change, [])
    q0, p0, _ = parity_runs[True, torch.float32]
    _, res = tval.ks_kernel_parity(q0, p0, PARITY_STEPS, PARITY_DELTA,
                                   PARAMS, subrings=2)
    assert res["hits_q_bitwise_equal"] == (change not in ("hits_q",
                                                          "unfilled"))
    assert res["hits_p_bitwise_equal"] == (change != "hits_p")
    assert res["count_mismatch"] == (change == "count")
    assert (res["max_abs_err"] > 0.0) == (change != "count")
    assert res["q_bitwise_equal"] and res["p_bitwise_equal"]
    assert res["status_mismatch"] == res["n_steps_mismatch"] == 0


def test_subring_kernel_parity_needs_cuda_rays():
    """No fallback: on CPU rays the B7 wrapper raises."""
    q0, p0 = _rays(6, torch.float32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tval.ks_kernel_parity(q0, p0, 100, DELTA, PARAMS, subrings=2)
