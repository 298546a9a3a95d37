"""Checkpoint / resume (grtrace_torch.engine.checkpoint) against the JAX
package's `grtrace.engine.checkpoint`, on the CPU.

* The chunk twins against the interpret-mode Pallas chunk kernels in
  float32: `_advance_fused` (kernel B3's chunk) against
  `advance_state_pallas`, equal steps, state within 5e-5 of max(|x|, 1);
  `_advance_eqc` (kernel B4) against `advance_state_pallas_eqc`, equal
  steps, best-estimate rows within 1e-6 (XLA:CPU's FMAs round
  differently).
* Within the port, chunked == monolithic bit for bit, a save and load in
  the middle included, for both layouts.
* An npz carry written by one package finishes in the other.
* The npz-only decision, steps == 0, the `done` and `resume` flags, the
  layout auto-select and the refusals of the kernel paths.

The chunk kernels themselves are held against their twins on the card by
chip_smoke.py (phases 22 and 23).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.engine import checkpoint as jck
from grtrace.engine import integrate_pallas as jp
from grtrace.physics import camera as jcam
from grtrace_torch.engine import checkpoint as tck
from grtrace_torch.engine import integrate as ti
from grtrace_torch.engine import integrate_cuda as tc

torch.set_num_threads(1)

ARGS = dict(delta=0.05, rs=2.0, r_max=31.0, omega=1.0)
SCAL = (0.05, 2.0, 31.0, 1.0)


def _ics(n, dtype):
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    q0, p0, *_ = jcam.camera_rays(np.array([30.0, 0.0, 0.0], dtype),
                                  dtype(np.radians(70.0)), n, n, dtype=jdt)
    return (np.asarray(q0, dtype).reshape(-1, 4),
            np.asarray(p0, dtype).reshape(-1, 4))


def _t(*xs):
    return tuple(torch.tensor(x) for x in xs)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _finish(st, chunk, backend="auto"):
    while not st.done:
        st = tck.advance(st, chunk, backend=backend)
    return st


def _final(st):
    return st.final_q, st.final_p, st.status, st.n_steps


@pytest.fixture(scope="module")
def rays32():
    return _ics(6, np.float32)


@pytest.fixture(scope="module")
def rays64():
    return _ics(6, np.float64)


@pytest.fixture(scope="module")
def mono64(rays64):
    """integrate_batch, 2500 steps: the monolithic float64 CPU result."""
    return ti.integrate_batch(*_t(*rays64), 2500, *SCAL)


# --- the chunk twins against the interpret-mode Pallas chunk kernels ------

def test_fused_chunk_twin_matches_pallas(rays32):
    q0, p0 = rays32
    state16 = np.concatenate([q0.T, p0.T, q0.T, p0.T]).astype(np.float32)
    js, jn = jp.advance_state_pallas(jnp.asarray(state16), 500, *SCAL,
                                     interpret=True)
    ts, tn = tck._advance_fused(torch.tensor(state16), 500, *SCAL)
    js = np.asarray(js)
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    assert (tn > 0).all()
    rel = np.abs(ts.numpy() - js) / np.maximum(np.abs(js), 1.0)
    assert rel.max() < 5e-5


def test_eqc_chunk_twin_matches_pallas(rays32):
    q0, p0 = rays32
    jst = jck.start(jnp.asarray(q0), jnp.asarray(p0), 500, compensated=True,
                    **ARGS)
    tst = tck.start(*_t(q0, p0), 500, compensated=True, **ARGS)
    # the opened carries agree bit for bit (one flow from the same state)
    assert np.array_equal(tst.state.numpy(), np.asarray(jst.state))
    assert np.array_equal(tst.opened.numpy(), jst.opened)
    js, jn = jp.advance_state_pallas_eqc(jnp.asarray(jst.state), 500, *SCAL,
                                         interpret=True)
    ts, tn = tck._advance_eqc(tst.state, 500, *SCAL)
    js, ts = np.asarray(js), ts.numpy()
    assert np.array_equal(tn.numpy(), np.asarray(jn))
    best_t, best_j = ts[:12] - ts[12:], js[:12] - js[12:]
    assert np.abs(best_t - best_j).max() < 1e-6


# --- chunked == monolithic, bit for bit, in the port -----------------------

def test_eqc_chunked_equals_monolithic(rays32, tmp_path):
    """The float32 production numerics: chunks with a save and load in the
    middle equal integrate_batch_compensated (B1's twin) bit for bit,
    final_p included (the close is eager torch with no FMA)."""
    q0, p0 = _t(*rays32)
    mono = ti.integrate_batch_compensated(q0, p0, 1800, *SCAL)
    st = tck.start(q0, p0, 1800, compensated=True, **ARGS)
    assert st.layout == "eqc"
    st = tck.advance(st, 800)
    path = str(tmp_path / "eqc.npz")
    st.save(path)
    st = tck.IntegrationState.load(path, device="cpu")
    assert st.layout == "eqc" and st.opened is not None
    st = _finish(st, 900)
    assert _equal(_final(st), mono)


def test_generic_chunked_equals_monolithic(rays64, mono64, tmp_path):
    """float64 rays on the CPU: chunks of the unfused loop equal
    integrate_batch bit for bit."""
    q0, p0 = _t(*rays64)
    mono = mono64
    path = str(tmp_path / "gen.npz")
    st = tck.integrate_chunked(q0, p0, 2500, chunk_steps=700,
                               checkpoint_path=path, **ARGS)
    assert st.layout == "generic" and st.steps_done == 2100
    assert _equal(_final(st), mono)
    assert _equal(_final(tck.IntegrationState.load(path, device="cpu")),
                  mono)


def test_fused_chunks_equal_one_fused_run(rays64):
    """B3's chunk twin: chained chunks equal one run of B3's twin loop."""
    q0, p0 = _t(*rays64)
    mono = ti.integrate_batch_fused(q0, p0, 2500, *SCAL)
    st = tck.start(q0, p0, 2500, **ARGS)
    state, n_steps = st.state, st.n_steps
    for _ in range(4):
        state, applied = tck._advance_fused(state, 700, *SCAL)
        n_steps = n_steps + applied
    st = dataclasses.replace(st, state=state, n_steps=n_steps,
                             steps_done=2500)
    assert _equal(_final(st), mono)


# --- carries across the two packages ---------------------------------------

def test_jax_npz_finishes_in_the_port(rays64, rays32, tmp_path):
    for (q0, p0), comp in ((rays64, False), (rays32, True)):
        path = str(tmp_path / f"jax_{comp}.npz")
        jst = jck.advance(jck.start(jnp.asarray(q0), jnp.asarray(p0), 1800,
                                    compensated=comp, **ARGS), 600)
        jst.save(path)
        st = tck.IntegrationState.load(path, device="cpu")
        assert st.layout == ("eqc" if comp else "generic")
        assert st.steps_done == 600 and st.state.dtype == torch.tensor(
            q0).dtype
        st = _finish(st, 1200)
        ref = jck.advance(jst, 1200)  # JAX finishes its own carry
        assert np.array_equal(st.status.numpy(), ref.status)
        assert np.array_equal(st.n_steps.numpy(), ref.n_steps)
        esc = ref.status == 2
        tol = 1e-4 if comp else 1e-9
        assert np.abs(st.final_q.numpy()[esc] - ref.final_q[esc]).max() < tol


def test_port_npz_loads_in_jax(rays64, rays32, tmp_path):
    for (q0, p0), comp in ((rays64, False), (rays32, True)):
        path = str(tmp_path / f"port_{comp}.npz")
        st = tck.advance(tck.start(*_t(q0, p0), 1800, compensated=comp,
                                   **ARGS), 600)
        st.save(path)
        jst = jck.IntegrationState.load(path)
        assert np.array_equal(jst.state, st.state.numpy())
        assert np.array_equal(jst.n_steps, st.n_steps.numpy())
        assert np.array_equal(jst.esc_pred, st.esc_pred.numpy())
        assert (jst.layout, jst.steps_done, jst.steps_total, jst.order) == (
            st.layout, 600, 1800, 2)
        assert (jst.delta, jst.rs, jst.r_max, jst.omega) == (0.05, 2.0, 31.0,
                                                             1.0)
        if comp:
            assert np.array_equal(jst.opened, st.opened.numpy())
        while not jst.done:
            jst = jck.advance(jst, 1200)
        mine = _finish(st, 1200)
        assert np.array_equal(jst.status, mine.status.numpy())
        assert np.array_equal(jst.n_steps, mine.n_steps.numpy())


def test_finalize_eqc_matches_jax(rays32):
    q0, p0 = rays32
    jst = jck.advance(jck.start(jnp.asarray(q0), jnp.asarray(p0), 1800,
                                compensated=True, **ARGS), 300)
    st = jnp.asarray(jst.state)
    j = np.asarray(jck._finalize_eqc(st, jnp.asarray(jst.opened), 0.05, 2.0))
    t = torch.stack(tck._finalize_eqc(torch.tensor(np.asarray(st)),
                                      torch.tensor(jst.opened), 0.05, 2.0))
    ulps = np.abs(t.numpy().view(np.int32).astype(np.int64)
                  - j.astype(np.float32).view(np.int32))
    assert ulps.max() <= 4  # XLA's close contracts FMAs; torch's does not


def test_legacy_impact_parameter_key(tmp_path):
    b = np.array([1.0, 5.0, 5.3, 9.0])
    np.savez(tmp_path / "old.npz", b=b)
    with np.load(tmp_path / "old.npz") as z:
        t = tck._load_esc_pred(z, 2.0)
        j = jck._load_esc_pred(z, 2.0)
    assert np.array_equal(t, j) and t.tolist() == [False, False, True, True]
    np.savez(tmp_path / "none.npz", x=b)
    with np.load(tmp_path / "none.npz") as z:
        assert tck._load_esc_pred(z, 2.0) is None


# --- flags, layouts and refusals -------------------------------------------

@pytest.mark.parametrize("comp", [False, True])
def test_zero_steps_is_a_noop(rays32, comp):
    q0, p0 = _t(*rays32)
    st = tck.start(q0, p0, 0, compensated=comp, **ARGS)
    assert st.done and not bool(st.opened.any()) if comp else st.done
    assert torch.equal(st.final_q, q0)
    assert (st.status == ti.STATUS_ALIVE).all() and (st.n_steps == 0).all()
    assert tck.advance(st, 100) is st
    again = tck.integrate_chunked(q0, p0, 0, compensated=comp, **ARGS)
    assert again.steps_done == 0 and torch.equal(again.state, st.state)


def test_done_and_resume_flags(rays64, mono64, tmp_path):
    q0, p0 = _t(*rays64)
    path = str(tmp_path / "resume.npz")
    st = tck.start(q0, p0, 2500, **ARGS)
    assert not st.done
    st = tck.advance(st, 700)
    st.save(path)
    assert not st.done and st.steps_done == 700
    # resume=True continues from the file, not from the launch state
    resumed = tck.integrate_chunked(q0 * 0.0, p0, 2500, chunk_steps=900,
                                    checkpoint_path=path, resume=True,
                                    **ARGS)
    # every ray has ended after the second chunk, so the job stops there
    assert resumed.done and resumed.steps_done == 700 + 900
    assert _equal(_final(resumed), mono64)
    # a budget that runs out leaves the job done with rays still alive
    short = tck.integrate_chunked(q0, p0, 300, chunk_steps=100, **ARGS)
    assert short.done and short.steps_done == 300
    assert (short.status == ti.STATUS_ALIVE).any()


def test_layout_auto_select(rays32, rays64):
    for (q0, p0), layout in ((rays32, "eqc"), (rays64, "generic")):
        st = tck.integrate_chunked(*_t(q0, p0), 200, chunk_steps=100, **ARGS)
        assert st.layout == layout and st.steps_done == 200
        # numpy rays go to `device`
        st = tck.integrate_chunked(q0, p0, 100, device="cpu", **ARGS)
        assert st.layout == layout and st.state.device.type == "cpu"


def test_non_npz_paths_raise(rays64, tmp_path):
    st = tck.start(*_t(*rays64), 100, **ARGS)
    for call in (lambda: st.save(str(tmp_path / "ck_dir")),
                 lambda: tck.IntegrationState.load(str(tmp_path / "ck_dir"),
                                                   device="cpu"),
                 lambda: tck.integrate_chunked(
                     *_t(*rays64), 100, checkpoint_path=str(tmp_path / "d"),
                     **ARGS)):
        with pytest.raises(ValueError, match="npz"):
            call()


def test_kernel_paths_refuse_cpu_carries(rays32, rays64):
    """backend 'cuda' runs B3 / B4 or raises: never a twin; a float64
    'eqc' carry has no kernel (B4 is float32)."""
    before = (tc.generic_launches, tc.chunk_launches)
    gen = tck.start(*_t(*rays64), 100, **ARGS)
    eqc = tck.start(*_t(*rays32), 100, compensated=True, **ARGS)
    for st in (gen, eqc):
        with pytest.raises(ValueError, match="CUDA"):
            tck.advance(st, 10, backend="cuda")
    eqc64 = tck.start(*_t(*rays64), 100, compensated=True, **ARGS)
    with pytest.raises(ValueError, match="B4"):
        tck.advance(eqc64, 10, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        tck.advance(gen, 10, backend="pallas")
    assert (tc.generic_launches, tc.chunk_launches) == before
    # the float64 eqc carry advances through the twin
    assert tck.advance(eqc64, 10, backend="torch").steps_done == 10


def test_load_defaults_to_the_card(monkeypatch, rays64, tmp_path):
    path = str(tmp_path / "c.npz")
    tck.start(*_t(*rays64), 100, **ARGS).save(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tck.IntegrationState.load(path)
    with pytest.raises(RuntimeError, match="CUDA"):
        tck.start(*rays64, 100, **ARGS)
