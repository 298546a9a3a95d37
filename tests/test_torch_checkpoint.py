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

The comparisons that take seconds are in
tests/test_torch_checkpoint_chunks.py and
tests/test_torch_checkpoint_jax.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grtrace.engine import checkpoint as jck
from grtrace.physics import camera as jcam
from grtrace_torch.engine import checkpoint as tck
from grtrace_torch.engine import integrate as ti
from grtrace_torch.engine import integrate_cuda as tc

torch.set_num_threads(1)

ARGS = dict(delta=0.05, rs=2.0, r_max=31.0, omega=1.0)


SCAL = (0.05, 2.0, 31.0, 1.0)


def _finish(st, chunk, backend="auto"):
    while not st.done:
        st = tck.advance(st, chunk, backend=backend)
    return st


def _ics(n, dtype):
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    q0, p0, *_ = jcam.camera_rays(np.array([30.0, 0.0, 0.0], dtype),
                                  dtype(np.radians(70.0)), n, n, dtype=jdt)
    return (np.asarray(q0, dtype).reshape(-1, 4),
            np.asarray(p0, dtype).reshape(-1, 4))


def _t(*xs):
    return tuple(torch.tensor(x) for x in xs)


@pytest.fixture(scope="module")
def rays32():
    return _ics(6, np.float32)


@pytest.fixture(scope="module")
def rays64():
    return _ics(6, np.float64)


# --- carries across the two packages ---------------------------------------


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
