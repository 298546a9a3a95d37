"""The checkpoint chunk twins against JAX's interpret-mode Pallas chunk
kernels, npz carries finishing across the two packages, and the eqc
read-out against JAX's (part of tests/test_torch_checkpoint.py, whose
docstring states the tolerances).

At most six tests a file: pytest-xdist's --dist loadfile hands out
the files with the most tests first, so a file this small runs after
the suite's long few-test files instead of ahead of them.
"""
import jax.numpy as jnp
import numpy as np
import torch

from grtrace.engine import checkpoint as jck
from grtrace.engine import integrate_pallas as jp
from grtrace_torch.engine import checkpoint as tck
from test_torch_checkpoint import ARGS, SCAL, _finish, _t, rays32, rays64

torch.set_num_threads(1)


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
