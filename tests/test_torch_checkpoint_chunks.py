"""Chunked equals monolithic bit for bit in the port, for both layouts, a
save and load in the middle included, and the `done` and `resume` flags
(part of tests/test_torch_checkpoint.py).

At most six tests a file: pytest-xdist's --dist loadfile hands out
the files with the most tests first, so a file this small runs after
the suite's long few-test files instead of ahead of them.
"""
import dataclasses

import pytest
import torch

from grtrace_torch.engine import checkpoint as tck
from grtrace_torch.engine import integrate as ti
from test_torch_checkpoint import ARGS, SCAL, _finish, _t, rays32, rays64

torch.set_num_threads(1)


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _final(st):
    return st.final_q, st.final_p, st.status, st.n_steps


@pytest.fixture(scope="module")
def mono64(rays64):
    """integrate_batch, 2500 steps: the monolithic float64 CPU result."""
    return ti.integrate_batch(*_t(*rays64), 2500, *SCAL)


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
