"""The disk mode's kernel-vs-twin parity check (part of
tests/test_torch_render_disk.py), held with a stand-in for the kernel:
equal where the kernel is its twin, and seeing a one-ulp or one-ray
difference in hit_q, hit_p or the hit flag.

At most six tests a file: pytest-xdist's --dist loadfile hands out
the files with the most tests first, so a file this small runs after
the suite's long few-test files instead of ahead of them.
"""
import pytest
import torch

from grtrace_torch.engine import integrate_ks as tks
from grtrace_torch.engine import integrate_ks_cuda
from grtrace_torch.engine import validate as tval
from test_torch_render_disk import PARITY_PARAMS, R_IN, _parity_rays

torch.set_num_threads(1)


def _fake_disk_kernel(change, calls):
    """Stands in for the B6 wrapper on CPU rays: the twin's outputs, with
    one element of one output changed by the least step, or one ray's hit
    flag flipped."""
    def kernel(q0, p0, steps, delta, params, r_max, omega, r_in, r_out,
               order=2, compensated=True):
        calls.append(compensated)
        twin = (tks.integrate_batch_disk_ksc if compensated
                else tks.integrate_batch_disk_ks)
        out = [t.clone() for t in twin(q0, p0, steps, delta, params, r_max,
                                       omega, r_in, r_out, order=order)]
        hit = (out[2] == tks.STATUS_DISK).nonzero()[0, 0]
        if change in ("hit_q", "hit_p"):
            row = out[4 if change == "hit_q" else 5][hit]
            row[2] = torch.nextafter(row[2], row.new_tensor(float("inf")))
        elif change == "hit":
            out[2][hit] = 2
        return tuple(out)
    return kernel


@pytest.mark.parametrize("compensated,dtype", [
    (True, torch.float32), (False, torch.float32), (False, torch.float64)])
def test_disk_kernel_parity_holds_the_kernel_to_its_twin(monkeypatch,
                                                          compensated, dtype):
    calls = []
    monkeypatch.setattr(integrate_ks_cuda, "integrate_batch_disk_cuda",
                        _fake_disk_kernel(None, calls))
    q0, p0 = _parity_rays(dtype)
    kern, res = tval.ks_kernel_parity(q0, p0, 500, 0.05, PARITY_PARAMS,
                                      compensated=compensated,
                                      disk=(R_IN, 14.0))
    assert calls == [compensated] and len(kern) == 6
    assert (kern[2] == tks.STATUS_DISK).any()
    assert res["status_mismatch"] == res["n_steps_mismatch"] == 0
    assert res["hit_mismatch"] == 0 and res["max_abs_err"] == 0.0
    assert all(res[k] for k in ("q_bitwise_equal", "p_bitwise_equal",
                                "hit_q_bitwise_equal", "hit_p_bitwise_equal"))


@pytest.mark.parametrize("change", ["hit_q", "hit_p", "hit"])
def test_disk_kernel_parity_sees_one_difference(monkeypatch, change):
    monkeypatch.setattr(integrate_ks_cuda, "integrate_batch_disk_cuda",
                        _fake_disk_kernel(change, []))
    q0, p0 = _parity_rays(torch.float32)
    _, res = tval.ks_kernel_parity(q0, p0, 500, 0.05, PARITY_PARAMS,
                                   disk=(R_IN, 14.0))
    assert res["hit_q_bitwise_equal"] == (change != "hit_q")
    assert res["hit_p_bitwise_equal"] == (change != "hit_p")
    assert res["hit_mismatch"] == (change == "hit")
    assert res["status_mismatch"] == (change == "hit")
    assert (res["max_abs_err"] > 0.0) == (change != "hit")
    assert res["q_bitwise_equal"] and res["p_bitwise_equal"]
