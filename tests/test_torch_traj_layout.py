"""Kernel S1's record layout (stride = ceil(steps / n_keep), n_keep_eff =
ceil(steps / stride)) and its entries in the build (part of
tests/test_torch_traj.py).

At most six tests a file: pytest-xdist's --dist loadfile hands out
the files with the most tests first, so a file this small runs after
the suite's long few-test files instead of ahead of them.
"""
import ctypes

import pytest

from grtrace_torch.engine import integrate as ti
from grtrace_torch.engine import integrate_cuda as tc
from grtrace_torch.kernels import build as tbuild


@pytest.mark.parametrize("steps,n_keep,layout", [
    (200_000, None, (1, 200_000)), (200_000, 1000, (200, 1000)),
    (300, 70, (5, 60)), (300, 300, (1, 300)), (300, 1000, (1, 300))])
def test_traj_layout(steps, n_keep, layout):
    """stride = ceil(steps / n_keep), n_keep_eff = ceil(steps / stride),
    stride 1 at n_keep >= steps (the single ray's every-step record)."""
    assert ti.traj_layout(steps, n_keep) == layout


def test_s1_entries_registered():
    """Both S1 entries are built from fantasy_schw16.cu (its record mode),
    with the signature (q0, p0, traj, ns, params, n, n_sub, steps, stride,
    n_keep, stream); no other source exports them."""
    names = tuple(tc.TRAJ_ENTRIES.values())
    assert set(names) <= set(tbuild.ENTRIES["fantasy_schw16"])
    assert [stem for stem, entries in tbuild.ENTRIES.items()
            if set(names) & set(entries)] == ["fantasy_schw16"]
    assert {src.stem for src in tbuild._sources()} == set(tbuild.ENTRIES)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in names:
        assert tbuild.argtypes(name) == [p] * 5 + [i] * 5 + [p]
