"""The port is complete: every module of the JAX package has its
counterpart in grtrace_torch but the Pallas kernels' modules (ported as
CUDA kernels, csrc/) and the test-only float64 oracle (deliberately not
ported), and the port's public names cover the JAX package's but its
compilation cache (the port's counterpart is kernels/build.py's build
cache).  The last two names ported, `Photon` and
`apply_relative_offsets`, equal JAX's."""
import dataclasses
import os

import numpy as np
import pytest

import grtrace_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOT_PORTED_MODULES = {"engine/integrate_pallas.py",
                      "engine/integrate_pallas_ks.py", "oracle/__init__.py",
                      "oracle/cpu_integrator.py", "oracle/kerr_fd.py"}


def _modules(package):
    top = os.path.join(ROOT, package)
    return {os.path.relpath(os.path.join(d, f), top).replace(os.sep, "/")
            for d, _, files in os.walk(top) for f in files
            if f.endswith(".py")}


def test_every_jax_module_has_a_counterpart():
    assert (_modules("grtrace") - _modules("grtrace_torch")
            == NOT_PORTED_MODULES)


def test_public_names_cover_the_jax_package():
    import grtrace
    assert (set(grtrace.__all__) - set(grtrace_torch.__all__)
            == {"enable_compilation_cache"})
    for name in grtrace_torch.__all__:
        assert hasattr(grtrace_torch, name), name


@pytest.mark.parametrize("angles", [(90.0, 180.0, 0.0, 0.0),
                                    (10.0, 350.0, -25.0, 30.0),
                                    (170.0, 5.0, 20.0, -10.0),
                                    (45.0, 720.5, 0.0, 0.0)])
def test_scene_helpers_match_jax(angles):
    """apply_relative_offsets (the clip at the poles, phi wrapped into
    [0, 2 pi)) and Photon's fields against JAX's."""
    from grtrace.io import scene as jscene
    got = grtrace_torch.apply_relative_offsets(*angles)
    want = jscene.apply_relative_offsets(*angles)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    fields = [(f.name, f.type, f.default)
              for f in dataclasses.fields(grtrace_torch.Photon)]
    assert fields == [(f.name, f.type, f.default)
                      for f in dataclasses.fields(jscene.Photon)]
