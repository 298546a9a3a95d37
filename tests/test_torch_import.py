"""The PyTorch port stands alone: it imports without jax and never imports
the JAX package, and neither does the GPU smoke script."""
import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
# between them these import every module of the port, each new module of
# the Kerr and disk slices on its own; of the subring slice's, the two that
# `import grtrace_torch` does not reach (it imports engine.subring and
# engine.hotspot); the command-line drivers; each new module of the
# disk product line (polarization, transfer maps, hot spots, their CLIs);
# the generic engine's (the Boyer-Lindquist flows, the twins, the
# kernels' wrappers); the observables' (antialiasing, visibilities,
# their drivers); and the throughput benchmark's driver
PORT_MODULES = ["grtrace_torch", "grtrace_torch.engine",
                "grtrace_torch.kernels.build",
                "grtrace_torch.physics.spacetime",
                "grtrace_torch.physics.kerr_schild",
                "grtrace_torch.engine.integrate_ks",
                "grtrace_torch.engine.integrate_ks_cuda",
                "grtrace_torch.engine.render_generic",
                "grtrace_torch.engine.validate",
                "grtrace_torch.physics.orbits",
                "grtrace_torch.engine.disk",
                "grtrace_torch.physics.photon_shell",
                "grtrace_torch.engine.spectrum",
                "grtrace_torch.cli.main",
                "grtrace_torch.cli.single_ray",
                "grtrace_torch.cli.band_sweep",
                "grtrace_torch.cli.probe",
                "grtrace_torch.physics.polarization",
                "grtrace_torch.io.transfer",
                "grtrace_torch.engine.hotspot",
                "grtrace_torch.cli.reshade",
                "grtrace_torch.cli.hotspot",
                "grtrace_torch.physics.kerr_bl",
                "grtrace_torch.engine.integrate_generic",
                "grtrace_torch.engine.integrate_generic_cuda",
                "grtrace_torch.engine.aa",
                "grtrace_torch.engine.visibility",
                "grtrace_torch.cli.subring",
                "grtrace_torch.cli.visibility",
                "grtrace_torch.cli.bench_cli"]

# One interpreter with jax and grtrace blocked (any import of them raises)
# imports the modules in turn and reports, for each, whether it imported
# and whether jax or grtrace appeared in sys.modules: one torch import
# instead of one per module.
_BLOCKED_IMPORTS = r"""
import importlib, json, sys, traceback
sys.modules['jax'] = None
sys.modules['grtrace'] = None
out = {}
for name in sys.argv[1:]:
    try:
        importlib.import_module(name)
        err = None
    except BaseException:
        err = traceback.format_exc()
    leaked = sorted(m for m in sys.modules if sys.modules[m] is not None
                    and (m == 'jax' or m.startswith(('jax.', 'grtrace.'))))
    out[name] = {'error': err, 'leaked': leaked}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def blocked_imports():
    """{module: {'error': traceback or None, 'leaked': [jax/grtrace
    modules in sys.modules after importing it]}}."""
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORTS,
                           *PORT_MODULES], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _port_sources():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "tools", "eqc_ablation.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "grtrace_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("module", PORT_MODULES)
def test_imports_with_jax_blocked(blocked_imports, module):
    got = blocked_imports[module]
    assert got["error"] is None, got["error"]
    assert not got["leaked"], f"{module} pulled in {got['leaked']}"


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_grtrace_import_in_source(path):
    with open(path) as f:
        src = f.read()
    bad = re.findall(r"^\s*(?:import|from)\s+(jax|grtrace)\b(?!_torch)", src,
                     re.MULTILINE)
    assert not bad, f"{path} imports {bad}"


def test_public_api():
    import grtrace_torch
    for name in ("SceneConfig", "IntegratorConfig", "PatchConfig", "render",
                 "RenderResult", "SchwarzschildIntegrator", "from_jax_scene",
                 "DiskConfig", "render_disk", "from_jax_disk",
                 "save_disk_maps", "polarized_moments", "HotspotConfig",
                 "from_jax_hotspot", "render_hotspot", "TransferMap",
                 "reshade", "hotspot_from_transfer", "subring_visibilities",
                 "save_subring_maps"):
        assert hasattr(grtrace_torch, name), name


def test_chip_smoke_refuses_without_cuda():
    """Without a card the smoke script exits non-zero and prints no
    result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py would run")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
