"""cli.bench_cli on the port (`--device cpu`) against JAX's
`grtrace.cli.bench_cli.main` with the same arguments: `--size 16 --steps
4000 --delta 0.05 --iters 1` alone, with `--dtype float64`, with
`--metric kerr --spin 0.9` and with `--metric kerr --spin 0.9 --disk`.
Both packages' four runs run once, in a module-scoped fixture, as eight
processes side by side (on the CPU; JAX's with float64 enabled), with a
ninth: JAX's default line with `--backend pallas`, its Pallas kernel run
in interpret mode as the JAX package's own tests run it on the CPU.  The
port's eager twins take 2-6 s a render at this size, so four runs in
this process would take about 30 s.

What is held: the JSON line's key set is JAX's and the printed line is
the dict `main` returns; `counts`, `metric`, `steps_budget`, `metric_family`,
`spin` and `dtype` are equal.  Each process also prints the int64 sum of
the last frame's `n_steps` (its package's `render` / `render_disk`
wrapped).  They are equal on the Schwarzschild lines: the float32 line
against the Pallas run, since on the CPU the port's float32 equatorial
rays take the compensated twin of that kernel where JAX's `auto` takes
its plain XLA loop; the float64 line against JAX's own line, both the
plain loop.  On the Kerr-Schild lines they agree within 2 steps a
captured ray, the step-count tolerance
of tests/test_torch_render_kerr_jax.py (a captured ray may trip the guard
up to 2 steps apart).  The port's mean steps a ray,
`geodesic_steps_per_s / rays_per_s`, agrees with its own sum over the
rays within the rounding of those two printed integers, 2 / rays_per_s
relative.  Without a card the default --device exits with a message; the
JAX backend names map to the port's.
"""
import json
import os
import subprocess
import sys

import pytest

from grtrace_torch.cli import bench_cli

COMMON = ["--size", "16", "--steps", "4000", "--delta", "0.05", "--iters",
          "1"]
RUNS = {"schwarzschild": [], "float64": ["--dtype", "float64"],
        "kerr": ["--metric", "kerr", "--spin", "0.9"],
        "disk": ["--metric", "kerr", "--spin", "0.9", "--disk"]}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a package's bench_cli.main with its render and render_disk wrapped to
# keep the last frame's int64 n_steps sum, printed after main's output
MAIN = """\
import json, sys
import numpy as np
{setup}
import {pkg}
from {pkg}.cli import bench_cli
last = []
def keep(fn):
    def call(*args, **kw):
        res = fn(*args, **kw)
        last[:] = [int(np.asarray(res.n_steps).astype(np.int64).sum())]
        return res
    return call
{pkg}.render, {pkg}.render_disk = keep({pkg}.render), keep({pkg}.render_disk)
{run}
print(json.dumps({{"n_steps_sum": last[-1]}}))
"""
JAX_MAIN = MAIN.format(
    pkg="grtrace", run="bench_cli.main(sys.argv[1:])",
    setup="import jax; jax.config.update('jax_platforms', 'cpu'); "
          "jax.config.update('jax_enable_x64', True)")
# JAX's line through its compensated Pallas kernel, in interpret mode
JAX_PALLAS_MAIN = MAIN.format(
    pkg="grtrace", run="bench_cli.main(sys.argv[1:])",
    setup="import functools, jax; "
          "jax.config.update('jax_platforms', 'cpu'); "
          "jax.config.update('jax_enable_x64', True); "
          "from grtrace.engine import integrate_pallas as ip; "
          "ip.integrate_batch_pallas = functools.partial("
          "ip.integrate_batch_pallas, interpret=True)")
# the port's printed line, then the dict its main returned
PORT_MAIN = MAIN.format(
    pkg="grtrace_torch", setup="",
    run="print(json.dumps(bench_cli.main(sys.argv[1:])))")
EQUAL = ("metric", "steps_budget", "metric_family", "spin", "dtype",
         "counts")


@pytest.fixture(scope="module")
def lines():
    """{(package, run): the output lines of its bench_cli.main, parsed},
    package 'jax', 'port' (--device cpu) or 'jax_pallas' (the default
    line only)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        filter(None, (ROOT, os.environ.get("PYTHONPATH")))))
    jobs = [(pkg, src, name, argv + extra)
            for pkg, src, extra in (("jax", JAX_MAIN, []),
                                    ("port", PORT_MAIN, ["--device", "cpu"]))
            for name, argv in RUNS.items()]
    jobs.append(("jax_pallas", JAX_PALLAS_MAIN, "schwarzschild",
                 ["--backend", "pallas"]))
    procs = {(pkg, name): subprocess.Popen(
        [sys.executable, "-c", src, *COMMON, *argv], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pkg, src, name, argv in jobs}
    out = {}
    try:
        for key, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=600)
            assert proc.returncode == 0, (key, stderr[-2000:])
            out[key] = [json.loads(line) for line in stdout.splitlines()
                        if line.startswith("{")]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _mean_steps(line):
    return line["geodesic_steps_per_s"] / line["rays_per_s"]


@pytest.mark.parametrize("name", list(RUNS))
def test_bench_cli_matches_jax(name, lines):
    """The port's line against JAX's on the same argv."""
    printed, m, port_steps = lines[("port", name)]
    assert printed == m
    j, jax_steps = lines[("jax", name)]
    assert list(m) == list(j)
    for k in EQUAL:
        assert m[k] == j[k], (k, m[k], j[k])
    c = m["counts"]
    assert c["numerical_error"] == c["in_domain"] == 0
    assert c["escaped"] == c["background"]
    assert (sum(v for k, v in c.items() if k != "background")
            == 16 * 16)
    assert m["backend"] == "auto" and m["unit"] == "s"
    port_sum, jax_sum = port_steps["n_steps_sum"], jax_steps["n_steps_sum"]
    if name == "schwarzschild":
        pallas, pallas_steps = lines[("jax_pallas", name)]
        assert pallas["counts"] == c
        jax_sum = pallas_steps["n_steps_sum"]
    if name in ("kerr", "disk"):
        assert abs(port_sum - jax_sum) <= 2 * c["captured"], (port_sum,
                                                              jax_sum)
    else:
        assert port_sum == jax_sum
    mean = port_sum / (16 * 16)
    assert abs(_mean_steps(m) - mean) <= 2.0 / m["rays_per_s"] * mean, (
        _mean_steps(m), mean)


def test_bench_cli_backends_jitter_out_and_device(monkeypatch, tmp_path):
    """JAX's backend names map to the port's ('pallas' -> 'cuda', 'xla' ->
    'torch') and the line names the port's; the warm-up renders at the
    scene's 30, each timed iteration i at 30 moved out by i + 1 float32
    ulps; --out writes the printed line; the steps are summed in int64;
    without a card the default --device exits with a message."""
    import numpy as np
    import torch

    import grtrace_torch

    calls = []

    class Result:
        counts = {"captured": 1, "in_domain": 0, "escaped": 3,
                  "background": 3, "numerical_error": 0}

        def device(self, name):
            assert name == "n_steps"
            return torch.full((2, 2), 2 ** 30, dtype=torch.int32)

    def fake_render(scene, *, bg_array, device):
        assert bg_array.shape == (2, 2, 3) and bg_array.dtype == np.uint8
        calls.append((scene.observer_distance, scene.integrator.backend,
                      device))
        return Result()

    monkeypatch.setattr(grtrace_torch, "render", fake_render)
    for jax_name, port_name in (("pallas", "cuda"), ("xla", "torch"),
                                ("torch", "torch")):
        calls.clear()
        out = tmp_path / f"{jax_name}.json"
        m = bench_cli.main(["--size", "2", "--iters", "2", "--backend",
                            jax_name, "--device", "cpu", "--out", str(out)])
        assert m["backend"] == port_name
        assert json.loads(out.read_text()) == m
        # 4 rays of 2**30 steps: 2**32 wraps to 0 in int32
        assert abs(_mean_steps(m) / 2 ** 30 - 1.0) < 1e-3
        one = float(np.nextafter(np.float32(30.0), np.float32(np.inf)))
        two = float(np.nextafter(np.float32(one), np.float32(np.inf)))
        assert calls == [(30.0, port_name, "cpu"), (one, port_name, "cpu"),
                         (two, port_name, "cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="--device cpu"):
            bench_cli.main(["--size", "2", "--iters", "1"])
