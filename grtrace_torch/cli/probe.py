"""Accelerator environment probe — the port's `grtrace.cli.probe`, and the
reference's own GPU probe (tests/cuda-test.py), which printed the CUDA
device count, name, capability, memory and SM count through torch.

Prints torch's version and CUDA build, each visible CUDA device with its
name, compute capability, memory, SM count and power limit (nvidia-smi),
and runs a one-op check on each.  Without a CUDA device it says so and
fails, unless --device cpu asks for the CPU check alone.

Run: python -m grtrace_torch.cli.probe [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..engine.metrics import nvidia_smi


def _one_op(device) -> bool:
    x = torch.arange(8.0, device=device)
    return float((x * x).sum()) == 140.0


def probe(device="cuda", file=None) -> bool:
    """Print the environment (to `file`, by default standard output); True
    when every check on `device` ('cuda': every visible card; 'cpu': the
    CPU) passed."""
    def p(*a):
        print(*a, file=file or sys.stdout)

    p(f"torch {torch.__version__}  CUDA build {torch.version.cuda}")
    if device == "cpu":
        ok = _one_op("cpu")
        p(f"  [cpu] one-op check {'OK' if ok else 'FAILED'}")
        return ok
    if not torch.cuda.is_available():
        p("no CUDA device visible (torch.cuda.is_available() is False)")
        return False
    n = torch.cuda.device_count()
    limits = nvidia_smi("power.limit")
    p(f"{n} CUDA device(s) visible")
    ok = True
    for i in range(n):
        prop = torch.cuda.get_device_properties(i)
        limit = limits[i] if i < len(limits) else "not read"
        p(f"  [{i}] {prop.name}  capability {prop.major}.{prop.minor}  "
          f"{prop.total_memory / 2**30:.2f} GiB  "
          f"{prop.multi_processor_count} SMs  power limit {limit}")
        good = _one_op(torch.device("cuda", i))
        ok &= good
        p(f"  [{i}] one-op check {'OK' if good else 'FAILED'}")
    return ok


def console(argv=None):
    parser = argparse.ArgumentParser(description="CUDA environment probe")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    sys.exit(0 if probe(args.device) else 1)


if __name__ == "__main__":
    console()
