"""What the tests of the port's command-line drivers share: the CLI's test
arguments (those of tests/test_cli_artifacts.py: 24x24, 3000 steps, delta
0.1, float64, 4 samples, without the plots), a CSV reader and a 32x32 file
background."""
import csv

import numpy as np
import pytest
from PIL import Image

CLI_ARGS = ["--size", "24", "--steps", "3000", "--delta", "0.1",
            "--n-samples", "4", "--dtype", "float64", "--backend", "xla",
            "--no-plots"]


def read_csv(path):
    """(header, rows as a string array)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], np.array(rows[1:])


@pytest.fixture(scope="module")
def background(tmp_path_factory):
    """A random 32x32 PNG background's path."""
    d = tmp_path_factory.mktemp("bg")
    tex = np.random.default_rng(0).integers(0, 255, (32, 32, 3),
                                            dtype=np.uint8)
    Image.fromarray(tex).save(d / "sky.png")
    return str(d / "sky.png")
