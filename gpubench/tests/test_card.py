"""One short run of each cell on the card (skips without one): the cells
of BENCHMARK.json, and the parked cells with their entries put back."""

import json
import subprocess
import sys

import pytest

from gpubench.registry import CHECKOUT, load_benchmark

from .conftest import parked_cells

# a run of the command, with a parked cell's entries put back
PARKED_RUN = """import sys
from gpubench import run
from gpubench.tests.conftest import bench_with
bench = bench_with(sys.argv[2])
run.load_benchmark = lambda: bench
sys.exit(run.main(sys.argv[1:]))"""


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  load_benchmark()["workloads"]]
                         + parked_cells())
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run with -m gpu on the card")
    entry = (["-c", PARKED_RUN] if cell in parked_cells()
             else ["-m", "gpubench"])
    out = subprocess.run(
        [sys.executable, *entry, "--workload", cell, "--seed",
         "2147483999", "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, cwd=CHECKOUT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
