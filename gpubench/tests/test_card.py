"""One short run of a cell on the card (skips without one)."""

import json
import subprocess
import sys

import pytest

from gpubench.registry import CHECKOUT


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["bert_base_q4_0.sts_stream",
                                  "bert_base_q4_0.passage_bulk"])
def test_cell_runs_correct_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; run with -m gpu on the card")
    out = subprocess.run(
        [sys.executable, "-m", "gpubench", "--workload", cell, "--seed",
         "2147483999", "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, cwd=CHECKOUT, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
