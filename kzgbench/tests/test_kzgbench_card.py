"""The benchmark's command end to end on the card: a short run of each
cell, correct, with the contract's last line.  Needs a CUDA card."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.card
@pytest.mark.parametrize("cell", ["node.block-9", "poster.tx-6"])
def test_command_runs_a_cell_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "kzgbench/run.py", "--workload", cell, "--seed", "3000000007", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"


def test_command_refuses_to_run_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = subprocess.run(
        [sys.executable, "kzgbench/run.py", "--workload", "node.block-9", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert out.returncode != 0 and not out.stdout.strip()
