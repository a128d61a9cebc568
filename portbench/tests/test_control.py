"""The control: the reference, in the precision below the one the
configuration states, put in the program's place, fails one of each cell's
numbers (bf16 store -> the program's own int8 store; bf16 backbone ->
float8 e4m3). The readings on the chip at the cells' own sizes, and the
limits set from them, are in PERF.md; here the cells are cut small."""

import pytest

from portbench.run import forbidden_modules, run_cell
from portbench.tests.small import CELLS, SECONDS


@pytest.mark.parametrize("cell", ["exact-1m-d128-bf16.q4096", "resnet50-flat-1m.open-mb8",
                                  "resnet50-flat-1m.index-b64"])
def test_the_control_fails_a_limit(cell):
    run = run_cell(cell, 7, SECONDS, False, "cpu", overrides=CELLS[cell], control=True)
    assert run["result"]["correct"]
    over = {n: v for n, v in run["control"].items() if v > run["checks"][n][1]}
    assert over, (run["control"], run["checks"])


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_each_cell_runs_correct_on_the_card_and_its_control_fails(cuda_device, cell):
    """Each cell at its own sizes, a short window."""
    run = run_cell(cell, 11, 2.0, True, cuda_device, control=True)
    assert run["result"]["correct"], run["checks"]
    assert not forbidden_modules()
    assert any(v > run["checks"][n][1] for n, v in run["control"].items())
