"""The control at a size a test run holds: the plain reference computed in
float8 in the program's place comes out not correct, where the program
(bfloat16, as the configurations state) comes out correct.  On the card the
same control runs at each cell's own size (`python3 portbench/control.py`)."""

import pytest

from portbench import cells, control
from portbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.build(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("name", sorted(tiny.CELLS))
def test_the_program_is_correct(root, name):
    res = tiny.run(root, name)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("name", sorted(tiny.CELLS))
@pytest.mark.parametrize("seed", tiny.CONTROL_SEEDS)
def test_the_control_is_not(root, name, seed):
    cell = cells.load_cell(name, root)
    nums = control.control_numbers(cell, seed, "cpu")
    assert any(not nums[k] <= lim for k, lim in cell.limits.items()), nums
