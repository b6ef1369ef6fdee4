"""The control comes out not correct: on the card, at the cell's own
size, the reference put in the program's place in the cell's control
precision (``limits/<cell>.json``'s ``control``: float8 products
under the bfloat16 the configurations state) is judged by the cell's
limits.  The runs that set the limits are ``python3 -m gpubench.control``;
this test holds one seed of each cell to them.

    python -m pytest -m cuda gpubench/tests/test_gpubench_control.py
"""
import pytest
import torch

from gpubench import check, control, spec
from gpubench.tests import tiny

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the control runs at the cell's own "
                    "size on the card")
    return "cuda"


@pytest.mark.parametrize("name", tiny.cells())
def test_control_is_not_correct(cuda_device, name):
    cell = spec.load_cell(name)
    row = control.readings(cell, 2 ** 31 + 4242, ["control"],
                           cuda_device)[0]
    numbers = {k: v for k, v in row.items()
               if k in cell.limits["numbers"]}
    numbers.update(batches=0.0, tokens=0.0)
    assert not check.passed(check.judge(numbers, cell.limits)), row
