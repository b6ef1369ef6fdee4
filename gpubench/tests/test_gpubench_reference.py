"""The reference against the port at test widths on the CPU: in float32
the port's captured group (its CPU twin) and the reference agree to
rounding on every number the check compares, the batches exactly."""
import pytest
import torch

from gpubench import harness
from gpubench.tests import tiny

#: float32 on both sides: the sums run in other orders, nothing else
FP32_TOL = 1e-4


@pytest.mark.parametrize("name", tiny.cells())
def test_reference_agrees_with_the_port_in_float32(name):
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    try:
        cell = tiny.cell(name)
        cell.config["port"]["dtype"] = "float32"
        r = harness.run(cell, 2 ** 31 + 3, 0.2, False, device="cpu")
    finally:
        torch.set_num_threads(n)
    got = r["readings"]
    assert got.pop("batches") == 0 and got.pop("tokens") == 0
    assert max(got.values()) < FP32_TOL, got
