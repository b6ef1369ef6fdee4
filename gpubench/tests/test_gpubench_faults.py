"""A broken timed path comes out not correct: each cell's run on the CPU
at test widths, with the program broken underneath, judged by the cell's
own limits: a step that leaves the state unchanged, half of each batch
left out, a later epoch fed in another order, and in a mixture of
experts each token sent to experts its gate did not choose."""
import pytest
import torch

from gpubench import harness
from gpubench.tests import tiny


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fault", ["frozen", "half", "order"])
@pytest.mark.parametrize("name", tiny.cells())
def test_broken_step_is_not_correct(name, fault):
    # the order of a later epoch shows once the window has reached one
    seconds = 3.0 if fault == "order" else 0.3
    r = harness.run(tiny.cell(name), 2 ** 31 + 91, seconds, trace=False,
                    device="cpu", fault=fault)
    assert r["correct"] is False
    assert [k for k, v in r["checks"].items()
            if v["value"] > v["limit"]]


@pytest.mark.parametrize("name", [n for n in tiny.cells()
                                  if tiny.cell(n).config.get("moe_experts")])
def test_wrong_routing_is_not_correct(name):
    r = harness.run(tiny.cell(name), 2 ** 31 + 92, 0.3, trace=False,
                    device="cpu", fault="route")
    assert r["correct"] is False
    # the gate's logits are right: the experts' outputs tell
    assert r["checks"]["moment_diff"]["value"] > \
        r["checks"]["moment_diff"]["limit"]
