"""Pure checks of ``chip_smoke.py`` that decide a phase from what the run
recorded: they run here on the CPU, without a card."""
import importlib.util
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PARK, BACK = (2, 1), (1, 2)


@pytest.mark.parametrize("acts, back_at, states, holds", [
    # the reactivated replica still active when the flash replay ends
    ([PARK, BACK], [230], ["healthy", "healthy"], True),
    # parked again before the replay ended: the park needs two
    # dispatchable replicas, so the warmup had passed
    ([PARK, BACK, PARK], [230], ["standby", "healthy"], True),
    ([PARK, BACK, PARK, BACK], [230], ["healthy", "healthy"], True),
    # no reactivation seen during the flash
    ([PARK, BACK], [], ["healthy", "healthy"], False),
    ([PARK], [], ["healthy", "standby"], False),
    ([], [], ["healthy", "healthy"], False),
    # the reactivated replica never through its warmup
    ([PARK, BACK], [230], ["healthy", "warming"], False),
    # states that disagree with the last action
    ([PARK, BACK, PARK], [230], ["healthy", "healthy"], False),
    ([PARK, BACK, BACK], [230], ["healthy", "healthy"], False),
])
def test_replica_law_evidence(smoke, acts, back_at, states, holds):
    got = smoke.replica_law_evidence(acts, back_at, states)
    assert (got is None) == holds, got
