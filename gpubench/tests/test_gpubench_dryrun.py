"""Every cell's plumbing end to end on the CPU, at test widths, through
the port's plain paths: the corpus, the port's packed loader and resident
pipeline, the captured group's CPU twin, the window, the readers and the
comparison, ending in the result's last line."""
import json

import pytest
import torch

from gpubench import harness, run
from gpubench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", tiny.cells())
def test_dry_run_of_each_cell(name):
    cell = tiny.cell(name)
    r = harness.run(cell, 2 ** 31 + 77, 0.5, trace=False, device="cpu")
    line = json.loads(json.dumps(r))
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 4
    # the allocator's peak is the card's: not measured on the CPU
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end} \
        - {"peak_mem_gib"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert set(line["checks"]) == set(cell.limits["numbers"])
    assert line["checks"]["batches"]["value"] == 0
    assert line["checks"]["tokens"]["value"] == 0


def test_traced_dry_run_reports_what_the_cpu_can_read():
    cell = tiny.cell(tiny.cells()[0])
    r = harness.run(cell, 2 ** 31 + 78, 0.5, trace=True, device="cpu")
    assert r["correct"] is True
    # counts and host spans read on the CPU; device metrics stay unread
    assert set(r["metrics"]) == {"pack_fill_pct", "host_ms_per_step"}
    assert 0 < r["metrics"]["pack_fill_pct"]["value"] <= 100
    assert "breakdown" not in r


def test_run_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", tiny.cells()[0], "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out == ""
