"""On the card only (skipped elsewhere, decided inside the `card` fixture):
each cell's whole run at the tiny size, traced, and the controls the limits
were set from, read at sizes a test run holds: the bf16 cells' fp8 control
at full width and depth on two images, the train cell's TF32 control at the
tiny size. Each control must fail one of its cell's numbers."""

import pytest
from perfbench import harness
from perfbench.run import load_cell
from perfbench.tests.tiny import run_tiny
from perfbench.tools import control

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_traced_on_card(card, cell):
    line, _ = run_tiny(cell, seconds=2.0, trace=True, device=str(card))
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0 and line["metrics"]


def failed_numbers(row: dict, limits: dict) -> list:
    return [k for k, lim in limits.items() if k in row and row[k] > lim]


@pytest.mark.card
def test_fp8_control_fails_eval_numbers(card, monkeypatch):
    bench, cell, config, traffic = load_cell("eval-sweep-b32", unlisted=True)
    small = dict(traffic, pool=2, calib_images=2, check_images=2)
    monkeypatch.setattr(control, "load_cell", lambda name, **kw: (bench, cell, config, small))
    rows = control.main(["--workload", "eval-sweep-b32", "--seeds", "41"])
    assert failed_numbers(rows[0]["control"], config["limits"]), rows[0]


@pytest.mark.card
def test_tf32_control_fails_train_numbers(card):
    from perfbench.tests.tiny import tiny

    rows = control.main(["--workload", "train-wider-b12", "--seeds", "41"], tiny_device=card)
    limits = tiny("train-wider-b12")[2]["limits"]
    assert failed_numbers(rows[0]["control"], limits), rows[0]
    assert not failed_numbers(rows[0]["program"], limits), rows[0]
