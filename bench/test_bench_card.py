"""On the card, at each cell's own size: the program's sound readings come
out correct and the control's (the reference in fp8) not, each judged as a
run's numbers are (``Run.compare``, ``Run.correct``).  Skips without a
card; run there as

    PYTHONPATH=src python -m pytest -q -m cuda bench/test_bench_card.py
"""
import pytest

from bench import core
from bench.control import prefill_readings, train_readings

CELLS = [w["name"] for w in core.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes_at_full_size(cell, card):
    kind = core.traffic_file(core.cell(core.benchmark(), cell)["traffic"])[
        "kind"]
    read = {"train": train_readings, "prefill": prefill_readings}[kind]
    got = read(cell, 2 ** 31 + 77, True)
    assert got["sound_correct"] is True, got
    assert got["control_correct"] is False, got
