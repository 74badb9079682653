"""The control: the plain reference computed with TF32 on, put in the
program's place, fails a cell's limits, while the program passes them.
At a size a test run holds; on the card only (TF32 exists there)."""

import pytest

from portbench import calibrate, harness
from portbench.tests.conftest import WITH_2D

SIZES = {"synapse3d.train": {"config": {"img_size": [32, 64, 64]}},
         "synapse3d.infer": {"config": {"img_size": [32, 64, 64]},
                             "traffic": {"volume": [48, 96, 96], "pool": 2}},
         "synapse2d.train": {"traffic": {"batch": 8}},
         "synapse2d.infer": {"traffic": {"slices": [40, 30]}}}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SIZES))
def test_control_fails_the_limits(card, cell):
    limits = harness.load_json(harness.ROOT / "limits" / f"{cell}.json")
    rows, _ = calibrate.reading(cell, 17, 1, control=True, device=card, overrides=SIZES[cell],
                                bench=WITH_2D)
    numbers = dict(rows)
    assert all(v <= limits[k] for k, v in numbers["program"].items()), numbers
    assert any(v > limits[k] for k, v in numbers["control"].items()), numbers
