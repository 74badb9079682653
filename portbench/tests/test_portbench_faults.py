"""A run with its timed path broken underneath comes out not correct,
once for each fault its cell can have, beside a sound run at the same
size that comes out correct."""

import pytest

from portbench import faults, run
from portbench.tests.conftest import INFER2D_SMALL, INFER_SMALL, TRAIN2D_SMALL, TRAIN_SMALL, WITH_2D

CELLS = {"synapse3d.train": (TRAIN_SMALL, ("unchanged", "half_batch")),
         "synapse3d.infer": (INFER_SMALL, ("half_batch", "altered")),
         "synapse2d.train": (TRAIN2D_SMALL, ("unchanged", "half_batch")),
         "synapse2d.infer": (INFER2D_SMALL, ("half_batch", "altered"))}


def _run(cell, fault=None):
    over, _ = CELLS[cell]
    argv = ["--workload", cell, "--seed", "2147483659", "--seconds", "0.1"]
    if fault is None:
        return run.main(argv, device="cpu", overrides=over, bench=WITH_2D)
    with faults.FAULTS[fault]():
        return run.main(argv, device="cpu", overrides=over, bench=WITH_2D)


@pytest.mark.parametrize("cell,fault", [(c, f) for c, (_, fs) in CELLS.items()
                                        for f in (None,) + fs])
def test_fault_is_caught(cell, fault):
    r = _run(cell, fault)
    assert r["correct"] is (fault is None), r["checks"]
