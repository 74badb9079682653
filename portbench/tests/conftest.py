"""Small sizes at which the cells run on the CPU: full widths, a short
patch. The training size keeps every stage at 2³ voxels or more, where
GroupNorm's groups hold enough values for two float32 runs to agree.

`WITH_2D` is `BENCHMARK.json` with the 2D cells (`cells_2d.json`), which
the benchmark does not run yet (PERF.md §7): their files are tested here
so that a later PR can add them as entries."""

import json
from pathlib import Path

import pytest

from portbench import harness

WITH_2D = harness.benchmark()
for _key, _entries in json.loads((Path(__file__).parent / "cells_2d.json").read_text()).items():
    WITH_2D[_key] = WITH_2D[_key] + _entries

TRAIN_SMALL = {"config": {"img_size": [32, 64, 64]}, "traffic": {"checked_steps": 2}}
INFER_SMALL = {"config": {"img_size": [16, 32, 32]}, "traffic": {"volume": [16, 32, 48]}}
TRAIN2D_SMALL = {"config": {"img_size": 64}, "traffic": {"batch": 4, "checked_steps": 2}}
INFER2D_SMALL = {"config": {"img_size": 64},
                 "traffic": {"slices": [5, 30, 7], "warmup_units": 1, "slice_batch": 8}}


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
