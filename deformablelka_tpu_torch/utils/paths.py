"""Dataset/results locations from environment variables.

The port's copy of `deformablelka_tpu/utils/paths.py`. Upstream's
3D/d_lka_former/paths.py:29-31 — env vars `d_lka_former_raw_data_base`,
`d_lka_former_preprocessed`, `RESULTS_FOLDER` locate raw data,
preprocessed data and results.
"""

from __future__ import annotations

import os
from pathlib import Path


def _env(name: str, default: str | None = None) -> Path | None:
    v = os.environ.get(name, default)
    return Path(v) if v else None


def raw_data_base() -> Path | None:
    return _env("d_lka_former_raw_data_base")


def preprocessed_folder() -> Path | None:
    return _env("d_lka_former_preprocessed")


def results_folder() -> Path:
    return _env("RESULTS_FOLDER", "./results")


def raw_cropped() -> Path | None:
    base = raw_data_base()
    return base / "d_lka_former_cropped_data" if base else None


def raw_data() -> Path | None:
    base = raw_data_base()
    return base / "d_lka_former_raw_data" if base else None
