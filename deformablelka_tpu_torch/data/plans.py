"""nnUNet "plans": upstream's pickled experiment configuration.

The port's copy of `deformablelka_tpu/data/plans.py` (pickle and
dataclasses only). Upstream's behaviour, as the JAX package re-derived it:
  experiment_planner_baseline_3DUNet.py:247-357 writes `*_plans_3D.pkl`
  with dataset-derived spacing/patch/batch/pool settings;
  run/default_configuration.py:56-69 loads it and hard-patches Synapse
  values (batch 2, patch [64,128,128]); trainers read
  plans["plans_per_stage"][stage] (Trainer_synapse.py:330-397).

`load_plans` reads the pickle (tolerating missing nnUNet classes via a
permissive unpickler) and `PlansConfig` exposes the fields the trainers
and predictors need.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional


class _PermissiveUnpickler(pickle.Unpickler):
    """The reference pickles numpy arrays + plain dicts, but sometimes
    references nnUNet classes; substitute a stub for unknown globals."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return type(name, (), {"__module__": module})


def load_plans(path: str | Path) -> dict:
    with open(path, "rb") as f:
        return _PermissiveUnpickler(f).load()


@dataclass
class PlansConfig:
    num_classes: int
    num_modalities: int
    patch_size: List[int]
    batch_size: int
    current_spacing: List[float]
    original_spacing: List[float]
    normalization_schemes: Dict[int, str] = field(default_factory=dict)
    use_mask_for_norm: Dict[int, bool] = field(default_factory=dict)
    intensity_properties: Optional[dict] = None
    pool_op_kernel_sizes: Optional[list] = None
    transpose_forward: List[int] = field(default_factory=lambda: [0, 1, 2])
    transpose_backward: List[int] = field(default_factory=lambda: [0, 1, 2])
    all_classes: Optional[list] = None

    @classmethod
    def from_plans(cls, plans: dict, stage: Optional[int] = None,
                   synapse_patch_override: bool = False) -> "PlansConfig":
        stages = plans["plans_per_stage"]
        if stage is None:
            stage = max(stages.keys()) if isinstance(stages, dict) \
                else len(stages) - 1
        st = stages[stage]
        patch = [int(v) for v in st["patch_size"]]
        batch = int(st["batch_size"])
        if synapse_patch_override:
            # run/default_configuration.py:62-69 hard-patch
            patch = [64, 128, 128]
            batch = 2
        props = plans.get("dataset_properties", {})
        intensity = props.get("intensityproperties")
        return cls(
            num_classes=int(plans["num_classes"]) + 1,  # +bg, nnUNet conv.
            num_modalities=int(plans["num_modalities"]),
            patch_size=patch,
            batch_size=batch,
            current_spacing=[float(v) for v in st["current_spacing"]],
            original_spacing=[float(v) for v in st["original_spacing"]],
            normalization_schemes=plans.get("normalization_schemes", {}),
            use_mask_for_norm=plans.get("use_mask_for_norm", {}),
            intensity_properties=intensity,
            pool_op_kernel_sizes=st.get("pool_op_kernel_sizes"),
            transpose_forward=list(plans.get("transpose_forward",
                                             [0, 1, 2])),
            transpose_backward=list(plans.get("transpose_backward",
                                              [0, 1, 2])),
            all_classes=plans.get("all_classes"),
        )
