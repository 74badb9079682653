"""Dataset analysis + experiment planning + bulk preprocessing.

The port's copy of `deformablelka_tpu/data/experiment_planning.py`, on
the port's `data/nifti.py`, `data/preprocessing.py` and
`data/dataset.compute_class_locations`:

    python -m deformablelka_tpu_torch.data.experiment_planning -t RAW -o PRE
        [--planner NAME] [--no_verify]

writes `PRE/plans_3D.pkl` and one `<case>.npz` + `<case>.pkl` per
training case, the folder that `cli/run_training.py` reads. Host work
only (numpy and scipy). Upstream's behaviour, as the JAX package
re-derived it:
  DatasetAnalyzer.py (intensity stats: foreground-voxel median/mean/sd and
  0.5/99.5 percentiles per modality, collected over the train set),
  experiment_planner_baseline_3DUNet.py:32-492 (`plan_experiment`: target
  spacing = per-axis median, except the lowest-resolution axis uses the
  10th percentile when anisotropy > 3; patch/batch heuristics; writes
  plans pkl), nnFormer_plan_and_preprocess.py:27-130 (CLI),
  sanity_checks.py (verify_dataset_integrity).

Dataset layout (decathlon-style): folder with imagesTr/, labelsTr/ and a
dataset.json {"modality": {"0": "CT"}, "labels": {...}}.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path

import numpy as np

from deformablelka_tpu_torch.data import nifti
from deformablelka_tpu_torch.data.preprocessing import (
    ANISO_THRESHOLD, GenericPreprocessor, crop_to_nonzero)
from deformablelka_tpu_torch.data.dataset import compute_class_locations


def verify_dataset_integrity(folder: str | Path) -> list:
    """Image/label pairing + geometry checks (sanity_checks.py)."""
    folder = Path(folder)
    problems = []
    images = sorted((folder / "imagesTr").glob("*.nii*"))
    for img_f in images:
        lab_f = folder / "labelsTr" / img_f.name.replace("_0000", "")
        if not lab_f.exists():
            problems.append(f"missing label for {img_f.name}")
            continue
        img = nifti.load(img_f)
        lab = nifti.load(lab_f)
        if img.data.shape[:3] != lab.data.shape[:3]:
            problems.append(f"shape mismatch {img_f.name}")
        if not np.allclose(img.affine, lab.affine, atol=1e-3):
            problems.append(f"affine mismatch {img_f.name}")
    return problems


class DatasetAnalyzer:
    def __init__(self, folder: str | Path):
        self.folder = Path(folder)
        with open(self.folder / "dataset.json") as f:
            self.meta = json.load(f)

    def analyze(self, max_fg_samples_per_case: int = 10000) -> dict:
        spacings, shapes = [], []
        fg_values = []
        all_classes = sorted(int(k) for k in self.meta["labels"].keys()
                             if int(k) > 0)
        images = sorted((self.folder / "imagesTr").glob("*.nii*"))
        rng = np.random.RandomState(1234)
        for img_f in images:
            lab_f = self.folder / "labelsTr" / img_f.name.replace("_0000",
                                                                  "")
            img = nifti.load(img_f)
            spacings.append(img.spacing)
            shapes.append(img.data.shape[:3])
            if lab_f.exists():
                lab = nifti.load(lab_f)
                fg = img.data[lab.data > 0]
                if len(fg) > max_fg_samples_per_case:
                    fg = fg[rng.choice(len(fg), max_fg_samples_per_case,
                                       False)]
                fg_values.append(np.asarray(fg, np.float32))
        fg_all = (np.concatenate(fg_values) if fg_values
                  else np.zeros(1, np.float32))
        intensity = {0: {
            "median": float(np.median(fg_all)),
            "mean": float(np.mean(fg_all)),
            "sd": float(np.std(fg_all)),
            "mn": float(np.min(fg_all)),
            "mx": float(np.max(fg_all)),
            "percentile_00_5": float(np.percentile(fg_all, 0.5)),
            "percentile_99_5": float(np.percentile(fg_all, 99.5)),
        }}
        return {
            "spacings": spacings,
            "shapes": shapes,
            "all_classes": all_classes,
            "modalities": self.meta.get("modality", {"0": "CT"}),
            "intensityproperties": intensity,
        }


class ExperimentPlanner:
    """Target-spacing / patch / batch heuristics (plan_experiment).

    The reference ships ~12 alternative planners
    (alternative_experiment_planning/: v21_{11,16,32}GB memory budgets,
    3convperstage, residual, CT2/nonCT/RGB normalization overrides,
    isotropic patch, poolBasedOnSpacing, targetSpacingForAnisoAxis /
    custom / noResampling). Those map here to constructor knobs; the
    named presets live in PLANNER_VARIANTS.
    """

    def __init__(self, fingerprint: dict, *,
                 target_spacing_mode: str = "aniso10pct",
                 custom_target_spacing=None,
                 normalization_override: str | None = None,
                 pool_based_on_spacing: bool = False,
                 conv_per_stage: int = 2,
                 residual: bool = False,
                 memory_budget_scale: float = 1.0):
        self.fp = fingerprint
        self.target_spacing_mode = target_spacing_mode
        self.custom_target_spacing = custom_target_spacing
        self.normalization_override = normalization_override
        self.pool_based_on_spacing = pool_based_on_spacing
        self.conv_per_stage = conv_per_stage
        self.residual = residual
        self.memory_budget_scale = memory_budget_scale

    def _target_spacing(self, spacings: np.ndarray) -> np.ndarray:
        mode = self.target_spacing_mode
        if mode == "custom":
            return np.asarray(self.custom_target_spacing, float)
        if mode == "none":  # noResampling: keep the median voxel grid
            return np.median(spacings, axis=0)
        if mode == "iso_mm":  # isotropic_in_mm: global median, all axes
            return np.full(3, float(np.median(spacings)))
        target = np.median(spacings, axis=0)
        if mode == "aniso10pct" and (
                target.max() / target.min() > ANISO_THRESHOLD):
            # targetSpacingForAnisoAxis: low-res axis → 10th percentile
            lowres_axis = int(np.argmax(target))
            target[lowres_axis] = np.percentile(
                spacings[:, lowres_axis], 10)
        return target

    def plan(self, max_patch_voxels: int = 64 * 128 * 128,
             default_batch: int = 2) -> dict:
        spacings = np.asarray(self.fp["spacings"], float)
        shapes = np.asarray(self.fp["shapes"], float)
        max_patch_voxels = int(max_patch_voxels * self.memory_budget_scale)
        target = self._target_spacing(spacings)
        new_shapes = shapes * spacings / target
        median_shape = np.median(new_shapes, axis=0)
        # patch: shrink the largest axes until under budget, then round to
        # multiples the network stem can divide (16 along axis0, 32 others)
        patch = np.minimum(median_shape, 999999).astype(float)
        while np.prod(patch) > max_patch_voxels:
            patch[np.argmax(patch)] *= 0.9
        mults = np.array([16, 32, 32])
        patch = np.maximum((np.round(patch / mults)).astype(int), 1) * mults
        patch = np.maximum(patch, mults)
        modalities = self.fp["modalities"]
        if self.normalization_override is not None:
            schemes = {int(k): self.normalization_override
                       for k in modalities}
        else:
            schemes = {int(k): ("CT" if str(v).upper() == "CT"
                                else "nonCT")
                       for k, v in modalities.items()}
        pools = [[2, 2, 2]] * 3
        if self.pool_based_on_spacing:
            # poolBasedOnSpacing: only pool axes whose spacing is within
            # 2× of the finest axis at that level (coarse axes pool late)
            pools = []
            sp = target.copy()
            for _ in range(3):
                step = [2 if sp[a] <= 2 * sp.min() else 1
                        for a in range(3)]
                pools.append(step)
                sp = sp * np.asarray(step, float)
        plans = {
            "num_classes": len(self.fp["all_classes"]),
            "all_classes": self.fp["all_classes"],
            "num_modalities": len(modalities),
            "normalization_schemes": schemes,
            "use_mask_for_norm": {int(k): schemes[int(k)] != "CT"
                                  for k in schemes},
            "dataset_properties": {
                "intensityproperties": self.fp["intensityproperties"]},
            "transpose_forward": [0, 1, 2],
            "transpose_backward": [0, 1, 2],
            "plans_per_stage": {0: {
                "patch_size": [int(v) for v in patch],
                "batch_size": default_batch,
                "current_spacing": [float(v) for v in target],
                "original_spacing": [float(v) for v in
                                     np.median(spacings, 0)],
                "pool_op_kernel_sizes": pools,
            }},
            "conv_per_stage": self.conv_per_stage,
            "residual": self.residual,
        }
        return plans


# Named presets mirroring alternative_experiment_planning/ (planner
# constructor kwargs; memory scales are the fp16 budget ratios of the
# reference's 11/16/32 GB planners vs the 8 GB baseline).
PLANNER_VARIANTS: dict = {
    "baseline": {},
    "v21_11GB": {"memory_budget_scale": 11 / 8},
    "v21_16GB": {"memory_budget_scale": 2.0},
    "v21_32GB": {"memory_budget_scale": 4.0},
    "3convperstage": {"conv_per_stage": 3},
    "residual": {"residual": True},
    "CT2": {"normalization_override": "CT2"},
    "nonCT": {"normalization_override": "nonCT"},
    "RGB_scaleto_0_1": {"normalization_override": "rgb01"},
    "noNorm": {"normalization_override": "noNorm"},
    "isotropic_in_mm": {"target_spacing_mode": "iso_mm"},
    "targetSpacingForAnisoAxis": {"target_spacing_mode": "aniso10pct"},
    "customTargetSpacing_2x2x2": {"target_spacing_mode": "custom",
                                  "custom_target_spacing": (2.0, 2.0, 2.0)},
    "noResampling": {"target_spacing_mode": "none"},
    "poolBasedOnSpacing": {"pool_based_on_spacing": True},
}


def make_planner(fingerprint: dict, variant: str = "baseline"
                 ) -> ExperimentPlanner:
    if variant not in PLANNER_VARIANTS:
        raise KeyError(f"unknown planner variant {variant!r}; "
                       f"choose from {sorted(PLANNER_VARIANTS)}")
    return ExperimentPlanner(fingerprint, **PLANNER_VARIANTS[variant])


def plan_and_preprocess(raw_folder: str | Path, out_folder: str | Path,
                        verify: bool = True,
                        planner: str = "baseline") -> dict:
    """Full pipeline: analyze → plan → preprocess every training case to
    npz (data+seg stacked, nnUNet layout) + properties pkl with
    class_locations."""
    raw_folder = Path(raw_folder)
    out_folder = Path(out_folder)
    out_folder.mkdir(parents=True, exist_ok=True)
    if verify:
        problems = verify_dataset_integrity(raw_folder)
        if problems:
            raise RuntimeError(f"dataset integrity: {problems}")
    analyzer = DatasetAnalyzer(raw_folder)
    fp = analyzer.analyze()
    plans = make_planner(fp, planner).plan()
    with open(out_folder / "plans_3D.pkl", "wb") as f:
        pickle.dump(plans, f)

    st = plans["plans_per_stage"][0]
    schemes = plans["normalization_schemes"]
    pre = GenericPreprocessor(
        normalization_schemes=[schemes[k] for k in sorted(schemes)],
        use_nonzero_mask=[plans["use_mask_for_norm"][k]
                          for k in sorted(schemes)],
        target_spacing=st["current_spacing"],
        intensity_properties=fp["intensityproperties"])

    for img_f in sorted((raw_folder / "imagesTr").glob("*.nii*")):
        lab_f = raw_folder / "labelsTr" / img_f.name.replace("_0000", "")
        img = nifti.load(img_f)
        lab = nifti.load(lab_f)
        data = np.asarray(img.data, np.float32)[None]
        seg = np.asarray(lab.data, np.float32)[None]
        d, s, props = pre.preprocess(data, img.spacing, seg)
        stacked = np.concatenate([d, s.astype(np.float32)], 0)
        case = img_f.name.split(".nii")[0].replace("_0000", "")
        np.savez_compressed(out_folder / f"{case}.npz",
                            data=stacked.astype(np.float32))
        props["class_locations"] = compute_class_locations(
            s[0], plans["all_classes"])
        with open(out_folder / f"{case}.pkl", "wb") as f:
            pickle.dump(props, f)
    return plans


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("-t", "--task", required=True,
                    help="raw task folder (imagesTr/labelsTr/dataset.json)")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--no_verify", action="store_true")
    ap.add_argument("-pl", "--planner", default="baseline",
                    choices=sorted(PLANNER_VARIANTS))
    args = ap.parse_args(argv)
    plan_and_preprocess(args.task, args.output, verify=not args.no_verify,
                        planner=args.planner)


if __name__ == "__main__":
    main()
