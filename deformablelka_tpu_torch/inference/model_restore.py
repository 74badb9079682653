"""Model restore: rebuild a model and its weights from a saved run directory.

Port of `deformablelka_tpu/inference/model_restore.py`. Upstream's
`restore_model(pkl_file, checkpoint)` (model_restore.py:43-130)
re-instantiates the trainer class from its pickled init args, then loads
the fold checkpoint; `load_model_and_checkpoint_files` (:118) collects
every `fold_*` checkpoint for multi-fold ensembling. As in the JAX
package, a small `model_config.json` beside the checkpoints —
{"factory": "<name in deformablelka_tpu_torch.models>", "kwargs": {...},
"example_shape": [...]} — takes the place of the pickle, so restore is
declarative. The checkpoints are the port's (`training/checkpoint.py`,
`torch.save`), with the model's `state_dict()` under "model". A run
directory of the JAX package (Orbax) is not read here: that needs JAX;
carry its variables with `convert/jax_params.state_dict_from_jax` and
save them through the port's `CheckpointManager`.

A torch module holds its own weights, so where the JAX package returns
one model and the variables of each fold, `load_model_and_checkpoint_
files` here returns one model per fold, each with its weights, in eval
mode on `device` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Sequence

import torch

from deformablelka_tpu_torch.training.checkpoint import CheckpointManager

MODEL_CONFIG = "model_config.json"


def save_model_config(run_dir: str | Path, factory: str, kwargs: dict,
                      example_shape: Sequence[int]):
    """Write the restore manifest (the analog of nnUNet's init-args pkl)."""
    cfg = {"factory": factory, "kwargs": kwargs,
           "example_shape": list(example_shape)}
    Path(run_dir).mkdir(parents=True, exist_ok=True)
    (Path(run_dir) / MODEL_CONFIG).write_text(json.dumps(cfg, indent=2))
    return cfg


def build_model_from_config(cfg: dict, device="cuda") -> torch.nn.Module:
    import deformablelka_tpu_torch.models as M
    factory = getattr(M, cfg["factory"])
    return factory(**cfg.get("kwargs", {}), device=device)


def restore_model(run_dir: str | Path,
                  checkpoint: str = "model_final_checkpoint", device="cuda"):
    """(model with the checkpoint's weights, in eval mode on `device`, its
    state_dict). run_dir holds `model_config.json` and the named
    checkpoint."""
    run_dir = Path(run_dir)
    cfg = json.loads((run_dir / MODEL_CONFIG).read_text())
    model = build_model_from_config(cfg, device)
    state, _ = CheckpointManager(run_dir).load(checkpoint)
    model.load_state_dict(state["model"], strict=True)
    return model.eval(), state["model"]


def load_model_and_checkpoint_files(model_base: str | Path,
                                    folds: Sequence[int] = (0,),
                                    checkpoint: str = "model_final_checkpoint",
                                    device="cuda") -> list:
    """One model per fold (fold dirs `fold_<i>/` under model_base), each
    with its fold's weights, in eval mode on `device`."""
    model_base = Path(model_base)
    return [restore_model(model_base / f"fold_{f}", checkpoint, device)[0]
            for f in folds]
