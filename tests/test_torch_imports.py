"""The port imports torch, never JAX nor anything of the JAX package."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in (ROOT / "deformablelka_tpu_torch").rglob("*.py"))

CHECK = """
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "deformablelka_tpu"
             or m.startswith("deformablelka_tpu."))
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_modules_are_listed():
    for name in ("ops.kernels", "training.losses", "training.train_step",
                 "train_path", "main_path", "profiling", "ops.deform2d",
                 "nn.lka2d", "models.maxvit", "models.maxvit_dlka",
                 "evaluation.metrics", "inference.predictor2d", "main_path2d",
                 "ops.dwconv3d", "nn.blocks3d", "nn.transformer3d",
                 "models.dlka_former", "convert.jax_params", "models",
                 "data.nifti", "data.preprocessing", "data.pancreas",
                 "inference.sliding_window", "training.checkpoint",
                 "inference.model_restore", "inference.predictor3d",
                 "inference.pancreas", "cli._pancreas_models",
                 "cli.predict_simple", "cli.test_pancreas", "case_path",
                 "native", "data.dataset", "data.augment", "training.trainer3d",
                 "training.cascade", "training.trainer_pancreas",
                 "evaluation.evaluator", "evaluation.postprocessing",
                 "cli.run_training", "cli.train_pancreas", "trainer_path",
                 "data.synapse2d", "data.skin", "evaluation.skin_eval",
                 "training.trainer2d", "convert.backbone", "cli.train_synapse2d",
                 "cli.test_synapse2d", "cli.train_skin", "trainer2d_path",
                 "nn.segformer", "models.daeformer", "models.dae_lka", "models.biformer",
                 "models.swinunet", "models.mvit", "models.stvit", "models.dat_lka",
                 "models.transunet", "models.hiformer", "models.registry"):
        assert f"deformablelka_tpu_torch.{name}" in MODULES
    assert len(MODULES) >= 80


@pytest.mark.parametrize("names", [MODULES, ["chip_smoke"]],
                         ids=["package", "chip_smoke"])
def test_import_loads_neither_jax_nor_the_jax_package(names):
    r = subprocess.run([sys.executable, "-c", CHECK, *names], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
