"""The port's 2D path (Slice C), and a device-time breakdown of it.

The 2D path is Synapse slice inference through `Predictor2D`, as the JAX
package's `cli/test_synapse2d.py` runs it per case: each of a case's
slices is zoomed to 224² on the host (order 3), the slices go through the
model 24 at a time (the last chunk zero-padded), the argmax runs on the
device, and the uint8 labels are zoomed back (order 0). Two
configurations, both at full width and depth (MaxViT-small rmlp encoder,
dims 96/192/384/768, depths 2/2/5/2, and the LKA decoder):

- "dlka": `MaxViTDeformableLKAFormer(num_classes=9)`, the flagship; its
  12 deformable convs per forward run `kernels.deform_dw_conv2d`;
- "lka_baseline": `maxvit_lka_former(num_classes=9)`, the paper's LKA
  Baseline; its 6 LKA chains per forward run `kernels.dw_chain2d`;
- the 2D ablation zoo, by registry name (`ZOO`, `models/registry.py`):
  upstream's widths at 224². The LKA Baseline's decoder runs the chain in
  DAE-LKA (4 per forward, at 28²×320 and 56²×128) and in MViT-LKA,
  DAT-LKA and STViT-LKA (6, at the Baseline's three sites); the other
  seven run no hand kernel.

Weights are random from a seed; `build` then sets every layer scale to 1
and draws the offset nets' weights from the seed, so that attention and
the gates shape the logits and the offsets vary per pixel and reach past
±1 (at init the encoder's layer scales are 1e-6 and the decoder's 1e-2).

    python -m deformablelka_tpu_torch.main_path2d [--dtype bf16]

runs each configuration's case once to warm up, then once under
`torch.profiler` on the card, and prints the wall time, the device's busy
share and the device time by kernel class and by kernel; then the host
clock of the case's two zooms alone, and the same profile of 10 batch-1
224² forwards of the flagship (the latency protocol). With `--dtype bf16`
those forwards take a bfloat16 input, as `bench.py:119` does: the stem,
the first MBConv and the first block's attention run in bfloat16, the
rest (and kernel 4) in float32. float32 is the default.
"""

from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

from deformablelka_tpu_torch.inference.predictor2d import Predictor2D
from deformablelka_tpu_torch.models.maxvit import LayerScale
from deformablelka_tpu_torch.models.maxvit_dlka import (maxvit_dlka_former,
                                                        maxvit_lka_former)
from deformablelka_tpu_torch.models.registry import MODELS_2D, build_model_2d
from deformablelka_tpu_torch.nn.lka2d import DeformConv, _LKABlockBase
from deformablelka_tpu_torch.profiling import device_profile, print_profile

PATCH = (224, 224)
CASE = (40, 512, 512)  # slices, height, width: one chunk of 24, one of 16
NUM_CLASSES = 9
SLICE_BATCH = 24
# the flagship's two configurations (any image size), then the zoo: every
# registry name but the flagship's two (224² only)
FLAGSHIP = ("dlka", "lka_baseline")
ZOO = tuple(n for n in MODELS_2D if not n.startswith("maxvit"))
CONFIGS = {"dlka": maxvit_dlka_former, "lka_baseline": maxvit_lka_former,
           **{name: functools.partial(build_model_2d, name) for name in ZOO}}
# dw_chain2d launches per forward of the zoo's models with the LKA decoder:
# `layer_lka_1` twice in each decoder layer but the first
LKA_DECODER_CHAINS = {"dae_lka": 4, "mvit_lka": 6, "dat_lka": 6, "stvit_lka": 6}
# kernel launches in one forward of each configuration (none: no entry)
LAUNCHES_PER_FORWARD = {
    "dlka": {"deform_dw_conv2d": 12},
    "lka_baseline": {"dw_chain2d": 6},
    **{name: {"dw_chain2d": LKA_DECODER_CHAINS[name]} if name in LKA_DECODER_CHAINS else {}
       for name in ZOO},
}
# offset-net weights are N(0, (s / sqrt(fan_in))²) with s by kernel size:
# the 7×7's input, the 5×5 deform conv's output, is ~4× smaller
OFFSET_SCALE = {5: 3.0, 7: 10.0}


def drive_gates_2d(model, seed: int) -> None:
    """Every layer scale 1; offset-net weights drawn from `seed`
    (`OFFSET_SCALE`)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DeformConv):
                w = m.offset_net.weight
                fan_in = w[0].numel()
                s = OFFSET_SCALE[w.shape[-1]]
                w.copy_(torch.randn(w.shape, generator=g) * s / fan_in ** 0.5)
            if isinstance(m, LayerScale):
                m.gamma.fill_(1.0)
            if isinstance(m, _LKABlockBase):
                m.layer_scale_1.fill_(1.0)
                m.layer_scale_2.fill_(1.0)


def build(config: str, seed: int = 0, device="cuda", img_size: int = PATCH[0]):
    """The model (gates driven) and its `Predictor2D`."""
    model = CONFIGS[config](NUM_CLASSES, img_size=img_size, seed=seed,
                            device=device)
    drive_gates_2d(model, seed + 11)
    predictor = Predictor2D(model, (img_size, img_size), NUM_CLASSES,
                            SLICE_BATCH, device=device)
    return model, predictor


def case(seed: int = 0, shape=CASE) -> np.ndarray:
    """A seeded synthetic case, (slices, H, W) float32."""
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def profile_2d_path(config: str, seed: int = 0) -> dict:
    _, predictor = build(config, seed)
    image = case(seed)
    predictor.predict_volume(image)  # warm-up
    torch.cuda.synchronize()
    return device_profile(lambda: predictor.predict_volume(image))


def zoom_seconds(seed: int = 0) -> tuple:
    """Host seconds of the case's zoom to the patch and of its labels'
    zoom back."""
    predictor = Predictor2D(None, PATCH, NUM_CLASSES, SLICE_BATCH, device="cpu")
    image = case(seed)
    t0 = time.perf_counter()
    slices = predictor.to_patch(image)
    t1 = time.perf_counter()
    predictor.from_patch(np.zeros(slices.shape[:3], np.uint8), image.shape[1:])
    return t1 - t0, time.perf_counter() - t1


def profile_latency(seed: int = 0, reps: int = 10, dtype=torch.float32) -> dict:
    model, _ = build("dlka", seed)
    x = torch.zeros(1, *PATCH, 1, device="cuda", dtype=dtype)

    def run():
        with torch.no_grad():
            for _ in range(reps):
                model(x)

    run()  # warm-up
    torch.cuda.synchronize()
    return device_profile(run)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                    help="the latency forwards' input type; bf16 is bench.py's")
    args = ap.parse_args()
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    for config in FLAGSHIP:
        print_profile(f"2D path {config}, case {CASE} at {PATCH}, "
                      f"batch {SLICE_BATCH}", profile_2d_path(config))
    zoom_in, zoom_out = zoom_seconds()
    print(f"host zooms of the case {CASE}: to {PATCH} (order 3) {zoom_in:.3f} s, "
          f"labels back (order 0) {zoom_out:.3f} s")
    print_profile(f"flagship, 10 forwards at batch 1 {PATCH}, input {args.dtype}",
                  profile_latency(dtype=dtype))


if __name__ == "__main__":
    main()
