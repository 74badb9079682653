"""The port's main path, and a device-time breakdown of it.

The main path is the JAX package's bench protocol (`bench.py:132-223`):
`dlka_former_synapse(num_classes=14, do_ds=False)` behind
`SlidingWindowInference` on a 96×192×160 volume, patch 64×128×128, step
0.5 (8 tiles), Gaussian blending, the 8 mirror flips in one batch, argmax
on the device. Weights are random from a seed; `build` then sets every
gamma to 1 and draws the offset convs' weights from the seed, so that the
D-LKA gates shape the logits and the offsets vary per voxel and reach
past ±1 (at init the offset weights are zero and gamma is 1e-6).

`build(trans_block=...)` puts another block of the registry in every
stage; the size-aware one, "TransformerBlock_Deform_LKA_Spatial_sequential",
is the path that runs the dilated depthwise kernel (`kernels.dwconv3d`:
9 launches per forward, `LAUNCHES_PER_FORWARD`).

`build(input_dtype=torch.bfloat16)` (`--dtype bf16`) is `bench.py`'s own
protocol (`bench.py:150-151,199-201`): the volume is uploaded in bfloat16
and the model takes bfloat16 tiles; its stem and `encoder1` run in
bfloat16 and every D-LKA block promotes to float32 at its position
embedding, so the kernels see float32 as before. float32 is the default.

    python -m deformablelka_tpu_torch.main_path [--trans_block NAME] [--dtype bf16]

runs the main path (with the published block, or NAME) once to warm up,
then once under `torch.profiler` on the card, and prints the wall time,
the device's busy share (the union of its kernel intervals over the wall
time) and the device time by kernel class and by kernel.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from deformablelka_tpu_torch.inference.sliding_window import SlidingWindowInference
from deformablelka_tpu_torch.models.dlka_former import dlka_former_synapse
from deformablelka_tpu_torch.nn.blocks3d import DeformConvPack3d
from deformablelka_tpu_torch.nn.transformer3d import DEFAULT_BLOCK, TRANSFORMER_BLOCKS
from deformablelka_tpu_torch.profiling import device_profile, print_profile

PATCH = (64, 128, 128)
VOLUME = (96, 192, 160)
NUM_CLASSES = 14
TILES = 8
DTYPES = {"f32": None, "bf16": torch.bfloat16}  # --dtype: the model input's type
BLOCKS = 21  # D-LKA blocks in one forward: one launch of each kernel apiece
SIZE_AWARE = "TransformerBlock_Deform_LKA_Spatial_sequential"
# kernel launches per batch-8 forward of the size-aware configuration: its
# gates take the fused chain at dims 32/64 (encoder stages 0-1, decoder4,
# decoder3) and the dilated depthwise kernel at 128/256 (stages 2-3,
# decoder5)
LAUNCHES_PER_FORWARD = {SIZE_AWARE: {"deform_conv3d": BLOCKS, "dw_chain3d": 12, "dwconv3d": 9}}


def drive_gates(model, seed: int) -> None:
    """gamma 1; offset-conv weights N(0, (10/sqrt(27·C))²) from `seed`."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, DeformConvPack3d):
                C = m.weight.shape[1]
                w = torch.randn(m.conv_offset.weight.shape, generator=g)
                m.conv_offset.weight.copy_(w * 10.0 / (27 * C) ** 0.5)
            if hasattr(m, "gamma"):
                m.gamma.fill_(1.0)


def build(seed: int = 0, device="cuda", trans_block: str = DEFAULT_BLOCK,
          input_dtype=None):
    """The model (gates driven) and the sliding-window engine, which feeds
    the model `input_dtype` (float32 unless given)."""
    model = dlka_former_synapse(NUM_CLASSES, do_ds=False, seed=seed,
                                trans_block=trans_block, device=device)
    drive_gates(model, seed + 11)
    sw = SlidingWindowInference(model, patch_size=PATCH,
                                num_classes=NUM_CLASSES, step_size=0.5,
                                do_mirroring=True, tta_batch=8, device=device,
                                input_dtype=input_dtype)
    return model, sw


def volume(seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).randn(*VOLUME, 1).astype(np.float32)


def profile_main_path(seed: int = 0, trans_block: str = DEFAULT_BLOCK,
                      input_dtype=None) -> dict:
    _, sw = build(seed, trans_block=trans_block, input_dtype=input_dtype)
    vol = volume(seed)
    sw.predict_segmentation(vol)  # warm-up
    torch.cuda.synchronize()
    return device_profile(lambda: sw.predict_segmentation(vol))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trans_block", default=DEFAULT_BLOCK,
                    choices=list(TRANSFORMER_BLOCKS))
    ap.add_argument("--dtype", default="f32", choices=list(DTYPES),
                    help="the model input's type; bf16 is bench.py's protocol")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print_profile(f"main path {VOLUME}, {TILES} tiles x 8 flips, {args.trans_block}, "
                  f"input {args.dtype}",
                  profile_main_path(trans_block=args.trans_block,
                                    input_dtype=DTYPES[args.dtype]))


if __name__ == "__main__":
    main()
