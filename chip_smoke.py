"""Drive the PyTorch port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Needs one CUDA card (the kernels are built for sm_90a: H100/H200) and
nvcc. Imports nothing of JAX. Phases, one line each (or a few):

1. device and build: the card's name and power limit (nvidia-smi), then
   the build of csrc/*.cu and its time;
2. each 3D forward kernel against its plain PyTorch version, at the four stage
   shapes of the main path with batch 8, TF32 off: max|err| against the
   stated tolerance, and the times of the kernel (CUDA events, and device
   time under torch.profiler), the plain version and, for the chain, two
   depthwise `F.conv3d` (timed in turns with the kernel), beside the
   card's bound for the work. The deform conv is checked and timed at
   offsets uniform in ±2.5 (some corners outside the volume) and in ±0.05
   (a trained checkpoint's size); beside it, cuDNN's dense 3³ `F.conv3d`
   at the same shape (the Δ = 0 channel mix alone, a yardstick: no
   PyTorch call computes the deform conv) and a tensor-core bound (three
   TF32 products per multiply at 495 TFLOP/s, the blend at 67 TFLOP/s
   f32, and the bytes) beside the f32 one;
3. the whole model, small input: the CUDA model against the same model
   on the CPU (the path the CPU tests hold against the JAX package);
4. the main path: `dlka_former_synapse(num_classes=14, do_ds=False)` at
   full width from seed 0, with gamma set to 1 and the offset convs'
   weights drawn from a seed, so the gates shape the logits and the
   offsets vary per voxel and reach past ±1; `predict_segmentation` of a
   seeded 96×192×160 volume with patch 64×128×128, step 0.5, Gaussian
   blending, 8-flip mirror TTA in one batch and argmax on the device.
   It prints the wall time, the peak device memory, each kernel's launch
   count (must be 21 blocks × 8 tiles = 168 of each 3D forward kernel and
   none of the others) and the share of voxels whose label agrees with
   the same run through the plain versions;
5. the deform backward kernel against its plain version (autograd of the
   plain forward) at the four stage shapes with batch 2, offsets uniform
   in ±2.5, TF32 off: max|err| of dx, d-offset and dw against the stated
   tolerance, and the kernel's (CUDA events, and device time under
   torch.profiler), the plain version's and the bound's times; beside
   them a yardstick, cuDNN's dense 3³ backward at the same shape
   (`torch.nn.grad.conv3d_input` + `conv3d_weight`, the Δ = 0 channel
   mixes alone: not the same function, and no PyTorch call computes a
   deformable-conv backward, so no library time);
5b. the chain backward kernel (`dw_chain3d_bwd`) against autograd of the
   plain chain at the four stage shapes with batch 2, TF32 off: max|err|
   of dx, dw_dw, db_dw, dw_dil and db_dil against the stated tolerance,
   two calls bitwise equal, the kernel's times (CUDA events and device
   time), the plain version's (the plain chain's backward alone), the
   bound (twice the forward's in-volume taps, as `portbench/counts.py`
   counts the operations; x and g read and dx written once, with the
   weights and their gradients) and a yardstick, the parent's path (the plain chain
   recomputed and differentiated on cuDNN), per launch and per step;
6. the small training step, CUDA against CPU: one step of the training
   path at img_size (16, 32, 32), batch 2, deep supervision, remat, from
   the same init and batch on both: loss, grad norm, the gradients tensor
   by tensor and as a whole, and the parameters after the step, each
   against its stated tolerance, beside the CPU step with itself on an
   image scaled by 1 + 1e-7 (a noise floor);
7. the training path (`train_path.py`, the step of `bench.py:59-106`) at
   full size: 3 steps, printing s/step (median of steps 2-3), peak device
   memory, the losses (finite) and the launches per step (42 deform and
   42 chain forwards, 21 deform and 21 chain backwards with remat); then
   step 1 again from the same init through the plain versions: the loss within 1e-5
   relative, every parameter tensor's gradient within ‖Δg‖ ≤ 1.5e-2·‖g‖ and
   the whole gradient within 1e-3 (beside the same comparison of the plain
   step with itself on an image scaled by 1 + 1e-7: its noise floor), all
   gradients finite and every `conv_offset.weight` gradient nonzero; and
   the two backward kernels' device time in one more step under
   torch.profiler;
8. the 2D kernels against their plain versions at the three decoder
   shapes of the 2D path (14²×384, 28²×192, 56²×96) with batch 24, TF32
   off: the depthwise deform conv at 5×5 and 7×7-dil3 (offsets uniform in
   ±2.5, a quarter of them exact integers) and the 2D LKA chain, each
   with max|err| against the stated tolerance, the kernel's, the plain
   version's and the bound's times, and for the chain two depthwise
   `F.conv2d` as its library time (no PyTorch call computes the deform
   conv: torchvision is absent): the chain and the library call both as
   the median of 5 windows of back-to-back calls (CUDA events, the two in
   turns) and as device time under torch.profiler; the deform conv as
   CUDA events and device time, beside a yardstick, the depthwise
   `F.conv2d(groups=C, dilation=dil)` at Δ = 0 (not the same function);
   then the chain alike at DAE-LKA's decoder shapes, 28²×320 and
   56²×128, batch 24;
9. the 2D path (`main_path2d.py`): `Predictor2D.predict_volume` of a
   seeded 40×512×512 case (224² patch, one chunk of 24 and a padded one
   of 16) for the flagship and the LKA Baseline at full width from seed
   0, layer scales 1 and the offset nets drawn from a seed: s/case, peak
   device memory, launches (24 deform convs per case on the flagship, 12
   chains on the Baseline, none of the others), then the same case
   through the plain versions: labels equal on ≥ 0.999 of pixels;
10. the 2D flagship at 64², batch 2, on the card against the same model
   on the CPU;
11. the 2D flagship's batch-1 224² latency in f32: CUDA events over 100
   back-to-back forwards after 10 warm-up forwards, and the host-clock
   mean ± std of 100 synchronised forwards;
12. the dilated 3D depthwise kernel against its plain version at the two
   shapes where the size-aware gates run it, 8³×128 (5³ dil 3) and 4³×256
   (3³ dil 2), batch 8, TF32 off: max|err| against the stated tolerance,
   and the kernel's (through its wrapper), the plain version's, one
   `F.conv3d(groups=C)`'s and the bound's times, the kernel and the
   library call timed alike (phase 8's two ways);
13. the size-aware path: phase 4's protocol, volume and gate driving with
   `main_path.build(trans_block="TransformerBlock_Deform_LKA_Spatial_sequential")`:
   s/volume, peak device memory, launches (exactly 168 deform convs, 96
   chains and 72 dilated depthwise convs, none of the others), then the
   same run through the plain versions: labels equal on ≥ 0.999 of voxels;
14. the Channel-sequential Synapse model, the ACDC model and the Pancreas
   model at small size, batch 2, on the card against the same model on
   the CPU, as phase 3;
15. the Synapse CLI (`cli/predict_simple.main`, `case_path.py`): a
   CT-like int16 case of (77, 162, 135) at spacing (3.75, 0.9, 0.9) in a
   folder, two folds of full-width `dlka_former_synapse` from seeds 0 and
   1 (gates driven) in `torch.save` checkpoints, TTA on, step 0.5: after
   one warm-up forward, s/case, the preprocessed shape and tile count, the
   host's seconds of preprocessing and restore, peak device memory and
   launches (21 of each 3D forward kernel per forward, forwards = tiles ×
   folds × 8 flips / the TTA batch of 8; none of the others); the written
   NIfTI read back (shape and affine the input's, uint8, labels < 14);
   then the same predictor through the plain versions: labels equal on ≥
   0.999 of voxels in the original geometry;
16. the Pancreas tester (`inference/pancreas.test_all_case`): first kernels
   1-2 against their plain versions at the Pancreas stage shapes (48³×32,
   24³×64, 12³×128, 6³×256, batch 1); then `dlka_net_pancreas` at patch
   96³ (seed 0, gates driven), stride 16/16, no mirroring, count blending,
   on a synthetic 128×128×80 case (z padded to 96: 3×3×1 tiles): s/case,
   peak device memory, launches (21 × 9 of each 3D forward kernel), the
   four metrics (finite, Dice in [0, 1]), then the labels through the
   plain versions: equal on ≥ 0.999 of voxels;
17. the Synapse trainer (`cli/run_training.main`, `trainer_path.py`) on 3
   synthetic preprocessed cases of (96, 192, 160) with 14 labels, after
   checking that the native resampler built: step 1 of
   `dlka_former_synapse(14, do_ds=True, remat=True)` at patch 64×128×128,
   batch 2, on the CLI's first batch (loaded and augmented in this
   thread), through the kernels and through the plain versions: the loss
   within 1e-5 relative, each parameter tensor's update p' − p within
   1.5e-2 and the whole within 1e-3 of the plain run's (phase 7's gates),
   the online tp/fp/fn equal (or apart only by argmax flips at near-ties)
   and 42 / 42 / 21 launches; then 2 epochs of 4 training and 2
   validation batches (moreDA in 4 threads): s/step (the median after the
   first), the waits on the prefetch queue, the host seconds of loading
   and augmenting a batch, s/epoch, the checkpoint writes, peak device
   memory, launches (42 / 42 / 21 per step, 21 / 21 / 0 per validation
   batch); `-val` on the 2 validation cases, its tiles in bfloat16 as
   the JAX CLI's (168 / 168 / 0 launches per case, `summary.json` and
   `postprocessing.json` written, the labels of one case ≥ 0.999 equal to
   the same bfloat16 run through the plain versions); `-c` from `model_latest`
   (epoch, step count and losses restored); and the step on one batch with
   the training augmenter's threads running beside it and with none, in
   turns;
18. the Pancreas trainer: kernel 3 against its plain version at the
   Pancreas stage shapes with batch 2 (its max|err|, ms per launch and
   bound); iteration 1 of `TrainerPancreas` (`dlka_net_pancreas` at 96³
   from seed 1337, batch 2, labeled_bs 1) through the kernels and through
   the plain versions (loss within 1e-5, updates as phase 17); 6
   iterations: s/iteration, peak device memory, 21 / 21 / 21 launches per
   iteration; then the port's Pancreas tester on the checkpoint
   `d_lka_former_iter_6` (189 / 189 launches, finite metrics);
19. the 2D deform backward kernel against its plain version (autograd of
   the plain forward) at the six decoder sites (14²×384, 28²×192, 56²×96;
   5×5 and 7×7-dil3), batch 24, offsets uniform in ±0.05, ±2.5 and ±8
   with a quarter of them exact integers, TF32 off: max|err| of dx,
   d-offset and dw against the stated tolerance at each scale, the
   kernel's time at each (CUDA events), at ±2.5 also its device time, its
   time with the L2 cache flushed before each call (as a training step
   finds its inputs), the plain version's and the bound's times; at ±2.5 the two clocks of one
   call side by side (events before and after, torch.profiler's kernels
   the call issues: the zero fills, the data kernel, the sum of dw's
   parts; the SM clock); a yardstick, cuDNN's depthwise `conv2d_input` +
   `conv2d_weight` at Δ = 0 (not the same function; no PyTorch call
   computes this backward, so no library time);
20. the 2D flagship's training step (`Trainer2D`, `trainer2d_path.py`) at
   224², batch 24, 9 classes, from the CLI's seed, on one synthetic batch:
   3 steps (s/step, the median of steps 2-3; peak device memory; finite
   losses; exactly 12 deform forwards and 12 deform backwards per step,
   none of the others) and the backward kernel's device time in a fourth;
   the backward kernel's 12 calls of a fifth step captured and timed alone
   (CUDA events), with their offsets' statistics;
   then step 1 from the same weights through the plain versions: the loss
   within 1e-5 relative, each parameter tensor's update and the whole
   update within the 2D gates (over three times the noise floor printed
   beside them: the plain step with the image × (1 + 1e-7)), every
   `offset_net.weight` gradient nonzero; and one step with the forward
   kernel and the recomputed plain VJP (`_PlainVjp`, what the backward
   kernel replaced), timed;
21. the 2D CLIs (`trainer2d_path.py`): `train_synapse2d.main` on 48
   synthetic 512² slices (B=24, 2 epochs of 2 batches, the eval hook at
   epoch 2 on one 40×512×512 volume held in memory): s/step, host
   seconds of loading and augmenting a batch, s/epoch, checkpoint writes,
   peak device memory, 12 / 12 launches per step, the hook's Dice finite
   in [0, 1], `best_model` written; the test CLI's volume function on
   `best_model` (24 deform forwards per case; the host's Dice and HD95)
   and the same volumes' labels through the plain versions: equal on ≥
   0.999 of pixels; the LKA Baseline
   (`--no_deform`): 3 steps (6 chain launches and no deform launch each)
   and step 1 against the plain versions (loss within 1e-5); then
   `train_skin.main` (224² RGB, one class, B=16, 2 epochs, test
   evaluation): s/step, the plateau scale, the best-validation
   checkpoint and finite skin metrics; then `--model`:
   `train_synapse2d --model dae_lka` (1 epoch of 2 batches, 4 chain
   launches per step), the test CLI's volume function on its
   `best_model` (4 per forward; labels ≥ 0.999 equal to the plain
   chain's) and `train_skin --model transunet --evaluate` (1 epoch of 2
   batches, no hand kernel);
22. the 2D ablation zoo (`main_path2d.ZOO`, the 11 registry models but
   the flagship's two), each: at narrow widths (`ZOO_NARROW`, 224², B=2)
   the card against the CPU (the path the CPU tests hold against the JAX
   package), max|Δ| within 1e-3·max(1, max|CPU|), TF32 off; at upstream
   widths from seed 0 (gates driven), 224², B=24: ms per forward (the
   median of 5 after a warm call), peak device memory, launches per
   forward (`main_path2d.LAUNCHES_PER_FORWARD`: 4 chains for dae_lka, 6
   for mvit_lka, dat_lka, stvit_lka, none for the others); for those
   four the labels ≥ 0.999 equal to the same forward through the plain
   chain; 3 `Trainer2D` steps (s/step, the median of steps 2-3; peak
   memory; finite losses; `trainer2d_path.LAUNCHES_PER_STEP`); for the
   four, step 1 again through the plain chain: the loss within 1e-5
   relative, the update p' − p per tensor and whole within
   `ZOO_UPDATE_GATES` (phase 20's 1e-3 / 1e-5 for dae_lka and stvit_lka,
   3e-3 / 1e-5 for dat_lka, 4e-3 / 3e-5 for mvit_lka: over three times
   the floors `grad_floor.py --two_d --model NAME` measures; a tensor
   whose update is rounding noise, an exactly zero gradient on a zero
   parameter, held by the whole only; the gradients printed beside);
23. the Pancreas baselines and nnUNet's 2D GenericUNet (`baselines_path.py`),
   which run no hand kernel: for each of VNet, the ResNet34 seg net and
   UNETR (`cli/_pancreas_models.build_pancreas_model`), at narrow widths
   (`BASELINE_NARROW`, 32³, B=2, as the CPU tests hold them against the
   JAX package) the card against the CPU within 1e-3·max(1, max|CPU|);
   at full width from the CLI's seed `TrainerPancreas` for 6 iterations
   at 96³, B=2, labeled_bs 1 (s/iteration, the median after the first;
   peak device memory; finite losses) and the Pancreas tester with the
   trained model on the 128×128×80 case, stride 16 (s/case with the
   host's metrics, finite, Dice in [0, 1]); then GenericUNet: three CT-like
   raw NIfTI cases (64×288×288) planned and preprocessed
   (`plan_and_preprocess`, host seconds), one step of a narrow GenericUNet
   (base 8, cap 32) on the 2D CLI's first batch on the card against the
   CPU (the loss within 1e-5, each tensor's update and the whole within
   three times the CPU floor with the image × (1 + 1e-7), at least 1.5e-2
   / 1e-3; the conv biases under instance norms, whose gradient is exactly
   zero, by the whole only), and `run_training 2d` on the planned folder at the CLI's
   defaults (256², B=2; 1 epoch of 2 batches and one validation batch):
   s/step, host seconds of loading and augmenting a batch, peak device
   memory, finite losses. Every hand-kernel count is 0 on every one of
   these paths (a launch would mean a D-LKA module in a baseline);
24. the port of `parallel/`, on a world of one rank (NCCL through a
   `file://` store, a ("data",) mesh of size 1; several ranks need
   several cards): the main path of phase 4 through the meshed engine
   (`SlidingWindowInference(mesh=)`): s/volume of its first call (the
   communicator's set-up) and of two more in turns with the one-device
   engine on the same model, labels equal to phase 4's, 168 / 168 / 0
   launches a volume; the data-parallel training step
   (`make_train_step(mesh=)`, `train_path`'s B=2 batch on the one rank):
   s/step of 3 steps, steps 2-3 in turns with the one-device kernel
   step's, step 1's loss within 1e-5 of the one-device step's and its
   gradients within phase 7's gates (`GRAD_TENSOR_RTOL`, `GRAD_RTOL`),
   42 / 42 / 21 launches a step; `spatial_conv3d` (the halo
   conv; a world of one takes zero halos) against `F.conv3d`, dense and
   depthwise-dilated, within 1e-4·max(1, max|ref|); the general 2D deform
   conv (groups 2, stride 2) on the card against the CPU, and its
   depthwise 'same' case launching kernel 4 once, equal to the kernel's
   wrapper plus the bias; Ranger's 13 steps on the card against the CPU
   (rtol 1e-5, atol 1e-7); `utils.profiling.latency_bench` and
   `latency_bench_scan` of the 2D flagship at batch 1, beside phase 11's
   number;
25. the JAX package's bfloat16-input inference (`bench.py:150-151,199-201`,
   `cli/test_pancreas.py:54-55`, `cli/run_training.py:174-175`,
   `bench.py:119`): the main path of phase 4 with the volume uploaded in
   bfloat16 (`main_path.build(input_dtype=torch.bfloat16)`): s/volume
   in turns with the same model's float32 engine (two calls each after a
   warm one) and beside phase 4's first call, 168 / 168 / 0 launches
   (every kernel call held to float32 by the wrappers' guard), the
   labels ≥ 0.999 equal to the same bfloat16 run through the plain
   versions; phase 16's case through the Pancreas tester in bfloat16 for
   each of its four models (`build_pancreas_model`: the sliding window's
   seconds beside the same model's float32 tester, s/case with the host
   metrics; D-LKA Net 189 / 189 launches, the baselines none; finite
   metrics); one `-val` batch in bfloat16 (the 8 mirror flips of one
   tile through the deep-supervision model, 21 / 21 / 0, the softmax
   within 1e-3 and the labels ≥ 0.999 equal to the plain versions'); the
   2D flagship's batch-1 224² forward on a bfloat16 input (ms in turns
   with the float32 input and beside phase 11, 12 launches, logits
   float32 and the labels ≥ 0.999 equal to the plain versions'). Phase
   17's `-val` runs in bfloat16 too (`cli/run_training.py`), its plain
   run as well;
26. kernel 7 (`conv3d_wgrad`, the weight gradient of the dense stride-1
   1³ and 3³ convs) at every such shape of the benchmark's
   `synapse3d.train` and `swin_unetr.train` (B=2, x and g N(0, 1)):
   ‖Δ‖ / ‖·‖ against the plain version in float64, beside cuDNN's own,
   within 1e-5; two calls bitwise equal; the kernel's time (CUDA events,
   in turns with the yardstick, and device time), its bound, the plain
   version's time and the yardstick, cuDNN's f32 `conv3d_weight` on the
   same channels-last views (the port's path where the kernel is not
   engaged); then per step of each cell, all shapes and those
   `convs.hand_wgrad_shape` engages. This table sets that rule.

Phase 19 runs right after phase 8, phase 26 after phase 5b, the others in order. Then one JSON
line of the kernels' numbers and, last, the contract line {"ok": true,
"device": {...}}. Any failure exits nonzero before it.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from deformablelka_tpu_torch import (baselines_path, case_path, main_path, main_path2d,
                                     native, parallel, train_path, trainer2d_path,
                                     trainer_path)
from deformablelka_tpu_torch.cli import (predict_simple, run_training, test_synapse2d,
                                         train_skin, train_synapse2d)
from deformablelka_tpu_torch.cli._pancreas_models import build_pancreas_model
from deformablelka_tpu_torch.grad_floor import NOISE_SHARE, plain_versions
from deformablelka_tpu_torch.data import nifti
from deformablelka_tpu_torch.data.augment import ThreadedAugmenter
from deformablelka_tpu_torch.data.dataset import load_case, load_dataset
from deformablelka_tpu_torch.inference import pancreas
from deformablelka_tpu_torch.inference.predictor2d import benchmark_inference_speed
from deformablelka_tpu_torch.inference.predictor3d import TTA_BATCH
from deformablelka_tpu_torch.inference.sliding_window import (SlidingWindowInference,
                                                             mirror_tta_softmax)
from deformablelka_tpu_torch.main_path import (BLOCKS, LAUNCHES_PER_FORWARD, PATCH,
                                              SIZE_AWARE, TILES, VOLUME)
from deformablelka_tpu_torch.models import (BiDAEFormer, DAEFormer, DAELKAFormer,
                                            DATLKAFormer, HiFormer, MViTLKAFormer, SegFormer,
                                            SemanticSTViT, STVitLKA, SwinUNet, TransUNet)
from deformablelka_tpu_torch.models.dlka_former import (_build, dlka_former_acdc,
                                                        dlka_former_synapse,
                                                        dlka_net_pancreas)
from deformablelka_tpu_torch.models.generic_unet import GenericUNet
from deformablelka_tpu_torch.models.pancreas_baselines import UNETR, Resnet34Seg, VNet
from deformablelka_tpu_torch.nn.blocks3d import DeformConvPack3d
from deformablelka_tpu_torch.nn.layers import init_parameters
from deformablelka_tpu_torch.nn.lka2d import DeformConv
from deformablelka_tpu_torch.ops import kernels
from deformablelka_tpu_torch.models.swin_unetr import swin_unetr_btcv
from deformablelka_tpu_torch.ops.convs import conv3d_weight_grad, hand_wgrad_shape, to_nchw, to_ncdhw
from deformablelka_tpu_torch.ops.deform2d import deform_conv2d
from deformablelka_tpu_torch.ops.deform2d import deform_dw_conv2d as deform2d_plain
from deformablelka_tpu_torch.ops.deform2d import deform_dw_conv2d_backward as deform2d_bwd_plain
from deformablelka_tpu_torch.ops.deform3d import deform_conv3d as deform_plain
from deformablelka_tpu_torch.ops.deform3d import deform_conv3d_backward as deform_bwd_plain
from deformablelka_tpu_torch.ops.dwconv3d import depthwise_conv3d_dilated as dw_plain
from deformablelka_tpu_torch.ops.lka import dw_chain2d as chain2d_plain
from deformablelka_tpu_torch.ops.lka import dw_chain3d as chain_plain
from deformablelka_tpu_torch.profiling import cold_ms, device_profile
from deformablelka_tpu_torch.training.losses import poly_lr
from deformablelka_tpu_torch.parallel.spatial import spatial_conv3d
from deformablelka_tpu_torch.training.train_step import make_ranger, make_sgd, make_train_step
from deformablelka_tpu_torch.training.trainer3d import make_ds_train_step
from deformablelka_tpu_torch.training.trainer_pancreas import TrainerPancreas
from deformablelka_tpu_torch.utils.profiling import latency_bench, latency_bench_scan

# (spatial size, channels, transformer blocks at that stage) on the main path
STAGES = ((32, 32, 6), (16, 64, 6), (8, 128, 6), (4, 256, 3))
# (spatial size, channels) of decoder_2, decoder_1, decoder_0 on the 2D path;
# each runs two LKA blocks: per forward, two launches of each deform conv
# (5×5, 7×7-dil3) in the flagship and two chains in the LKA Baseline
DECODER = ((14, 384), (28, 192), (56, 96))
# (spatial size, channels) of DAE-LKA's decoder_1 and decoder_0, where its
# LKA blocks run the 2D chain twice each per forward
DAE_LKA_DECODER = ((28, 320), (56, 128))
BATCH_2D = main_path2d.SLICE_BATCH
DEFORM_SITES = ((5, 1), (7, 3))  # (k, dilation)
# (spatial size, channels, K, dilation, launches per forward) of the dilated
# depthwise conv on the size-aware path: encoder stage 2 and decoder5 at
# 8³×128, encoder stage 3 at 4³×256, three blocks each
DW_SITES = ((8, 128, 5, 3, 6), (4, 256, 3, 2, 3))
# (spatial size, channels) of the Pancreas model's stages at its 96³ patch
PANCREAS_STAGES = ((48, 32), (24, 64), (12, 128), (6, 256))
BATCH = 8
TRAIN_BATCH = train_path.BATCH
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12      # H100 SXM f32 outside the tensor cores
TF32_FLOP_PER_S = 495e12    # H100 SXM TF32 on the tensor cores, dense
REL_TOL = 1e-4              # max|kernel - plain| ≤ REL_TOL · max(1, max|plain|)
MIN_AGREEMENT = 0.999       # argmax share, kernels vs plain versions


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    raise SystemExit(1)


def _summed(counts) -> dict:
    """The launches of several runs (`kernels.launch_counts()` each) added."""
    return dict(sum(map(Counter, counts), Counter()))


def timed_ms(fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_in_turns_ms(kernel, library, reps: int, windows: int = 5) -> tuple:
    """Per call, the median over `windows` windows of `reps` back-to-back
    calls, each timed with CUDA events, of `kernel` and of `library`, their
    windows in turns (kernel, library, library, kernel, ...)."""
    times = {kernel: [], library: []}
    for i in range(windows):
        for fn in ((kernel, library) if i % 2 == 0 else (library, kernel)):
            times[fn].append(timed_ms(fn, reps, warmup=1))
    return float(np.median(times[kernel])), float(np.median(times[library]))


def device_ms(fn, calls: int, kernel: str | None = None) -> float:
    """Device time per call under torch.profiler: the hand kernel's
    (`kernel`, its class in `profiling.kernel_class`) or, with None, that of
    every device kernel the calls ran."""
    prof = device_profile(lambda: [fn() for _ in range(calls)])
    return (prof["kernel_ms"] if kernel is None else prof["by_class"][kernel]) / calls


def bound_ms(n_bytes: float, flops: float) -> dict:
    """The least time for the work: bytes over the memory rate, or
    operations over the f32 rate, whichever is larger."""
    return {"bytes_ms": n_bytes / HBM_BYTES_PER_S * 1e3,
            "ops_ms": flops / F32_FLOP_PER_S * 1e3}


def _bound(r) -> tuple:
    return (max(r["bytes_ms"], r["ops_ms"]),
            "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations")


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print("phase 1 device: nvidia-smi name, power.limit:", flush=True)
    print(smi.splitlines()[0], flush=True)
    print(f"phase 1 device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
          flush=True)
    t0 = time.perf_counter()
    kernels.library()
    print(f"phase 1 build: csrc/*.cu with nvcc for sm_90a and loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def _deform_check(x, off, w, b, label):
    """max|kernel - plain| at one set of offsets, against the tolerance."""
    ref = deform_plain(x, off, w, b)
    got = kernels.deform_conv3d(x, off, w, b)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    tol = REL_TOL * max(1.0, ref.abs().max().item())
    if not err <= tol:
        fail(f"deform_conv3d disagrees with its plain version at {label}: "
             f"max|err| {err:.3e} > {tol:.3e}")
    return err, tol


def phase_kernels():
    """Each kernel against its plain version at the four stage shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    rows = {"deform_conv3d": [], "dw_chain3d": []}
    for S, C, sites in STAGES:
        V = S ** 3
        x = torch.randn(BATCH, S, S, S, C, device=dev, generator=g)
        xn = to_ncdhw(x).contiguous()
        # deform conv, at offsets uniform in ±2.5 and in ±0.05 (a trained
        # checkpoint reads |Δ| ≤ 0.034)
        off = (torch.rand(BATCH, S, S, S, 81, device=dev, generator=g) * 2 - 1) * 2.5
        small = (torch.rand(BATCH, S, S, S, 81, device=dev, generator=g) * 2 - 1) * 0.05
        w = torch.randn(3, 3, 3, C, C, device=dev, generator=g) / (27 * C) ** 0.5
        b = torch.randn(C, device=dev, generator=g) * 0.1
        err, tol = _deform_check(x, off, w, b, f"{S}^3 C={C}, offsets in ±2.5")
        err_small, _ = _deform_check(x, small, w, b, f"{S}^3 C={C}, offsets in ±0.05")
        outside = (off.abs() > 1).float().mean().item()
        kernel = lambda: kernels.deform_conv3d(x, off, w, b)
        ms = timed_ms(kernel, 20)
        dms = device_ms(kernel, 20, "deform_conv3d (hand kernel)")
        sms = timed_ms(lambda: kernels.deform_conv3d(x, small, w, b), 20)
        pms = timed_ms(lambda: deform_plain(x, off, w, b), 3, warmup=1)
        # cuDNN's dense 3³ conv at the same shape: the Δ = 0 channel mix alone,
        # a yardstick and not the same function
        wn = w.permute(4, 3, 0, 1, 2).contiguous()
        cms = timed_ms(lambda: F.conv3d(xn, wn, b, padding=1), 20)
        n_bytes = 4 * (BATCH * V * (C + 81 + C) + 27 * C * C + C)
        mix, blend = BATCH * V * 27 * 2 * C * C, BATCH * V * 27 * 16 * C
        bnd = bound_ms(n_bytes, mix + blend)
        bms, by = _bound(bnd)
        # on the tensor cores: three TF32 products per multiply of the mix,
        # the blend on the CUDA cores, the two pipes in parallel
        tc = max(bnd["bytes_ms"], 3 * mix / TF32_FLOP_PER_S * 1e3,
                 blend / F32_FLOP_PER_S * 1e3)
        rows["deform_conv3d"].append(dict(S=S, C=C, sites=sites, err=max(err, err_small),
                                          tol=tol, ms=ms, plain_ms=pms, lib_ms=None,
                                          device_ms=dms, small_offset_ms=sms,
                                          dense_conv_ms=cms, tc_bound_ms=tc, **bnd))
        print(f"phase 2 deform_conv3d B={BATCH} {S}^3 C={C}: max|err| {err:.3e} at ±2.5, "
              f"{err_small:.3e} at ±0.05 (tol {tol:.3e}), |Δ|>1 share {outside:.3f}, "
              f"kernel {ms:.4f} ms (device {dms:.4f}) at ±2.5, {sms:.4f} ms at ±0.05, "
              f"plain {pms:.4f} ms, bound {bms:.4f} ms ({by}; f32), tensor-core bound "
              f"{tc:.4f} ms, cuDNN dense 3^3 conv {cms:.4f} ms", flush=True)
        del off, small
        # dw chain
        w5 = torch.randn(5, 5, 5, 1, C, device=dev, generator=g) / 125 ** 0.5
        b5 = torch.randn(C, device=dev, generator=g) * 0.1
        w7 = torch.randn(7, 7, 7, 1, C, device=dev, generator=g) / 343 ** 0.5
        b7 = torch.randn(C, device=dev, generator=g) * 0.1
        ref = chain_plain(x, w5, b5, w7, b7)
        got = kernels.dw_chain3d(x, w5, b5, w7, b7)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = REL_TOL * max(1.0, ref.abs().max().item())
        if not err <= tol:
            fail(f"dw_chain3d disagrees with its plain version at {S}^3 C={C}")
        pms = timed_ms(lambda: chain_plain(x, w5, b5, w7, b7), 10)
        # the library call: two depthwise F.conv3d on NCDHW tensors, timed in
        # turns with the kernel
        w5n, w7n = w5.permute(4, 3, 0, 1, 2).contiguous(), w7.permute(4, 3, 0, 1, 2).contiguous()
        kernel = lambda: kernels.dw_chain3d(x, w5, b5, w7, b7)
        library = lambda: F.conv3d(F.conv3d(xn, w5n, b5, padding=2, groups=C),
                                   w7n, b7, padding=9, dilation=3, groups=C)
        ms, lms = timed_in_turns_ms(kernel, library, 10)
        dms = device_ms(kernel, 10, "dw_chain3d (hand kernel)")
        ldms = device_ms(library, 10)
        n_bytes = 4 * (2 * BATCH * V * C + (125 + 343 + 2) * C)
        flops = BATCH * V * C * 2 * (125 + 343)
        bnd = bound_ms(n_bytes, flops)
        bms, by = _bound(bnd)
        rows["dw_chain3d"].append(dict(S=S, C=C, sites=sites, err=err, tol=tol,
                                       ms=ms, plain_ms=pms, lib_ms=lms, device_ms=dms,
                                       lib_device_ms=ldms, **bnd))
        print(f"phase 2 dw_chain3d B={BATCH} {S}^3 C={C}: max|err| {err:.3e} "
              f"(tol {tol:.3e}), kernel {ms:.4f} ms (device {dms:.4f}), plain "
              f"{pms:.4f} ms, F.conv3d x2 {lms:.4f} ms (device {ldms:.4f}), bound "
              f"{bms:.4f} ms ({by})", flush=True)
        del x, xn, ref, got
        torch.cuda.empty_cache()
    return rows


def phase_small_reference(phase=3, factory=dlka_former_synapse, img=(16, 32, 32),
                          num_classes=14, **kw):
    """The CUDA model against the same model on the CPU, small input; the
    CUDA forward's launches."""
    models = {}
    for dev in ("cuda", "cpu"):
        models[dev] = factory(num_classes, do_ds=False, img_size=img, seed=0,
                              device=dev, **kw)
        main_path.drive_gates(models[dev], seed=7)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, *img, 1).astype(np.float32))
    with torch.no_grad():
        ref = models["cpu"](x)
        kernels.reset_launches()
        got = models["cuda"](x.cuda()).cpu()
    launches = kernels.launch_counts()
    err = (got - ref).abs().max().item()
    tol = 1e-3 * max(1.0, ref.abs().max().item())
    print(f"phase {phase} {factory.__name__}{kw or ''} small input {img} B=2: CUDA "
          f"model vs CPU model max|err| {err:.3e} (tol {tol:.3e}), finite "
          f"{bool(torch.isfinite(got).all())}, launches {launches}", flush=True)
    if not (err <= tol and torch.isfinite(got).all()):
        fail(f"the CUDA model {factory.__name__}{kw or ''} disagrees with the CPU "
             "model on a small input")
    return launches


def phase_small_configs():
    """Phase 14: the other 3D configurations, card against CPU."""
    seq = phase_small_reference(
        14, trans_block="TransformerBlock_Deform_LKA_Channel_sequential")
    if seq.get("dwconv3d") != 9:
        fail(f"the Channel-sequential forward launched dwconv3d {seq.get('dwconv3d')} times")
    phase_small_reference(14, dlka_former_acdc, (8, 64, 64), 4)
    phase_small_reference(14, dlka_net_pancreas, (32, 32, 32), 2)


def phase_main_path(phase=4, trans_block=main_path.DEFAULT_BLOCK, expected=None):
    """The main path with `trans_block`; `expected`: its launches per
    forward (the published block: one of each 3D forward kernel per block)."""
    model, sw = main_path.build(seed=0, trans_block=trans_block)
    vol = main_path.volume(seed=0)
    offsets_seen = []

    def record(_m, _inp, out):
        offsets_seen.append((out.abs().max().item(), (out.abs() > 1).float().mean().item()))

    if len(sw.origins(VOLUME)) != TILES:
        fail(f"expected {TILES} tiles")
    with torch.no_grad():  # warm-up: one batch-8 forward
        model(torch.zeros(8, *PATCH, 1, device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    seg = sw.predict_segmentation(vol)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"phase {phase} main path {trans_block}: predict_segmentation {VOLUME} "
          f"patch {PATCH}, {TILES} tiles x 8 flips: {wall:.3f} s wall, peak device "
          f"memory {peak / 2**30:.3f} GiB, launches {launches}", flush=True)
    per_forward = expected or {"deform_conv3d": BLOCKS, "dw_chain3d": BLOCKS}
    expected = {n: TILES * c for n, c in per_forward.items()}
    if launches != expected:
        fail(f"main path launches {launches}, expected {expected}")
    if seg.shape != VOLUME or seg.dtype != np.uint8 or seg.max() >= 14:
        fail(f"bad segmentation {seg.shape} {seg.dtype}")

    hooks = [m.conv_offset.register_forward_hook(record)
             for m in model.modules() if isinstance(m, DeformConvPack3d)]
    with plain_versions():
        t0 = time.perf_counter()
        seg_plain = sw.predict_segmentation(vol)
        torch.cuda.synchronize()
        wall_plain = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    agree = float((seg == seg_plain).mean())
    max_off = max(m for m, _ in offsets_seen)
    past_one = float(np.mean([s for _, s in offsets_seen]))
    print(f"phase {phase} main path vs plain versions: label agreement {agree:.6f} "
          f"(min {MIN_AGREEMENT}), plain run {wall_plain:.3f} s; offsets max|Δ| "
          f"{max_off:.3f}, mean share |Δ|>1 {past_one:.4f}; classes in seg "
          f"{np.unique(seg).size}", flush=True)
    if agree < MIN_AGREEMENT:
        fail("the main path through the kernels disagrees with the plain versions")
    if max_off <= 1.0:
        fail("the offsets never reached past ±1")
    return launches, wall, seg


def _rel_close(name, got, ref, report):
    err = (got - ref).abs().max().item()
    tol = REL_TOL * max(1.0, ref.abs().max().item())
    report[name] = (err, tol)
    return err <= tol


def phase_backward_kernel():
    """The deform backward kernel against autograd of the plain forward."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    rows = []
    for S, C, sites in STAGES:
        V, B = S ** 3, TRAIN_BATCH
        x = torch.randn(B, S, S, S, C, device=dev, generator=g)
        off = (torch.rand(B, S, S, S, 81, device=dev, generator=g) * 2 - 1) * 2.5
        w = torch.randn(3, 3, 3, C, C, device=dev, generator=g) / (27 * C) ** 0.5
        gy = torch.randn(B, S, S, S, C, device=dev, generator=g)
        ref = deform_bwd_plain(x, off, w, gy)
        got = kernels.deform_conv3d_bwd(x, off, w, gy)
        torch.cuda.synchronize()
        report = {}
        ok = all([_rel_close(n, a, r, report)
                  for n, a, r in zip(("dx", "doff", "dw"), got, ref)])
        del got, ref
        kernel = lambda: kernels.deform_conv3d_bwd(x, off, w, gy)
        ms = timed_ms(kernel, 10)
        dms = device_ms(kernel, 10, "deform_conv3d_bwd (hand kernel)")
        pms = timed_ms(lambda: deform_bwd_plain(x, off, w, gy), 3, warmup=1)
        # yardstick: cuDNN's dense 3³ data and weight gradients at Δ = 0
        xn, gn = to_ncdhw(x).contiguous(), to_ncdhw(gy).contiguous()
        wn = w.permute(4, 3, 0, 1, 2).contiguous()
        yms = timed_ms(lambda: (torch.nn.grad.conv3d_input(xn.shape, wn, gn, padding=1),
                                torch.nn.grad.conv3d_weight(xn, wn.shape, gn, padding=1)), 10)
        # read x, offsets, w, g once; write dx, d-offset, dw once. Per voxel
        # and tap: the two channel mixes (dsamp = g·w_kᵀ, dw += sampᵀ·g),
        # 4·Ci·Co; per channel the sample's 8-corner blend (16), the dx
        # scatter (16) and each corner's dot dsamp·x (16); per voxel the
        # dot products' 8 corners scaled by the three weight derivatives (48)
        n_bytes = 4 * (B * V * (C + 81 + C) + 27 * C * C + B * V * (C + 81) + 27 * C * C)
        flops = B * V * 27 * (4 * C * C + 48 * C + 48)
        bnd = bound_ms(n_bytes, flops)
        bms, by = _bound(bnd)
        err = max(e for e, _ in report.values())
        rows.append(dict(S=S, C=C, sites=sites, err=err, ms=ms, plain_ms=pms,
                         lib_ms=None, device_ms=dms, yardstick_ms=yms, **bnd))
        errs = ", ".join(f"{n} {e:.3e} (tol {t:.3e})" for n, (e, t) in report.items())
        print(f"phase 5 deform_conv3d_bwd B={B} {S}^3 C={C}: max|err| {errs}; "
              f"kernel {ms:.4f} ms (device {dms:.4f}), plain {pms:.4f} ms, bound "
              f"{bms:.4f} ms ({by}), library none (no PyTorch call computes this "
              f"backward); yardstick, cuDNN's dense 3^3 backward at Δ = 0 "
              f"(conv3d_input + conv3d_weight) {yms:.4f} ms", flush=True)
        if not ok:
            fail(f"deform_conv3d_bwd disagrees with its plain version at {S}^3 C={C}")
        del x, off, w, gy, xn, gn
        torch.cuda.empty_cache()
    return rows


def _chain_bwd_work(B, S, C) -> dict:
    """The chain backward's least work at one call: twice the forward's
    in-volume taps (the multiply-adds of dw_dil's and da's, then dw_dw's
    and dx's, as `portbench/counts.py` counts the backward), and the bytes
    it has to move: x and g read and dx written once, the weights and b_dw
    read, their five gradients written. Beside them, the kernel's own
    multiply-adds (every tap of its three passes and two tap sums,
    zero-padded ones too, and the recompute of a), printed, not a bound."""
    V = S ** 3
    return {"bytes": 4 * (3 * B * V * C + (2 * (125 + 343) + 3) * C),
            "flops": 4 * B * C * (in_volume_taps(S, 5, 1) + in_volume_taps(S, 7, 3)),
            "kernel_flops": 2 * B * V * C * (3 * 125 + 2 * 343)}


def phase_chain_backward_kernel():
    """Phase 5b: the chain backward kernel against autograd of the plain
    chain at the four stage shapes (B=2), per tensor, and its times."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4322)
    rows = []
    for S, C, sites in STAGES:
        B = TRAIN_BATCH
        args = (torch.randn(B, S, S, S, C, device=dev, generator=gen),
                torch.randn(5, 5, 5, 1, C, device=dev, generator=gen) / 125 ** 0.5,
                torch.randn(C, device=dev, generator=gen) * 0.1,
                torch.randn(7, 7, 7, 1, C, device=dev, generator=gen) / 343 ** 0.5,
                torch.randn(C, device=dev, generator=gen) * 0.1)
        gy = torch.randn(B, S, S, S, C, device=dev, generator=gen)
        leaves = [a.clone().requires_grad_() for a in args]
        y = chain_plain(*leaves)
        plain = lambda: torch.autograd.grad(y, leaves, gy, retain_graph=True)
        ref = plain()
        got = kernels.dw_chain3d_bwd(*args, gy)
        torch.cuda.synchronize()
        report = {}
        ok = all([_rel_close(n, a, r, report) for n, a, r in
                  zip(("dx", "dw_dw", "db_dw", "dw_dil", "db_dil"), got, ref)])
        bitwise = all(torch.equal(a, b) for a, b in zip(got, kernels.dw_chain3d_bwd(*args, gy)))
        del got, ref
        kernel = lambda: kernels.dw_chain3d_bwd(*args, gy)
        ms = timed_ms(kernel, 20)
        prof = device_profile(lambda: [kernel() for _ in range(20)])
        dms = prof["by_class"]["dw_chain3d_bwd (hand kernel)"] / 20
        # the passes apart: a = dw5(x) + b5 (<5, 1, ·, false, false>), da
        # and dw7's parts (<7, 3, ...>), dx and dw5's (<5, 1, ·, true, true>), the sum
        passes = {"a": 0.0, "da, dw7": 0.0, "dx, dw5": 0.0, "sum": 0.0}
        for name, t in prof["by_name"].items():
            key = ("sum" if "bwd_sum" in name else "da, dw7" if "<7, 3" in name
                   else "a" if "false, false" in name else "dx, dw5")
            if "dw_chain3d_bwd" in name:
                passes[key] += t / 20
        pms = timed_ms(plain, 3, warmup=1)

        def parent_path():  # `_PlainVjp`'s backward: the plain chain again, its VJP
            inputs = [a.detach().requires_grad_() for a in args]
            with torch.enable_grad():
                return torch.autograd.grad(chain_plain(*inputs), inputs, gy)

        yms = timed_ms(parent_path, 3, warmup=1)
        ydms = device_ms(parent_path, 3)
        work = _chain_bwd_work(B, S, C)
        bnd = bound_ms(work["bytes"], work["flops"])
        bms, by = _bound(bnd)
        err = max(e for e, _ in report.values())
        rows.append(dict(S=S, C=C, sites=sites, err=err, ms=ms, plain_ms=pms, lib_ms=None,
                         device_ms=dms, yardstick_ms=yms, yardstick_device_ms=ydms, **bnd))
        split = ", ".join(f"{k} {v:.4f}" for k, v in passes.items())
        errs = ", ".join(f"{n} {e:.3e} (tol {t:.3e})" for n, (e, t) in report.items())
        print(f"phase 5b dw_chain3d_bwd B={B} {S}^3 C={C}: max|err| {errs}; two calls "
              f"bitwise equal {bitwise}; kernel {ms:.4f} ms (device {dms:.4f}: {split}), plain "
              f"(autograd of the plain chain, its backward alone) {pms:.4f} ms, bound "
              f"{bms:.4f} ms ({by}; 2x the forward's in-volume taps; x, g, dx once), "
              f"the kernel's own multiply-adds at 67 TFLOP/s "
              f"{work['kernel_flops'] / F32_FLOP_PER_S * 1e3:.4f} ms; yardstick, the "
              f"parent's path (the plain chain recomputed and its VJP on cuDNN) {yms:.4f} ms "
              f"(device {ydms:.4f})", flush=True)
        if not (ok and bitwise):
            fail(f"dw_chain3d_bwd disagrees with its plain version at {S}^3 C={C}, or "
                 "two calls differ")
        del args, gy, leaves, y
        torch.cuda.empty_cache()
    per_step = {k: sum(r["sites"] * r[k] for r in rows)
                for k in ("ms", "device_ms", "plain_ms", "yardstick_ms", "yardstick_device_ms",
                          "bytes_ms", "ops_ms")}
    print(f"phase 5b dw_chain3d_bwd per training step (B={TRAIN_BATCH}, the 21 sites): kernel "
          f"{per_step['ms']:.3f} ms (device {per_step['device_ms']:.3f}), bound "
          f"{max(per_step['bytes_ms'], per_step['ops_ms']):.4f} ms, plain "
          f"{per_step['plain_ms']:.2f} ms, yardstick (the parent's path) "
          f"{per_step['yardstick_ms']:.2f} ms (device {per_step['yardstick_device_ms']:.2f})",
          flush=True)
    return rows


WGRAD_RTOL = 1e-5   # ‖kernel − float64‖ ≤ WGRAD_RTOL · ‖float64‖, per conv


def wgrad_cells() -> dict:
    """{cell: {(B, D, H, W, Ci, Co, k): convs a step}}: the dense stride-1
    1³ and 3³ convs of the benchmark's two training cells whose weight
    gradient `ops.convs` can give kernel 7 (`train_path.dense_wgrad_sites`)."""
    return {"synapse3d.train": train_path.dense_wgrad_sites(
                dlka_former_synapse(14, do_ds=True, img_size=PATCH, remat=True, device="meta"),
                (TRAIN_BATCH, *PATCH, 1)),
            "swin_unetr.train": train_path.dense_wgrad_sites(
                swin_unetr_btcv(14, img_size=(96, 96, 96), feature_size=48, remat=True,
                                device="meta"), (TRAIN_BATCH, 96, 96, 96, 1))}


def _rel_norm(got, ref) -> float:
    return ((got.double() - ref).norm() / ref.norm()).item()


def phase_conv3d_wgrad(out_dir: Path | None = None) -> list:
    """Phase 26: kernel 7 (`conv3d_wgrad`) at every dense weight-gradient
    shape of `synapse3d.train` and `swin_unetr.train`, x and g N(0, 1):
    ‖Δ‖ / ‖·‖ against the plain version in float64 (beside cuDNN's own),
    two calls bitwise equal, and per call the kernel's time (CUDA events,
    in turns with the yardstick; device time), its bound (max(2·N·Ci·Co·k³
    / 67 TFLOP/s, (|x| + |g|) / 3.35 TB/s)), the plain version (float32,
    one GEMM a tap) and the yardstick: cuDNN's f32 `conv3d_weight` on the
    same channels-last views, the call autograd of `F.conv3d` makes (the
    port's path where the kernel is not engaged). The table that sets
    `convs.hand_wgrad_shape`; a row's `sites` are its convs a step where
    that rule engages the kernel, else 0. Rows also go to
    `out_dir`/conv3d_wgrad.json."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4326)
    rows = []
    for cell, sites in wgrad_cells().items():
        for (B, D, H, W, ci, co, k), n in sorted(sites.items(), key=lambda kv: -kv[0][1]):
            x = torch.randn(B, D, H, W, ci, device=dev, generator=gen)
            g = torch.randn(B, D, H, W, co, device=dev, generator=gen)
            ref = conv3d_weight_grad(x.double(), g.double(), k)
            got = kernels.conv3d_wgrad(x, g, k)
            bitwise = torch.equal(got, kernels.conv3d_wgrad(x, g, k))
            shape = (co, ci, k, k, k)
            library = lambda: torch.nn.grad.conv3d_weight(to_ncdhw(x), shape, to_ncdhw(g),
                                                          padding=k // 2)
            err, lib_err = _rel_norm(got, ref), _rel_norm(library(), ref)
            del ref, got
            kernel = lambda: kernels.conv3d_wgrad(x, g, k)
            once = max(timed_ms(kernel, 1, warmup=1), timed_ms(library, 1, warmup=1))
            reps = int(min(50, max(1, 60 / once)))
            ms, lms = timed_in_turns_ms(kernel, library, reps, windows=3)
            dms = device_ms(kernel, reps, "conv3d_wgrad (hand kernel)")
            ldms = device_ms(library, reps)
            pms = timed_ms(lambda: conv3d_weight_grad(x, g, k), 1, warmup=1)
            N = B * D * H * W
            bnd = bound_ms(4 * N * (ci + co), 2 * N * ci * co * k ** 3)
            bms, by = _bound(bnd)
            plan = kernels.conv3d_wgrad_plan(B, D, H, W, ci, co, k)
            engaged = hand_wgrad_shape(ci, co, k, N)
            row = dict(cell=cell, shape=[B, D, H, W], ci=ci, co=co, k=k, per_step=n,
                       sites=n if engaged else 0, err=err, cudnn_err=lib_err, bitwise=bitwise,
                       ms=ms, device_ms=dms, bound_ms=bms, bound_by=by, plain_ms=pms,
                       lib_ms=None, yardstick_ms=lms, yardstick_device_ms=ldms,
                       engaged=engaged, **bnd,
                       plan=dict(tile=plan.channel_tile, brick=plan.tile, grid=plan.grid,
                                 threads=plan.threads, smem=plan.smem_bytes))
            rows.append(row)
            print(f"phase 26 conv3d_wgrad {cell} B={B} {D}x{H}x{W} {ci}->{co} {k}^3 "
                  f"x{n}/step: err {err:.2e} (cuDNN {lib_err:.2e}; tol {WGRAD_RTOL:g}), "
                  f"bitwise {bitwise}; kernel {ms:.4f} ms (device {dms:.4f}), bound {bms:.4f} "
                  f"({by}), plain {pms:.3f}, yardstick cuDNN conv3d_weight {lms:.4f} (device "
                  f"{ldms:.4f}); yardstick / kernel {lms / ms:.2f}; plan {row['plan']}",
                  flush=True)
            if not (err <= WGRAD_RTOL and bitwise):
                fail(f"conv3d_wgrad disagrees with its plain version at {row}")
            del x, g
            torch.cuda.empty_cache()
    for cell in ("synapse3d.train", "swin_unetr.train"):
        rs = [r for r in rows if r["cell"] == cell]
        tot = {key: sum(r["per_step"] * r[key] for r in rs)
               for key in ("ms", "device_ms", "bound_ms", "yardstick_ms", "yardstick_device_ms")}
        eng = [r for r in rs if r["engaged"]]
        print(f"phase 26 conv3d_wgrad per step of {cell}: {sum(r['per_step'] for r in rs)} "
              f"weight gradients, kernel {tot['ms']:.2f} ms (device {tot['device_ms']:.2f}), "
              f"bound {tot['bound_ms']:.3f}, yardstick {tot['yardstick_ms']:.2f} (device "
              f"{tot['yardstick_device_ms']:.2f}); engaged by hand_wgrad_shape: "
              f"{sum(r['per_step'] for r in eng)} a step, kernel "
              f"{sum(r['per_step'] * r['device_ms'] for r in eng):.2f} device-ms against the "
              f"yardstick's {sum(r['per_step'] * r['yardstick_device_ms'] for r in eng):.2f}",
              flush=True)
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "conv3d_wgrad.json").write_text(json.dumps(rows, indent=1))
    return rows


SMALL_IMG = (16, 32, 32)
LOSS_RTOL = 1e-5        # loss, kernels vs plain / CUDA vs CPU, relative
NORM_RTOL = 1e-4        # grad norm, CUDA vs CPU, relative
# Gradients are compared tensor by tensor, ‖Δg‖ ≤ rtol · ‖g‖, and as a
# whole; a tensor without its gradient, or with part of it, is off by ~1.
# Two correct f32 runs of one step differ too: when the forward's rounding
# changes (the image scaled by 1 + 1e-7), single tensors move by up to
# 4.4e-3 at full size and 7.7e-4 at 16×32×32, the whole gradient by up to
# 1.0e-4 and 5.0e-4 (`python -m deformablelka_tpu_torch.grad_floor`, seeds
# 0-2, H100 80GB HBM3). Each limit is over three times the largest reading.
GRAD_TENSOR_RTOL = 1.5e-2  # phase 7, full size, kernels vs plain versions
GRAD_RTOL = 1e-3           # phase 7, the whole gradient
SMALL_GRAD_TENSOR_RTOL = 3e-3  # phase 6, CUDA vs CPU
SMALL_GRAD_RTOL = 2e-3
PARAM_ATOL = 1e-5        # phase 6, the parameters after the step


def grad_rel(grads, ref):
    """The worst per-tensor ‖Δg‖/‖g‖ with its tensor, and the whole one."""
    rel = {n: (grads[n] - ref[n]).norm().item() / max(ref[n].norm().item(), 1e-30)
           for n in ref}
    worst = max(rel, key=rel.get)
    flat = lambda g: torch.cat([t.flatten() for t in g.values()])
    return worst, rel[worst], ((flat(grads) - flat(ref)).norm() / flat(ref).norm()).item()


def phase_small_train_step():
    """One training step on the card against the same step on the CPU."""
    out = {}
    for run, dev, scale in (("cuda", "cuda", 1.0), ("cpu", "cpu", 1.0),
                            ("cpu, image x (1 + 1e-7)", "cpu", 1 + 1e-7)):
        path = train_path.build(seed=0, img_size=SMALL_IMG, device=dev)
        path.image.mul_(scale)
        m = train_path.step(path)
        params = dict(path.model.named_parameters())
        out[run] = (float(m["loss"]), float(m["grad_norm"]),
                    {n: p.detach().cpu() for n, p in params.items()},
                    {n: p.grad.detach().cpu() for n, p in params.items()})
    (lk, nk, pk, gk), (lc, nc, pc, gc) = out["cuda"], out["cpu"]
    worst, worst_rel, whole = grad_rel(gk, gc)
    dp = max((pk[n] - pc[n]).abs().max().item() for n in pc)
    floor_worst, floor_rel, floor_whole = grad_rel(out["cpu, image x (1 + 1e-7)"][3], gc)
    print(f"phase 6 noise floor, CPU step with the image x (1 + 1e-7) vs CPU: "
          f"worst per-tensor ‖Δg‖/‖g‖ {floor_rel:.3e} ({floor_worst}), whole "
          f"gradient {floor_whole:.3e}", flush=True)
    print(f"phase 6 small train step {SMALL_IMG} B={TRAIN_BATCH}, deep "
          f"supervision, remat: loss CUDA {lk:.7f} CPU {lc:.7f} (rtol "
          f"{LOSS_RTOL}), grad norm CUDA {nk:.6f} CPU {nc:.6f} (rtol {NORM_RTOL}); "
          f"gradients over {len(gc)} tensors: worst ‖Δg‖/‖g‖ {worst_rel:.3e} "
          f"({worst}; max {SMALL_GRAD_TENSOR_RTOL}), whole {whole:.3e} (max "
          f"{SMALL_GRAD_RTOL}); parameters after the step max|Δ| {dp:.3e} (max "
          f"{PARAM_ATOL})", flush=True)
    if not (abs(lk - lc) <= LOSS_RTOL * abs(lc) and abs(nk - nc) <= NORM_RTOL * nc
            and worst_rel <= SMALL_GRAD_TENSOR_RTOL and whole <= SMALL_GRAD_RTOL
            and dp <= PARAM_ATOL):
        fail("the training step on the card disagrees with the CPU")


def phase_train_path():
    """The training path at full size, then step 1 through the plain versions."""
    path = train_path.build(seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, metrics, per_step = [], [], []
    grads_k = None
    for i in range(3):
        kernels.reset_launches()
        t0 = time.perf_counter()
        m = train_path.step(path)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_step.append(kernels.launch_counts())
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        if i == 0:
            grads_k = {n: p.grad.detach().clone()
                       for n, p in path.model.named_parameters()}
    peak = torch.cuda.max_memory_allocated()
    s_step = float(np.median(times[1:]))
    by_class = device_profile(lambda: train_path.step(path))["by_class"]
    bwd_device_ms = by_class["deform_conv3d_bwd (hand kernel)"]
    chain_bwd_device_ms = by_class["dw_chain3d_bwd (hand kernel)"]
    print(f"phase 7 training path B={TRAIN_BATCH} patch {train_path.PATCH}, remat, "
          f"deep supervision: {s_step:.4f} s/step (median of steps 2-3; steps "
          f"{', '.join(f'{t:.4f}' for t in times)} s), peak device memory "
          f"{peak / 2**30:.3f} GiB; losses {[round(l, 6) for l, _ in metrics]}, "
          f"grad norms {[round(n, 4) for _, n in metrics]}; launches per step "
          f"{per_step}; deform_conv3d_bwd {bwd_device_ms:.3f}, dw_chain3d_bwd "
          f"{chain_bwd_device_ms:.3f} device-ms per step (a fourth step under "
          "torch.profiler)", flush=True)
    for counts in per_step:
        if counts != train_path.LAUNCHES_PER_STEP:
            fail(f"training step launches {counts}, expected "
                 f"{train_path.LAUNCHES_PER_STEP}")
    if not all(np.isfinite(l) and np.isfinite(n) for l, n in metrics):
        fail("a training loss or grad norm is not finite")
    del path
    torch.cuda.empty_cache()

    def plain_step_1(scale):
        path = train_path.build(seed=0)
        path.image.mul_(scale)
        with plain_versions():
            t0 = time.perf_counter()
            m = train_path.step(path)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        grads = {n: p.grad.detach() for n, p in path.model.named_parameters()}
        del path
        torch.cuda.empty_cache()
        return float(m["loss"]), grads, wall

    loss_k = metrics[0][0]
    loss_p, grads_p, wall_plain = plain_step_1(1.0)
    worst, worst_rel, whole = grad_rel(grads_k, grads_p)
    _, grads_floor, _ = plain_step_1(1 + 1e-7)
    floor_worst, floor_rel, floor_whole = grad_rel(grads_floor, grads_p)
    del grads_floor
    finite = all(bool(torch.isfinite(g).all()) for g in grads_k.values())
    offset_grads = {n: grads_k[n].abs().max().item() for n in grads_k
                    if n.endswith("conv_offset.weight")}
    print(f"phase 7 noise floor, plain step 1 with the image x (1 + 1e-7) vs "
          f"plain step 1: worst per-tensor ‖Δg‖/‖g‖ {floor_rel:.3e} ({floor_worst}), "
          f"whole gradient {floor_whole:.3e}", flush=True)
    print(f"phase 7 step 1 vs plain versions ({wall_plain:.3f} s): loss "
          f"{loss_k:.7f} vs {loss_p:.7f} (rtol {LOSS_RTOL}); worst per-tensor "
          f"‖Δg‖/‖g‖ {worst_rel:.3e} ({worst}; max {GRAD_TENSOR_RTOL}), whole "
          f"gradient {whole:.3e} (max {GRAD_RTOL}) over {len(grads_p)} tensors; "
          f"gradients finite {finite}; conv_offset.weight gradients nonzero in "
          f"{sum(v > 0 for v in offset_grads.values())} of {len(offset_grads)} "
          f"blocks (smallest max|g| {min(offset_grads.values()):.3e})", flush=True)
    if abs(loss_k - loss_p) > LOSS_RTOL * abs(loss_p):
        fail("the training loss through the kernels disagrees with the plain run")
    if worst_rel > GRAD_TENSOR_RTOL or whole > GRAD_RTOL:
        fail(f"the gradient through the kernels disagrees with the plain run ({worst})")
    if not finite:
        fail("a gradient is not finite")
    if len(offset_grads) != BLOCKS or min(offset_grads.values()) <= 0:
        fail("a conv_offset.weight got no gradient")
    return per_step, s_step


def _offsets_2d(shape, g, reach=2.5):
    """Offsets uniform in ±reach on the card, a quarter of them exact
    integers (0 among them)."""
    off = (torch.rand(shape, device="cuda", generator=g) * 2 - 1) * reach
    pick = torch.rand(shape, device="cuda", generator=g)
    return torch.where(pick < 0.25, off.round(), off)


def _chain_row(x, g, sites: int, label: str = "") -> dict:
    """Kernel 5 on x (B, S, S, C) with seeded weights against its plain
    version: max|err| against the stated tolerance, its time and cuDNN's
    two depthwise `F.conv2d` in turns (CUDA events, then device time), the
    plain version's and the bound's. `sites`: its launches per forward of
    the LKA Baseline (the kernel line's sums)."""
    dev = x.device
    B, S, _, C = x.shape
    w5 = torch.randn(5, 5, 1, C, device=dev, generator=g) / 5
    b5 = torch.randn(C, device=dev, generator=g) * 0.1
    w7 = torch.randn(7, 7, 1, C, device=dev, generator=g) / 7
    b7 = torch.randn(C, device=dev, generator=g) * 0.1
    ref = chain2d_plain(x, w5, b5, w7, b7)
    got = kernels.dw_chain2d(x, w5, b5, w7, b7)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    tol = REL_TOL * max(1.0, ref.abs().max().item())
    # the kernel and the library call (two depthwise F.conv2d on NCHW
    # tensors) timed alike: CUDA events, then device time
    kernel = lambda: kernels.dw_chain2d(x, w5, b5, w7, b7)
    xn = to_nchw(x).contiguous()
    w5n, w7n = w5.permute(3, 2, 0, 1).contiguous(), w7.permute(3, 2, 0, 1).contiguous()
    library = lambda: F.conv2d(F.conv2d(xn, w5n, b5, padding=2, groups=C),
                               w7n, b7, padding=9, dilation=3, groups=C)
    ms, lms = timed_in_turns_ms(kernel, library, 20)
    dms = device_ms(kernel, 20, "dw_chain2d (hand kernel)")
    ldms = device_ms(library, 20)
    pms = timed_ms(lambda: chain2d_plain(x, w5, b5, w7, b7), 10)
    n_bytes = 4 * (2 * B * S * S * C + (25 + 49 + 2) * C)
    flops = B * S * S * C * 2 * (25 + 49)
    bnd = bound_ms(n_bytes, flops)
    bms, by = _bound(bnd)
    row = dict(S=S, C=C, sites=sites, err=err, tol=tol, ms=ms,
               plain_ms=pms, lib_ms=lms, device_ms=dms,
               lib_device_ms=ldms, **bnd)
    print(f"phase 8 {label}dw_chain2d B={B} {S}^2 C={C}: max|err| {err:.3e} (tol "
          f"{tol:.3e}), kernel {ms:.4f} ms ({dms:.4f} device), F.conv2d x2 "
          f"{lms:.4f} ms ({ldms:.4f} device): kernel/library {ms / lms:.3f} "
          f"({dms / ldms:.3f} device); plain {pms:.4f} ms, bound {bms:.4f} ms "
          f"({by}; bound / device time {bms / dms:.3f})", flush=True)
    if not err <= tol:
        fail(f"dw_chain2d disagrees with its plain version at {S}^2 C={C}")
    del xn, ref, got
    return row


def phase_2d_kernels():
    """The 2D kernels against their plain versions at the decoder shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2024)
    rows = {"deform_dw_conv2d": [], "dw_chain2d": []}
    B = BATCH_2D
    for S, C in DECODER:
        x = torch.randn(B, S, S, C, device=dev, generator=g)
        for k, dil in DEFORM_SITES:
            K = k * k
            off = _offsets_2d((B, S, S, 2 * K), g)
            w = torch.randn(k, k, 1, C, device=dev, generator=g) / k
            ref = deform2d_plain(x, off, w, dil)
            got = kernels.deform_dw_conv2d(x, off, w, dil)
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            tol = REL_TOL * max(1.0, ref.abs().max().item())
            kernel = lambda: kernels.deform_dw_conv2d(x, off, w, dil)
            ms = timed_ms(kernel, 20)
            dms = device_ms(kernel, 20, "deform_dw_conv2d (hand kernel)")
            pms = timed_ms(lambda: deform2d_plain(x, off, w, dil), 3, warmup=1)
            # yardstick: cuDNN's depthwise conv at Δ = 0, same k and dilation
            xn = to_nchw(x).contiguous()
            wn = w.permute(3, 2, 0, 1).contiguous()
            yms = timed_ms(lambda: F.conv2d(xn, wn, padding=(k // 2) * dil, dilation=dil,
                                            groups=C), 20)
            # read x, offsets and w once, write y once; per output value and
            # tap the 4-corner bilinear blend (4 FMA less the first add: 7
            # FLOP) and the tap weight (1 FMA)
            n_bytes = 4 * (B * S * S * (2 * C + 2 * K) + K * C)
            flops = B * S * S * C * K * 9
            bnd = bound_ms(n_bytes, flops)
            bms, by = _bound(bnd)
            rows["deform_dw_conv2d"].append(dict(S=S, C=C, k=k, sites=2, err=err, tol=tol,
                                                 ms=ms, plain_ms=pms, lib_ms=None,
                                                 device_ms=dms, yardstick_ms=yms, **bnd))
            print(f"phase 8 deform_dw_conv2d B={B} {S}^2 C={C} k={k} dil={dil}: max|err| "
                  f"{err:.3e} (tol {tol:.3e}), |Δ|>1 share "
                  f"{(off.abs() > 1).float().mean().item():.3f}, kernel {ms:.4f} ms "
                  f"(device {dms:.4f}), plain {pms:.4f} ms, bound {bms:.4f} ms ({by}), "
                  "library none (torchvision is not installed); yardstick, cuDNN's "
                  f"depthwise F.conv2d at Δ = 0 {yms:.4f} ms", flush=True)
            if not err <= tol:
                fail(f"deform_dw_conv2d disagrees with its plain version at {S}^2 C={C} k={k}")
            del off, ref, got, xn
        rows["dw_chain2d"].append(_chain_row(x, g, sites=2))
        del x
        torch.cuda.empty_cache()
    # DAE-LKA's decoder sites, held and timed alike; outside the LKA
    # Baseline's per-forward sums of the kernel line (sites 0)
    for S, C in DAE_LKA_DECODER:
        x = torch.randn(B, S, S, C, device=dev, generator=g)
        rows["dw_chain2d"].append(_chain_row(x, g, sites=0, label="DAE-LKA "))
        del x
        torch.cuda.empty_cache()
    return rows


def phase_2d_path():
    """Predictor2D on a seeded 40×512×512 case, both configurations, then
    the same case through the plain versions."""
    image = main_path2d.case(seed=0)
    S = image.shape[0]
    forwards = -(-S // BATCH_2D)
    launches, walls = {}, {}
    for config in main_path2d.FLAGSHIP:
        model, predictor = main_path2d.build(config, seed=0)
        offsets_seen = []
        with torch.no_grad():  # warm-up: one forward at the slice batch
            model(torch.zeros(BATCH_2D, *main_path2d.PATCH, 1, device="cuda"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        labels = predictor.predict_volume(image)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[config] = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        expected = {n: forwards * c for n, c in main_path2d.LAUNCHES_PER_FORWARD[config].items()}
        print(f"phase 9 2D path {config}: predict_volume {image.shape} at "
              f"{main_path2d.PATCH}, {forwards} forwards of {BATCH_2D}: {wall:.3f} s/case, "
              f"peak device memory {peak / 2**30:.3f} GiB, launches {launches[config]}",
              flush=True)
        if launches[config] != expected:
            fail(f"2D path {config} launches {launches[config]}, expected {expected}")
        if (labels.shape != image.shape or labels.min() < 0
                or labels.max() >= main_path2d.NUM_CLASSES):
            fail(f"bad labels {labels.shape} {labels.dtype}")
        hooks = [m.offset_net.register_forward_hook(
            lambda _m, _i, out: offsets_seen.append(out.abs().max().item()))
            for m in model.modules() if isinstance(m, DeformConv)]
        with plain_versions():
            t0 = time.perf_counter()
            labels_plain = predictor.predict_volume(image)
            torch.cuda.synchronize()
            wall_plain = time.perf_counter() - t0
        for h in hooks:
            h.remove()
        agree = float((labels == labels_plain).mean())
        print(f"phase 9 2D path {config} vs plain versions: label agreement {agree:.6f} "
              f"(min {MIN_AGREEMENT}), plain run {wall_plain:.3f} s; classes in labels "
              f"{np.unique(labels).size}"
              + (f"; offsets max|Δ| {max(offsets_seen):.3f}" if offsets_seen else ""),
              flush=True)
        if agree < MIN_AGREEMENT:
            fail(f"the 2D path {config} through the kernels disagrees with the plain versions")
        if config == "dlka" and max(offsets_seen) <= 1.0:
            fail("the 2D offsets never reached past ±1")
        walls[config] = wall
        del model, predictor
        torch.cuda.empty_cache()
    return launches, walls


def phase_2d_small_reference():
    """The 2D flagship on the card against the same model on the CPU."""
    img = 64
    models = {dev: main_path2d.build("dlka", seed=0, device=dev, img_size=img)[0]
              for dev in ("cuda", "cpu")}
    x = torch.from_numpy(np.random.RandomState(5).randn(2, img, img, 1).astype(np.float32))
    with torch.no_grad():
        ref = models["cpu"](x)
        got = models["cuda"](x.cuda()).cpu()
    err = (got - ref).abs().max().item()
    tol = 1e-3 * max(1.0, ref.abs().max().item())
    same = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
    print(f"phase 10 2D flagship {img}^2 B=2: CUDA model vs CPU model max|err| "
          f"{err:.3e} (tol {tol:.3e}), argmax equal on {same:.6f}, finite "
          f"{bool(torch.isfinite(got).all())}", flush=True)
    if not (err <= tol and torch.isfinite(got).all()):
        fail("the 2D CUDA model disagrees with the CPU model")


def phase_2d_latency():
    """Batch-1 224² latency of the flagship, f32: warm-up, then timed
    forwards (`bench.py:109-129` times a scan of 100 on the device)."""
    model, _ = main_path2d.build("dlka", seed=0)
    x = torch.zeros(1, *main_path2d.PATCH, 1, device="cuda")
    with torch.no_grad():
        device_ms = timed_ms(lambda: model(x), 100, warmup=10)
    mean, std = benchmark_inference_speed(model, main_path2d.PATCH, warmup=10, reps=100)
    print(f"phase 11 2D flagship batch 1 {main_path2d.PATCH} f32: {device_ms:.3f} ms per "
          f"forward (CUDA events over 100 back-to-back forwards); "
          f"{mean:.3f} ± {std:.3f} ms (host clock, synchronised, 100 reps)", flush=True)
    return device_ms


def in_volume_taps(S: int, K: int, dil: int) -> int:
    """Σ over the voxels of an S³ volume of the taps of a K³ dilated
    stencil that fall inside it: the multiply-adds the conv needs (a tap
    outside reads the zero padding)."""
    per_axis = sum(0 <= z + (k - K // 2) * dil < S for z in range(S) for k in range(K))
    return per_axis ** 3


def phase_dwconv3d_kernel():
    """The dilated depthwise kernel against its plain version at the
    size-aware gates' two shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1357)
    rows = []
    for S, C, K, dil, sites in DW_SITES:
        V = S ** 3
        x = torch.randn(BATCH, S, S, S, C, device=dev, generator=g)
        w = torch.randn(K, K, K, 1, C, device=dev, generator=g) / K ** 1.5
        b = torch.randn(C, device=dev, generator=g) * 0.1
        ref = dw_plain(x, w, b, dil)
        got = kernels.dwconv3d(x, w, b, dil)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        tol = REL_TOL * max(1.0, ref.abs().max().item())
        # the kernel through its wrapper and the library call (one depthwise
        # F.conv3d on an NCDHW tensor) timed alike: CUDA events over
        # back-to-back calls, where the host's time per call can set the
        # pace, then the device time alone under torch.profiler
        kernel = lambda: kernels.dwconv3d(x, w, b, dil)
        xn = to_ncdhw(x).contiguous()
        wn = w.permute(4, 3, 0, 1, 2).contiguous()
        library = lambda: F.conv3d(xn, wn, b, padding=dil * (K // 2), dilation=dil,
                                   groups=C)
        ms, lms = timed_in_turns_ms(kernel, library, 50)
        dms = device_ms(kernel, 50, "dwconv3d (hand kernel)")
        ldms = device_ms(library, 50)
        pms = timed_ms(lambda: dw_plain(x, w, b, dil), 50)
        # read x, w and b once, write y once; a multiply-add per channel for
        # each tap inside the volume, and the bias
        n_bytes = 4 * (2 * BATCH * V * C + K ** 3 * C + C)
        flops = BATCH * C * (2 * in_volume_taps(S, K, dil) + V)
        bnd = bound_ms(n_bytes, flops)
        bms, by = _bound(bnd)
        rows.append(dict(S=S, C=C, sites=sites, err=err, tol=tol, ms=ms,
                         plain_ms=pms, lib_ms=lms, device_ms=dms, lib_device_ms=ldms,
                         **bnd))
        print(f"phase 12 dwconv3d B={BATCH} {S}^3 C={C} K={K} dil={dil}: max|err| "
              f"{err:.3e} (tol {tol:.3e}), kernel {ms:.4f} ms through the wrapper "
              f"({dms:.4f} device), F.conv3d {lms:.4f} ms ({ldms:.4f} device): "
              f"kernel/library {ms / lms:.3f} ({dms / ldms:.3f} device); plain "
              f"{pms:.4f} ms, bound {bms:.4f} ms ({by}; taps inside the volume "
              f"{in_volume_taps(S, K, dil) / (V * K ** 3):.3f} of all)", flush=True)
        if not err <= tol:
            fail(f"dwconv3d disagrees with its plain version at {S}^3 C={C}")
        del x, xn, ref, got
        torch.cuda.empty_cache()
    return rows


def _expected_3d(forwards: int) -> dict:
    """Launches of a 3D path of the published block: 21 of each 3D forward
    kernel per forward, none of the others."""
    return {"deform_conv3d": BLOCKS * forwards, "dw_chain3d": BLOCKS * forwards}


def phase_synapse_cli():
    """Phase 15: `predict_simple` on a CT-like case with two folds, then
    the same predictor through the plain versions."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        case = case_path.write_case(tmp / "in")
        case_path.write_fold_checkpoints(tmp / "run")
        warm = dlka_former_synapse(case_path.NUM_CLASSES, do_ds=False, device="cuda")
        with torch.no_grad():  # warm-up: one batch-8 forward
            warm(torch.zeros(TTA_BATCH, *case_path.PATCH, 1, device="cuda"))
        del warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        predictor = predict_simple.main(case_path.predict_simple_argv(
            tmp / "in", tmp / "out", tmp / "run"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        info = dict(predictor.last_case)
        folds = len(predictor.engines)
        forwards = info["tiles"] * folds * (8 // TTA_BATCH)
        src, out = nifti.load(case), nifti.load(tmp / "out" / case.name)
        print(f"phase 15 Synapse CLI predict_simple: case {src.data.shape} {src.data.dtype} at "
              f"spacing {src.spacing} → preprocessed {info['preprocessed_shape']}, "
              f"{info['tiles']} tiles x {folds} folds x 8 flips ({forwards} batch-"
              f"{TTA_BATCH} forwards): {info['case_s']:.3f} s/case "
              f"({wall:.3f} s for main with the models' build and checkpoint loads); host: "
              f"preprocess {info['preprocess_s']:.3f} s, restore {info['restore_s']:.3f} s; "
              f"prediction (folds and fetch) {info['predict_s']:.3f} s; peak device memory "
              f"{peak / 2**30:.3f} GiB; launches {launches}", flush=True)
        if launches != _expected_3d(forwards):
            fail(f"Synapse CLI launches {launches}, expected {_expected_3d(forwards)}")
        if (out.data.shape != src.data.shape or not np.array_equal(out.affine, src.affine)
                or out.data.dtype != np.uint8 or out.data.max() >= case_path.NUM_CLASSES):
            fail(f"bad written labels {out.data.shape} {out.data.dtype} max {out.data.max()}")
        with plain_versions():
            t0 = time.perf_counter()
            seg_plain = predictor.predict_file(case, tmp / "plain.nii.gz")
            wall_plain = time.perf_counter() - t0
    agree = float((out.data == seg_plain).mean())
    print(f"phase 15 Synapse CLI vs plain versions: label agreement {agree:.6f} in the original "
          f"geometry (min {MIN_AGREEMENT}), plain run {wall_plain:.3f} s; classes in the "
          f"labels {np.unique(out.data).size}", flush=True)
    if agree < MIN_AGREEMENT:
        fail("the Synapse CLI through the kernels disagrees with the plain versions")
    del predictor
    torch.cuda.empty_cache()
    return launches, info["case_s"]


def pancreas_kernel_checks():
    """Kernels 1-2 against their plain versions at the Pancreas stage
    shapes, batch 1 (6³ is a partial tile of kernel 1; the chain's bands
    are taller than H at 12³ and 6³)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(97)
    for S, C in PANCREAS_STAGES:
        x = torch.randn(1, S, S, S, C, device=dev, generator=g)
        off = (torch.rand(1, S, S, S, 81, device=dev, generator=g) * 2 - 1) * 2.5
        w = torch.randn(3, 3, 3, C, C, device=dev, generator=g) / (27 * C) ** 0.5
        b = torch.randn(C, device=dev, generator=g) * 0.1
        err, tol = _deform_check(x, off, w, b, f"{S}^3 C={C} B=1, offsets in ±2.5")
        ms = timed_ms(lambda: kernels.deform_conv3d(x, off, w, b), 20)
        w5 = torch.randn(5, 5, 5, 1, C, device=dev, generator=g) / 125 ** 0.5
        w7 = torch.randn(7, 7, 7, 1, C, device=dev, generator=g) / 343 ** 0.5
        b5, b7 = (torch.randn(C, device=dev, generator=g) * 0.1 for _ in range(2))
        ref = chain_plain(x, w5, b5, w7, b7)
        got = kernels.dw_chain3d(x, w5, b5, w7, b7)
        torch.cuda.synchronize()
        cerr = (got - ref).abs().max().item()
        ctol = REL_TOL * max(1.0, ref.abs().max().item())
        cms = timed_ms(lambda: kernels.dw_chain3d(x, w5, b5, w7, b7), 20)
        print(f"phase 16 kernels at the Pancreas stage {S}^3 C={C} B=1: deform_conv3d max|err| "
              f"{err:.3e} (tol {tol:.3e}) {ms:.4f} ms; dw_chain3d max|err| {cerr:.3e} (tol "
              f"{ctol:.3e}) {cms:.4f} ms (plans' tiles: deform "
              f"{kernels.deform3d_plan(1, S, S, S, C, C).tile}, chain "
              f"{kernels.chain3d_plan(1, S, S, S, C).tile})", flush=True)
        if not cerr <= ctol:
            fail(f"dw_chain3d disagrees with its plain version at {S}^3 C={C} B=1")
        del x, off, ref, got
    torch.cuda.empty_cache()


def phase_pancreas_tester():
    """Phase 16: the Pancreas tester on a synthetic case, then its labels
    through the plain versions."""
    pancreas_kernel_checks()
    model = case_path.pancreas_model(seed=0)
    sw = pancreas.make_pancreas_sliding_window(
        model, patch_size=case_path.PANCREAS_PATCH, stride_xy=case_path.PANCREAS_STRIDE,
        stride_z=case_path.PANCREAS_STRIDE)
    case = case_path.pancreas_case(seed=0)
    padded = tuple(max(s, p) for s, p in zip(case[1].shape, case_path.PANCREAS_PATCH))
    tiles = len(sw.origins(padded))
    with torch.no_grad():  # warm-up: one forward at the tile batch
        model(torch.zeros(1, *case_path.PANCREAS_PATCH, 1, device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    labels, window_s = [], []
    single = pancreas.test_single_case

    def recorded(*args):
        t0 = time.perf_counter()
        out = single(*args)
        window_s.append(time.perf_counter() - t0)
        labels.append(out[0])
        return out

    t0 = time.perf_counter()
    with mock.patch.object(pancreas, "test_single_case", recorded):
        avg = pancreas.test_all_case(sw, [case], verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"phase 16 Pancreas tester: case {case[1].shape} padded to {padded}, patch "
          f"{case_path.PANCREAS_PATCH}, stride {case_path.PANCREAS_STRIDE}, {tiles} tiles "
          f"(batch-1 forwards): {wall:.3f} s/case, of it {window_s[0]:.3f} s the sliding "
          f"window (forwards, fetch, host argmax), the rest the host's metrics; peak "
          f"device memory {peak / 2**30:.3f} GiB; (dice, jaccard, hd95, asd) "
          f"{avg.tolist()}; foreground share {labels[0].mean():.4f}; launches {launches}",
          flush=True)
    if launches != _expected_3d(tiles):
        fail(f"Pancreas tester launches {launches}, expected {_expected_3d(tiles)}")
    if not (np.all(np.isfinite(avg)) and 0.0 <= avg[0] <= 1.0):
        fail(f"bad Pancreas metrics {avg}")
    with plain_versions():
        t0 = time.perf_counter()
        labels_plain, _ = pancreas.test_single_case(sw, case[1])
        wall_plain = time.perf_counter() - t0
    agree = float((labels[0] == labels_plain).mean())
    print(f"phase 16 Pancreas tester vs plain versions: label agreement {agree:.6f} (min "
          f"{MIN_AGREEMENT}), plain run {wall_plain:.3f} s", flush=True)
    if agree < MIN_AGREEMENT:
        fail("the Pancreas tester through the kernels disagrees with the plain versions")
    del model, sw
    torch.cuda.empty_cache()
    return launches, wall


def _to_device(batch) -> dict:
    """A host training batch on the card, as `Trainer3D` moves it."""
    return {"data": torch.from_numpy(batch["data"]).cuda(),
            "target": [torch.from_numpy(t).cuda().long() for t in batch["target"]]}


def _counts_agree(counts_k, counts_p, logits_k, logits_p) -> tuple:
    """(ok, flips): the online-eval tp/fp/fn of two runs agree, or every
    difference comes from voxels whose argmax differs between the runs at a
    near-tie of the plain run's top two logits (≤ 1e-4 · max|logit|); one
    such voxel moves the counts by at most 4 in all."""
    if all(np.array_equal(a, b) for a, b in zip(counts_k, counts_p)):
        return True, 0
    flips = logits_k.argmax(-1) != logits_p.argmax(-1)
    n = int(flips.sum())
    top2 = logits_p.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1])[flips]
    tol = 1e-4 * max(1.0, logits_p.abs().max().item())
    l1 = sum(float(np.abs(a - b).sum()) for a, b in zip(counts_k, counts_p))
    return n > 0 and bool((margin <= tol).all()) and l1 <= 4 * n, n


def synapse_first_step(batch):
    """Step 1 of the Synapse trainer (`make_ds_train_step`, the model as
    `run_training` builds it) on `batch`, through the kernels and through
    the plain versions: loss, update, online-eval counts."""
    out = {}
    for plain in (False, True):
        model = dlka_former_synapse(trainer_path.NUM_CLASSES, do_ds=True,
                                    img_size=trainer_path.PATCH, remat=True)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        lr = poly_lr(0, 1000, 1e-2)
        step = make_ds_train_step(model, make_sgd(model.parameters(), lr))
        b = _to_device(batch)
        with plain_versions() if plain else contextlib.nullcontext():
            with torch.no_grad():
                logits = model(b["data"])[0]
            kernels.reset_launches()
            t0 = time.perf_counter()
            m = step(b, lr)
            loss = float(m["loss"])
            wall = time.perf_counter() - t0
            launches = kernels.launch_counts()
        out[plain] = dict(loss=loss, wall=wall, launches=launches, logits=logits,
                          counts=[m[k].cpu().numpy() for k in ("tp", "fp", "fn")],
                          update={n: p.detach() - before[n]
                                  for n, p in model.named_parameters()})
        del model, before, step, b
        torch.cuda.empty_cache()
    k, p = out[False], out[True]
    worst, worst_rel, whole = grad_rel(k["update"], p["update"])
    agree, flips = _counts_agree(k["counts"], p["counts"], k["logits"], p["logits"])
    print(f"phase 17 Synapse trainer step 1 vs plain versions ({p['wall']:.3f} s): loss "
          f"{k['loss']:.7f} vs {p['loss']:.7f} (rtol {LOSS_RTOL}); update p' - p over "
          f"{len(p['update'])} tensors: worst ‖Δu‖/‖u‖ {worst_rel:.3e} ({worst}; max "
          f"{GRAD_TENSOR_RTOL}), whole {whole:.3e} (max {GRAD_RTOL}); tp/fp/fn "
          f"{'equal' if not flips and agree else f'differ at {flips} argmax flips'}; "
          f"launches {k['launches']}", flush=True)
    if abs(k["loss"] - p["loss"]) > LOSS_RTOL * abs(p["loss"]):
        fail("the trainer's loss through the kernels disagrees with the plain run")
    if worst_rel > GRAD_TENSOR_RTOL or whole > GRAD_RTOL:
        fail(f"the trainer's update through the kernels disagrees with the plain run ({worst})")
    if not agree:
        fail("the trainer's tp/fp/fn through the kernels disagree with the plain run")
    if k["launches"] != trainer_path.LAUNCHES_PER_STEP:
        fail(f"step 1 launches {k['launches']}, expected {trainer_path.LAUNCHES_PER_STEP}")


def _seconds(xs) -> str:
    return "[" + ", ".join(f"{x:.3f}" for x in xs) + "]"


def phase_synapse_trainer():
    """Phase 17: the Synapse trainer through `run_training.main`: step 1
    against the plain versions, 2 epochs, `-val`, `-c`."""
    native.num_threads()
    if not native.HAVE_NATIVE:
        fail("the native resampler did not build (g++ -fopenmp): the augmentation "
             "would run on scipy")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        pre = tmp / "pre"
        t0 = time.perf_counter()
        cases = trainer_path.write_preprocessed(pre)
        print(f"phase 17 Synapse trainer: {len(cases)} synthetic preprocessed cases of "
              f"{trainer_path.CASE_SHAPE} written in {time.perf_counter() - t0:.3f} s; "
              f"native resampler built, {native.num_threads()} OpenMP threads", flush=True)
        batch = trainer_path.synchronous_batch(pre)
        synapse_first_step(batch)

        argv = trainer_path.run_training_argv(pre, tmp / "out")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with trainer_path.Recorder() as rec:
            trainer = run_training.main(argv)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        t, launches = rec.times, rec.launches
        steps = trainer_path.EPOCHS * trainer_path.TRAIN_BATCHES
        print(f"phase 17 Synapse trainer run_training B={trainer_path.BATCH} patch "
              f"{trainer_path.PATCH}, remat, moreDA in {run_training.NUM_WORKERS} threads, "
              f"{trainer_path.EPOCHS} epochs x ({trainer_path.TRAIN_BATCHES} + "
              f"{trainer_path.VAL_BATCHES}) batches: {float(np.median(t['step'][1:])):.4f} "
              f"s/step (median after the first; steps {_seconds(t['step'])}); waits on the "
              f"prefetch queue {_seconds(t['wait'])} s; host seconds per training batch in "
              f"one worker thread (over the {len(t['augment'])} the workers made): load "
              f"median {float(np.median(t['load'])):.3f}, augment median "
              f"{float(np.median(t['augment'])):.3f} mean {float(np.mean(t['augment'])):.3f} "
              f"max {max(t['augment']):.3f}; per validation batch: load "
              f"{float(np.median(t['load_val'])):.3f}, augment "
              f"{float(np.median(t['augment_val'])):.3f}; epochs {_seconds(t['epoch'])} s; checkpoint "
              f"writes {_seconds(t['checkpoint_write'])} s; {wall:.3f} s for main with the "
              f"model's build; peak device memory {peak / 2**30:.3f} GiB; losses "
              f"{[round(l, 6) for l in trainer.all_tr_losses]}, val "
              f"{[round(l, 6) for l in trainer.all_val_losses]}, global Dice "
              f"{[round(d, 6) for d in trainer.all_val_eval_metrics]}", flush=True)
        if len(t["step"]) != steps or any(c != trainer_path.LAUNCHES_PER_STEP
                                          for c in launches["step"]):
            fail(f"training step launches {launches['step']}, expected "
                 f"{steps} x {trainer_path.LAUNCHES_PER_STEP}")
        if any(c != trainer_path.LAUNCHES_PER_VAL_BATCH for c in launches["val_batch"]):
            fail(f"validation batch launches {launches['val_batch']}, expected "
                 f"{trainer_path.LAUNCHES_PER_VAL_BATCH}")
        if not (trainer.epoch == trainer_path.EPOCHS and trainer.step == steps
                and np.all(np.isfinite(trainer.all_tr_losses + trainer.all_val_losses))):
            fail(f"bad training bookkeeping: epoch {trainer.epoch} step {trainer.step}")
        run_launches = _summed(launches["step"] + launches["val_batch"])

        # -val: every validation case, then one of them through the plain versions
        kernels.reset_launches()
        t0 = time.perf_counter()
        validator = run_training.main(argv + ["-val"])
        torch.cuda.synchronize()
        wall_val = time.perf_counter() - t0
        val_launches = kernels.launch_counts()
        val_dir = validator.output_folder / "validation"
        val_cases = sorted(run_training.split_cases(load_dataset(pre))[1])
        model = validator.model
        sw = SlidingWindowInference(lambda x: model(x)[0], patch_size=trainer_path.PATCH,
                                    num_classes=trainer_path.NUM_CLASSES, step_size=0.5,
                                    tta_batch=TTA_BATCH, input_dtype=torch.bfloat16)
        tiles = len(sw.origins(trainer_path.CASE_SHAPE))
        summary = json.loads((val_dir / "summary.json").read_text())
        dice = [summary["results"]["mean"][str(c)]["Dice"]
                for c in range(1, trainer_path.NUM_CLASSES)]
        print(f"phase 17 Synapse -val: {len(val_cases)} cases of {trainer_path.CASE_SHAPE}, "
              f"{tiles} tiles x 8 flips each (batch-{TTA_BATCH} forwards): {wall_val:.3f} s "
              f"for main with the model's build, the predictions, summary.json and "
              f"postprocessing.json; launches {val_launches} "
              f"({ {n: c // len(val_cases) for n, c in val_launches.items()} } per case); "
              f"mean foreground Dice "
              f"{np.nanmean(dice):.4f}", flush=True)
        if val_launches != _expected_3d(tiles * len(val_cases)):
            fail(f"-val launches {val_launches}, expected "
                 f"{_expected_3d(tiles * len(val_cases))}")
        if not ((val_dir / "postprocessing.json").exists()
                and len(summary["results"]["all"]) == len(val_cases)):
            fail("-val did not write its summary and postprocessing decision")
        data, _ = load_case(load_dataset(pre)[val_cases[0]])
        vol = np.moveaxis(np.asarray(data[:-1], np.float32), 0, -1)
        with plain_versions():
            t0 = time.perf_counter()
            seg_plain = sw.predict_segmentation(vol)
            wall_plain = time.perf_counter() - t0
        seg = np.load(val_dir / f"{val_cases[0]}.npz")["data"]
        agree = float((seg == seg_plain).mean())
        print(f"phase 17 Synapse -val vs plain versions on {val_cases[0]}: label agreement "
              f"{agree:.6f} (min {MIN_AGREEMENT}), plain run {wall_plain:.3f} s", flush=True)
        if agree < MIN_AGREEMENT:
            fail("-val through the kernels disagrees with the plain versions")
        del validator, model, sw

        # -c: model_latest (written every 50 epochs; here by the trainer's own
        # save), then one more epoch
        trainer.save_checkpoint("model_latest")
        trainer.ckpt.wait_until_finished()
        t0 = time.perf_counter()
        resumed = run_training.main(trainer_path.run_training_argv(
            pre, tmp / "out", "-c", epochs=trainer_path.EPOCHS + 1))
        wall_c = time.perf_counter() - t0
        ok = (resumed.epoch == trainer_path.EPOCHS + 1
              and resumed.step == steps + trainer_path.TRAIN_BATCHES
              and resumed.all_tr_losses[:-1] == trainer.all_tr_losses)
        print(f"phase 17 Synapse -c: resumed at epoch {trainer.epoch}, step {trainer.step}; "
              f"ended at epoch {resumed.epoch}, step {resumed.step} in {wall_c:.3f} s; "
              f"restored losses {'equal' if ok else 'differ'}", flush=True)
        if not ok:
            fail("-c did not resume from model_latest")
        del resumed
        augmenter_contention(trainer, pre, batch)
        del trainer
    torch.cuda.empty_cache()
    return run_launches, val_launches


def augmenter_contention(trainer, pre, batch):
    """s/step of `trainer` on one fixed batch, with the CLI's training
    augmenter (4 threads) running beside it and with none, in turns
    (none, running, running, none; 3 steps each)."""
    train, _ = run_training.split_cases(load_dataset(pre))
    times = {"none": [], "running": []}
    for mode in ("none", "running", "running", "none"):
        gen = None
        if mode == "running":
            loader, transform = run_training.make_pipeline(
                train, trainer_path.PATCH, trainer_path.BATCH, 99, True, "moreDA",
                run_training.deep_supervision_scales(trainer_path.STEM))
            gen = ThreadedAugmenter(loader, transform, num_workers=run_training.NUM_WORKERS)
            time.sleep(1.0)  # the workers under way
        for _ in range(3):
            t0 = time.perf_counter()
            trainer.train_batch(batch)
            times[mode].append(time.perf_counter() - t0)
        if gen is not None:
            gen.stop()
            for thread in gen.threads:
                thread.join()
    print(f"phase 17 Synapse trainer step on one batch, in turns: "
          f"{float(np.median(times['none'])):.4f} s/step with no augmenter thread "
          f"{_seconds(times['none'])}, {float(np.median(times['running'])):.4f} with the "
          f"training augmenter's {run_training.NUM_WORKERS} threads running "
          f"{_seconds(times['running'])}", flush=True)


def pancreas_backward_checks() -> list:
    """Kernel 3 against its plain version at the Pancreas stage shapes,
    batch 2 (its trainer's), offsets in ±2.5."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(98)
    rows = []
    for S, C in PANCREAS_STAGES:
        B, V = 2, S ** 3
        x = torch.randn(B, S, S, S, C, device=dev, generator=g)
        off = (torch.rand(B, S, S, S, 81, device=dev, generator=g) * 2 - 1) * 2.5
        w = torch.randn(3, 3, 3, C, C, device=dev, generator=g) / (27 * C) ** 0.5
        gy = torch.randn(B, S, S, S, C, device=dev, generator=g)
        ref = deform_bwd_plain(x, off, w, gy)
        got = kernels.deform_conv3d_bwd(x, off, w, gy)
        torch.cuda.synchronize()
        report = {}
        ok = all([_rel_close(n, a, r, report)
                  for n, a, r in zip(("dx", "doff", "dw"), got, ref)])
        del got, ref
        ms = timed_ms(lambda: kernels.deform_conv3d_bwd(x, off, w, gy), 10)
        n_bytes = 4 * (B * V * (C + 81 + C) + 27 * C * C + B * V * (C + 81) + 27 * C * C)
        bms, by = _bound(bound_ms(n_bytes, B * V * 27 * (4 * C * C + 48 * C + 48)))
        plan = kernels.deform3d_bwd_plan(B, S, S, S, C, C)
        rows.append(dict(S=S, C=C, ms=ms, bound_ms=bms))
        errs = ", ".join(f"{n} {e:.3e} (tol {t:.3e})" for n, (e, t) in report.items())
        print(f"phase 18 deform_conv3d_bwd at the Pancreas stage {S}^3 C={C} B={B}: "
              f"max|err| {errs}; kernel {ms:.4f} ms, bound {bms:.4f} ms ({by}); plan grid "
              f"{plan.grid}, GEMM parts {plan.parts}", flush=True)
        if not ok:
            fail(f"deform_conv3d_bwd disagrees with its plain version at {S}^3 C={C} B={B}")
        del x, off, w, gy
    torch.cuda.empty_cache()
    return rows


def pancreas_first_iteration(tmp: Path):
    """Iteration 1 of the Pancreas trainer through the kernels and through
    the plain versions (there with remat, which gives the same values: the
    plain deform conv's autograd would hold tens of GB at 48³ otherwise)."""
    out = {}
    for plain in (False, True):
        model = trainer_path.pancreas_model()
        if plain:
            for m in model.modules():
                if hasattr(m, "remat"):
                    m.remat = True
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        trainer = TrainerPancreas(model, tmp / f"first_{plain}", max_iterations=1,
                                  batch_size=trainer_path.BATCH,
                                  labeled_bs=trainer_path.PANCREAS_LABELED)
        trainer.initialize()
        batch = trainer_path.pancreas_loader().next_batch()
        with plain_versions() if plain else contextlib.nullcontext():
            t0 = time.perf_counter()
            loss = float(trainer.train_step(batch["data"], batch["target"])["loss"])
            wall = time.perf_counter() - t0
        out[plain] = (loss, wall, {n: p.detach() - before[n]
                                   for n, p in model.named_parameters()})
        del model, before, trainer
        torch.cuda.empty_cache()
    (loss_k, _, upd_k), (loss_p, wall_p, upd_p) = out[False], out[True]
    worst, worst_rel, whole = grad_rel(upd_k, upd_p)
    print(f"phase 18 Pancreas trainer iteration 1 vs plain versions ({wall_p:.3f} s): loss "
          f"{loss_k:.7f} vs {loss_p:.7f} (rtol {LOSS_RTOL}); update over {len(upd_p)} "
          f"tensors: worst ‖Δu‖/‖u‖ {worst_rel:.3e} ({worst}; max {GRAD_TENSOR_RTOL}), "
          f"whole {whole:.3e} (max {GRAD_RTOL})", flush=True)
    if abs(loss_k - loss_p) > LOSS_RTOL * abs(loss_p):
        fail("the Pancreas trainer's loss through the kernels disagrees with the plain run")
    if worst_rel > GRAD_TENSOR_RTOL or whole > GRAD_RTOL:
        fail(f"the Pancreas trainer's update disagrees with the plain run ({worst})")


def phase_pancreas_trainer():
    """Phase 18: kernel 3 at the Pancreas stages, the Pancreas trainer, then
    the Pancreas tester on its checkpoint."""
    rows = pancreas_backward_checks()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        pancreas_first_iteration(tmp)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer, record = trainer_path.train_pancreas(tmp / "run")
        peak = torch.cuda.max_memory_allocated()
        secs = [s for s, _, _ in record]
        per_iteration = [c for _, _, c in record]
        print(f"phase 18 Pancreas trainer B={trainer_path.BATCH} patch "
              f"{case_path.PANCREAS_PATCH}, labeled_bs {trainer_path.PANCREAS_LABELED}, "
              f"{len(record)} iterations: {float(np.median(secs[1:])):.4f} s/iteration "
              f"(median after the first; {_seconds(secs)}), peak device memory "
              f"{peak / 2**30:.3f} GiB; losses {[round(l, 6) for _, l, _ in record]}; "
              f"launches per iteration {per_iteration[0]}", flush=True)
        if any(c != trainer_path.PANCREAS_LAUNCHES_PER_ITERATION for c in per_iteration):
            fail(f"Pancreas iteration launches {per_iteration}, expected "
                 f"{trainer_path.PANCREAS_LAUNCHES_PER_ITERATION}")
        if not np.all(np.isfinite([l for _, l, _ in record])):
            fail("a Pancreas training loss is not finite")
        kernels.reset_launches()
        t0 = time.perf_counter()
        avg = trainer_path.test_pancreas_checkpoint(tmp / "run")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        print(f"phase 18 Pancreas tester on d_lka_former_iter_{trainer_path.PANCREAS_ITERATIONS}: "
              f"{wall:.3f} s with the model's build and checkpoint load; (dice, jaccard, "
              f"hd95, asd) {avg.tolist()}; launches {launches}", flush=True)
        if launches != _expected_3d(9):
            fail(f"Pancreas tester launches {launches}, expected {_expected_3d(9)}")
        if not (np.all(np.isfinite(avg)) and 0.0 <= avg[0] <= 1.0):
            fail(f"bad Pancreas metrics {avg}")
        del trainer
    torch.cuda.empty_cache()
    return _summed(per_iteration), rows


# phase 19's offset scales: a trained checkpoint's (|Δ| ≤ 0.034, PERF.md
# §7), the kernels' usual test scale, the driven gates' (|Δ| up to 5-8)
BWD_2D_REACHES = (0.05, 2.5, 8.0)


def _sm_clock() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def _bwd_2d_clocks(kernel, label):
    """The two clocks of one wrapper call: CUDA events over 10 back-to-back
    calls, then torch.profiler over 10 more (every kernel the call issues:
    the zero fills of dx and d-offset, the data kernel, the sum of dw's
    parts), then the events again; the SM clock before each."""
    clock_a = _sm_clock()
    ev_ms = timed_ms(kernel, 10)
    clock_b = _sm_clock()
    prof = device_profile(lambda: [kernel() for _ in range(10)])
    ev_after = timed_ms(kernel, 10)
    kernels_ms = {name: ms / 10 for name, ms in prof["by_name"].items()}
    listing = ", ".join(f"{name[:60]} {ms:.4f}" for name, ms in
                        sorted(kernels_ms.items(), key=lambda kv: -kv[1]))
    print(f"phase 19 clocks {label}: CUDA events {ev_ms:.4f} ms a call (SM clock {clock_a}), "
          f"again after the profiler {ev_after:.4f}; torch.profiler (SM clock {clock_b}): "
          f"wall {prof['wall_ms'] / 10:.4f} ms a call, device busy "
          f"{prof['device_busy_ms'] / 10:.4f}, kernels {sum(kernels_ms.values()):.4f} "
          f"({listing})", flush=True)
    return prof["by_class"]["deform_dw_conv2d_bwd (hand kernel)"] / 10


def phase_2d_backward_kernel():
    """Phase 19: the 2D deform backward kernel against autograd of the
    plain forward at the six decoder sites, batch 24, at three offset
    scales (`BWD_2D_REACHES`); timed at each, the two clocks read at ±2.5."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2025)
    rows = []
    B = trainer2d_path.BATCH
    for S, C in DECODER:
        x = torch.randn(B, S, S, C, device=dev, generator=g)
        gy = torch.randn(B, S, S, C, device=dev, generator=g)
        for k, dil in DEFORM_SITES:
            K = k * k
            w = torch.randn(k, k, 1, C, device=dev, generator=g) / k
            by_reach = {}
            for reach in BWD_2D_REACHES:
                off = _offsets_2d((B, S, S, 2 * K), g, reach)
                ref = deform2d_bwd_plain(x, off, w, gy, dil)
                got = kernels.deform_dw_conv2d_bwd(x, off, w, gy, dil)
                torch.cuda.synchronize()
                report = {}
                ok = all([_rel_close(n, a, r, report)
                          for n, a, r in zip(("dx", "doff", "dw"), got, ref)])
                del got, ref
                kernel = lambda: kernels.deform_dw_conv2d_bwd(x, off, w, gy, dil)
                errs = ", ".join(f"{n} {e:.3e} (tol {t:.3e})" for n, (e, t) in report.items())
                if not ok:
                    print(f"phase 19 deform_dw_conv2d_bwd B={B} {S}^2 C={C} k={k} dil={dil} "
                          f"offsets in ±{reach}: max|err| {errs}", flush=True)
                    fail(f"deform_dw_conv2d_bwd disagrees with its plain version at {S}^2 "
                         f"C={C} k={k}, offsets in ±{reach}")
                if reach != 2.5:
                    by_reach[reach] = (timed_ms(kernel, 10), max(e for e, _ in report.values()),
                                       errs)
                    del off
                    continue
                label = f"B={B} {S}^2 C={C} k={k} dil={dil}"
                dms = _bwd_2d_clocks(kernel, label)
                ms = timed_ms(kernel, 10)
                cms = cold_ms(kernel)
                pms = timed_ms(lambda: deform2d_bwd_plain(x, off, w, gy, dil), 2, warmup=1)
                err, errs_25 = max(e for e, _ in report.values()), errs
                del off
            # yardstick: cuDNN's depthwise data and weight gradients at Δ = 0
            xn, gn = to_nchw(x).contiguous(), to_nchw(gy).contiguous()
            wn = w.permute(3, 2, 0, 1).contiguous()
            pad = (k // 2) * dil
            yms = timed_ms(lambda: (
                torch.nn.grad.conv2d_input(xn.shape, wn, gn, padding=pad, dilation=dil, groups=C),
                torch.nn.grad.conv2d_weight(xn, wn.shape, gn, padding=pad, dilation=dil,
                                            groups=C)), 10)
            # read x, offsets, w, g once; write dx, d-offset, dw once. Per
            # pixel, tap and channel: the 4-corner blend and its two
            # derivatives (3 × 7), g·w (1), the dw product (2), the two
            # offset dot products (4), the 4 dx contributions (4); per
            # pixel and tap the 12 corner coefficients (24)
            n_bytes = 4 * (B * S * S * (2 * C + 2 * K) + K * C + B * S * S * (C + 2 * K) + K * C)
            flops = B * S * S * K * (32 * C + 24)
            bnd = bound_ms(n_bytes, flops)
            bms, by = _bound(bnd)
            small_ms, small_err, small_errs = by_reach[0.05]
            large_ms, large_err, large_errs = by_reach[8.0]
            rows.append(dict(S=S, C=C, k=k, sites=2, err=max(err, small_err, large_err), ms=ms,
                             plain_ms=pms, lib_ms=None, device_ms=dms, yardstick_ms=yms,
                             small_offset_ms=small_ms, large_offset_ms=large_ms,
                             cold_ms=cms, **bnd))
            print(f"phase 19 deform_dw_conv2d_bwd B={B} {S}^2 C={C} k={k} dil={dil}: max|err| "
                  f"{errs_25}; kernel {ms:.4f} ms (device {dms:.4f}; each call alone after the "
                  f"L2 cache is flushed {cms:.4f}), plain {pms:.4f} ms, bound "
                  f"{bms:.4f} ms ({by}), library none (no PyTorch call computes this "
                  f"backward); yardstick, cuDNN's depthwise conv2d_input + conv2d_weight at "
                  f"Δ = 0 {yms:.4f} ms; offsets in ±0.05 {small_ms:.4f} ms (max|err| "
                  f"{small_errs}), in ±8 {large_ms:.4f} ms (max|err| {large_errs})", flush=True)
            del w, xn, gn
        del x, gy
        torch.cuda.empty_cache()
    return rows


# Phase 20's gates on the 2D flagship's first update, kernels vs plain
# versions, ‖Δu‖ ≤ rtol · ‖u‖ per tensor and as a whole. Two correct plain
# steps differ by up to 2.588e-4 per tensor and 2.246e-6 as a whole (the
# image scaled by 1 + 1e-7, or the batch's samples swapped; the kernels
# against plain 1.511e-4 and 1.98e-6: `python -m
# deformablelka_tpu_torch.grad_floor --two_d`, seeds 0-2, H100 80GB HBM3,
# 700 W); each gate is over three times the largest reading.
GRAD2D_TENSOR_RTOL = 1e-3
GRAD2D_RTOL = 1e-5


def _first_update_2d(batch, config="dlka", patch=None, scale=1.0):
    """(loss, update p' − p, gradients, seconds) of step 1 of `config`'s
    Trainer2D from the CLI's seed on `batch`, the wrappers patched by the
    context `patch` (or not), the image scaled by `scale`."""
    with tempfile.TemporaryDirectory() as tmp:
        trainer = trainer2d_path.step_trainer(tmp, config)
    params = dict(trainer.model.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    b = dict(batch, image=batch["image"] * np.float32(scale))
    with patch if patch is not None else contextlib.nullcontext():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(trainer.train_step(b))
        wall = time.perf_counter() - t0
    out = (loss, {n: p.detach() - before[n] for n, p in params.items()},
           {n: p.grad.detach().clone() for n, p in params.items()}, wall)
    del trainer, before, params
    torch.cuda.empty_cache()
    return out


def _train_steps_2d(batch, config, steps=3):
    """`steps` steps of `config`'s Trainer2D on `batch`: (seconds, losses,
    launches, per step), the trainer and the peak device memory."""
    tmp = tempfile.TemporaryDirectory()
    trainer = trainer2d_path.step_trainer(tmp.name, config)
    tmp.cleanup()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, losses, per_step = [], [], []
    for _ in range(steps):
        kernels.reset_launches()
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(batch)))
        times.append(time.perf_counter() - t0)
        per_step.append(kernels.launch_counts())
    return times, losses, per_step, trainer, torch.cuda.max_memory_allocated()


def _bwd_2d_on_step_inputs(trainer, batch) -> float:
    """The 2D backward kernel on one training step's own inputs: each of the
    step's 12 calls captured, then timed alone (CUDA events, 10 calls),
    beside its offsets' statistics and whether it took 16-byte accesses.
    Returns the sum over the calls, ms."""
    real = kernels.deform_dw_conv2d_bwd
    captured = []

    def capture(x, offset, w, g, dil=1):
        captured.append(tuple(t.detach().clone() for t in (x, offset, w, g)) + (dil,))
        return real(x, offset, w, g, dil)

    with mock.patch.object(kernels, "deform_dw_conv2d_bwd", capture):
        trainer.train_step(batch)
    total = 0.0
    for x, off, w, g, dil in captured:
        ms = timed_ms(lambda: real(x, off, w, g, dil), 10)
        total += ms
        a = off.abs()
        print(f"phase 20 deform_dw_conv2d_bwd on the step's inputs {tuple(x.shape)} k={w.shape[0]} "
              f"dil={dil}: {ms:.4f} ms; |Δ| max {a.max().item():.3f}, mean "
              f"{a.mean().item():.4f}, ≤ 0.05 {(a <= 0.05).float().mean().item():.3f}, integer "
              f"{(off == off.round()).float().mean().item():.3f}; 16-byte aligned "
              f"{all(t.data_ptr() % 16 == 0 for t in (x, g))}", flush=True)
    del captured
    torch.cuda.empty_cache()
    return total


def phase_2d_train_step():
    """Phase 20: the flagship's Trainer2D step at full size, step 1 against
    the plain versions and the noise floor, one step through `_PlainVjp`."""
    batch = trainer2d_path.synthetic_batch(0)
    times, losses, per_step, trainer, peak = _train_steps_2d(batch, "dlka")
    bwd_device_ms = device_profile(lambda: trainer.train_step(batch))["by_class"][
        "deform_dw_conv2d_bwd (hand kernel)"]
    bwd_inputs_ms = _bwd_2d_on_step_inputs(trainer, batch)
    del trainer
    torch.cuda.empty_cache()
    s_step = float(np.median(times[1:]))
    print(f"phase 20 2D flagship Trainer2D step B={trainer2d_path.BATCH} "
          f"{trainer2d_path.IMG}^2, {trainer2d_path.NUM_CLASSES} classes: {s_step:.4f} s/step "
          f"(median of steps 2-3; steps {_seconds(times)} s), peak device memory "
          f"{peak / 2**30:.3f} GiB; losses {[round(l, 6) for l in losses]}; launches per "
          f"step {per_step[0]}; deform_dw_conv2d_bwd {bwd_device_ms:.3f} device-ms per step "
          f"(a fourth step under torch.profiler), {bwd_inputs_ms:.3f} ms on a fifth step's "
          "inputs, each call timed alone", flush=True)
    if any(c != trainer2d_path.LAUNCHES_PER_STEP["dlka"] for c in per_step):
        fail(f"2D training step launches {per_step}, expected "
             f"{trainer2d_path.LAUNCHES_PER_STEP['dlka']}")
    if not np.all(np.isfinite(losses)):
        fail("a 2D training loss is not finite")
    loss_k, upd_k, grads_k, _ = _first_update_2d(batch)
    loss_p, upd_p, _, wall_p = _first_update_2d(batch, patch=plain_versions())
    _, upd_f, _, _ = _first_update_2d(batch, patch=plain_versions(), scale=1 + 1e-7)
    # the forward kernel with the recomputed plain VJP (what `_PlainVjp`
    # did): the training path before the backward kernel
    _, _, _, wall_vjp = _first_update_2d(
        batch, patch=mock.patch.object(kernels, "deform_dw_conv2d_bwd", deform2d_bwd_plain))
    worst, worst_rel, whole = grad_rel(upd_k, upd_p)
    floor_worst, floor_rel, floor_whole = grad_rel(upd_f, upd_p)
    finite = all(bool(torch.isfinite(g).all()) for g in grads_k.values())
    offset_grads = {n: grads_k[n].abs().max().item() for n in grads_k
                    if n.endswith("offset_net.weight")}
    print(f"phase 20 noise floor, plain step 1 with the image x (1 + 1e-7) vs plain step 1: "
          f"worst per-tensor ‖Δu‖/‖u‖ {floor_rel:.3e} ({floor_worst}), whole update "
          f"{floor_whole:.3e}", flush=True)
    print(f"phase 20 step 1 vs plain versions ({wall_p:.3f} s): loss {loss_k:.7f} vs "
          f"{loss_p:.7f} (rtol {LOSS_RTOL}); update p' - p over {len(upd_p)} tensors: worst "
          f"‖Δu‖/‖u‖ {worst_rel:.3e} ({worst}; max {GRAD2D_TENSOR_RTOL}), whole {whole:.3e} "
          f"(max {GRAD2D_RTOL}); gradients finite {finite}; offset_net.weight gradients "
          f"nonzero in {sum(v > 0 for v in offset_grads.values())} of {len(offset_grads)} "
          f"deform convs (smallest max|g| {min(offset_grads.values()):.3e}); one step with "
          f"the forward kernel and the recomputed plain VJP (_PlainVjp) {wall_vjp:.3f} s",
          flush=True)
    if abs(loss_k - loss_p) > LOSS_RTOL * abs(loss_p):
        fail("the 2D training loss through the kernels disagrees with the plain run")
    if worst_rel > GRAD2D_TENSOR_RTOL or whole > GRAD2D_RTOL:
        fail(f"the 2D update through the kernels disagrees with the plain run ({worst})")
    if not finite:
        fail("a 2D gradient is not finite")
    if len(offset_grads) != 12 or min(offset_grads.values()) <= 0:
        fail("an offset_net.weight got no gradient")
    return per_step, s_step


def _synapse2d_cli(tmp: Path) -> dict:
    """`train_synapse2d.main` on the 2D path's slices, the eval hook on its
    volumes; then the test CLI's volume function on `best_model`, through
    the kernels and the plain versions."""
    t0 = time.perf_counter()
    trainer2d_path.write_slices(tmp / "slices", tmp / "lists")
    cases = trainer2d_path.volumes(1)
    print(f"phase 21 Synapse 2D: {trainer2d_path.BATCH * trainer2d_path.TRAIN_BATCHES} "
          f"synthetic {trainer2d_path.SLICE}^2 slices and {len(cases)} volumes of "
          f"{trainer2d_path.VOLUME} made in {time.perf_counter() - t0:.3f} s", flush=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with trainer2d_path.Recorder() as rec:
        trainer = train_synapse2d.main(
            trainer2d_path.synapse_argv(tmp / "slices", tmp / "lists", tmp / "out"),
            eval_cases=cases)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t = rec.times
    steps = trainer2d_path.EPOCHS * trainer2d_path.TRAIN_BATCHES
    dice = [d for _, d in trainer.eval_results]
    print(f"phase 21 Synapse 2D train_synapse2d B={trainer2d_path.BATCH} "
          f"{trainer2d_path.IMG}^2, {trainer2d_path.EPOCHS} epochs x "
          f"{trainer2d_path.TRAIN_BATCHES} batches: {float(np.median(t['step'][1:])):.4f} "
          f"s/step (median after the first; steps {_seconds(t['step'])}); host seconds per "
          f"batch, loaded and augmented in the training thread: {_seconds(t['batch'])}; "
          f"epochs {_seconds(trainer.epoch_times)} s; checkpoint writes "
          f"{_seconds(t['checkpoint_write'])} s; eval hook (epoch, mean Dice) "
          f"{trainer.eval_results}; {wall:.3f} s for main with the model's build; peak "
          f"device memory {peak / 2**30:.3f} GiB; losses {[round(l, 6) for l in trainer.losses]}; "
          f"launches per step {rec.launches[0]}", flush=True)
    if len(rec.launches) != steps or any(c != trainer2d_path.LAUNCHES_PER_STEP["dlka"]
                                         for c in rec.launches):
        fail(f"train_synapse2d step launches {rec.launches}")
    if not (len(dice) == 1 and trainer.eval_results[0][0] == trainer2d_path.EPOCHS
            and np.isfinite(dice[0]) and 0.0 <= dice[0] <= 1.0):
        fail(f"bad eval hook results {trainer.eval_results}")
    if not ((tmp / "out" / "ckpt" / "best_model").is_dir()
            and np.all(np.isfinite(trainer.losses)) and trainer.step == steps):
        fail("train_synapse2d did not train or write best_model")
    step_launches = _summed(rec.launches)
    del trainer

    predictor = test_synapse2d.load_predictor(tmp / "out")
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = test_synapse2d.evaluate_volumes(predictor, cases)
    wall = time.perf_counter() - t0
    test_launches = kernels.launch_counts()
    # the labels alone through the plain versions (the host's surface
    # metrics of a barely trained model's labels take ~39 s a volume)
    with plain_versions():
        t0 = time.perf_counter()
        labels_p = [predictor.predict_volume(image) for image, _, _ in cases]
        wall_p = time.perf_counter() - t0
    agree = min(float((r[3] == lp).mean()) for r, lp in zip(res, labels_p))
    forwards = len(cases) * -(-trainer2d_path.VOLUME[0] // BATCH_2D)
    expected = {"deform_dw_conv2d": 12 * forwards}
    print(f"phase 21 Synapse 2D test CLI (evaluate_volumes) on best_model: {wall:.3f} s for "
          f"{len(cases)} volumes, mean Dice {[round(r[1], 4) for r in res]}, launches "
          f"{test_launches}; vs plain versions ({wall_p:.3f} s): label agreement {agree:.6f} "
          f"(min {MIN_AGREEMENT})", flush=True)
    if test_launches != expected:
        fail(f"test CLI launches {test_launches}, expected {expected}")
    if agree < MIN_AGREEMENT:
        fail("the test CLI's labels through the kernels disagree with the plain versions")
    del predictor
    torch.cuda.empty_cache()
    return step_launches, cases


def _zoo_clis(tmp: Path, cases) -> dict:
    """The CLIs' `--model`: `train_synapse2d --model dae_lka` (1 epoch of 2
    batches), the test CLI's volume function on its `best_model` (the same
    volumes) through the kernels and the plain versions, `train_skin
    --model transunet --evaluate` (1 epoch of 2 batches). Returns the
    launches by path."""
    out = {}
    want = trainer2d_path.LAUNCHES_PER_STEP["dae_lka"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with trainer2d_path.Recorder() as rec:
        trainer = train_synapse2d.main(trainer2d_path.synapse_argv(
            tmp / "slices", tmp / "lists", tmp / "zoo_out", "--model", "dae_lka", epochs=1))
    t = rec.times
    print(f"phase 21 train_synapse2d --model dae_lka B={trainer2d_path.BATCH} "
          f"{trainer2d_path.IMG}^2, 1 epoch x {trainer2d_path.TRAIN_BATCHES} batches: steps "
          f"{_seconds(t['step'])} s; host seconds per batch {_seconds(t['batch'])}; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; losses "
          f"{[round(l, 6) for l in trainer.losses]}; launches per step {rec.launches}",
          flush=True)
    if (len(rec.launches) != trainer2d_path.TRAIN_BATCHES
            or any(c != want for c in rec.launches)):
        fail(f"train_synapse2d --model dae_lka step launches {rec.launches}, expected {want}")
    if not ((tmp / "zoo_out" / "ckpt" / "best_model").is_dir()
            and np.all(np.isfinite(trainer.losses))):
        fail("train_synapse2d --model dae_lka did not train or write best_model")
    out["train_synapse2d --model dae_lka, 1 epoch of 2 batches"] = _summed(rec.launches)
    del trainer

    predictor = test_synapse2d.load_predictor(tmp / "zoo_out", model="dae_lka")
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = test_synapse2d.evaluate_volumes(predictor, cases)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    with plain_versions():
        labels_p = [predictor.predict_volume(image) for image, _, _ in cases]
    agree = min(float((r[3] == lp).mean()) for r, lp in zip(res, labels_p))
    forwards = len(cases) * -(-trainer2d_path.VOLUME[0] // BATCH_2D)
    expected = {"dw_chain2d": main_path2d.LAUNCHES_PER_FORWARD["dae_lka"]["dw_chain2d"] * forwards}
    print(f"phase 21 test_synapse2d --model dae_lka (evaluate_volumes) on best_model: "
          f"{wall:.3f} s for {len(cases)} volume(s) of {trainer2d_path.VOLUME}, mean Dice "
          f"{[round(r[1], 4) for r in res]}, launches {launches}; label agreement with the "
          f"plain versions {agree:.6f} (min {MIN_AGREEMENT})", flush=True)
    if launches != expected:
        fail(f"test CLI --model dae_lka launches {launches}, expected {expected}")
    if agree < MIN_AGREEMENT:
        fail("the dae_lka test CLI's labels through the kernels disagree with the plain run")
    out[f"test_synapse2d --model dae_lka, {len(cases)} volume"] = launches
    del predictor
    torch.cuda.empty_cache()

    root = tmp / "skin"
    if not (root / "data_train.npy").exists():
        trainer2d_path.write_skin(root)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with trainer2d_path.Recorder() as rec:
        trainer = train_skin.main(trainer2d_path.skin_argv(
            root, tmp / "skin_transunet", "--model", "transunet", epochs=1))
    best = trainer.test_metrics["best"]
    metrics = {k: best[k] for k in ("dsc", "accuracy", "specificity", "sensitivity")}
    print(f"phase 21 train_skin --model transunet B={trainer2d_path.SKIN_BATCH} "
          f"{trainer2d_path.IMG}^2 RGB, 1 class, 1 epoch of "
          f"{trainer2d_path.SKIN_SPLITS[0] // trainer2d_path.SKIN_BATCH} batches: steps "
          f"{_seconds(rec.times['step'])} s; best val loss {trainer.best_val_loss:.6f}; test "
          f"{metrics}; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} "
          f"GiB; launches per step {rec.launches}", flush=True)
    if any(rec.launches):
        fail(f"train_skin --model transunet launched a hand kernel: {rec.launches}")
    if not ((tmp / "skin_transunet" / "best_model").is_dir()
            and np.isfinite(trainer.best_val_loss)
            and np.all(np.isfinite(list(metrics.values())))):
        fail("train_skin --model transunet did not write its best checkpoint or its "
             "metrics are not finite")
    out["train_skin --model transunet, 1 epoch of 2 batches"] = _summed(rec.launches)
    del trainer
    torch.cuda.empty_cache()
    return out


def _lka_baseline_step():
    """The LKA Baseline's (`--no_deform`) Trainer2D step: 3 steps, then step
    1 against the plain versions."""
    batch = trainer2d_path.synthetic_batch(1)
    times, losses, per_step, trainer, peak = _train_steps_2d(batch, "lka_baseline")
    del trainer
    torch.cuda.empty_cache()
    loss_k = _first_update_2d(batch, "lka_baseline")[0]
    loss_p = _first_update_2d(batch, "lka_baseline", patch=plain_versions())[0]
    print(f"phase 21 LKA Baseline (--no_deform) Trainer2D step B={trainer2d_path.BATCH}: "
          f"{float(np.median(times[1:])):.4f} s/step (steps {_seconds(times)}), peak device "
          f"memory {peak / 2**30:.3f} GiB, launches per step {per_step[0]}; step 1 loss "
          f"{loss_k:.7f} vs plain {loss_p:.7f} (rtol {LOSS_RTOL})", flush=True)
    if any(c != trainer2d_path.LAUNCHES_PER_STEP["lka_baseline"] for c in per_step):
        fail(f"LKA Baseline step launches {per_step}")
    if not (np.all(np.isfinite(losses)) and abs(loss_k - loss_p) <= LOSS_RTOL * abs(loss_p)):
        fail("the LKA Baseline's loss through the kernels disagrees with the plain run")
    return _summed(per_step)


def _skin_cli(tmp: Path) -> dict:
    root = trainer2d_path.write_skin(tmp / "skin")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with trainer2d_path.Recorder() as rec:
        trainer = train_skin.main(trainer2d_path.skin_argv(root, tmp / "skin_out"))
    peak = torch.cuda.max_memory_allocated()
    t = rec.times
    best = trainer.test_metrics["best"]
    metrics = {k: best[k] for k in ("dsc", "accuracy", "specificity", "sensitivity")}
    print(f"phase 21 skin train_skin B={trainer2d_path.SKIN_BATCH} {trainer2d_path.IMG}^2 "
          f"RGB, 1 class, {trainer2d_path.EPOCHS} epochs of "
          f"{trainer2d_path.SKIN_SPLITS[0] // trainer2d_path.SKIN_BATCH} batches: "
          f"{float(np.median(t['step'][1:])):.4f} s/step (steps {_seconds(t['step'])}); "
          f"epochs with validation {_seconds(trainer.epoch_times)} s; checkpoint writes "
          f"{_seconds(t['checkpoint_write'])} s; best val loss {trainer.best_val_loss:.6f}, "
          f"plateau scale {trainer.scheduler.scale}; test {metrics}; peak device memory "
          f"{peak / 2**30:.3f} GiB; launches per step {rec.launches[0]}", flush=True)
    if any(c != trainer2d_path.LAUNCHES_PER_STEP["dlka"] for c in rec.launches):
        fail(f"skin step launches {rec.launches}")
    if not ((tmp / "skin_out" / "best_model").is_dir() and np.isfinite(trainer.best_val_loss)
            and trainer.scheduler.scale == 1.0 and np.all(np.isfinite(list(metrics.values())))):
        fail("train_skin did not write its best checkpoint or its metrics are not finite")
    return _summed(rec.launches)


def phase_2d_clis():
    """Phase 21: train_synapse2d, the test CLI's volume function, the LKA
    Baseline's step and train_skin; then the same CLIs with `--model`."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        synapse, cases = _synapse2d_cli(tmp)
        baseline = _lka_baseline_step()
        skin = _skin_cli(tmp)
        zoo = _zoo_clis(tmp, cases)
    torch.cuda.empty_cache()
    return synapse, baseline, skin, zoo


# the zoo's narrow widths for phase 22's card-against-CPU forward (224², as
# the CPU tests `tests/test_torch_zoo_*.py` hold them against the JAX package)
ZOO_NARROW = {
    "daeformer": lambda: DAEFormer(9, dims=(32, 64, 128), layers=(1, 1, 1)),
    "dae_lka": lambda: DAELKAFormer(9, dims=(32, 64, 128), layers=(1, 1, 1)),
    "mvit_lka": lambda: MViTLKAFormer(9, embed_dim=16),
    "dat_lka": lambda: DATLKAFormer(9, dims=(24, 48, 96, 192), depths=(2, 2, 2, 2)),
    "stvit_lka": lambda: STVitLKA(9, embed_dim=24, num_heads=(1, 2, 4, 8)),
    "semantic_stvit": lambda: SemanticSTViT(9, embed_dim=24, depths=(2, 2, 6, 2, 2, 2, 2),
                                            num_heads=(1, 2, 4, 8, 4, 2, 1)),
    "bidaeformer": lambda: BiDAEFormer(9, dims=(64, 96, 128), depths=(1, 1, 1)),
    "swinunet": lambda: SwinUNet(9, embed_dim=16, num_heads=(1, 2, 4, 8)),
    "segformer": lambda: SegFormer(9, dims=(16, 32, 40, 64), layers=(1, 1, 1, 1),
                                   embed_dim=32),
    "transunet": lambda: TransUNet(9, apply_sigmoid=False, hidden=64, num_layers=2, heads=4,
                                   mlp_dim=128, block_units=(1, 1, 1), width_factor=0.5),
    "hiformer": lambda: HiFormer(9, swin_dims=(32, 64, 128), cnn_dims=(16, 32, 64),
                                 cnn_blocks=(1, 1, 1), swin_depths=(2, 2, 2),
                                 swin_heads=(1, 2, 4), dlf_heads=(2, 2)),
}
ZOO_CPU_RTOL = 1e-3   # card vs CPU, max|Δ| / max(1, max|CPU|), TF32 off
# phase 22's step 1 against the plain chain: (each tensor's update, the
# whole update) relative, over three times the floors that `grad_floor.py
# --two_d --model NAME` measured, seeds 0-2 (plain runs with the image ×
# (1 + 1e-7) or the batch swapped; H100 80GB HBM3, 700 W): dae_lka 1.728e-4 /
# 2.715e-6, stvit_lka 4.678e-5 / 1.374e-6 (phase 20's 2D gates), dat_lka
# 8.208e-4 / 2.732e-6, mvit_lka 1.053e-3 / 7.301e-6. A tensor whose update
# is ≤ `grad_floor.NOISE_SHARE` of the whole's is rounding noise (an
# exactly zero gradient on a zero parameter) and held by the whole only.
ZOO_UPDATE_GATES = {"dae_lka": (1e-3, 1e-5), "stvit_lka": (1e-3, 1e-5),
                    "dat_lka": (3e-3, 1e-5), "mvit_lka": (4e-3, 3e-5)}


def _zoo_card_vs_cpu(name) -> tuple:
    """The narrow model on the card against itself on the CPU, batch 2."""
    model = ZOO_NARROW[name]()
    init_parameters(model, torch.Generator().manual_seed(0))
    main_path2d.drive_gates_2d(model, 11)
    model.eval()
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 224, 224, 1).astype(np.float32))
    with torch.no_grad():
        ref = model(x)
        got = model.cuda()(x.cuda()).cpu()
    return (got - ref).abs().max().item() / max(1.0, ref.abs().max().item()), \
        bool(torch.isfinite(got).all())


def _forward_ms(model, x, reps: int = 5) -> float:
    """The median of `reps` forwards after one warm call, CUDA events."""
    times = []
    with torch.no_grad():
        model(x)
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            model(x)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_2d_zoo() -> dict:
    """Phase 22: the 11 zoo models on the card. Returns the launches by
    path (the forwards, the training steps)."""
    fwd_launches, step_launches = {}, {}
    batch = trainer2d_path.synthetic_batch(0)
    x = torch.from_numpy(batch["image"]).cuda()
    for name in main_path2d.ZOO:
        t_start = time.perf_counter()
        err, finite = _zoo_card_vs_cpu(name)
        print(f"phase 22 {name} narrow, 224^2 B=2: card vs CPU max|Δ|/max(1, max|CPU|) "
              f"{err:.3e} (tol {ZOO_CPU_RTOL}), finite {finite}", flush=True)
        if not (err <= ZOO_CPU_RTOL and finite):
            fail(f"{name} on the card disagrees with the CPU")
        model, _ = main_path2d.build(name, seed=0)
        n_params = sum(p.numel() for p in model.parameters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = _forward_ms(model, x)
        peak = torch.cuda.max_memory_allocated()
        kernels.reset_launches()
        with torch.no_grad():
            labels = model(x).argmax(-1)
        launches = kernels.launch_counts()
        expected = main_path2d.LAUNCHES_PER_FORWARD[name]
        fwd_launches[name] = launches
        agree = None
        if expected:
            with plain_versions(), torch.no_grad():
                agree = float((model(x).argmax(-1) == labels).float().mean())
        print(f"phase 22 {name} full width ({n_params / 1e6:.2f} M parameters) 224^2 "
              f"B={x.shape[0]}: {ms:.3f} ms per forward (median of 5 after a warm call), "
              f"peak device memory {peak / 2**30:.3f} GiB, launches per forward {launches}"
              + ("" if agree is None else f"; labels vs the plain chain {agree:.6f} (min "
                 f"{MIN_AGREEMENT})"), flush=True)
        if launches != expected:
            fail(f"{name} forward launches {launches}, expected {expected}")
        if agree is not None and agree < MIN_AGREEMENT:
            fail(f"{name}'s labels through the chain kernel disagree with the plain chain")
        del model, labels
        torch.cuda.empty_cache()

        times, losses, per_step, trainer, peak = _train_steps_2d(batch, name)
        del trainer
        torch.cuda.empty_cache()
        step_launches[name] = _summed(per_step)
        print(f"phase 22 {name} Trainer2D B={trainer2d_path.BATCH} "
              f"{trainer2d_path.IMG}^2: {float(np.median(times[1:])):.4f} s/step (median of "
              f"steps 2-3; steps {_seconds(times)} s), peak device memory "
              f"{peak / 2**30:.3f} GiB, losses {[round(l, 6) for l in losses]}, launches per "
              f"step {per_step[0]}", flush=True)
        if any(c != trainer2d_path.LAUNCHES_PER_STEP[name] for c in per_step):
            fail(f"{name} step launches {per_step}")
        if not np.all(np.isfinite(losses)):
            fail(f"a {name} training loss is not finite")
        if expected:
            # the 2D gates hold the update p' - p, as phase 20: a gradient
            # whose exact value is 0 (the keys' bias under the softmax over
            # tokens) differs by up to 1.2 relative between two correct runs
            # (`grad_floor.py --two_d --model dae_lka`)
            loss_k, upd_k, grads_k, _ = _first_update_2d(batch, name)
            loss_p, upd_p, grads_p, _ = _first_update_2d(batch, name, patch=plain_versions())
            # a tensor whose update is rounding noise (an exactly zero
            # gradient on a zero parameter, as MViT's `norm_k.bias` under
            # the softmax) is held by the whole update only
            share = {n: (u.norm() / torch.cat([t.flatten() for t in upd_p.values()]).norm()
                         ).item() for n, u in upd_p.items()}
            noise = sorted(n for n in share if share[n] <= NOISE_SHARE)
            _, _, whole = grad_rel(upd_k, upd_p)
            worst, worst_rel, _ = grad_rel({n: upd_k[n] for n in upd_p if n not in noise},
                                           {n: u for n, u in upd_p.items() if n not in noise})
            g_worst, g_rel, g_whole = grad_rel(grads_k, grads_p)
            held = min(v for n, v in share.items() if n not in noise)
            tensor_rtol, whole_rtol = ZOO_UPDATE_GATES[name]
            print(f"phase 22 {name} step 1 vs the plain chain: loss {loss_k:.7f} vs "
                  f"{loss_p:.7f} (rtol {LOSS_RTOL}); update p' - p over {len(upd_p)} tensors: "
                  f"worst ‖Δu‖/‖u‖ {worst_rel:.3e} ({worst}; max {tensor_rtol}), "
                  f"whole {whole:.3e} (max {whole_rtol}); {len(noise)} tensors of noise "
                  f"(‖u‖/‖U‖ ≤ {max((share[n] for n in noise), default=0):.2e}; the smallest "
                  f"held {held:.2e}){': ' + ', '.join(noise[:3]) + ' …' if noise else ''}; "
                  f"gradients (not gated): worst {g_rel:.3e} ({g_worst}), whole {g_whole:.3e}",
                  flush=True)
            if abs(loss_k - loss_p) > LOSS_RTOL * abs(loss_p):
                fail(f"{name}'s training loss through the chain kernel disagrees")
            if worst_rel > tensor_rtol or whole > whole_rtol:
                fail(f"{name}'s update through the chain kernel disagrees ({worst})")
            del upd_k, upd_p, grads_k, grads_p
            torch.cuda.empty_cache()
        print(f"phase 22 {name}: {time.perf_counter() - t_start:.1f} s", flush=True)
    return {"2D zoo, one forward of each of the 11": _summed(fwd_launches.values()),
            "2D zoo Trainer2D, 3 steps of each of the 11": _summed(step_launches.values())}


# the baselines' narrow widths for phase 23's card-against-CPU forward (32³,
# as tests/test_torch_pancreas_baselines.py holds them against the JAX package)
BASELINE_NARROW = {
    "vnet": lambda: VNet(n_classes=2, n_filters=4),
    "resnet34": lambda: Resnet34Seg(n_classes=2),
    "unetr": lambda: UNETR(n_classes=2, img_size=(32, 32, 32), hidden=48, heads=4,
                           mlp_dim=96, feature_size=4),
}
GENERIC_UNET_NARROW = dict(base_num_features=8, max_features=32)


def _no_launches(counts: dict) -> bool:
    """No launch of the D-LKA block's kernels; kernel 7 (`conv3d_wgrad`, the
    dense convs' weight gradient) serves any 3D model's training."""
    return not any(n for name, n in counts.items() if name != "conv3d_wgrad")


def _baseline_card_vs_cpu(name) -> tuple:
    """The narrow baseline on the card against itself on the CPU, batch 2."""
    model = BASELINE_NARROW[name]()
    init_parameters(model, torch.Generator().manual_seed(0))
    model.eval()
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 32, 32, 32, 1).astype(np.float32))
    with torch.no_grad():
        ref = model(x)
        kernels.reset_launches()
        got = model.cuda()(x.cuda()).cpu()
    return (got - ref).abs().max().item() / max(1.0, ref.abs().max().item()), \
        bool(torch.isfinite(got).all()), kernels.launch_counts()


def _generic_unet_step(batch, device, scale=1.0) -> tuple:
    """(loss, update p' - p per tensor on the host, launches) of one
    `make_ds_train_step` of the narrow 2D GenericUNet from seed 0 on
    `batch`, the image × `scale`."""
    model = _build(GenericUNet(len(baselines_path.RAW_LABELS), ndim=2, num_pool=5,
                               **GENERIC_UNET_NARROW), 0, device)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    lr = poly_lr(0, 1000, 1e-2)
    step = make_ds_train_step(model, make_sgd(model.parameters(), lr))
    b = {"data": torch.from_numpy(batch["data"] * np.float32(scale)).to(device),
         "target": [torch.from_numpy(t).to(device).long() for t in batch["target"]]}
    kernels.reset_launches()
    loss = float(step(b, lr)["loss"])
    return loss, {n: (p.detach() - before[n]).cpu()
                  for n, p in model.named_parameters()}, kernels.launch_counts()


def _pancreas_baseline(name) -> dict:
    """Phase 23's Pancreas part for one baseline; its launches by path."""
    err, finite, launches = _baseline_card_vs_cpu(name)
    print(f"phase 23 {name} narrow, 32^3 B=2: card vs CPU max|Δ|/max(1, max|CPU|) "
          f"{err:.3e} (tol {ZOO_CPU_RTOL}), finite {finite}, launches {launches}", flush=True)
    if not (err <= ZOO_CPU_RTOL and finite and _no_launches(launches)):
        fail(f"{name} on the card disagrees with the CPU (or launched a hand kernel)")
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer, record = trainer_path.train_pancreas(Path(tmp), model=name)
        peak = torch.cuda.max_memory_allocated()
    n_params = sum(p.numel() for p in trainer.model.parameters())
    secs = [s for s, _, _ in record]
    losses = [l for _, l, _ in record]
    per_iteration = [c for _, _, c in record]
    print(f"phase 23 {name} ({n_params / 1e6:.2f} M parameters) TrainerPancreas "
          f"B={trainer_path.BATCH} patch {case_path.PANCREAS_PATCH}, labeled_bs "
          f"{trainer_path.PANCREAS_LABELED}, {len(record)} iterations: "
          f"{float(np.median(secs[1:])):.4f} s/iteration (median after the first; "
          f"{_seconds(secs)}), peak device memory {peak / 2**30:.3f} GiB; losses "
          f"{[round(l, 6) for l in losses]}; launches per iteration {per_iteration[0]}",
          flush=True)
    if not all(_no_launches(c) for c in per_iteration):
        fail(f"{name}'s training launched a hand kernel: {per_iteration}")
    if not np.all(np.isfinite(losses)):
        fail(f"a {name} training loss is not finite")
    sw = pancreas.make_pancreas_sliding_window(
        trainer.model.eval(), patch_size=case_path.PANCREAS_PATCH,
        stride_xy=case_path.PANCREAS_STRIDE, stride_z=case_path.PANCREAS_STRIDE)
    case = case_path.pancreas_case(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    avg = pancreas.test_all_case(sw, [case], verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tester = kernels.launch_counts()
    print(f"phase 23 {name} Pancreas tester, trained model, {case[1].shape} stride "
          f"{case_path.PANCREAS_STRIDE}: {wall:.3f} s/case with the host's metrics, peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; (dice, "
          f"jaccard, hd95, asd) {avg.tolist()}; launches {tester}", flush=True)
    if not _no_launches(tester):
        fail(f"{name}'s tester launched a hand kernel: {tester}")
    if not (np.all(np.isfinite(avg)) and 0.0 <= avg[0] <= 1.0):
        fail(f"bad {name} Pancreas metrics {avg}")
    del trainer, sw
    torch.cuda.empty_cache()
    return _summed(per_iteration + [tester])


def _generic_unet_2d() -> dict:
    """Phase 23's GenericUNet part: raw data → plans → `run_training 2d`;
    its launches."""
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        baselines_path.write_raw_task(tmp / "raw")
        plans, plan_secs = baselines_path.plan(tmp / "raw", tmp / "pre")
        shapes = {p.stem: np.load(p)["data"].shape for p in sorted((tmp / "pre").glob("*.npz"))}
        print(f"phase 23 plan_and_preprocess: 3 raw cases {baselines_path.RAW_SHAPE} at "
              f"spacings {baselines_path.RAW_SPACINGS}: {plan_secs:.3f} s of host; stage 0 "
              f"{plans['plans_per_stage'][0]}; preprocessed {shapes}", flush=True)
        batch = baselines_path.synchronous_batch_2d(tmp / "pre")
        loss_k, upd_k, launches = _generic_unet_step(batch, "cuda")
        loss_c, upd_c, _ = _generic_unet_step(batch, "cpu")
        _, upd_f, _ = _generic_unet_step(batch, "cpu", 1 + 1e-7)
        _, _, whole = grad_rel(upd_k, upd_c)
        _, _, f_whole = grad_rel(upd_f, upd_c)
        # a conv's bias under an instance norm has an exactly zero gradient:
        # its update is the weight decay plus rounding noise, held by the
        # whole update only
        held = lambda upd: {n: u for n, u in upd.items() if not n.endswith(".conv.bias")}
        worst, worst_rel, _ = grad_rel(held(upd_k), held(upd_c))
        f_worst, f_rel, _ = grad_rel(held(upd_f), held(upd_c))
        tensor_gate = max(GRAD_TENSOR_RTOL, 3 * f_rel)
        whole_gate = max(GRAD_RTOL, 3 * f_whole)
        print(f"phase 23 GenericUNet 2D narrow ({GENERIC_UNET_NARROW}) step on the CLI's "
              f"first batch {batch['data'].shape}: loss card {loss_k:.7f} CPU {loss_c:.7f} "
              f"(rtol {LOSS_RTOL}); update p' - p over {len(held(upd_c))} of {len(upd_c)} tensors "
              f"(the biases under instance norms held by the whole): worst ‖Δu‖/‖u‖ "
              f"{worst_rel:.3e} ({worst}; max {tensor_gate:.3e}), whole {whole:.3e} (max "
              f"{whole_gate:.3e}); CPU floor, image x (1 + 1e-7): {f_rel:.3e} ({f_worst}), "
              f"whole {f_whole:.3e}; launches {launches}", flush=True)
        if abs(loss_k - loss_c) > LOSS_RTOL * abs(loss_c):
            fail("GenericUNet's loss on the card disagrees with the CPU")
        if worst_rel > tensor_gate or whole > whole_gate:
            fail(f"GenericUNet's update on the card disagrees with the CPU ({worst})")
        if not _no_launches(launches):
            fail(f"GenericUNet's step launched a hand kernel: {launches}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with trainer_path.Recorder() as rec:
            trainer = run_training.main(baselines_path.run_training_2d_argv(
                tmp / "pre", tmp / "out"))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        t = rec.times
        steps, vals = rec.launches["step"], rec.launches["val_batch"]
        losses = trainer.all_tr_losses + trainer.all_val_losses
        n_params = sum(p.numel() for p in trainer.model.parameters())
        print(f"phase 23 run_training 2d, GenericUNet ({n_params / 1e6:.2f} M parameters), "
              f"patch {baselines_path.PATCH_2D} B=2, 1 epoch of {len(steps)} batches + "
              f"{len(vals)} validation batch: steps {_seconds(t['step'])} s "
              f"({float(np.median(t['step'][1:])):.4f} s/step after the first), validation "
              f"{_seconds(t['val_batch'])} s, queue waits {_seconds(t['wait'])} s, host "
              f"seconds per batch: load {_seconds(t['load'])}, augment "
              f"{_seconds(t['augment'])}; {wall:.3f} s with the CLI's set-up; peak device "
              f"memory {peak / 2**30:.3f} GiB; losses {losses}; launches per step "
              f"{steps[0]}, per validation batch {vals[0]}", flush=True)
        if not all(_no_launches(c) for c in steps + vals):
            fail(f"run_training 2d launched a hand kernel: {steps} {vals}")
        if len(steps) != baselines_path.BATCHES_2D or not np.all(np.isfinite(losses)):
            fail(f"run_training 2d: {len(steps)} steps, losses {losses}")
        del trainer
    torch.cuda.empty_cache()
    return _summed(steps + vals)


def phase_baselines() -> dict:
    """Phase 23: the Pancreas baselines and GenericUNet 2D; their launches
    by path (all 0)."""
    t_start = time.perf_counter()
    out = {f"Pancreas {name}, 6 iterations + tester":
           _pancreas_baseline(name) for name in baselines_path.BASELINES}
    out["run_training 2d, 2 + 1 batches"] = _generic_unet_2d()
    print(f"phase 23: {time.perf_counter() - t_start:.1f} s", flush=True)
    return out


def _meshed_volume(mesh, seg_one_device) -> dict:
    """Phase 24 (a): the main path through the meshed engine, timed in
    turns with the one-device engine on the same model; its launches a
    volume."""
    model, sw_one = main_path.build(seed=0)
    sw = SlidingWindowInference(model, patch_size=PATCH, num_classes=main_path.NUM_CLASSES,
                                step_size=0.5, do_mirroring=True, tta_batch=8, mesh=mesh)
    vol = main_path.volume(seed=0)
    with torch.no_grad():  # warm-up: one batch-8 forward
        model(torch.zeros(8, *PATCH, 1, device="cuda"))
    walls, counts, equal = {"mesh": [], "one": []}, [], []
    # the first meshed call, then in turns: one-device, meshed, meshed, one-device
    for engine, name in ((sw, "mesh"), (sw_one, "one"), (sw, "mesh"), (sw, "mesh"),
                         (sw_one, "one")):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        seg = engine.predict_segmentation(vol)
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
        equal.append(float((seg == seg_one_device).mean()))
        if name == "mesh":
            counts.append(kernels.launch_counts())
    tiles = len(sw.local_origins(sw.origins(VOLUME)))
    print(f"phase 24 meshed main path, world {mesh.size('data')}: predict_segmentation "
          f"{VOLUME}, {tiles} of {TILES} tiles on this rank: first call "
          f"{walls['mesh'][0]:.3f} s (the communicator's set-up), then in turns with the "
          f"one-device engine: meshed {', '.join(f'{w:.3f}' for w in walls['mesh'][1:])} "
          f"s/volume, one-device {', '.join(f'{w:.3f}' for w in walls['one'])} s/volume; "
          f"labels equal to phase 4's on {equal} of the voxels; launches a meshed volume "
          f"{counts}", flush=True)
    expected = _expected_3d(TILES)
    if any(c != expected for c in counts):
        fail(f"meshed main path launches {counts}, expected {expected}")
    if any(e != 1.0 for e in equal):
        fail("the meshed main path's labels differ from phase 4's")
    del model, sw, sw_one
    torch.cuda.empty_cache()
    return counts[0]


def _dp_step(mesh) -> dict:
    """Phase 24 (b): the data-parallel step at full width against the
    one-device kernel step (step 1, then timed in turns); its launches
    over 3 steps."""
    grads_of = lambda model: {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    ref, path = train_path.build(seed=0), train_path.build(seed=0)
    step = make_train_step(path.model, make_sgd(path.model.parameters(), train_path.LR),
                           mesh=mesh)
    image, label = parallel.shard_batch(mesh, (path.image, path.label))
    loss_ref = float(train_path.step(ref)["loss"])
    grads_ref = grads_of(ref.model)
    times, per_step, losses, ref_times = [], [], [], []
    for i, name in enumerate(("mesh", "mesh", "one", "one", "mesh")):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        if name == "one":
            train_path.step(ref)
            torch.cuda.synchronize()
            ref_times.append(time.perf_counter() - t0)
            continue
        m = step(image, label)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_step.append(kernels.launch_counts())
        losses.append(float(m["loss"]))
        if i == 0:
            grads = grads_of(path.model)
    worst, worst_rel, whole = grad_rel(grads, grads_ref)
    print(f"phase 24 data-parallel step, world {mesh.size('data')}, B={TRAIN_BATCH} on this "
          f"rank: steps {', '.join(f'{t:.4f}' for t in times)} s, the one-device kernel "
          f"step's 2-3 in turns with its 2-3: {', '.join(f'{t:.4f}' for t in ref_times)} s; "
          f"step 1 vs the one-device kernel step: loss {losses[0]:.7f} vs {loss_ref:.7f} "
          f"(rtol {LOSS_RTOL}), worst per-tensor ‖Δg‖/‖g‖ {worst_rel:.3e} ({worst}; max "
          f"{GRAD_TENSOR_RTOL}), whole {whole:.3e} (max {GRAD_RTOL}); losses "
          f"{[round(l, 6) for l in losses]}; launches per step {per_step}", flush=True)
    if abs(losses[0] - loss_ref) > LOSS_RTOL * abs(loss_ref):
        fail("the data-parallel step's loss disagrees with the one-device step's")
    if worst_rel > GRAD_TENSOR_RTOL or whole > GRAD_RTOL:
        fail(f"the data-parallel step's gradient disagrees with the one-device step's ({worst})")
    if any(c != train_path.LAUNCHES_PER_STEP for c in per_step):
        fail(f"data-parallel step launches {per_step}, expected {train_path.LAUNCHES_PER_STEP}")
    if not np.all(np.isfinite(losses)):
        fail(f"data-parallel losses {losses}")
    del path, ref, step
    torch.cuda.empty_cache()
    return _summed(per_step)


def _rel_err(got, ref) -> tuple:
    err = (got.cpu() - ref.cpu()).abs().max().item()
    return err, REL_TOL * max(1.0, ref.abs().max().item())


def _halo_conv_and_grouped_deform(mesh):
    """Phase 24 (c): `spatial_conv3d` on the card against `F.conv3d`, the
    general deform conv on the card against the CPU."""
    g = torch.Generator(device="cuda").manual_seed(24)
    x = torch.randn(2, 32, 32, 32, 32, device="cuda", generator=g)
    group = mesh.group("data")
    for label, w, dil, groups in (
            ("3^3 dense", torch.randn(32, 32, 3, 3, 3, device="cuda", generator=g)
             / (27 * 32) ** 0.5, 1, 1),
            ("5^3 depthwise dil 3", torch.randn(32, 1, 5, 5, 5, device="cuda", generator=g)
             / 125 ** 0.5, 3, 32)):
        b = torch.randn(32, device="cuda", generator=g) * 0.1
        got = spatial_conv3d(x, w, group, bias=b, dilation=dil, groups=groups)
        ref = F.conv3d(to_ncdhw(x), w, b, padding=dil * (w.shape[2] // 2), dilation=dil,
                       groups=groups).permute(0, 2, 3, 4, 1)
        err, tol = _rel_err(got, ref)
        print(f"phase 24 spatial_conv3d {label} {tuple(x.shape)}, world "
              f"{mesh.size('data')}: max|err| vs F.conv3d {err:.3e} (tol {tol:.3e})", flush=True)
        if not err <= tol:
            fail(f"spatial_conv3d {label} disagrees with F.conv3d")
    x2 = torch.randn(4, 28, 28, 16, device="cuda", generator=g)
    w2 = torch.randn(3, 3, 8, 12, device="cuda", generator=g) / 72 ** 0.5
    b2 = torch.randn(12, device="cuda", generator=g) * 0.1
    off = (torch.rand(4, 14, 14, 18, device="cuda", generator=g) * 2 - 1) * 2.5
    kw = dict(stride=2, padding=1, groups=2)
    got = deform_conv2d(x2, off, w2, b2, **kw)
    ref = deform_conv2d(*(t.cpu() for t in (x2, off, w2, b2)), **kw)
    err, tol = _rel_err(got, ref)
    wd = torch.randn(5, 5, 1, 16, device="cuda", generator=g) / 5
    bd = torch.randn(16, device="cuda", generator=g) * 0.1
    offd = (torch.rand(4, 28, 28, 50, device="cuda", generator=g) * 2 - 1) * 2.5
    before = kernels.deform_dw_conv2d.launches
    got_dw = deform_conv2d(x2, offd, wd, bd, padding=6, dilation=3, groups=16)
    launched = kernels.deform_dw_conv2d.launches - before
    same = torch.equal(got_dw, kernels.deform_dw_conv2d(x2, offd, wd, 3) + bd)
    print(f"phase 24 deform_conv2d groups 2 stride 2 {tuple(x2.shape)} -> {tuple(got.shape)}: "
          f"card vs CPU max|err| {err:.3e} (tol {tol:.3e}); its depthwise 5x5 dil 3 'same' "
          f"case launched deform_dw_conv2d {launched} time(s), equal to the wrapper's "
          f"{same}", flush=True)
    if not err <= tol:
        fail("the general deform conv on the card disagrees with the CPU")
    if launched != 1 or not same:
        fail("the depthwise deform conv did not go through kernel 4")


def _ranger_and_latency(latency_phase11: float):
    """Phase 24 (d): Ranger on the card against the CPU; the latency
    helpers on the 2D flagship at batch 1."""
    g = torch.Generator().manual_seed(5)
    init = [torch.randn(s, generator=g) for s in ((64, 32), (32,), (3, 3, 16, 16))]
    grads = [[torch.randn(t.shape, generator=g) * 0.5 for t in init] for _ in range(13)]
    out = {}
    for dev in ("cuda", "cpu"):
        params = [torch.nn.Parameter(t.clone().to(dev)) for t in init]
        opt = make_ranger(params, 3e-2, weight_decay=1e-2)
        for gs in grads:
            for p, gr in zip(params, gs):
                p.grad = gr.to(dev)
            opt.step()
        out[dev] = [p.detach().cpu() for p in params]
    bad = sum(int((~torch.isclose(a, b, rtol=1e-5, atol=1e-7)).sum())
              for a, b in zip(out["cuda"], out["cpu"]))
    err = max((a - b).abs().max().item() for a, b in zip(out["cuda"], out["cpu"]))
    print(f"phase 24 Ranger, 13 steps on 3 tensors: card vs CPU max|Δ| {err:.3e}, "
          f"{bad} values outside rtol 1e-5, atol 1e-7", flush=True)
    if bad:
        fail("Ranger's steps on the card disagree with the CPU")
    model, _ = main_path2d.build("dlka", seed=0)
    x = torch.zeros(1, *main_path2d.PATCH, 1, device="cuda")
    lat = latency_bench(model, (x,), warmup=10, reps=100, inner=10)
    scan = latency_bench_scan(model, (x,), reps=100, rounds=3)
    print(f"phase 24 latency_bench 2D flagship batch 1 {main_path2d.PATCH} f32: "
          f"{lat['mean_ms']:.3f} ± {lat['std_ms']:.3f} ms ({lat['reps']} calls, CUDA events "
          f"over windows of 10); latency_bench_scan {scan['mean_ms']:.3f} ± "
          f"{scan['std_ms']:.3f} ms ({scan['reps']} calls, 100 back to back a round); "
          f"phase 11: {latency_phase11:.3f} ms", flush=True)
    if not (np.isfinite(lat["mean_ms"]) and np.isfinite(scan["mean_ms"])):
        fail("the latency helpers returned no time")
    del model
    torch.cuda.empty_cache()


def phase_parallel(seg_one_device, latency_phase11: float) -> dict:
    """Phase 24: `parallel/` on a world of one rank; launches by path."""
    import torch.distributed as dist

    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        parallel.init_process_group("cuda", f"file://{Path(tmp) / 'store'}", 0, 1)
        try:
            mesh = parallel.make_mesh(("data",), device_type="cuda")
            print(f"phase 24 world: backend {dist.get_backend()}, {mesh}", flush=True)
            out = {"meshed main path, world 1": _meshed_volume(mesh, seg_one_device),
                   "data-parallel step, world 1, 3 steps": _dp_step(mesh)}
            _halo_conv_and_grouped_deform(mesh)
            _ranger_and_latency(latency_phase11)
        finally:
            dist.destroy_process_group()
    print(f"phase 24: {time.perf_counter() - t_start:.1f} s", flush=True)
    return out


def _bf16_main_path(wall_f32: float) -> dict:
    """Phase 4's volume uploaded in bf16: s/volume in turns with the same
    model's f32 engine (and beside phase 4's call), launches, labels vs
    the same bf16 run through the plain versions."""
    model, sw = main_path.build(seed=0, input_dtype=torch.bfloat16)
    sw32 = SlidingWindowInference(model, patch_size=PATCH, num_classes=main_path.NUM_CLASSES,
                                  step_size=0.5, do_mirroring=True, tta_batch=8)
    vol = main_path.volume(seed=0)
    walls = {"bf16": [], "f32": []}

    def timed(engine, key):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine.predict_segmentation(vol)
        torch.cuda.synchronize()
        walls[key].append(time.perf_counter() - t0)
        return out

    timed(sw, "bf16"), timed(sw32, "f32")  # warm-up, one call each
    walls = {"bf16": [], "f32": []}
    kernels.reset_launches()
    seg = timed(sw, "bf16")
    launches = kernels.launch_counts()
    seg32 = timed(sw32, "f32")
    timed(sw, "bf16"), timed(sw32, "f32")
    with plain_versions():
        seg_plain = sw.predict_segmentation(vol)
    agree = float((seg == seg_plain).mean())
    print(f"phase 25 main path, bf16 input: predict_segmentation {VOLUME}: "
          f"{' / '.join(f'{w:.3f}' for w in walls['bf16'])} s wall, in turns with the "
          f"f32 engine's {' / '.join(f'{w:.3f}' for w in walls['f32'])} (phase 4, f32, "
          f"first call: {wall_f32:.3f} s); launches {launches}; labels vs the bf16 plain "
          f"run {agree:.6f} (min {MIN_AGREEMENT}), vs the f32 run "
          f"{float((seg == seg32).mean()):.6f}", flush=True)
    if launches != _expected_3d(TILES):
        fail(f"bf16 main path launches {launches}")
    if seg.shape != VOLUME or seg.dtype != np.uint8 or agree < MIN_AGREEMENT:
        fail("the bf16 main path through the kernels disagrees with the plain versions")
    del model, sw, sw32
    return launches


def _bf16_pancreas_tester() -> dict:
    """Phase 16's case through the tester in bf16, each of its four
    models, then the same model's f32 tester."""
    case = case_path.pancreas_case(seed=0)
    out = {}
    for name in ("dlka_net", "vnet", "resnet34", "unetr"):
        model = build_pancreas_model(name, main_path.DEFAULT_BLOCK, case_path.PANCREAS_PATCH)
        engines = {dtype: pancreas.make_pancreas_sliding_window(
            model, patch_size=case_path.PANCREAS_PATCH, stride_xy=case_path.PANCREAS_STRIDE,
            stride_z=case_path.PANCREAS_STRIDE, input_dtype=dtype)
            for dtype in (torch.bfloat16, None)}
        padded = tuple(max(s, p) for s, p in zip(case[1].shape, case_path.PANCREAS_PATCH))
        tiles = len(engines[None].origins(padded))
        with torch.no_grad():
            for dtype in (torch.bfloat16, torch.float32):
                model(torch.zeros(1, *case_path.PANCREAS_PATCH, 1, device="cuda", dtype=dtype))
        torch.cuda.synchronize()
        walls, labels = {}, {}
        for dtype, sw in engines.items():
            kernels.reset_launches()
            t0 = time.perf_counter()
            labels[dtype], _ = pancreas.test_single_case(sw, case[1])
            walls[dtype] = time.perf_counter() - t0
            if dtype is not None:
                launches = kernels.launch_counts()
        t0 = time.perf_counter()
        avg = pancreas.test_all_case(engines[torch.bfloat16], [case], verbose=False)
        wall = time.perf_counter() - t0
        expected = _expected_3d(tiles) if name == "dlka_net" else {}
        print(f"phase 25 Pancreas tester, bf16 input, --model {name}: sliding window "
              f"{walls[torch.bfloat16]:.3f} s (f32: {walls[None]:.3f} s), {wall:.3f} s/case "
              f"with the host metrics ({tiles} tiles); labels vs f32 "
              f"{float((labels[torch.bfloat16] == labels[None]).mean()):.6f}; (dice, jaccard, "
              f"hd95, asd) {avg.tolist()}; launches {launches}", flush=True)
        if launches != expected:
            fail(f"bf16 Pancreas tester {name}: launches {launches}, expected {expected}")
        if not (np.all(np.isfinite(avg)) and 0.0 <= avg[0] <= 1.0):
            fail(f"bf16 Pancreas tester {name}: bad metrics {avg}")
        out[f"Pancreas tester bf16 --model {name}, 1 case"] = launches
        del model, engines
        torch.cuda.empty_cache()
    return out


def _bf16_val_batch() -> dict:
    """One `-val` batch: the 8 mirror flips of one bf16 tile through the
    deep-supervision model, kernels against plain versions."""
    model = dlka_former_synapse(trainer_path.NUM_CLASSES, do_ds=True, remat=True, seed=0)
    main_path.drive_gates(model, 11)
    tile = torch.from_numpy(main_path.volume(seed=1)[:PATCH[0], :PATCH[1], :PATCH[2]])
    tile = tile[None].to(torch.bfloat16).cuda()

    def forward():
        with torch.no_grad():
            return mirror_tta_softmax(lambda x: model(x)[0], tile, (0, 1, 2), True, TTA_BATCH)

    forward()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    prob = forward()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    with plain_versions():
        prob_plain = forward()
    err = (prob - prob_plain).abs().max().item()
    agree = (prob.argmax(-1) == prob_plain.argmax(-1)).float().mean().item()
    print(f"phase 25 -val batch, bf16 tile {PATCH} x 8 flips: {wall:.3f} s; softmax "
          f"{prob.dtype}, max|kernels - plain| {err:.3g} (max 1e-3), labels {agree:.6f}; "
          f"launches {launches}", flush=True)
    if launches != _expected_3d(1) or prob.dtype != torch.float32:
        fail(f"bf16 -val batch launches {launches}, softmax {prob.dtype}")
    if not (err <= 1e-3 and agree >= MIN_AGREEMENT):
        fail("the bf16 -val batch through the kernels disagrees with the plain versions")
    del model
    return launches


def _bf16_2d_latency(latency_f32: float) -> dict:
    """The 2D flagship's batch-1 224² forward on a bf16 input, timed in
    turns with the f32 input."""
    model, _ = main_path2d.build("dlka", seed=0)
    g = torch.Generator().manual_seed(3)
    x32 = torch.randn(1, *main_path2d.PATCH, 1, generator=g).cuda()
    x = x32.to(torch.bfloat16)
    ms = {"bf16": [], "f32": []}
    with torch.no_grad():
        for _ in range(2):
            ms["bf16"].append(timed_ms(lambda: model(x), 50, warmup=5))
            ms["f32"].append(timed_ms(lambda: model(x32), 50, warmup=5))
        kernels.reset_launches()
        logits = model(x)
        launches = kernels.launch_counts()
        with plain_versions():
            logits_plain = model(x)
    agree = (logits.argmax(-1) == logits_plain.argmax(-1)).float().mean().item()
    print(f"phase 25 2D flagship batch 1 {main_path2d.PATCH}, bf16 input: "
          f"{' / '.join(f'{m:.3f}' for m in ms['bf16'])} ms per forward (CUDA events over "
          f"50), in turns with the f32 input's {' / '.join(f'{m:.3f}' for m in ms['f32'])} "
          f"(phase 11, f32: {latency_f32:.3f} ms); logits {logits.dtype}, labels vs plain "
          f"{agree:.6f}; launches {launches}", flush=True)
    if (launches != main_path2d.LAUNCHES_PER_FORWARD["dlka"] or logits.dtype != torch.float32
            or agree < MIN_AGREEMENT):
        fail(f"bf16 2D forward: launches {launches}, logits {logits.dtype}, agreement {agree}")
    del model
    return launches


def phase_bf16_input(wall_f32: float, latency_f32: float) -> dict:
    """Phase 25: the JAX package's bf16-input inference paths."""
    t0 = time.perf_counter()
    out = {"inference main path, bf16 input": _bf16_main_path(wall_f32)}
    out.update(_bf16_pancreas_tester())
    out["-val batch, bf16 input"] = _bf16_val_batch()
    out["2D flagship batch 1, bf16 input"] = _bf16_2d_latency(latency_f32)
    torch.cuda.empty_cache()
    print(f"phase 25 took {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def kernel_line(rows, launches):
    """rows[name]: (what its sums are per, the per-stage measurements);
    launches[path]: counts by kernel."""
    out = []
    for name, (per, rs) in rows.items():
        k = kernels.HAND_KERNELS[name]
        per_call = lambda key: sum(r["sites"] * r[key] for r in rs)
        bound, by = _bound({"bytes_ms": per_call("bytes_ms"),
                            "ops_ms": per_call("ops_ms")})
        out.append({
            "name": name, "route": "cuda", "source": f"deformablelka_tpu_torch/csrc/{k.source}",
            "replaces": k.replaces,
            "launches": sum(c.get(name, 0) for c in launches.values()),
            "launches_by_path": {path: c.get(name, 0) for path, c in launches.items()},
            "max_abs_err": max(r["err"] for r in rs),
            "ms": per_call("ms"), "plain_ms": per_call("plain_ms"),
            "bound_ms": bound, "bound_by": by,
            "library_ms": None if rs[0]["lib_ms"] is None else per_call("lib_ms"),
            "per": per,
        })
        for key, row_key in (("device_ms", "device_ms"),
                             ("library_device_ms", "lib_device_ms")):
            out[-1][key] = per_call(row_key) if row_key in rs[0] else None
        for key in ("small_offset_ms", "large_offset_ms", "cold_ms", "dense_conv_ms",
                    "tc_bound_ms", "yardstick_ms", "yardstick_device_ms"):
            if key in rs[0]:
                out[-1][key] = per_call(key)
        # sites held and timed outside the per-forward sums (DAE-LKA's chain)
        other = [r for r in rs if r["sites"] == 0]
        if other:
            out[-1]["other_sites"] = [{
                "shape": [BATCH_2D, r["S"], r["S"], r["C"]], "max_abs_err": r["err"],
                "ms": r["ms"], "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
                "library_ms": r["lib_ms"], "library_device_ms": r["lib_device_ms"],
                "bound_ms": _bound(r)[0], "bound_by": _bound(r)[1]} for r in other]
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_start = time.perf_counter()
    phase_device()
    stages = "the 21 launches at the four stage shapes"
    rows = {n: (f"one forward at batch 8: {stages}", rs) for n, rs in phase_kernels().items()}
    phase_small_reference()
    launches, wall_main, seg_main = phase_main_path()
    rows["deform_conv3d_bwd"] = (f"one training step at batch 2: {stages}",
                                 phase_backward_kernel())
    rows["dw_chain3d_bwd"] = (f"one training step at batch 2: {stages}",
                              phase_chain_backward_kernel())
    rows["conv3d_wgrad"] = ("one training step of synapse3d.train and one of swin_unetr.train "
                            "at batch 2: the 116 + 14 launches `convs.hand_wgrad_shape` engages",
                            [r for r in phase_conv3d_wgrad() if r["engaged"]])
    phase_small_train_step()
    per_step, _ = phase_train_path()
    train_launches = _summed(per_step)
    decoder = "the three decoder shapes"
    rows_2d = phase_2d_kernels()
    rows["deform_dw_conv2d"] = (f"one flagship forward at batch 24: the 12 launches at {decoder}",
                                rows_2d["deform_dw_conv2d"])
    rows["dw_chain2d"] = (f"one LKA Baseline forward at batch 24: the 6 launches at {decoder}",
                          rows_2d["dw_chain2d"])
    # phase 19 beside the other 2D kernels: late in a long run torch.profiler
    # dropped most of its kernel records (PERF.md §7)
    rows["deform_dw_conv2d_bwd"] = (
        f"one flagship training step at batch 24: the 12 launches at {decoder}",
        phase_2d_backward_kernel())
    launches_2d, _ = phase_2d_path()
    phase_2d_small_reference()
    latency_2d = phase_2d_latency()
    rows["dwconv3d"] = ("one forward at batch 8: the 9 launches at 8³×128 (5³ dil 3) and "
                        "4³×256 (3³ dil 2)", phase_dwconv3d_kernel())
    launches_sa, _, _ = phase_main_path(13, SIZE_AWARE, LAUNCHES_PER_FORWARD[SIZE_AWARE])
    phase_small_configs()
    launches_cli, _ = phase_synapse_cli()
    launches_pancreas, _ = phase_pancreas_tester()
    launches_trainer, launches_val = phase_synapse_trainer()
    launches_pancreas_trainer, _ = phase_pancreas_trainer()
    per_step_2d, _ = phase_2d_train_step()
    launches_synapse2d, launches_baseline2d, launches_skin, launches_zoo_clis = phase_2d_clis()
    launches_zoo = phase_2d_zoo()
    launches_baselines = phase_baselines()
    launches_parallel = phase_parallel(seg_main, latency_2d)
    launches_bf16 = phase_bf16_input(wall_main, latency_2d)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(kernel_line(rows, {
        "inference main path": launches, "training path, 3 steps": train_launches,
        **{f"2D path {c}": n for c, n in launches_2d.items()},
        "size-aware main path": launches_sa,
        "Synapse CLI predict_simple, 1 case": launches_cli,
        "Pancreas tester, 1 case": launches_pancreas,
        "Synapse trainer, 2 epochs of 4 + 2 batches": launches_trainer,
        "Synapse -val, 2 cases": launches_val,
        "Pancreas trainer, 6 iterations": launches_pancreas_trainer,
        "2D flagship Trainer2D, 3 steps": _summed(per_step_2d),
        "train_synapse2d, 2 epochs of 2 batches": launches_synapse2d,
        "LKA Baseline Trainer2D, 3 steps": launches_baseline2d,
        "train_skin, 2 epochs of 2 batches": launches_skin,
        **launches_zoo_clis, **launches_zoo, **launches_baselines,
        **launches_parallel, **launches_bf16})), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
