"""deformablelka_tpu_torch — D-LKA Net in PyTorch for NVIDIA Hopper.

A port of the JAX package `deformablelka_tpu`, module for module: the 3D
D-LKA Former (inference and training) with its block-variant registry and
its Synapse, ACDC and Pancreas configurations, 3D case inference through
the `predict_simple` and `test_pancreas` CLIs, 3D training through
`run_training` and `train_pancreas`, and the 2D MaxViT D-LKA Net (slice
inference, and training through `train_synapse2d` and `train_skin`),
the 2D ablation zoo, the Pancreas baselines and GenericUNet, and
`parallel` (meshes of ranks over `torch.distributed`: tile-sharded
sliding windows, data-parallel and halo-exchange training steps).
Tensors are channels-last ((B, D, H, W, C) or (B, H, W, C)) at every
public function, as in the JAX package, and module attributes keep the
upstream torch names, so a state_dict converts with
`deformablelka_tpu.convert.torch_loader`.

The kernels are hand-written CUDA for `sm_90a` (`csrc/`), built with nvcc
at first use (`ops/kernels.py`):

- `ops.kernels.deform_conv3d` and `deform_conv3d_bwd`: the exact
  trilinear 3³ deformable conv and its backward;
- `ops.kernels.dw_chain3d`: the fused dw5³ → dw7³-dil3 LKA chain;
- `ops.kernels.deform_dw_conv2d` and `deform_dw_conv2d_bwd`: the exact
  bilinear depthwise 2D deformable conv and its backward;
- `ops.kernels.dw_chain2d`: the fused dw5² → dw7²-dil3 LKA chain;
- `ops.kernels.dwconv3d`: the dilated depthwise K³ conv of the
  size-aware gates.

Each has a plain PyTorch version beside it, which a CPU tensor takes.
Importing this package imports nothing but torch, numpy and scipy (h5py
only where an h5 case is read, PIL where skin images are prepared).
"""

__version__ = "0.1.0"
