"""deformablelka_tpu_torch — D-LKA Net in PyTorch for NVIDIA Hopper.

A port of the JAX package `deformablelka_tpu`, module for module: the 3D
D-LKA Former (inference and training) with its block-variant registry and
its Synapse, ACDC and Pancreas configurations, 3D case inference through
the `predict_simple` and `test_pancreas` CLIs, 3D training through
`run_training` and `train_pancreas`, and the 2D MaxViT D-LKA Net (slice
inference, and training through `train_synapse2d` and `train_skin`),
the 2D ablation zoo, the Pancreas baselines and GenericUNet, Swin
UNETR's BTCV configuration (`models.swin_unetr`, a model of the port's
own, trained through `training.train_step`), and `parallel` (meshes of ranks over `torch.distributed`: tile-sharded
sliding windows, data-parallel and halo-exchange training steps).
Tensors are channels-last ((B, D, H, W, C) or (B, H, W, C)) at every
public function, as in the JAX package, and module attributes keep the
upstream torch names, so a state_dict converts with
`deformablelka_tpu.convert.torch_loader`.

The kernels are hand-written CUDA for `sm_90a` (`csrc/`), built with nvcc
at first use; `ops.kernels.HAND_KERNELS` lists them, one record each: the
wrapper, the plain PyTorch version a CPU tensor takes, the source, the
device functions' names and the operation count.

Importing this package imports nothing but torch, numpy and scipy (h5py
only where an h5 case is read, PIL where skin images are prepared).
"""

__version__ = "0.1.0"
