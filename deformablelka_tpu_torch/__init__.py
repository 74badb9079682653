"""deformablelka_tpu_torch — the D-LKA Former in PyTorch for NVIDIA Hopper.

A port of the JAX package `deformablelka_tpu`, module for module. Tensors
are channels-last (B, D, H, W, C) at every public function, as in the JAX
package, and module attributes keep the upstream torch names, so a
state_dict converts with `deformablelka_tpu.convert.torch_loader`.

The two kernels of the 3D inference path are hand-written CUDA for
`sm_90a` (`csrc/`), built with nvcc at first use (`ops/kernels.py`):

- `ops.kernels.deform_conv3d`: the exact trilinear 3³ deformable conv;
- `ops.kernels.dw_chain3d`: the fused dw5³ → dw7³-dil3 LKA chain.

Each has a plain PyTorch version beside it, which a CPU tensor takes.
Importing this package imports nothing but torch, numpy and scipy.
"""

__version__ = "0.1.0"
