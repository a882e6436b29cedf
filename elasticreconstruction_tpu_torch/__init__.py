"""PyTorch/CUDA port of the dense RGB-D reconstruction pipeline.

This package is the PyTorch counterpart of ``elasticreconstruction_tpu``
(the JAX/Pallas reference). It mirrors the reference's subpackage layout so
each module's counterpart is found by path:

- ``core``          SE3 ops, fixed-capacity point-cloud containers, file IO
- ``kernels``       torch ops (k-NN, voxel grid, normals, FPFH) and, under
                    ``kernels/cuda``, the hand-written Hopper kernels that
                    replace the reference's Pallas kernels
- ``registration``  FPFH + RANSAC + point-to-plane ICP pair registration

The pipeline has no learned parameters, so everything is a plain function on
tensors. Entry points that build tensors take ``device=`` and default to
``"cuda"``; nothing moves to the CPU on its own.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry is not a neural net: reduced-precision (TF32) matmul inputs put
# ~1e-3 relative error into the |q|^2+|p|^2-2qp distance expansions, which
# flips radius-neighbour sets and nearest-neighbour argmins. Every matmul here
# has a tiny contraction (K = 3..33), so full f32 costs nothing measurable.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
