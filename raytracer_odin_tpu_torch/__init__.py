"""PyTorch/CUDA port of the wavefront path tracer in `raytracer_odin_tpu`.

The JAX package stays the reference; this package mirrors its module
names (ops/traverse.py <-> ops/traverse.py, ...) and its array layouts at
public functions, runs eagerly on one NVIDIA GPU (H100, sm_90a), and
replaces each Pallas TPU kernel on its path with a CUDA kernel written by
hand (csrc/). It imports neither jax nor anything of the JAX package.

Render math stays in full float32: the JAX package pins its render-critical
matmuls to Precision.HIGHEST because bf16 products biased cornell energy by
+11%; the Hopper form of that trap is TF32, switched off here for every
importer.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
