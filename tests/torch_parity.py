"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py):
hand a JAX DeviceScene to the port as numpy, on the CPU.

Importing it keeps PyTorch to one intra-op thread in the test process: the
suite runs several workers on shared cores, and PyTorch's default of one
thread per core made the render tests ten times slower under that
contention (376 s instead of 37 s)."""

import numpy as np
import torch

from raytracer_odin_tpu_torch.models.scene import (
    BVH_FIELDS,
    TENSOR_FIELDS,
    scene_from_numpy,
)

torch.set_num_threads(1)


def torch_scene(jax_scene, device="cpu"):
    """The port's DeviceScene holding the JAX scene's arrays, its BVH
    included. A streamed JAX scene packs its triangle rows 128 wide; the
    port keeps their first 12 columns and marks the scene streamed."""
    arrays = {f: np.asarray(getattr(jax_scene, f)) for f in TENSOR_FIELDS}
    arrays["bvh"] = {f: np.asarray(getattr(jax_scene.bvh, f))
                     for f in BVH_FIELDS}
    stream = arrays["ptri"].shape[1] == 128
    arrays["ptri"] = arrays["ptri"][:, :12]
    return scene_from_numpy(
        arrays, env_tex=jax_scene.env_tex, row_spec=jax_scene.row_spec,
        tex_kinds=jax_scene.tex_kinds, stream=stream, device=device,
    )


def within_16_ulp(got, want) -> bool:
    """Every value of `got` within 16 float32 ulp of `want`: the CPU
    tolerance of a hit distance, since XLA's CPU backend fuses
    multiply-adds (tests/test_torch_kernels.py)."""
    want = np.asarray(want, np.float32)
    return bool(np.all(np.abs(np.asarray(got) - want)
                       <= 16 * np.spacing(np.abs(want))))
