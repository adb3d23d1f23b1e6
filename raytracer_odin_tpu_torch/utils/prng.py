"""Counter-based per-lane uniforms via the PCG4D hash (port of
raytracer_odin_tpu/utils/prng.py).

Every draw is a pure function of (seed key, sample, tag, stream id, draw
index), so renders are invariant under batching and lane permutation, and
the port draws exactly the JAX package's bits.

torch has no uint32 arithmetic to rely on, so the words live in int32:
multiplies and adds wrap to the same low 32 bits, and the logical right
shift is the arithmetic one masked to the shifted-in width.

On a CUDA device the draws are one launch of the draw kernel
(ops/prng_kernel.py, csrc/prng_kernels.cu), which computes this chain in
uint32 and gives its bits; on the CPU the chain below runs (`plain_cols`).
Every call is the program's span "draw" (utils/profiling.py).
"""

from __future__ import annotations

import torch

from raytracer_odin_tpu_torch.ops import prng_kernel
from raytracer_odin_tpu_torch.utils import profiling

_M32 = 0xFFFFFFFF

# Tag for the camera-jitter draw (distinct from bounce tags 0..depth-1).
JITTER_TAG = 0x7E11
# The program's span around each call of uniforms and uniforms_cols.
SPAN = "draw"


def key_from_seed(seed: int) -> tuple:
    """The two uint32 words of `jax.random.PRNGKey(seed)` (threefry key
    data), computed without jax: (seed >> 32, seed & 0xFFFFFFFF)."""
    seed = int(seed)
    if not 0 <= seed < (1 << 32):
        raise ValueError(f"seed must be in [0, 2**32), got {seed}")
    return (seed >> 32) & _M32, seed & _M32


def _i32(x, device) -> torch.Tensor:
    """A uint32 counter (python int or integer tensor) as int32 bits (a
    python int is filled in on the device: no copy from the host)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32)
    x = int(x) & _M32
    if x >= 1 << 31:
        x -= 1 << 32
    return torch.full((), x, dtype=torch.int32, device=device)


def _srl(x, k: int):
    """Logical right shift of int32 bits."""
    return (x >> k) & ((1 << (32 - k)) - 1)


def _pcg4d(a, b, c, d):
    """PCG4D mix of four uint32 streams (as int32 bits)."""
    a = a * 1664525 + 1013904223
    b = b * 1664525 + 1013904223
    c = c * 1664525 + 1013904223
    d = d * 1664525 + 1013904223
    a = a + b * d
    b = b + c * a
    c = c + a * b
    d = d + b * c
    a = a ^ _srl(a, 16)
    b = b ^ _srl(b, 16)
    c = c ^ _srl(c, 16)
    d = d ^ _srl(d, 16)
    a = a + b * d
    b = b + c * a
    c = c + a * b
    d = d + b * c
    return a, b, c, d


def _to_unit(w):
    """uint32 bits -> f32 in [0, 1) using the top 24 bits."""
    return _srl(w, 8).to(torch.float32) * (1.0 / (1 << 24))


def plain_cols(key, samples, tags, sids, n: int):
    """The plain chain of torch ops: uniforms_cols on any device."""
    k0, k1 = key
    dev = sids.device
    a = _i32(samples, dev) ^ _i32(k0, dev)
    b = _i32(tags, dev) ^ _i32(k1, dev)
    c = _i32(sids, dev)
    a, b, c = torch.broadcast_tensors(a, b, c)
    outs = []
    for blk in range((n + 3) // 4):
        outs.extend(_pcg4d(a, b, c, torch.full_like(c, blk)))
    return tuple(_to_unit(w) for w in outs[:n])


def uniforms_cols(key, samples, tags, sids, n: int):
    """`uniforms` as a tuple of n [...] columns: the same draws, no final
    stack (the columnar shade, ops/shading_cols.py, reads them apart)."""
    with profiling.span(SPAN):
        if sids.device.type == "cuda":
            return prng_kernel.draws(key, samples, tags, sids, n, cols=True)
        return plain_cols(key, samples, tags, sids, n)


def uniforms(key, samples, tags, sids, n: int):
    """[..., n] uniforms addressed by (sample, tag, stream-id) counters
    under `key` (the word pair of key_from_seed). `samples`/`tags` may be
    python ints or int tensors, broadcast against the int tensor `sids`."""
    with profiling.span(SPAN):
        if sids.device.type == "cuda":
            return prng_kernel.draws(key, samples, tags, sids, n)
        return torch.stack(plain_cols(key, samples, tags, sids, n), dim=-1)
