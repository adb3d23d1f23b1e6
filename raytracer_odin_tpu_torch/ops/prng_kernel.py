"""The lanes' random draws as one hand-written CUDA kernel
(csrc/prng_kernels.cu, whose note says why its bits are the plain chain's
and what bounds it).

utils/prng.py's `uniforms` and `uniforms_cols` launch it for stream ids on
a CUDA device and run their plain chain of torch ops on the CPU; nothing
falls back from the kernel to the chain. One launch makes a call's draws:

  * `draws(key, samples, tags, sids, n, cols)`: the [..., n] rows of
    `uniforms`, or with `cols` the n [...] columns of `uniforms_cols`
    (written as [n, ...] and unbound: one kernel with an output stride).

A counter that is a Python int goes to the kernel by value; an integer
tensor goes as an int32 array broadcast to the draws' shape (the pool's
and refill's per-lane samples and tags). The key words go by value. The
kernel runs on the current stream, makes no sync, and raises inside a CUDA
graph capture: a graph would freeze the by-value counters, so the shade
graphs take their draws as inputs.

`launch.launches` counts the kernel's launches; each launch also counts
the program's `draw_kernel` counter (COUNTER, utils/profiling.py).
"""

from __future__ import annotations

import ctypes

import torch

from raytracer_odin_tpu_torch.utils import profiling

# The program's counter of draw calls the kernel served.
COUNTER = "draw_kernel"

_M32 = 0xFFFFFFFF
_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32


class DrawArgs(ctypes.Structure):
    """csrc/prng_kernels.cu's DrawArgs, field for field."""
    _fields_ = ([(n, _P) for n in ("samples", "tags", "sids", "out")]
                + [("draw_stride", ctypes.c_longlong)]
                + [(n, _I) for n in ("lane_stride", "lanes", "n")]
                + [(n, _U) for n in ("k0", "k1", "sample", "tag")])


def _lanes(x, shape, dev):
    """x as a contiguous int32 array of `shape` on dev (x itself where it
    is one: the main path's stream ids)."""
    if (x.dtype != torch.int32 or x.shape != shape or x.device != dev
            or not x.is_contiguous()):
        x = x.to(device=dev, dtype=torch.int32).expand(shape).contiguous()
    return x


def _counter(x, shape, dev):
    """(an int32 array of `shape` or None, the uint32 value): a tensor
    counter goes per lane, a Python int by value."""
    if isinstance(x, torch.Tensor):
        return _lanes(x, shape, dev), 0
    return None, int(x) & _M32


def prepare(key, samples, tags, sids, n: int, cols: bool):
    """The launch's arguments, its output [n, ...] (cols) or [..., n], and
    the tensors they point into (kept alive until the launch)."""
    n = int(n)
    if n < 1:
        raise ValueError(f"draw kernel: n = {n}, want at least 1")
    dev = sids.device
    per_lane = [x.shape for x in (samples, tags)
                if isinstance(x, torch.Tensor)]
    shape = (torch.broadcast_shapes(sids.shape, *per_lane) if per_lane
             else sids.shape)
    sids = _lanes(sids, shape, dev)
    samp, sample = _counter(samples, shape, dev)
    tag_a, tag = _counter(tags, shape, dev)
    lanes = sids.numel()
    if cols:
        out = torch.empty((n,) + tuple(shape), dtype=torch.float32,
                          device=dev)
        lane_stride, draw_stride = 1, lanes
    else:
        out = torch.empty(tuple(shape) + (n,), dtype=torch.float32,
                          device=dev)
        lane_stride, draw_stride = n, 1
    k0, k1 = (int(k) & _M32 for k in key)
    args = DrawArgs(
        samples=None if samp is None else samp.data_ptr(),
        tags=None if tag_a is None else tag_a.data_ptr(),
        sids=sids.data_ptr(), out=out.data_ptr(), draw_stride=draw_stride,
        lane_stride=lane_stride, lanes=lanes, n=n, k0=k0, k1=k1,
        sample=sample, tag=tag)
    return args, out, (sids, samp, tag_a)


def draws(key, samples, tags, sids, n: int, cols: bool = False):
    """The PCG4D draws of utils/prng.uniforms ([..., n]), or with `cols`
    those of uniforms_cols (a tuple of n [...] columns), in one launch on
    the stream ids' CUDA device's current stream."""
    dev = sids.device
    if dev.type != "cuda":
        raise ValueError(f"draw kernel: stream ids on {dev}, want a CUDA "
                         "device")
    with torch.cuda.device(dev):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("draw kernel: called during a CUDA graph "
                               "capture, which would freeze its counters; "
                               "pass the draws into the graph as inputs")
        args, out, _keep = prepare(key, samples, tags, sids, n, cols)
        if args.lanes:
            launch(args, torch.cuda.current_stream(dev).cuda_stream)
    return out.unbind(0) if cols else out


_abi_checked = False


def launch(args: DrawArgs, stream: int) -> None:
    """One launch of the draw kernel on `stream` (of the current device),
    counted in launch.launches and the program's COUNTER; raises on a
    launch error."""
    global _abi_checked
    from raytracer_odin_tpu_torch.ops import cuda_build

    lib = cuda_build.load()
    if not _abi_checked:
        size = ctypes.c_int(0)
        lib.rt_draw_abi(ctypes.addressof(size))
        if size.value != ctypes.sizeof(DrawArgs):
            raise RuntimeError(f"draw kernel: argument struct of "
                               f"{size.value} bytes, ctypes has "
                               f"{ctypes.sizeof(DrawArgs)}")
        _abi_checked = True
    rc = lib.rt_draw_launch(ctypes.addressof(args), stream)
    if rc != 0:
        raise RuntimeError(f"draw kernel launch failed: cudaError {rc}")
    launch.launches += 1
    profiling.count(COUNTER)


launch.launches = 0
