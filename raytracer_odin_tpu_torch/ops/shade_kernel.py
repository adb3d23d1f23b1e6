"""The row layout's shading segment as one hand-written CUDA kernel
(csrc/shade_kernels.cu, whose note says what bounds it and what its design
does about that).

ops/integrator.py's segments of the row layout (first_segment,
later_segment) and their halves (first_head and first_tail, later_head and
later_tail) launch it for tensors on a CUDA device (`engages`); on the CPU
they run their PyTorch, and nothing falls back from the kernel to it. The
kernel computes what that PyTorch computes, expression by expression, so
on the card the two agree bit for bit (tests/test_torch_shade_kernel.py).
Its three forms:

  * `fused`: a segment of a scene on the dense light pdf (fewer lights
    than light_cull.threshold(), or none) in one launch: the head, the
    dense light pdf and the tail.
  * `head` and `tail`: the halves, which a segment of a scene on the
    culled light pdf launches with light_cull.light_pdf_sum_culled (the
    lists, K5) between them. `head` returns the PyTorch head's eight
    tensors as views of one [n, 20] buffer; `tail` takes them, or the
    PyTorch head's, and the light pdf.

Each takes `first`: bounce 0 (the camera rays o, d; the state padded to
whole RB blocks with dead lanes) or a later bounce (the lane state and its
alive mask). The scene's static facts are the kernel's arguments
(`scene_layout`): the offsets of its shade row's blocks (row_spec; an
absent block is -1), its texture kinds (tex_kinds), its env map (env_tex),
its light count and the dense sum's chunk of lights and step of lanes.
One kernel serves every scene; none is told apart by name. The draws stay
inputs ([N, 6]): the kernel has no generator.

`launch.launches` counts the kernel's launches that ran: each eager
launch, and each that a replay of a CUDA graph repeats (shade_graph adds
those; a capture and its warm-up are not counted). shade_graph.run counts
the program's `shade_kernel` counter (COUNTER) for a shade span in which
it grew.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from raytracer_odin_tpu_torch.ops import pallas_intersect as pi
from raytracer_odin_tpu_torch.ops import shading

# Kernel modes (csrc/shade_kernels.cu).
FUSED, HEAD, TAIL = 0, 1, 2
# The head buffer [n, HEAD_W]: pos 0:3, new_d 3:6, throughput 6:9,
# radiance 9:12, value 12:15, p_cos 15, p_vndf 16, 3 pad.
HEAD_W = 20
# The program's counter of shade spans in which the kernel ran
# (utils/profiling.py; counted by shade_graph.run).
COUNTER = "shade_kernel"

# A shade row's blocks (models/build.py) and their widths, in the order of
# the kernel's offset arguments.
ROW_BLOCKS = (("ng", 3), ("n", 9), ("tex", 6), ("tan", 12), ("color", 3),
              ("emission", 3), ("metallic", 1), ("roughness", 1),
              ("texids", 4), ("tri_p", 3), ("tri_u", 3), ("tri_v", 3))
_REQUIRED = ("ng", "n", "color", "emission", "metallic", "roughness",
             "tri_p", "tri_u", "tri_v")


def engages(device) -> bool:
    """Whether the shade kernel shades the row layout's segments for
    tensors on `device`: on any CUDA device."""
    return torch.device(device).type == "cuda"


class SceneLayout(NamedTuple):
    """The kernel's integer arguments for a scene: its shade row's width,
    the offset of each block of ROW_BLOCKS (-1: absent), its texture kinds
    (color, emission, metallic-roughness, normal), its env map's atlas
    entry (-1: none), its light count, and the dense light pdf's lights and
    lanes a step (shading.light_pdf_sum's chunk and pdf_lanes)."""
    row_width: int
    offsets: tuple
    kinds: tuple
    env_tex: int
    n_lights: int
    light_chunk: int
    pdf_lanes: int


def scene_layout(scene, light_chunk: int) -> SceneLayout:
    """The scene's static facts as the kernel's arguments; raises
    ValueError for a row layout the kernel cannot read."""
    spec = dict(scene.row_spec)
    widths = dict(ROW_BLOCKS)
    row_width = int(scene.shade_row.shape[1])
    bad = sorted(set(spec) - set(widths))
    bad += [n for n in _REQUIRED if n not in spec]
    bad += [n for n in spec if n in widths
            and not 0 <= spec[n] <= row_width - widths[n]]
    kinds = tuple(int(bool(k)) for k in scene.tex_kinds)
    if any(kinds) and not ("tex" in spec and "texids" in spec):
        bad.append("tex/texids (textured kinds)")
    if kinds[3] and "tan" not in spec:
        bad.append("tan (normal maps)")
    if bad:
        raise ValueError(f"shade kernel: row_spec {scene.row_spec!r} of "
                         f"width {row_width}: bad blocks {bad}")
    n_lights = int(scene.light_p.shape[0])
    chunk = int(light_chunk)
    if chunk < 1:
        raise ValueError(f"shade kernel: light_chunk {chunk} < 1")
    return SceneLayout(row_width,
                       tuple(int(spec.get(n, -1)) for n, _ in ROW_BLOCKS),
                       kinds, int(scene.env_tex), n_lights, chunk,
                       shading.pdf_lanes(n_lights, chunk))


def _host_reciprocal(x: float) -> float:
    """1 / x in float32, as torch's CUDA division by a host scalar makes
    the factor it multiplies with."""
    return float(np.float32(1.0) / np.float32(x))


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class _Scene(ctypes.Structure):
    """csrc/shade_kernels.cu's ShadeScene, field for field."""
    _fields_ = ([(n, _P) for n in ("shade_row", "texels", "texels_srgb",
                                   "tex_offset", "tex_width", "tex_height",
                                   "light_rows")]
                + [("row_width", _I)]
                + [("off_" + n, _I) for n, _ in ROW_BLOCKS]
                + [(n, _I) for n in ("kind_color", "kind_emission",
                                     "kind_mr", "kind_normal", "env_tex",
                                     "n_lights", "light_chunk", "pdf_lanes")]
                + [(n, _F) for n in ("inv_pi", "inv_tau", "inv_three",
                                     "inv_lights")])


_TAIL_INPUTS = ("pos", "new_d", "p_cos", "p_vndf", "value", "hit", "thr",
                "rad", "p_light")


class _Lanes(ctypes.Structure):
    """csrc/shade_kernels.cu's ShadeLanes, field for field."""
    _fields_ = ([(n, _I) for n in ("n", "npad", "first", "has_p_light")]
                + [(n, _P) for n in ("o", "d", "state", "t", "tri_idx",
                                     "alive", "uniforms")]
                + [(n, _P) for n in _TAIL_INPUTS]
                + [(n + "_s", _I) for n in _TAIL_INPUTS]
                + [(n, _P) for n in ("state_out", "alive_out", "head_out",
                                     "hit_out")])


def _device(x) -> torch.device:
    if x.device.type != "cuda":
        raise ValueError(f"shade kernel: tensors on {x.device}, want a "
                         "CUDA device")
    return x.device


def _flat(x, width: int, dtype=torch.float32):
    """x as a contiguous [n, width] ([n] for width 0) tensor of dtype that
    starts on a 16-byte boundary (the kernel's vector loads)."""
    x = x.reshape(-1, width) if width else x.reshape(-1)
    x = x.to(dtype).contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _strided(x, width: int):
    """(x as [n, width] or [n] with unit inner stride, its row stride)."""
    x = x.reshape(-1, width) if width else x.reshape(-1)
    if x.dtype not in (torch.float32, torch.bool):
        x = x.to(torch.float32)
    if width and x.stride(1) != 1:
        x = x.contiguous()
    return x, x.stride(0)


def _scene_args(scene, light_chunk: int, dev) -> _Scene:
    lay = scene_layout(scene, light_chunk)
    tensors = {"shade_row": scene.shade_row, "texels": scene.tex_texels,
               "texels_srgb": scene.tex_texels_srgb,
               "tex_offset": scene.tex_offset, "tex_width": scene.tex_width,
               "tex_height": scene.tex_height,
               "light_rows": scene.light_rows}
    for name, x in tensors.items():
        if x.device != dev or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"shade kernel: scene.{name} must be a "
                             f"contiguous tensor on {dev} that starts on a "
                             "16-byte boundary")
    kw = {name: x.data_ptr() for name, x in tensors.items()}
    kw.update({"off_" + n: off for (n, _), off in zip(ROW_BLOCKS,
                                                      lay.offsets)})
    kw.update(zip(("kind_color", "kind_emission", "kind_mr", "kind_normal"),
                  lay.kinds))
    return _Scene(
        **kw, row_width=lay.row_width, env_tex=lay.env_tex,
        n_lights=lay.n_lights, light_chunk=lay.light_chunk,
        pdf_lanes=lay.pdf_lanes, inv_pi=_host_reciprocal(math.pi),
        inv_tau=_host_reciprocal(2.0 * math.pi),
        inv_three=_host_reciprocal(3.0),
        inv_lights=_host_reciprocal(lay.n_lights) if lay.n_lights else 0.0)


_abi_checked = False


def launch(mode: int, sc: _Scene, ln: _Lanes, dev) -> None:
    """One launch of the shade kernel in `mode` on `dev`'s current stream,
    counted in launch.launches (module docstring)."""
    global _abi_checked
    from raytracer_odin_tpu_torch.ops import cuda_build

    lib = cuda_build.load()
    if not _abi_checked:
        sizes = (ctypes.c_int * 2)()
        lib.rt_shade_abi(ctypes.addressof(sizes))
        want = (ctypes.sizeof(_Scene), ctypes.sizeof(_Lanes))
        if tuple(sizes) != want:
            raise RuntimeError(f"shade kernel: argument structs of "
                               f"{tuple(sizes)} bytes, ctypes has {want}")
        _abi_checked = True
    if ln.npad == 0:
        return
    rc = pi._launch(lib.rt_shade_launch, mode, ctypes.addressof(sc),
                    ctypes.addressof(ln), device=dev)
    if rc != 0:
        raise RuntimeError(f"shade kernel launch failed: cudaError {rc}")
    launch.launches += 1


launch.launches = 0


def _head_lanes(first: bool, x, d, t, tri_idx, alive, uniforms):
    """The lane inputs of a FUSED or HEAD launch: (lanes, the tensors it
    points into). first: x, d are bounce 0's camera rays [..., 3]; else x
    is the lane state [N, 12] and alive its mask."""
    n = t.numel()
    keep = {"t": _flat(t, 0), "tri_idx": _flat(tri_idx, 0, torch.int32),
            "uniforms": _flat(uniforms, 6)}
    if first:
        keep.update(o=_flat(x, 3), d=_flat(d, 3))
    else:
        keep.update(state=_flat(x, 12), alive=_flat(alive, 0, torch.bool))
    ln = _Lanes(n=n, npad=n, first=int(first),
                **{k: v.data_ptr() for k, v in keep.items()})
    return ln, keep


def fused(scene, first: bool, x, d, t, tri_idx, alive, uniforms,
          light_chunk: int):
    """A whole segment, one launch: (state, alive), [Npad, 12] and [Npad]
    at bounce 0 (`first`; x, d the camera rays), else [N, 12] and [N] (x
    the lane state, alive its mask)."""
    dev = _device(t)
    ln, keep = _head_lanes(first, x, d, t, tri_idx, alive, uniforms)
    if first:
        ln.npad = -(-ln.n // pi.RB) * pi.RB
    state = torch.empty((ln.npad, 12), dtype=torch.float32, device=dev)
    alive_out = torch.empty((ln.npad,), dtype=torch.bool, device=dev)
    ln.state_out, ln.alive_out = state.data_ptr(), alive_out.data_ptr()
    launch(FUSED, _scene_args(scene, light_chunk, dev), ln, dev)
    return state, alive_out


def head(scene, first: bool, x, d, t, tri_idx, alive, uniforms,
         light_chunk: int):
    """A segment up to the light pdf, the inputs as `fused` takes them:
    the PyTorch head's eight tensors (pos, new_d, p_cos, p_vndf, value,
    hit, throughput, radiance), flat over the lanes."""
    dev = _device(t)
    ln, keep = _head_lanes(first, x, d, t, tri_idx, alive, uniforms)
    buf = torch.empty((ln.n, HEAD_W), dtype=torch.float32, device=dev)
    hit = torch.empty((ln.n,), dtype=torch.bool, device=dev)
    ln.head_out, ln.hit_out = buf.data_ptr(), hit.data_ptr()
    launch(HEAD, _scene_args(scene, light_chunk, dev), ln, dev)
    return (buf[:, 0:3], buf[:, 3:6], buf[:, 15], buf[:, 16], buf[:, 12:15],
            hit, buf[:, 6:9], buf[:, 9:12])


def tail(scene, first: bool, pos, new_d, p_cos, p_vndf, value, hit,
         throughput, radiance, p_light, light_chunk: int):
    """A segment from the light pdf p_light on, given a head's eight
    tensors: (state, alive) as `fused` returns them."""
    dev = _device(pos)
    n = hit.numel()
    npad = -(-n // pi.RB) * pi.RB if first else n
    ins = dict(zip(_TAIL_INPUTS, (pos, new_d, p_cos, p_vndf, value, hit,
                                  throughput, radiance, p_light)))
    widths = {"pos": 3, "new_d": 3, "value": 3, "thr": 3, "rad": 3}
    ln = _Lanes(n=n, npad=npad, first=int(first),
                has_p_light=int(p_light is not None))
    keep = []
    for name, x in ins.items():
        if x is None:
            continue
        x, stride = _strided(x, widths.get(name, 0))
        keep.append(x)
        setattr(ln, name, x.data_ptr())
        setattr(ln, name + "_s", stride)
    state = torch.empty((npad, 12), dtype=torch.float32, device=dev)
    alive = torch.empty((npad,), dtype=torch.bool, device=dev)
    ln.state_out, ln.alive_out = state.data_ptr(), alive.data_ptr()
    launch(TAIL, _scene_args(scene, light_chunk, dev), ln, dev)
    return state, alive
