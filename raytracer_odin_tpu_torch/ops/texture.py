"""Texture atlas + bilinear sampling (port of
raytracer_odin_tpu/ops/texture.py).

All textures live in one [P, 16] float32 pool of quad-packed rows (each
row carries its bilinear footprint p00, p10, p01, p11, wrapped at build
time), so one bilinear tap is one row gather. Sampling semantics follow
textures.odin:79-135: pixel = uv * dims, floor with floor-mod wrap, sRGB
decode before the lerp (pre-decoded pool), default value for tex id < 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from raytracer_odin_tpu_torch.utils.math3d import device_vector


def build_atlas(textures) -> dict:
    """Pack decoded HostTextures into the quad-packed pool (numpy):
    texels [P, 16], offset/width/height [K]."""
    texels = []
    offsets, widths, heights = [], [], []
    off = 0
    for t in textures:
        h, w, c = t.data.shape
        rgba = np.ones((h, w, 4), np.float32)
        rgba[..., :c] = t.data[..., :4]
        xp = np.roll(rgba, -1, axis=1)   # (x+1) % w
        yp = np.roll(rgba, -1, axis=0)   # (y+1) % h
        xyp = np.roll(xp, -1, axis=0)
        quad = np.concatenate([rgba, xp, yp, xyp], axis=-1)  # [h, w, 16]
        texels.append(quad.reshape(-1, 16))
        offsets.append(off)
        widths.append(w)
        heights.append(h)
        off += h * w
    if not texels:
        texels = [np.ones((1, 16), np.float32)]
        offsets, widths, heights = [0], [1], [1]
    return {
        "tex_texels": np.concatenate(texels, axis=0),
        "tex_offset": np.array(offsets, np.int32),
        "tex_width": np.array(widths, np.int32),
        "tex_height": np.array(heights, np.int32),
    }


_SRGB_COLS = [c for q in range(4) for c in (4 * q, 4 * q + 1, 4 * q + 2)]


def srgb_decode_pool(texels: np.ndarray) -> np.ndarray:
    """pow(2.2) decode of a quad-packed pool's rgb columns (alpha passes
    through), hoisted out of the per-sample path (textures.odin:99-101)."""
    out = np.array(texels, np.float32, copy=True)
    cols = out[:, _SRGB_COLS]
    out[:, _SRGB_COLS] = np.power(np.maximum(cols, 0.0), np.float32(2.2))
    return out


def sample(scene, tex_id, uv, srgb: bool = False,
           default=(1.0, 1.0, 1.0, 1.0)):
    """Bilinear sample; tex_id [...] int32, uv [..., 2] -> [..., 4]."""
    tid = torch.clamp(tex_id, min=0).long()
    w = scene.tex_width[tid]
    h = scene.tex_height[tid]
    off = scene.tex_offset[tid]

    dims = torch.stack([w, h], dim=-1).to(torch.float32)
    pix = uv * dims
    lo = torch.floor(pix)
    t = pix - lo

    dims_i = torch.stack([w, h], dim=-1)
    c00 = torch.remainder(lo.to(torch.int32), dims_i)

    pool = scene.tex_texels_srgb if srgb else scene.tex_texels
    quad = pool[(off + c00[..., 1] * w + c00[..., 0]).long()]  # [..., 16]
    p00 = quad[..., 0:4]
    p10 = quad[..., 4:8]
    p01 = quad[..., 8:12]
    p11 = quad[..., 12:16]

    ty = t[..., 1:2]
    tx = t[..., 0:1]
    out = (p00 + (p01 - p00) * ty) * (1 - tx) + (p10 + (p11 - p10) * ty) * tx

    default_arr = device_vector(default, out.dtype, out.device)
    return torch.where((tex_id >= 0)[..., None], out, default_arr)


def sample_env(scene, d, env_tex_id: int):
    """Equirectangular environment lookup on ray miss
    (raytracer.odin:437-446): u = 0.5 + atan2(d.z, d.x)/tau,
    v = 0.5 - asin(d.y)/pi."""
    u = 0.5 + torch.atan2(d[..., 2], d[..., 0]) / (2.0 * math.pi)
    v = 0.5 - torch.asin(torch.clamp(d[..., 1], -1.0, 1.0)) / math.pi
    uv = torch.stack([u, v], dim=-1)
    tex_id = torch.full(d.shape[:-1], env_tex_id, dtype=torch.int32,
                        device=d.device)
    return sample(scene, tex_id, uv, srgb=False,
                  default=(0.0, 0.0, 0.0, 0.0))[..., :3]


def sample_env_cols(scene, d, env_tex_id: int):
    """Columnar `sample_env`: d is a [3, ...] column triple; returns the
    (r, g, b) column triple. The equirect mapping runs on columns; the uv
    pair and the quad-row gather keep their row form."""
    u = 0.5 + torch.atan2(d[2], d[0]) / (2.0 * math.pi)
    v = 0.5 - torch.asin(torch.clamp(d[1], -1.0, 1.0)) / math.pi
    uv = torch.stack([u, v], dim=-1)
    tex_id = torch.full(d.shape[1:], env_tex_id, dtype=torch.int32,
                        device=d.device)
    out = sample(scene, tex_id, uv, srgb=False,
                 default=(0.0, 0.0, 0.0, 0.0))
    return out[..., :3].movedim(-1, 0).contiguous()
