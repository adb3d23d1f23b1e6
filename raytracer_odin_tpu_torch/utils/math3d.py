"""Vector and quaternion math on [..., k] tensors, and the host-side
projection helpers of the debug overlay (port of
raytracer_odin_tpu/utils/math3d.py)."""

from __future__ import annotations

import numpy as np
import torch


def sq(x):
    """x*x (utils.odin:6)."""
    return x * x


def device_vector(values, dtype=torch.float32, device="cpu"):
    """A small constant vector written on `device` by fill kernels.
    torch.tensor(values, device=<a card>) copies from pageable host memory,
    which waits for the card's queue to drain: inside a render step that
    stalls the host's enqueue (chip_smoke.py lists such syncs)."""
    out = torch.zeros(len(values), dtype=dtype, device=device)
    for i, v in enumerate(values):
        if v:
            out[i].fill_(v)
    return out


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def norm_l1(x):
    """Sum of absolute components (utils.odin:10)."""
    return torch.sum(torch.abs(x), dim=-1)


def length(x):
    return torch.sqrt(torch.sum(x * x, dim=-1))


def normalize(x, eps: float = 0.0):
    n = length(x)[..., None]
    if eps:
        n = torch.clamp(n, min=eps)
    return x / n


def cross(a, b):
    """3-vector cross product over the last axis (broadcasting), with
    jnp.cross's component formulas."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


# Quaternions, (..., 4) as (x, y, z, w): the VNDF sampler's tangent frame
# rotates the shading normal onto +z (shading.odin:104-106).

def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_rotate(q, v):
    """v + 2*cross(q.xyz, cross(q.xyz, v) + w*v)."""
    u = q[..., :3]
    w = q[..., 3:4]
    t = cross(u, v) + w * v
    return v + 2.0 * cross(u, t)


def quat_from_z_to(n):
    """Quaternion mapping local +z onto world direction n: w =
    sqrt((1+n.z)/2), q = (-n.y/(2w), n.x/(2w), 0, w); a 180-degree turn
    about x when n.z == -1."""
    nz = n[..., 2]
    w = torch.sqrt(torch.clamp((1.0 + nz) * 0.5, min=0.0))
    safe_w = torch.where(w > 0, w, torch.ones_like(w))
    qx = -n[..., 1] / (2.0 * safe_w)
    qy = n[..., 0] / (2.0 * safe_w)
    qz = torch.zeros_like(w)
    q_main = torch.stack([qx, qy, qz, w], dim=-1)
    q_flip = device_vector((1.0, 0.0, 0.0, 0.0), n.dtype,
                           n.device).expand_as(q_main)
    return torch.where((w > 0)[..., None], q_main, q_flip)


# ---------------------------------------------------------------------------
# Projection helpers for the debug-line overlay (utils.odin:22-98). Host-side
# numpy, as in the JAX package: they draw on snapshots, not in the hot path.
# ---------------------------------------------------------------------------

def world_to_screen(cam_pos, cam_basis, fov_x, dims, point):
    """Perspective projection of a world point to pixel coords
    (utils.odin:22-37).

    dims = (width, height). Returns (x, y) with y flipped to image rows; NaN
    when the point is (numerically) in the camera plane."""
    p = np.asarray(point, np.float32) - np.asarray(cam_pos, np.float32)
    p = np.linalg.inv(np.asarray(cam_basis, np.float32)) @ p
    if abs(p[2]) < 1e-6:
        return np.array([np.nan, np.nan], np.float32)
    p = p / p[2]
    w, h = float(dims[0]), float(dims[1])
    aspect = w / h
    tan_fx = np.tan(fov_x / 2)
    tan_fy = tan_fx / aspect
    sx = (p[0] / tan_fx * 0.5 + 0.5) * w
    sy = (p[1] / tan_fy * 0.5 + 0.5) * h
    return np.array([sx, h - sy], np.float32)


def line_to_screen(cam_pos, cam_basis, fov_x, dims, p0_world, p1_world):
    """Clip a world-space segment against the 5-plane view frustum and
    project it (utils.odin:39-98). Returns (s0, s1, ok)."""
    inv = np.linalg.inv(np.asarray(cam_basis, np.float32))
    p0 = inv @ (np.asarray(p0_world, np.float32) - cam_pos)
    p1 = inv @ (np.asarray(p1_world, np.float32) - cam_pos)
    w, h = float(dims[0]), float(dims[1])
    aspect = w / h
    tan_fx = np.tan(fov_x / 2)
    tan_fy = tan_fx / aspect

    planes = [
        lambda p: p[2] - 1e-3,
        lambda p: p[0] + tan_fx * p[2],
        lambda p: tan_fx * p[2] - p[0],
        lambda p: p[1] + tan_fy * p[2],
        lambda p: tan_fy * p[2] - p[1],
    ]
    for plane in planes:
        f0, f1 = plane(p0), plane(p1)
        if f0 < 0 and f1 < 0:
            return None, None, False
        if f0 < 0:
            t = f0 / (f0 - f1)
            p0 = p0 + (p1 - p0) * t
        elif f1 < 0:
            t = f0 / (f0 - f1)
            p1 = p0 + (p1 - p0) * t

    def project(p):
        p = p / p[2]
        sx = (p[0] / tan_fx * 0.5 + 0.5) * w
        sy = (p[1] / tan_fy * 0.5 + 0.5) * h
        return np.array([sx, h - sy], np.float32)

    return project(p0), project(p1), True
