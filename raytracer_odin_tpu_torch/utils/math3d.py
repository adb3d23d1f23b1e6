"""Vector and quaternion math on [..., k] tensors (port of
raytracer_odin_tpu/utils/math3d.py; the host-side projection helpers of
the debug overlay are not ported)."""

from __future__ import annotations

import torch


def sq(x):
    """x*x (utils.odin:6)."""
    return x * x


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
    q_flip = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=n.dtype,
                          device=n.device).expand_as(q_main)
    return torch.where((w > 0)[..., None], q_main, q_flip)
