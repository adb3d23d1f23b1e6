"""Columnar 3-vector math (port of raytracer_odin_tpu/utils/vec3c.py).

A column triple is a [3, ...] tensor: row c holds component c of every
lane, contiguous, so an operation on all three components is one eager
launch. Quaternions are [4, ...] (x, y, z, w). Every helper repeats the JAX
module's per-component arithmetic in its order (dot is a0*b0 + a1*b1 +
a2*b2, left to right), so results equal the row forms of utils/math3d.py
but for the three-term reduction order of torch.sum, which may differ in
the last ulp. `stack` gives the [..., 3] form the row functions take, and
`splat` goes back.
"""

from __future__ import annotations

import torch


def splat(v):
    """[..., 3] -> [3, ...], each component row contiguous."""
    return v.movedim(-1, 0).contiguous()


def stack(v):
    """[3, ...] -> [..., 3] (boundary use only)."""
    return v.movedim(0, -1).contiguous()


def add(a, b):
    return a + b


def sub(a, b):
    return a - b


def neg(a):
    return -a


def scale(a, s):
    """Vector times a scalar column (or a python number)."""
    return a * s


def mul(a, b):
    """Componentwise product."""
    return a * b


def dot(a, b):
    p = a * b
    return p[0] + p[1] + p[2]


def cross(a, b):
    """(a1 b2 - a2 b1, a2 b0 - a0 b2, a0 b1 - a1 b0). The components are
    rotated with torch.roll: indexing a card's tensor with a python list
    copies the list to the card, which waits for its queue."""
    ay, az = torch.roll(a, -1, 0), torch.roll(a, -2, 0)
    by, bz = torch.roll(b, -1, 0), torch.roll(b, -2, 0)
    return ay * bz - az * by


def norm_l1(a):
    p = torch.abs(a)
    return p[0] + p[1] + p[2]


def length(a):
    return torch.sqrt(dot(a, a))


def normalize(a, eps: float = 0.0):
    n = length(a)
    if eps:
        n = torch.clamp(n, min=eps)
    return a / n


def where(c, a, b):
    """Per-component select by a boolean column."""
    return torch.where(c, a, b)


# ---------------------------------------------------------------------------
# Columnar quaternions (x, y, z, w), as math3d's quaternion helpers.
# ---------------------------------------------------------------------------

def quat_conj(q):
    return torch.cat([-q[:3], q[3:]])


def quat_rotate(q, v):
    """v + 2*cross(q.xyz, cross(q.xyz, v) + w*v) (math3d.quat_rotate)."""
    u = q[:3]
    t = cross(u, v) + v * q[3]
    return v + cross(u, t) * 2.0


def quat_from_z_to(n):
    """Quaternion mapping +z onto n (math3d.quat_from_z_to,
    shading.odin:104-106); a 180-degree turn about x when n.z == -1."""
    w = torch.sqrt(torch.clamp((1.0 + n[2]) * 0.5, min=0.0))
    ok = w > 0
    safe_w = torch.where(ok, w, 1.0)
    qx = -n[1] / (2.0 * safe_w)
    qy = n[0] / (2.0 * safe_w)
    zero = torch.zeros_like(w)
    return torch.stack([torch.where(ok, qx, 1.0), torch.where(ok, qy, 0.0),
                        zero, torch.where(ok, w, 0.0)])
