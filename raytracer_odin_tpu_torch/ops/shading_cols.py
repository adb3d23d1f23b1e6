"""Columnar forms of the sampling and BRDF stage (port of
raytracer_odin_tpu/ops/shading_cols.py).

Function for function the JAX module: the same reference citations and
the same operation order, with every 3-vector a [3, N] column triple
(utils/vec3c.py) and the six uniforms a tuple of [N] columns. The columnar
compacted trace (integrator's COLUMNS layout, RT_TPU_COLS=1) shades through
it; every other route keeps the [..., 3] forms of ops/shading.py.
The only arithmetic difference from the row forms is the order of the
three-term reductions (torch.sum there, left to right here), and shade's
Lambert term, which the JAX module writes color * (cos / pi) where the row
form has (color * cos) / pi.
"""

from __future__ import annotations

import math

import torch

from raytracer_odin_tpu_torch.ops import shading
from raytracer_odin_tpu_torch.utils import vec3c as v3
from raytracer_odin_tpu_torch.utils.math3d import sq

PI = math.pi
TAU = 2.0 * math.pi


def sphere_uniform(u1, u2):
    """shading.sphere_uniform (shading.odin:9-15), columnar."""
    phi = TAU * u1
    z = 2.0 * u2 - 1.0
    r = torch.sqrt(torch.clamp(1.0 - sq(z), min=0.0))
    return torch.stack([torch.sin(phi) * r, torch.cos(phi) * r, z])


def cosine_weighted(n, u1, u2):
    """normalize(sphere_uniform() + n) (shading.odin:32-35)."""
    return v3.normalize(v3.add(sphere_uniform(u1, u2), n), eps=1e-20)


def cosine_weighted_pdf(n, omega):
    """max(dot(n, omega)/pi, 0) (shading.odin:37-39)."""
    return torch.clamp(v3.dot(n, omega) / PI, min=0.0)


def _light_columns(scene, idx):
    """The sampled lights' (p, u, v) rows as column triples: the row
    lookup (shading._small_table_lookup) split at the boundary."""
    return tuple(v3.splat(shading._small_table_lookup(t, idx))
                 for t in (scene.light_p, scene.light_u, scene.light_v))


def surface_sample(scene, origin, u_idx, u1, u2):
    """shading.surface_sample (shading.odin:41-50), columnar."""
    n_lights = scene.light_p.shape[0]
    idx = torch.clamp((u_idx * n_lights).to(torch.int32), max=n_lights - 1)
    flip = u1 + u2 > 1.0
    u = torch.where(flip, 1.0 - u1, u1)
    v = torch.where(flip, 1.0 - u2, u2)
    lp, lu, lv = _light_columns(scene, idx)
    world = v3.add(lp, v3.add(v3.scale(lu, u), v3.scale(lv, v)))
    return v3.normalize(v3.sub(world, origin), eps=1e-20)


def light_pdf_sum(scene, o, d, chunk: int = 256):
    """shading.light_pdf_sum (shading.odin:52-100) on column inputs: the
    row-form sweep behind a stack boundary (the sweep broadcasts each ray
    against a chunk of lights, which wants the rays as rows)."""
    if scene.light_p.shape[0] == 0:
        return torch.zeros(o.shape[1:], dtype=torch.float32, device=o.device)
    return shading.light_pdf_sum(scene, v3.stack(o), v3.stack(d),
                                 chunk=chunk)


def vndf_sample(n, omega, alpha, u1, u2):
    """shading.vndf_sample (Heitz VNDF, shading.odin:102-122), columnar."""
    rot = v3.quat_from_z_to(n)
    V = v3.quat_rotate(v3.quat_conj(rot), omega)
    Vh = v3.normalize(torch.stack([alpha * V[0], alpha * V[1], V[2]]),
                      eps=1e-20)
    lensq = torch.hypot(Vh[0], Vh[1])
    degen = lensq == 0
    safe_len = torch.where(degen, 1.0, lensq)
    T1 = torch.stack([torch.where(degen, 1.0, -Vh[1] / safe_len),
                      torch.where(degen, 0.0, Vh[0] / safe_len),
                      torch.zeros_like(safe_len)])
    T2 = v3.cross(Vh, T1)
    r = torch.sqrt(u1)
    phi = TAU * u2
    t1 = r * torch.sin(phi)
    t2 = r * torch.cos(phi)
    s = 0.5 * (1.0 + Vh[2])
    t2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - sq(t1), min=0.0)) + s * t2
    t3 = torch.sqrt(torch.clamp(1.0 - sq(t1) - sq(t2), min=0.0))
    Nh = v3.add(v3.add(v3.scale(T1, t1), v3.scale(T2, t2)), v3.scale(Vh, t3))
    Ne = v3.normalize(
        torch.stack([alpha * Nh[0], alpha * Nh[1],
                     torch.clamp(Nh[2], min=0.0)]),
        eps=1e-20)
    return v3.quat_rotate(rot, Ne)


def vndf_pdf(n, omega, alpha, L):
    """shading.vndf_pdf (shading.odin:124-137), columnar."""
    Ne = v3.normalize(v3.add(omega, L), eps=1e-20)
    rot = v3.quat_from_z_to(n)
    V = v3.quat_rotate(v3.quat_conj(rot), omega)
    N = v3.quat_rotate(v3.quat_conj(rot), Ne)
    alpha2 = sq(alpha)
    lam = (-1.0 + torch.sqrt(1.0 + alpha2 * (sq(V[0]) + sq(V[1]))
                             / sq(V[2]))) * 0.5
    G1 = 1.0 / (1.0 + lam)
    D = 1.0 / (PI * alpha2
               * sq(sq(N[0] / alpha) + sq(N[1] / alpha) + sq(N[2])))
    normal = G1 * torch.clamp(v3.dot(V, N), min=0.0) * D / V[2]
    return normal / (4.0 * v3.dot(L, Ne))


def sample_direction(scene, mat_pos, mat_normal, mat_roughness, in_d,
                     uniforms, has_lights: bool):
    """shading.sample_direction (shading.odin:139-151), columnar.
    uniforms: six [N] columns (strategy t, a, b, light index, a2, b2)."""
    t = uniforms[0]
    d_cos = cosine_weighted(mat_normal, uniforms[1], uniforms[2])
    if has_lights:
        d_light = surface_sample(scene, mat_pos, uniforms[3], uniforms[4],
                                 uniforms[5])
    else:
        d_light = d_cos
    nh = vndf_sample(mat_normal, v3.neg(in_d), sq(mat_roughness),
                     uniforms[4], uniforms[5])
    d_vndf = v3.sub(in_d, v3.scale(nh, 2.0 * v3.dot(nh, in_d)))

    use_cos = t <= 0.33333
    use_light = (~use_cos) & (t < 0.666666) & has_lights
    return v3.where(use_cos, d_cos, v3.where(use_light, d_light, d_vndf))


def bsdf_pdfs(mat_normal, mat_roughness, in_d, out_d):
    """shading.bsdf_pdfs, columnar: (cos_pdf, vndf_pdf) of out_d, the
    mixture's terms that read no light."""
    p_cos = cosine_weighted_pdf(mat_normal, out_d)
    p_vndf = vndf_pdf(mat_normal, v3.neg(in_d), sq(mat_roughness), out_d)
    return p_cos, p_vndf


def mixture_pdf(scene, mat_pos, mat_normal, mat_roughness, in_d, out_d,
                has_lights: bool, light_chunk: int = 256):
    """shading.mixture_pdf (shading.odin:153-162), columnar: bsdf_pdfs,
    the light pdf of shading.light_pdf behind a stack boundary (from
    light_cull.threshold() lights on the culled sum, K5 on the card, on any
    device, as the row form takes it), then shading.mix_pdfs."""
    p_cos, p_vndf = bsdf_pdfs(mat_normal, mat_roughness, in_d, out_d)
    p_light = (shading.light_pdf(scene, v3.stack(mat_pos), v3.stack(out_d),
                                 light_chunk) if has_lights else None)
    return shading.mix_pdfs(p_cos, p_light, p_vndf)


def shade(mat_color, mat_normal, mat_metallic, mat_roughness, in_d, out_d):
    """shading.shade (Cook-Torrance GGX + Lambert, shading.odin:164-204),
    columnar: BRDF x cos(theta) as a column triple."""
    alpha = sq(mat_roughness)
    alpha2 = sq(alpha)

    L = out_d
    V = v3.neg(in_d)
    H = v3.normalize(v3.add(L, V), eps=1e-20)
    N = mat_normal

    cosine = v3.dot(L, N)

    f0, f90 = 0.04, 1.0
    fb = 1.0 - v3.dot(H, L)
    fresnel_base = fb * fb * fb * fb * fb
    fresnel_diff_spec = f0 + (f90 - f0) * fresnel_base

    hn = v3.dot(H, N)
    distribution = (alpha2 * (hn >= 0).to(alpha2.dtype)
                    / (PI * sq((alpha2 - 1.0) * sq(hn) + 1.0)))

    def smith_g(x):
        c = v3.dot(N, x)
        return 2.0 * torch.clamp(c, min=0.0) / (
            c + torch.sqrt(alpha2 + (1.0 - alpha2) * sq(c)))

    geometry = smith_g(L) * smith_g(V)
    cook_torrance = distribution * geometry / (4.0 * v3.dot(V, N))

    lamb = torch.clamp(cosine, min=0.0) / PI

    fresnel_metallic = mat_color + (f90 - mat_color) * fresnel_base
    diffuse = mat_color * lamb
    metallic_term = cook_torrance * fresnel_metallic
    dielectric = diffuse + (cook_torrance - diffuse) * fresnel_diff_spec
    return dielectric + (metallic_term - dielectric) * mat_metallic
