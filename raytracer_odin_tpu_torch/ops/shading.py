"""Sampling strategies + BRDF (port of raytracer_odin_tpu/ops/shading.py,
shading.odin).

One-sample MIS mixture, weights 1/3 cosine-hemisphere, 1/3 emissive
surface, 1/3 GGX-VNDF (shading.odin:139-151); without emissive surfaces the
light branch is skipped and VNDF takes its mass (pdf weighted x2). The
light pdf sums over every emissive triangle hit along the ray, converting
area to solid angle with t^2/|cos| (shading.odin:52-60): a dense sweep
over the light list, or from light_cull.threshold() lights on the
cluster-culled sum of K5 (ops/light_cull.py). The BRDF is glTF metallic-roughness Cook-Torrance GGX
+ Lambert (shading.odin:164-204), term by term with its quirks. All
randomness comes in as explicit uniform tensors.
"""

from __future__ import annotations

import math

import torch

from raytracer_odin_tpu_torch.ops import light_cull
from raytracer_odin_tpu_torch.ops.geometry import RAY_EPS, intersect_triangle
from raytracer_odin_tpu_torch.utils.math3d import (
    cross,
    device_vector,
    dot,
    normalize,
    quat_conj,
    quat_from_z_to,
    quat_rotate,
    sq,
)

PI = math.pi
TAU = 2.0 * math.pi


def sphere_uniform(u1, u2):
    """Uniform direction on the unit sphere (shading.odin:9-15)."""
    phi = TAU * u1
    z = 2.0 * u2 - 1.0
    r = torch.sqrt(torch.clamp(1.0 - sq(z), min=0.0))
    return torch.stack([torch.sin(phi) * r, torch.cos(phi) * r, z], dim=-1)


def cosine_weighted(n, u1, u2):
    """normalize(sphere_uniform() + n) (shading.odin:32-35)."""
    return normalize(sphere_uniform(u1, u2) + n, eps=1e-20)


def cosine_weighted_pdf(n, omega):
    """max(dot(n, omega)/pi, 0) (shading.odin:37-39)."""
    return torch.clamp(dot(n, omega) / PI, min=0.0)


def _small_table_lookup(table, idx):
    """Row lookup of a small table. The JAX package contracts a one-hot
    matrix to dodge the TPU's fixed per-gather cost; it yields the table
    rows exactly, and so does a plain gather on the GPU."""
    return table[idx.long()]


def surface_sample(scene, origin, u_idx, u1, u2):
    """Pick a uniform emissive triangle and a uniform point on it
    (shading.odin:41-50); returns the normalized direction from origin."""
    n_lights = scene.light_p.shape[0]
    idx = torch.clamp((u_idx * n_lights).to(torch.int32), max=n_lights - 1)
    flip = u1 + u2 > 1.0
    u = torch.where(flip, 1.0 - u1, u1)
    v = torch.where(flip, 1.0 - u2, u2)
    world = (
        _small_table_lookup(scene.light_p, idx)
        + u[..., None] * _small_table_lookup(scene.light_u, idx)
        + v[..., None] * _small_table_lookup(scene.light_v, idx)
    )
    return normalize(world - origin, eps=1e-20)


# Lane-light pairs a step of the dense light pdf: each [lanes, lights, 3]
# intermediate stays near 200 MB (a whole 1080p batch against 256 lights
# made them 6.4 GB each), and a scene with a few lights keeps its batch in
# one step.
PDF_PAIRS = 1 << 24


def pdf_lanes(n_lights: int, chunk: int = 256) -> int:
    """Lanes a step of light_pdf_sum with `chunk` lights at a time."""
    return max(1, PDF_PAIRS // max(1, min(chunk, n_lights)))


def light_pdf_terms(scene, o, d, s: int, e: int):
    """bu, bv and the contributions fac * t^2/|dot(ng, d)| of lights s..e-1
    for rays o, d [..., 3] (RAY_EPS offset applied), each [..., e - s]: the
    contribution is 0 where the ray misses, at t < 0 and where it is NaN;
    +inf is kept."""
    t, bu, bv, ok = intersect_triangle(
        o[..., None, :], d[..., None, :], scene.light_p[s:e],
        scene.light_u[s:e], scene.light_v[s:e],
    )
    ok = ok & (t >= 0)
    ng = scene.light_ng[s:e].expand(t.shape + (3,))
    w = sq(t) / torch.abs(dot(ng, d[..., None, :]))
    contrib = torch.where(ok, scene.light_pdf_factor[s:e] * w, 0.0)
    return bu, bv, torch.where(torch.isnan(contrib), 0.0, contrib)


def light_pdf_sum(scene, o, d, chunk: int = 256, lanes: int | None = None):
    """Sum of per-triangle solid-angle pdfs over ALL emissive triangles hit
    along the ray (shading.odin:52-100), divided by the light count: origin
    offset by RAY_EPS, hits counted when t >= 0, weight t^2/|dot(ng, d)|
    times 2/|cross(u, v)|; NaN contributions count 0, +inf is kept. Lights
    go `chunk` at a time and lanes `lanes` at a time (pdf_lanes by
    default); a lane's sum does not depend on the lanes beside it."""
    n_lights = scene.light_p.shape[0]
    if n_lights == 0:
        return torch.zeros(o.shape[:-1], dtype=torch.float32, device=o.device)
    lanes = lanes or pdf_lanes(n_lights, chunk)
    o = o + d * RAY_EPS
    o2, d2 = o.reshape(-1, 3), d.reshape(-1, 3)
    sums = []
    for a in range(0, max(1, o2.shape[0]), lanes):
        oa, da = o2[a:a + lanes], d2[a:a + lanes]
        acc = torch.zeros(oa.shape[:1], dtype=torch.float32, device=o.device)
        for s in range(0, n_lights, chunk):
            contrib = light_pdf_terms(scene, oa, da, s, min(n_lights,
                                                            s + chunk))[2]
            acc = acc + torch.sum(contrib, dim=-1)
        sums.append(acc)
    total = sums[0] if len(sums) == 1 else torch.cat(sums)
    return (total / n_lights).reshape(o.shape[:-1])


def vndf_sample(n, omega, alpha, u1, u2):
    """Heitz VNDF sampling of the GGX half-vector (shading.odin:102-122).
    `omega` is the view direction (-in_ray.d), alpha = roughness^2."""
    rot = quat_from_z_to(n)
    V = quat_rotate(quat_conj(rot), omega)
    Vh = normalize(
        torch.stack([alpha * V[..., 0], alpha * V[..., 1], V[..., 2]], dim=-1),
        eps=1e-20,
    )
    lensq = torch.hypot(Vh[..., 0], Vh[..., 1])
    safe_len = torch.where(lensq == 0, 1.0, lensq)
    ex = device_vector((1.0, 0.0, 0.0), n.dtype, n.device)
    T1 = torch.where(
        (lensq == 0)[..., None],
        ex.expand(Vh.shape),
        torch.stack(
            [-Vh[..., 1] / safe_len, Vh[..., 0] / safe_len,
             torch.zeros_like(safe_len)],
            dim=-1,
        ),
    )
    T2 = cross(Vh, T1)
    r = torch.sqrt(u1)
    phi = TAU * u2
    t1 = r * torch.sin(phi)
    t2 = r * torch.cos(phi)
    s = 0.5 * (1.0 + Vh[..., 2])
    t2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - sq(t1), min=0.0)) + s * t2
    Nh = (
        t1[..., None] * T1
        + t2[..., None] * T2
        + torch.sqrt(torch.clamp(1.0 - sq(t1) - sq(t2), min=0.0))[..., None]
        * Vh
    )
    Ne = normalize(
        torch.stack(
            [alpha * Nh[..., 0], alpha * Nh[..., 1],
             torch.clamp(Nh[..., 2], min=0.0)],
            dim=-1,
        ),
        eps=1e-20,
    )
    return quat_rotate(rot, Ne)


def vndf_pdf(n, omega, alpha, L):
    """VNDF pdf of reflecting `omega` to L (shading.odin:124-137)."""
    Ne = normalize(omega + L, eps=1e-20)
    rot = quat_from_z_to(n)
    V = quat_rotate(quat_conj(rot), omega)
    N = quat_rotate(quat_conj(rot), Ne)
    alpha2 = sq(alpha)
    lam = (
        -1.0
        + torch.sqrt(1.0 + alpha2 * (sq(V[..., 0]) + sq(V[..., 1]))
                     / sq(V[..., 2]))
    ) * 0.5
    G1 = 1.0 / (1.0 + lam)
    D = 1.0 / (
        PI
        * alpha2
        * sq(sq(N[..., 0] / alpha) + sq(N[..., 1] / alpha) + sq(N[..., 2]))
    )
    normal = G1 * torch.clamp(dot(V, N), min=0.0) * D / V[..., 2]
    return normal / (4.0 * dot(L, Ne))


def sample_direction(scene, mat_pos, mat_normal, mat_roughness, in_d,
                     uniforms, has_lights: bool):
    """One bounce direction from the 1/3-1/3-1/3 mixture
    (shading.odin:139-151). uniforms: [..., 6] = (strategy t, a, b, light
    index, a2, b2); all candidates are computed and selected by t."""
    t = uniforms[..., 0]
    d_cos = cosine_weighted(mat_normal, uniforms[..., 1], uniforms[..., 2])
    if has_lights:
        d_light = surface_sample(
            scene, mat_pos, uniforms[..., 3], uniforms[..., 4],
            uniforms[..., 5],
        )
    else:
        d_light = d_cos
    nh = vndf_sample(mat_normal, -in_d, sq(mat_roughness), uniforms[..., 4],
                     uniforms[..., 5])
    d_vndf = in_d - 2.0 * dot(nh, in_d)[..., None] * nh

    use_cos = t <= 0.33333
    use_light = (~use_cos) & (t < 0.666666) & has_lights
    return torch.where(
        use_cos[..., None], d_cos,
        torch.where(use_light[..., None], d_light, d_vndf),
    )


def bsdf_pdfs(mat_normal, mat_roughness, in_d, out_d):
    """(cos_pdf, vndf_pdf) of out_d: the mixture's terms that read no
    light (shading.odin:153-162)."""
    p_cos = cosine_weighted_pdf(mat_normal, out_d)
    p_vndf = vndf_pdf(mat_normal, -in_d, sq(mat_roughness), out_d)
    return p_cos, p_vndf


def light_pdf(scene, mat_pos, out_d, light_chunk: int = 256):
    """The light pdf of out_d from mat_pos for a scene with lights: the
    dense sum (`light_chunk` lights a step) below light_cull.threshold()
    lights and the culled sum (K5) from there on, on any device (the JAX
    package takes the dense sum whenever its backend is the CPU)."""
    if light_cull.serves(scene):
        return light_cull.light_pdf_sum_culled(scene, mat_pos, out_d)
    return light_pdf_sum(scene, mat_pos, out_d, chunk=light_chunk)


def mix_pdfs(p_cos, p_light, p_vndf):
    """(cos_pdf + light_pdf + vndf_pdf * (1|2)) / 3: p_light None for a
    scene without lights."""
    if p_light is not None:
        return (p_cos + p_light + p_vndf) / 3.0
    return (p_cos + p_vndf * 2.0) / 3.0


def mixture_pdf(scene, mat_pos, mat_normal, mat_roughness, in_d, out_d,
                has_lights: bool, light_chunk: int = 256):
    """(cos_pdf + light_pdf + vndf_pdf * (1|2)) / 3 (shading.odin:153-162),
    the light pdf from `light_pdf`."""
    p_cos, p_vndf = bsdf_pdfs(mat_normal, mat_roughness, in_d, out_d)
    p_light = (light_pdf(scene, mat_pos, out_d, light_chunk)
               if has_lights else None)
    return mix_pdfs(p_cos, p_light, p_vndf)


def shade(mat_color, mat_normal, mat_metallic, mat_roughness, in_d, out_d):
    """Cook-Torrance GGX + Lambert, BRDF x cos(theta) (shading.odin:164-204),
    including step() gating the NDF and the unclamped 4*dot(V, N)."""
    alpha = sq(mat_roughness)
    alpha2 = sq(alpha)

    L = out_d
    V = -in_d
    H = normalize(L + V, eps=1e-20)
    N = mat_normal

    cosine = dot(L, N)

    f0, f90 = 0.04, 1.0
    fb = 1.0 - dot(H, L)
    fresnel_base = fb * fb * fb * fb * fb  # pow(x, 5) safe for negative x
    fresnel_diff_spec = f0 + (f90 - f0) * fresnel_base
    fresnel_metallic = mat_color + (f90 - mat_color) * fresnel_base[..., None]

    hn = dot(H, N)
    distribution = (
        alpha2
        * (hn >= 0).to(alpha2.dtype)  # math.step(0, dot(H, N))
        / (PI * sq((alpha2 - 1.0) * sq(hn) + 1.0))
    )

    def smith_g(x):
        c = dot(N, x)
        return 2.0 * torch.clamp(c, min=0.0) / (
            c + torch.sqrt(alpha2 + (1.0 - alpha2) * sq(c))
        )

    geometry = smith_g(L) * smith_g(V)
    cook_torrance = distribution * geometry / (4.0 * dot(V, N))
    specular = cook_torrance[..., None]

    diffuse = mat_color * torch.clamp(cosine, min=0.0)[..., None] / PI

    metallic_term = specular * fresnel_metallic
    dielectric = diffuse + (specular - diffuse) * fresnel_diff_spec[..., None]

    return dielectric + (metallic_term - dielectric) * mat_metallic[..., None]
