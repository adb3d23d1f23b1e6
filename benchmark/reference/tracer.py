# Frozen torch rewrite of raytracer_odin_tpu_torch/oracle/cpu_reference.py at
# commit 6dc2ca8, with the reference's own scene (reference/scene.py).
"""The plain reference path tracer: the renderer's specification with
another construction, in plain torch, so that the benchmark can judge a
render statistically.

The specification (the Odin reference renderer's math): one-sample MIS
over cosine, light and GGX-VNDF sampling with equal weights, the glTF
metallic-roughness BRDF times the cosine, bilinear sRGB textures,
emission added on every hit, a path ending on a miss or when the
throughput update |value|_1 / pdf falls to 1e-5 or below, at most `depth`
segments, and a ray offset of 1e-3 along its direction.

The construction: brute-force intersection over every triangle by
Cramer's rule, as one matrix product a chunk of triangles; cosine
sampling by the sqrt-polar map; VNDF sampling in an explicit orthonormal
basis; torch's own generator for every draw. Nothing of the program is
used: no BVH, clusters, lists, lane budgets or counter-based streams.

`precision="tf32"` rounds both operands of every matrix product to TF32's
10-bit mantissa, as a TF32 matmul does: the control, one precision step
below the float32 that the configurations state.
"""

from __future__ import annotations

import math

import torch

RAY_EPS = 1e-3
PRECISIONS = ("float32", "tf32")


def _tf32(x):
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a, b, precision):
    if precision == "tf32":
        a, b = _tf32(a), _tf32(b)
    return a @ b


def _dot(a, b):
    return (a * b).sum(-1)


def _unit(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-20)


class Tracer:
    """Reference renders of rows of an image of `scene` (reference.scene's
    RefScene) on its device. `chunk` bounds the rays x triangles elements
    of one matrix product."""

    def __init__(self, scene, precision="float32", chunk=1 << 26):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r}")
        self.sc = scene
        self.precision = precision
        self.chunk = chunk
        self.dev = scene.tri_p.device
        self._tri_mat = self._triangle_matrix(scene.tri_p, scene.tri_u,
                                              scene.tri_v)
        self._light_mat = self._triangle_matrix(scene.light_p, scene.light_u,
                                                scene.light_v)

    @staticmethod
    def _triangle_matrix(p, u, v):
        """[10, 4, T]: against ray rows [d, o, d x o, 1] it gives the four
        Cramer determinants det, t_num, bu_num, bv_num of every triangle:
        det = -d.(u x v), t_num = o.(u x v) - p.(u x v),
        bu_num = -(d x o).v + d.(p x v), bv_num = (d x o).u - d.(p x u)."""
        n = torch.cross(u, v, dim=-1)
        z = torch.zeros_like(n)
        T = p.shape[0]
        cols = [
            torch.cat([-n, z, z, torch.zeros(T, 1, device=p.device)], 1),
            torch.cat([z, n, z, -_dot(n, p)[:, None]], 1),
            torch.cat([torch.cross(p, v, dim=-1), z, -v,
                       torch.zeros(T, 1, device=p.device)], 1),
            torch.cat([-torch.cross(p, u, dim=-1), z, u,
                       torch.zeros(T, 1, device=p.device)], 1),
        ]
        return torch.stack(cols, 0).permute(2, 0, 1).contiguous()

    def _solve(self, rows, mat):
        """Cramer solve of rays `rows` [N, 10] against triangles `mat`
        [10, 4, C]: (t, bu, bv, ok) each [N, C]."""
        C = mat.shape[2]
        out = _mm(rows, mat.reshape(10, 4 * C), self.precision).reshape(
            -1, 4, C)
        det, t_num, bu_num, bv_num = out.unbind(1)
        ok = det.abs() > 1e-30
        inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
        t, bu, bv = t_num * inv, bu_num * inv, bv_num * inv
        ok = ok & (bu >= 0) & (bv >= 0) & (bu + bv <= 1)
        return t, bu, bv, ok

    @staticmethod
    def _ray_rows(o, d):
        one = torch.ones(o.shape[0], 1, device=o.device)
        return torch.cat([d, o, torch.cross(d, o, dim=-1), one], 1)

    def intersect(self, o, d):
        """Nearest hit of rays (o, d) [N, 3]: (t, triangle, bu, bv),
        triangle -1 on a miss."""
        o = o + d * RAY_EPS
        N = o.shape[0]
        rows = self._ray_rows(o, d)
        best_t = torch.full((N,), math.inf, device=self.dev)
        best_i = torch.full((N,), -1, dtype=torch.int64, device=self.dev)
        best_u = torch.zeros(N, device=self.dev)
        best_v = torch.zeros(N, device=self.dev)
        T = self._tri_mat.shape[2]
        step = max(1, min(T, self.chunk // max(N, 1)))
        ar = torch.arange(N, device=self.dev)
        for s in range(0, T, step):
            t, bu, bv, ok = self._solve(rows, self._tri_mat[..., s:s + step])
            t = torch.where(ok & (t > 0), t, math.inf)
            tk, k = t.min(dim=1)
            better = tk < best_t
            best_t = torch.where(better, tk, best_t)
            best_i = torch.where(better, s + k, best_i)
            best_u = torch.where(better, bu[ar, k], best_u)
            best_v = torch.where(better, bv[ar, k], best_v)
        return best_t + RAY_EPS, best_i, best_u, best_v

    def light_pdf(self, o, d):
        """Solid-angle pdf of direction d from o under uniform light-triangle
        sampling: the sum over every light triangle the ray meets."""
        sc = self.sc
        o = o + d * RAY_EPS
        t, bu, bv, ok = self._solve(self._ray_rows(o, d), self._light_mat)
        ok = ok & (t >= 0)
        cos = _dot(sc.light_ng[None], d[:, None]).abs()
        c = torch.where(ok, sc.light_pdf_factor[None] * t * t / cos, 0.0)
        c = torch.nan_to_num(c, nan=0.0)
        return c.sum(1) / sc.num_lights

    def tex_sample(self, tid, uv):
        """Bilinear, floor and wrap, of the sRGB-decoded texels: [N, 4];
        (1, 1, 1, 1) where tid < 0."""
        sc = self.sc
        t = tid.clamp(min=0)
        w, h, off = sc.tex_width[t], sc.tex_height[t], sc.tex_offset[t]
        px, py = uv[:, 0] * w, uv[:, 1] * h
        x0, y0 = torch.floor(px), torch.floor(py)
        fx, fy = (px - x0)[:, None], (py - y0)[:, None]
        x0 = torch.remainder(x0.long(), w)
        y0 = torch.remainder(y0.long(), h)
        x1, y1 = (x0 + 1) % w, (y0 + 1) % h

        def at(x, y):
            return sc.texels[off + y * w + x]

        val = ((at(x0, y0) * (1 - fy) + at(x0, y1) * fy) * (1 - fx)
               + (at(x1, y0) * (1 - fy) + at(x1, y1) * fy) * fx)
        return torch.where((tid >= 0)[:, None], val, torch.ones_like(val))

    def material(self, d, idx, bu, bv):
        sc = self.sc
        ti = idx.clamp(min=0)
        w0, w1, w2 = (1 - bu - bv)[:, None], bu[:, None], bv[:, None]
        uvs = sc.tri_uv[ti]
        uv = uvs[:, 0] * w0 + uvs[:, 1] * w1 + uvs[:, 2] * w2
        pos = sc.tri_p[ti] + sc.tri_u[ti] * w1 + sc.tri_v[ti] * w2
        mat = sc.tri_mat[ti]
        color = sc.mat_color[mat] * self.tex_sample(sc.mat_tex[mat], uv)[:, :3]
        ns = sc.tri_n[ti]
        n = _unit(ns[:, 0] * w0 + ns[:, 1] * w1 + ns[:, 2] * w2)
        inside = _dot(sc.tri_ng[ti], d) > 0
        n = torch.where(inside[:, None], -n, n)
        rough = torch.clamp(sc.mat_roughness[mat], min=0.03)
        return pos, n, color, sc.mat_emission[mat], sc.mat_metallic[mat], rough

    def trace(self, o, d, depth, gen):
        """Radiance [N, 3] of paths from (o, d), and the live segments
        cast (a segment a path a bounce it enters alive)."""
        N = o.shape[0]
        radiance = torch.zeros(N, 3, device=self.dev)
        throughput = torch.ones(N, 3, device=self.dev)
        lane = torch.arange(N, device=self.dev)
        segments = 0
        has_lights = self.sc.num_lights > 0
        for _ in range(depth):
            if lane.numel() == 0:
                break
            segments += lane.numel()
            _, idx, bu, bv = self.intersect(o, d)
            hit = idx >= 0
            pos, n, color, emission, metallic, rough = self.material(
                d, idx, bu, bv)
            # misses see no environment: the configurations have none
            radiance.index_add_(0, lane, torch.where(
                hit[:, None], throughput * emission, 0.0))
            M = lane.numel()

            def rand():
                return torch.rand(M, generator=gen, device=self.dev)

            tsel = rand()
            d_cos = _cosine_sample(rand(), rand(), n)
            if has_lights:
                li = torch.randint(0, self.sc.num_lights, (M,),
                                   generator=gen, device=self.dev)
                d_light = self._light_sample(li, rand(), rand(), pos)
            else:
                d_light = d_cos
            alpha = rough * rough
            nh = _vndf_sample(rand(), rand(), n, -d, alpha)
            d_vndf = d - 2 * _dot(nh, d)[:, None] * nh
            use_cos = tsel <= 0.33333
            use_light = (~use_cos) & (tsel < 0.666666) & has_lights
            nd = torch.where(use_cos[:, None], d_cos,
                             torch.where(use_light[:, None], d_light, d_vndf))
            p_cos = torch.clamp(_dot(n, nd) / math.pi, min=0.0)
            p_vndf = _vndf_pdf(n, -d, alpha, nd)
            if has_lights:
                pdf = (p_cos + self.light_pdf(pos, nd) + p_vndf) / 3
            else:
                pdf = (p_cos + 2 * p_vndf) / 3
            value = _shade(color, n, metallic, rough, d, nd)
            cont = (value.abs().sum(-1) / pdf > 1e-5) & hit
            throughput = (throughput * value / pdf[:, None])[cont]
            lane, o, d = lane[cont], pos[cont], nd[cont]
        return radiance, segments

    def _light_sample(self, li, u, v, origin):
        sc = self.sc
        flip = u + v > 1
        u = torch.where(flip, 1 - u, u)[:, None]
        v = torch.where(flip, 1 - v, v)[:, None]
        world = sc.light_p[li] + u * sc.light_u[li] + v * sc.light_v[li]
        return _unit(world - origin)

    def camera_rays(self, rows, width, height, fov_x, gen, spp):
        """Jittered camera rays of `spp` samples of every pixel of `rows`:
        [spp * len(rows) * width, 3] each, sample-major."""
        sc = self.sc
        r = torch.as_tensor(rows, dtype=torch.float32, device=self.dev)
        R = r.numel()
        tan_fx = math.tan(fov_x / 2)
        tan_fy = tan_fx / (width / height)
        px = torch.arange(width, dtype=torch.float32, device=self.dev)[None, :]
        py = ((height - 1.0) - r)[:, None]
        jx = torch.rand(spp, R, width, generator=gen, device=self.dev)
        jy = torch.rand(spp, R, width, generator=gen, device=self.dev)
        x = (px + jx) / (width / 2) - 1
        y = (py + jy) / (height / 2) - 1
        v = torch.stack([x * tan_fx, y * tan_fy, torch.ones_like(x)], -1)
        d = _unit(_mm(v.reshape(-1, 3), sc.cam_basis.T, self.precision))
        return sc.cam_pos.expand_as(d).contiguous(), d

    def render_rows(self, rows, width, height, fov_x, depth, spp, gen,
                    lanes=1 << 18):
        """`spp` samples of every pixel of image rows `rows` (of a
        width x height image): (total, total of squares) [R, W, 3] in
        float64, and the live segments cast. Samples go through in batches
        of about `lanes` paths."""
        R = len(rows)
        P = R * width
        total = torch.zeros(P, 3, dtype=torch.float64, device=self.dev)
        total_sq = torch.zeros_like(total)
        segments = 0
        per = max(1, lanes // P)
        done = 0
        while done < spp:
            k = min(per, spp - done)
            o, d = self.camera_rays(rows, width, height, fov_x, gen, k)
            rad, seg = self.trace(o, d, depth, gen)
            rad = rad.double().reshape(k, P, 3)
            total += rad.sum(0)
            total_sq += (rad * rad).sum(0)
            segments += seg
            done += k
        return (total.reshape(R, width, 3), total_sq.reshape(R, width, 3),
                segments)


def _cosine_sample(u1, u2, n):
    r = torch.sqrt(u1)
    phi = 2 * math.pi * u2
    x, y = r * torch.cos(phi), r * torch.sin(phi)
    z = torch.sqrt(torch.clamp(1 - u1, min=0.0))
    t, b = _onb(n)
    return x[:, None] * t + y[:, None] * b + z[:, None] * n


def _onb(n):
    """Branchless orthonormal basis (Duff et al. 2017)."""
    s = torch.where(n[:, 2] >= 0, 1.0, -1.0)
    a = -1.0 / (s + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t1 = torch.stack([1.0 + s * n[:, 0] ** 2 * a, s * b, -s * n[:, 0]], -1)
    t2 = torch.stack([b, s + n[:, 1] ** 2 * a, -n[:, 1]], -1)
    return t1, t2


def _vndf_sample(u1, u2, n, wo, alpha):
    """Heitz 2018 visible-normal sampling in an explicit tangent frame."""
    t1w, t2w = _onb(n)
    V = torch.stack([_dot(wo, t1w), _dot(wo, t2w), _dot(wo, n)], -1)
    Vh = _unit(torch.stack([alpha * V[:, 0], alpha * V[:, 1], V[:, 2]], -1))
    lensq = Vh[:, 0] ** 2 + Vh[:, 1] ** 2
    safe = torch.sqrt(torch.clamp(lensq, min=1e-30))
    T1 = torch.where(
        (lensq > 1e-30)[:, None],
        torch.stack([-Vh[:, 1] / safe, Vh[:, 0] / safe,
                     torch.zeros_like(safe)], -1),
        torch.tensor([1.0, 0.0, 0.0], device=n.device))
    T2 = torch.cross(Vh, T1, dim=-1)
    r = torch.sqrt(u1)
    phi = 2 * math.pi * u2
    t1, t2 = r * torch.cos(phi), r * torch.sin(phi)
    s = 0.5 * (1 + Vh[:, 2])
    t2 = (1 - s) * torch.sqrt(torch.clamp(1 - t1 * t1, min=0.0)) + s * t2
    Nh = (t1[:, None] * T1 + t2[:, None] * T2
          + torch.sqrt(torch.clamp(1 - t1 * t1 - t2 * t2, min=0.0))[:, None]
          * Vh)
    Ne = _unit(torch.stack([alpha * Nh[:, 0], alpha * Nh[:, 1],
                            torch.clamp(Nh[:, 2], min=0.0)], -1))
    return Ne[:, 0:1] * t1w + Ne[:, 1:2] * t2w + Ne[:, 2:3] * n


def _vndf_pdf(n, wo, alpha, L):
    Ne = _unit(wo + L)
    t1w, t2w = _onb(n)
    V = torch.stack([_dot(wo, t1w), _dot(wo, t2w), _dot(wo, n)], -1)
    Nl = torch.stack([_dot(Ne, t1w), _dot(Ne, t2w), _dot(Ne, n)], -1)
    a2 = alpha * alpha
    lam = (-1 + torch.sqrt(1 + a2 * (V[:, 0] ** 2 + V[:, 1] ** 2)
                           / V[:, 2] ** 2)) * 0.5
    G1 = 1 / (1 + lam)
    D = 1 / (math.pi * a2 * ((Nl[:, 0] / alpha) ** 2 + (Nl[:, 1] / alpha) ** 2
                             + Nl[:, 2] ** 2) ** 2)
    return (G1 * torch.clamp(_dot(V, Nl), min=0.0) * D / V[:, 2]
            / (4 * _dot(L, Ne)))


def _shade(color, n, metallic, roughness, in_d, out_d):
    """glTF metallic-roughness BRDF times the cosine."""
    alpha = roughness ** 2
    a2 = (alpha ** 2)[:, None]
    L, V = out_d, -in_d
    H = _unit(L + V)
    cosine = _dot(L, n)
    fb = (1 - _dot(H, L)) ** 5
    f_ds = 0.04 + 0.96 * fb
    f_met = color + (1 - color) * fb[:, None]
    hn = _dot(H, n)[:, None]
    D = a2 * (hn >= 0) / (math.pi * ((a2 - 1) * hn ** 2 + 1) ** 2)

    def G(x):
        c = _dot(n, x)[:, None]
        return 2 * torch.clamp(c, min=0.0) / (c + torch.sqrt(
            a2 + (1 - a2) * c ** 2))

    spec = D * G(L) * G(V) / (4 * _dot(V, n)[:, None])
    diff = color * torch.clamp(cosine, min=0.0)[:, None] / math.pi
    diel = diff + (spec - diff) * f_ds[:, None]
    met = spec * f_met
    return diel + (met - diel) * metallic[:, None]
