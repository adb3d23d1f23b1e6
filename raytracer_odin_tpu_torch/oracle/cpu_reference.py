"""Independent CPU reference renderer, the oracle (port of
raytracer_odin_tpu/oracle/cpu_reference.py, numpy only).

It is written to be algorithmically independent of the renderer's own path
(ops/): the same specification (the reference renderer's math, cited
below), a different construction:

  * triangle intersection via Cramer's rule on the reference's explicit
    3x3 system (raytracer.odin:136-150's formulation), each column
    determinant split into ray-side/triangle-side triple products
    (_cramer_solve): another expression graph, evaluation order and
    rounding than the renderer's Moller-Trumbore (ops/geometry.py);
  * cosine-hemisphere sampling via the sqrt-polar method instead of
    normalize(sphere + n): the same distribution, another map;
  * VNDF sampling/pdf via an explicit orthonormal basis instead of a
    quaternion rotation;
  * numpy's PCG64 instead of the renderer's counter-based PCG4D streams.

So statistical agreement between the two is strong evidence of
correctness. It reads a DeviceScene on any device through .cpu().numpy()
and needs nothing but numpy, so it runs on a GPU host without jax, where
it is the one reference besides the golden images. Everything is
vectorized over a flat ray batch; intersection is brute force. `render`
can return the per-pixel sample variance and render a band of rows;
`render_mp` fans the rows out over a process pool in bands.
"""

from __future__ import annotations

import numpy as np


def _dot(a, b):
    return np.sum(a * b, axis=-1)


def _normalize(v, eps=1e-20):
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return v / np.maximum(n, eps)


def _norm_l1(v):
    return np.sum(np.abs(v), axis=-1)


RAY_EPS = 1e-3


class OracleScene:
    """Numpy copy of the device scene (unpermuted order is fine)."""

    def __init__(self, dscene):
        def g(a):
            return a.detach().cpu().numpy()

        self.tri_p = g(dscene.tri_p)
        self.tri_u = g(dscene.tri_u)
        self.tri_v = g(dscene.tri_v)
        self.tri_ng = g(dscene.tri_ng)
        self.tri_n = g(dscene.tri_n)
        self.tri_tex = g(dscene.tri_tex)
        self.tri_tan = g(dscene.tri_tan)
        self.tri_mat = g(dscene.tri_mat)
        self.mat_color = g(dscene.mat_color)
        self.mat_emission = g(dscene.mat_emission)
        self.mat_metallic = g(dscene.mat_metallic)
        self.mat_roughness = g(dscene.mat_roughness)
        self.mat_tex = g(dscene.mat_tex)
        self.tex_texels = g(dscene.tex_texels)
        self.tex_offset = g(dscene.tex_offset)
        self.tex_width = g(dscene.tex_width)
        self.tex_height = g(dscene.tex_height)
        self.light_p = g(dscene.light_p)
        self.light_u = g(dscene.light_u)
        self.light_v = g(dscene.light_v)
        self.light_ng = g(dscene.light_ng)
        self.light_pdf_factor = g(dscene.light_pdf_factor)
        self.cam_pos = g(dscene.cam_pos)
        self.cam_basis = g(dscene.cam_basis)
        self.env_tex = int(dscene.env_tex)


def _cramer_solve(u, v, p, o, d):
    """Cramer's-rule solve of the reference's per-(ray, triangle) 3x3 system
    A @ [bu, bv, t] = o - p with A's columns [u, v, -d]
    (raytracer.odin:136-150's formulation; previously solved here via
    LAPACK np.linalg.inv, now via closed-form column determinants — same
    system, same float32 numerics class, ~50x faster because every term
    reduces to an [N,3]x[3,C] matmul instead of N*C batched LU calls).

    Each solution component is det(A with one column replaced by b)/det(A),
    and each such determinant is a scalar triple product that splits over
    b = o - p into a ray-side cross dotted with a triangle row plus a
    triangle-side cross dotted with a ray row:

      det(A)  = det[u, v, -d] = -d.(u x v)
      t_num   = det[u, v, b]  =  o.(u x v) - p.(u x v)
      bu_num  = det[b, v, -d] = -v.(d x o) + d.(p x v)
      bv_num  = det[u, b, -d] =  u.(d x o) - d.(p x u)

    u, v, p: [C, 3] triangle rows; o, d: [N, 3] rays.
    Returns (det, t_num, bu_num, bv_num), all [N, C].
    """
    n_uv = np.cross(u, v)                       # [C, 3]
    dxo = np.cross(d, o)                        # [N, 3]
    det = -(d @ n_uv.T)                         # [N, C]
    t_num = o @ n_uv.T - (n_uv * p).sum(-1)[None]
    pxv = np.cross(p, v)                        # [C, 3]
    bu_num = -(dxo @ v.T) + d @ pxv.T
    pxu = np.cross(p, u)
    bv_num = dxo @ u.T - d @ pxu.T
    return det, t_num, bu_num, bv_num


def intersect_brute(sc: OracleScene, o, d):
    """Nearest hit via the reference's 3x3 linear-system solve over all
    triangles (Cramer closed form, _cramer_solve). o, d: [N, 3].
    Returns (t, idx, bu, bv); idx = -1 on miss."""
    o = o + d * RAY_EPS
    N = o.shape[0]
    T = sc.tri_p.shape[0]
    best_t = np.full(N, np.inf, np.float32)
    best_i = np.full(N, -1, np.int64)
    best_u = np.zeros(N, np.float32)
    best_v = np.zeros(N, np.float32)
    # Chunk over triangles to bound the [N, C] temporaries.
    step = max(1, min(T, 64_000_000 // max(N, 1)))
    rows = np.arange(N)
    for s in range(0, T, step):
        e = min(T, s + step)
        det, t_num, bu_num, bv_num = _cramer_solve(
            sc.tri_u[s:e], sc.tri_v[s:e], sc.tri_p[s:e], o, d
        )
        with np.errstate(all="ignore"):
            ok_det = np.abs(det) > 1e-30
            inv_det = 1.0 / np.where(ok_det, det, 1.0)
            t = t_num * inv_det
            bu = bu_num * inv_det
            bv = bv_num * inv_det
        ok = ok_det & (bu >= 0) & (bv >= 0) & (bu + bv <= 1) & (t > 0)
        t = np.where(ok, t, np.inf)
        k = np.argmin(t, axis=1)
        tk = t[rows, k]
        better = tk < best_t
        best_t = np.where(better, tk, best_t)
        best_i = np.where(better, s + k, best_i)
        best_u = np.where(better, bu[rows, k], best_u)
        best_v = np.where(better, bv[rows, k], best_v)
    best_t = np.where(best_i >= 0, best_t + RAY_EPS, np.inf)
    return best_t, best_i, best_u, best_v


def tex_sample(sc: OracleScene, tid, uv, srgb=False, default=(1, 1, 1, 1)):
    """Bilinear with floor + wrap + pre-lerp sRGB (textures.odin:79-135).
    The atlas stores quad-packed rows [p00, p10, p01, p11] (see
    ops/texture.build_atlas); the math below is still an independent
    implementation of the reference's floor/ceil bilinear semantics."""
    tid = np.asarray(tid)
    out = np.tile(np.asarray(default, np.float32), tid.shape + (1,))
    mask = tid >= 0
    if not mask.any():
        return out
    t = np.maximum(tid, 0)
    w = sc.tex_width[t]
    h = sc.tex_height[t]
    off = sc.tex_offset[t]
    dims = np.stack([w, h], axis=-1)
    pix = uv * dims
    lo = np.floor(pix)
    frac = (pix - lo).astype(np.float32)
    c00 = np.mod(lo.astype(np.int64), dims)

    quad = sc.tex_texels[off + c00[..., 1] * w + c00[..., 0]].astype(np.float32)
    p00, p10, p01, p11 = (
        quad[..., 0:4], quad[..., 4:8], quad[..., 8:12], quad[..., 12:16]
    )
    if srgb:
        def dec(px):
            px = px.copy()
            px[..., :3] = np.power(np.maximum(px[..., :3], 0), 2.2)
            return px
        p00, p10, p01, p11 = dec(p00), dec(p10), dec(p01), dec(p11)
    ty = frac[..., 1:2]
    tx = frac[..., 0:1]
    val = (p00 * (1 - ty) + p01 * ty) * (1 - tx) + (p10 * (1 - ty) + p11 * ty) * tx
    out[mask] = val[mask]
    return out


def env_color(sc: OracleScene, d):
    u = 0.5 + np.arctan2(d[..., 2], d[..., 0]) / (2 * np.pi)
    v = 0.5 - np.arcsin(np.clip(d[..., 1], -1, 1)) / np.pi
    uv = np.stack([u, v], axis=-1)
    tid = np.full(d.shape[:-1], sc.env_tex, np.int64)
    return tex_sample(sc, tid, uv, srgb=False, default=(0, 0, 0, 0))[..., :3]


# --- sampling strategies (independent constructions) -----------------------

def cosine_sample(rng, n):
    """sqrt-polar cosine-weighted hemisphere around n."""
    N = n.shape[0]
    u1 = rng.random(N, np.float32)
    u2 = rng.random(N, np.float32)
    r = np.sqrt(u1)
    phi = 2 * np.pi * u2
    x = r * np.cos(phi)
    y = r * np.sin(phi)
    z = np.sqrt(np.maximum(1 - u1, 0))
    t, b = _onb(n)
    return x[:, None] * t + y[:, None] * b + z[:, None] * n


def _onb(n):
    """Branchless orthonormal basis (Duff et al.)."""
    s = np.where(n[..., 2] >= 0, 1.0, -1.0)
    a = -1.0 / (s + n[..., 2])
    bb = n[..., 0] * n[..., 1] * a
    t = np.stack(
        [1.0 + s * n[..., 0] ** 2 * a, s * bb, -s * n[..., 0]], axis=-1
    )
    b = np.stack([bb, s + n[..., 1] ** 2 * a, -n[..., 1]], axis=-1)
    return t.astype(np.float32), b.astype(np.float32)


def cosine_pdf(n, w):
    return np.maximum(_dot(n, w) / np.pi, 0)


def light_sample(rng, sc: OracleScene, origin):
    N = origin.shape[0]
    idx = rng.integers(0, sc.light_p.shape[0], N)
    u = rng.random(N, np.float32)
    v = rng.random(N, np.float32)
    flip = u + v > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    world = sc.light_p[idx] + u[:, None] * sc.light_u[idx] + v[:, None] * sc.light_v[idx]
    return _normalize(world - origin)


def light_pdf(sc: OracleScene, o, d):
    """Summed solid-angle pdf over all light triangles along the ray
    (shading.odin:52-100), via the 3x3-inverse intersection."""
    o = o + d * RAY_EPS
    N = o.shape[0]
    L = sc.light_p.shape[0]
    det, t_num, bu_num, bv_num = _cramer_solve(
        sc.light_u, sc.light_v, sc.light_p, o, d
    )
    with np.errstate(all="ignore"):
        ok_det = np.abs(det) > 1e-30
        inv_det = 1.0 / np.where(ok_det, det, 1.0)
        t = t_num * inv_det
        bu = bu_num * inv_det
        bv = bv_num * inv_det
    ok = ok_det & (bu >= 0) & (bv >= 0) & (bu + bv <= 1) & (t >= 0)
    cosry = np.abs(_dot(np.broadcast_to(sc.light_ng[None], (N, L, 3)), d[:, None]))
    with np.errstate(all="ignore"):
        w = t * t / cosry
        contrib = np.where(ok, sc.light_pdf_factor[None] * w, 0.0)
    contrib = np.where(np.isnan(contrib), 0.0, contrib)
    return contrib.sum(axis=1) / L


def vndf_sample(rng, n, wo, alpha):
    """Heitz 2018 VNDF sampling in an explicit tangent frame."""
    N = n.shape[0]
    t1w, t2w = _onb(n)
    # view in local frame
    V = np.stack([_dot(wo, t1w), _dot(wo, t2w), _dot(wo, n)], axis=-1)
    Vh = _normalize(np.stack([alpha * V[..., 0], alpha * V[..., 1], V[..., 2]], axis=-1))
    lensq = Vh[..., 0] ** 2 + Vh[..., 1] ** 2
    safe = np.sqrt(np.maximum(lensq, 1e-30))
    T1 = np.where(
        (lensq > 1e-30)[..., None],
        np.stack([-Vh[..., 1] / safe, Vh[..., 0] / safe, np.zeros(N, np.float32)], axis=-1),
        np.array([1.0, 0, 0], np.float32),
    )
    T2 = np.cross(Vh, T1)
    u1 = rng.random(N, np.float32)
    u2 = rng.random(N, np.float32)
    r = np.sqrt(u1)
    phi = 2 * np.pi * u2
    t1 = r * np.cos(phi)
    t2 = r * np.sin(phi)
    s = 0.5 * (1 + Vh[..., 2])
    t2 = (1 - s) * np.sqrt(np.maximum(1 - t1 * t1, 0)) + s * t2
    Nh = (
        t1[:, None] * T1
        + t2[:, None] * T2
        + np.sqrt(np.maximum(0, 1 - t1 * t1 - t2 * t2))[:, None] * Vh
    )
    Ne_local = _normalize(
        np.stack([alpha * Nh[..., 0], alpha * Nh[..., 1], np.maximum(0, Nh[..., 2])], axis=-1)
    )
    return (
        Ne_local[..., 0:1] * t1w + Ne_local[..., 1:2] * t2w + Ne_local[..., 2:3] * n
    )


def vndf_pdf(n, wo, alpha, L):
    Ne = _normalize(wo + L)
    t1w, t2w = _onb(n)
    V = np.stack([_dot(wo, t1w), _dot(wo, t2w), _dot(wo, n)], axis=-1)
    Nl = np.stack([_dot(Ne, t1w), _dot(Ne, t2w), _dot(Ne, n)], axis=-1)
    a2 = alpha * alpha
    with np.errstate(all="ignore"):
        lam = (-1 + np.sqrt(1 + a2 * (V[..., 0] ** 2 + V[..., 1] ** 2) / V[..., 2] ** 2)) * 0.5
        G1 = 1 / (1 + lam)
        D = 1 / (
            np.pi * a2 * ((Nl[..., 0] / alpha) ** 2 + (Nl[..., 1] / alpha) ** 2 + Nl[..., 2] ** 2) ** 2
        )
        res = G1 * np.maximum(0, _dot(V, Nl)) * D / V[..., 2] / (4 * _dot(L, Ne))
    return res


def shade(color, n, metallic, roughness, in_d, out_d):
    """glTF metallic-roughness BRDF x cos (shading.odin:164-204)."""
    alpha = roughness**2
    a2 = alpha**2
    L = out_d
    V = -in_d
    H = _normalize(L + V)
    cosine = _dot(L, n)
    fb = (1 - _dot(H, L)) ** 5
    f_ds = 0.04 + 0.96 * fb
    f_met = color + (1 - color) * fb[:, None]
    hn = _dot(H, n)
    D = a2 * (hn >= 0) / (np.pi * ((a2 - 1) * hn**2 + 1) ** 2)

    def G(x):
        c = _dot(n, x)
        return 2 * np.maximum(c, 0) / (c + np.sqrt(a2 + (1 - a2) * c**2))

    with np.errstate(all="ignore"):
        ct = D * G(L) * G(V) / (4 * _dot(V, n))
    spec = ct[:, None]
    diff = color * np.maximum(cosine, 0)[:, None] / np.pi
    diel = diff + (spec - diff) * f_ds[:, None]
    met = spec * f_met
    return diel + (met - diel) * metallic[:, None]


def point_material(sc: OracleScene, d, idx, bu, bv):
    ti = np.maximum(idx, 0)
    w0 = (1 - bu - bv)[:, None]
    w1 = bu[:, None]
    w2 = bv[:, None]
    tex = sc.tri_tex[ti]
    uv = tex[:, 0] * w0 + tex[:, 1] * w1 + tex[:, 2] * w2
    pos = sc.tri_p[ti] + sc.tri_u[ti] * w1 + sc.tri_v[ti] * w2
    mat = sc.tri_mat[ti]
    mtex = sc.mat_tex[mat]
    mr = tex_sample(sc, mtex[:, 2], uv)
    colt = tex_sample(sc, mtex[:, 0], uv, srgb=True)
    emit = tex_sample(sc, mtex[:, 1], uv, srgb=True)
    tri_n = sc.tri_n[ti]
    n_sm = _normalize(tri_n[:, 0] * w0 + tri_n[:, 1] * w1 + tri_n[:, 2] * w2)
    # normal mapping
    has_nm = mtex[:, 3] >= 0
    if has_nm.any():
        tan = sc.tri_tan[ti]
        tan4 = tan[:, 0] * w0 + tan[:, 1] * w1 + tan[:, 2] * w2
        tan4 = tan4 / np.maximum(np.linalg.norm(tan4, axis=-1, keepdims=True), 1e-20)
        lx = tan4[:, :3]
        lz = n_sm
        ly = np.cross(lz, lx) * tan4[:, 3:4]
        ns = tex_sample(sc, mtex[:, 3], uv, default=(0.5, 1.0, 0.5, 0.0))[:, :3]
        ln = ns * 2 - 1
        nm = _normalize(lx * ln[:, 0:1] + ly * ln[:, 1:2] + lz * ln[:, 2:3])
        n_sm = np.where(has_nm[:, None], nm, n_sm)
    ng = sc.tri_ng[ti]
    inside = _dot(ng, d) > 0
    return {
        "pos": pos,
        "normal": n_sm,
        "inside": inside,
        "color": sc.mat_color[mat] * colt[:, :3],
        "emission": sc.mat_emission[mat] * emit[:, :3],
        "roughness": np.maximum(sc.mat_roughness[mat] * mr[:, 1], 0.03),
        "metallic": sc.mat_metallic[mat] * mr[:, 2],
    }


def trace(sc: OracleScene, o, d, depth, rng):
    """Iterative wavefront trace over a flat ray batch [N, 3]."""
    N = o.shape[0]
    has_lights = sc.light_p.shape[0] > 0
    radiance = np.zeros((N, 3), np.float32)
    throughput = np.ones((N, 3), np.float32)
    alive = np.ones(N, bool)
    for _ in range(depth):
        t, idx, bu, bv = intersect_brute(sc, o, d)
        hit = (idx >= 0) & alive
        miss = (~(idx >= 0)) & alive
        radiance[miss] += throughput[miss] * env_color(sc, d[miss])
        m = point_material(sc, d, idx, bu, bv)
        n = np.where(m["inside"][:, None], -m["normal"], m["normal"])
        radiance[hit] += throughput[hit] * m["emission"][hit]

        tsel = rng.random(N, np.float32)
        d_cos = cosine_sample(rng, n)
        if has_lights:
            d_light = light_sample(rng, sc, m["pos"])
        else:
            d_light = d_cos
        nh = vndf_sample(rng, n, -d, m["roughness"] ** 2)
        d_vndf = d - 2 * _dot(nh, d)[:, None] * nh
        use_cos = tsel <= 0.33333
        use_light = (~use_cos) & (tsel < 0.666666) & has_lights
        nd = np.where(use_cos[:, None], d_cos, np.where(use_light[:, None], d_light, d_vndf))

        with np.errstate(all="ignore"):
            p_cos = cosine_pdf(n, nd)
            p_vndf = vndf_pdf(n, -d, m["roughness"] ** 2, nd)
            if has_lights:
                p_light = light_pdf(sc, m["pos"], nd)
                pdf = (p_cos + p_light + p_vndf) / 3
            else:
                pdf = (p_cos + 2 * p_vndf) / 3
            value = shade(m["color"], n, m["metallic"], m["roughness"], d, nd)
            cont = (_norm_l1(value) / pdf > 1e-5) & hit
            throughput = np.where(cont[:, None], throughput * value / pdf[:, None], throughput)
        alive = cont
        o = m["pos"]
        d = nd
        if not alive.any():
            break
    return radiance


def render(dscene, width, height, fov_x, depth, spp, seed=0,
           return_var=False, row_offset=0, n_rows=None):
    """Render the mean image [n_rows, width, 3] of `spp` samples with the
    oracle: rows [row_offset, row_offset + n_rows) of a height-`height`
    image (all of it by default); rays and sampling decisions come from
    numpy's generator seeded with `seed`. With return_var, returns (mean,
    per-pixel sample variance)."""
    sc = dscene if isinstance(dscene, OracleScene) else OracleScene(dscene)
    if n_rows is None:
        n_rows = height
    rng = np.random.default_rng(seed)
    acc = np.zeros((n_rows, width, 3), np.float64)
    acc2 = np.zeros((n_rows, width, 3), np.float64)
    aspect = width / height
    tan_fx = np.tan(fov_x / 2)
    tan_fy = tan_fx / aspect
    r = row_offset + np.arange(n_rows, dtype=np.float32)[:, None]
    px = np.arange(width, dtype=np.float32)[None, :]
    py = (height - 1.0) - r
    for _ in range(spp):
        jx = rng.random((n_rows, width), np.float32)
        jy = rng.random((n_rows, width), np.float32)
        x = (px + jx) / (width / 2) - 1
        y = (py + jy) / (height / 2) - 1
        v = np.stack([x * tan_fx, np.broadcast_to(y * tan_fy, x.shape),
                      np.ones_like(x)], axis=-1)
        d = _normalize(v @ sc.cam_basis.T).reshape(-1, 3).astype(np.float32)
        o = np.broadcast_to(sc.cam_pos, d.shape).astype(np.float32)
        sample = trace(sc, o, d, depth, rng).reshape(n_rows, width, 3)
        acc += sample
        if return_var:
            acc2 += sample.astype(np.float64) ** 2
    mean = (acc / spp).astype(np.float32)
    if not return_var:
        return mean
    var = np.maximum(acc2 / spp - (acc / spp) ** 2, 0.0).astype(np.float32)
    return mean, var


# --- the row-band fan-out ----------------------------------------------------
# Each band of rows draws from its own PCG64 stream seeded by (seed, band
# index): another, equally valid sample set than render(seed), since the
# oracle's comparisons are statistical, never bitwise.

_MP_SCENE = None
MP_CONTEXTS = ("fork", "spawn", "forkserver")


def _mp_init(sc):
    global _MP_SCENE
    _MP_SCENE = sc


def _mp_band(args):
    (row0, n_rows, width, height, fov_x, depth, spp, seed, band,
     return_var) = args
    # render() takes an integer seed: one child integer of the pair
    child_seed = int(np.random.SeedSequence([seed, band])
                     .generate_state(1)[0])
    return render(_MP_SCENE, width, height, fov_x, depth, spp,
                  seed=child_seed, return_var=return_var, row_offset=row0,
                  n_rows=n_rows)


def render_mp(dscene, width, height, fov_x, depth, spp, seed=0,
              return_var=False, workers=None, band_rows=16):
    """render() fanned out over bands of `band_rows` rows on a pool of
    `workers` processes (default: one a core); workers <= 1 is render()
    itself. Band b draws from the stream of (seed, b). The pool starts
    with the context RT_ORACLE_MP_CONTEXT names ("fork" by default,
    "spawn" or "forkserver"). The scene is read into numpy here, before
    the pool starts, so a forked worker never touches the card."""
    import multiprocessing as mp
    import os

    workers = workers if workers is not None else (os.cpu_count() or 1)
    if workers <= 1:
        return render(dscene, width, height, fov_x, depth, spp, seed=seed,
                      return_var=return_var)
    method = os.environ.get("RT_ORACLE_MP_CONTEXT") or "fork"
    if method not in MP_CONTEXTS:
        raise ValueError(f"RT_ORACLE_MP_CONTEXT={method!r} is not honoured: "
                         f"it takes one of {', '.join(MP_CONTEXTS)}")
    sc = dscene if isinstance(dscene, OracleScene) else OracleScene(dscene)
    bands = [(row0, min(band_rows, height - row0), width, height, fov_x,
              depth, spp, seed, b, return_var)
             for b, row0 in enumerate(range(0, height, band_rows))]
    with mp.get_context(method).Pool(workers, initializer=_mp_init,
                                     initargs=(sc,)) as pool:
        parts = pool.map(_mp_band, bands)
    if return_var:
        return (np.concatenate([p[0] for p in parts], axis=0),
                np.concatenate([p[1] for p in parts], axis=0))
    return np.concatenate(parts, axis=0)
