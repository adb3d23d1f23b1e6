"""Scene finalization + device upload (port of
raytracer_odin_tpu/models/build.py).

`finish_scene` (raytracer.odin:62-91): collect emissive triangles into the
Morton-ordered light list and its packed light-cluster rows, order the
triangles by the BVH permutation, pack the texture atlas, the 12-wide
kernel triangle rows, the cluster AABBs and the scene-specialised shade
rows and the flattened BVH, decide whether the scene is streamed, and
upload them as a torch DeviceScene.
"""

from __future__ import annotations

import numpy as np

from raytracer_odin_tpu_torch.models.scene import (
    DeviceScene,
    HostMaterial,
    HostScene,
    HostTexture,
    scene_from_numpy,
)
from raytracer_odin_tpu_torch.ops import bvh as bvh_mod
from raytracer_odin_tpu_torch.ops import culling, light_cull
from raytracer_odin_tpu_torch.ops import pallas_intersect as pi
from raytracer_odin_tpu_torch.ops import texture as texture_mod
from raytracer_odin_tpu_torch.ops.geometry import aabb_of_triangles
from raytracer_odin_tpu_torch.utils import profiling

EMISSIVE_EPS = 1e-6  # raytracer.odin:64


def scene_arrays(host: HostScene, env_map: HostTexture | None = None,
                 verbose: bool = False):
    """Host-side half of finish_scene: (arrays, statics) with `arrays` the
    numpy array of every DeviceScene tensor field (and under "bvh" the
    flattened BVH's arrays) and `statics` its env_tex, row_spec, tex_kinds
    and stream."""
    n_tri = host.num_triangles

    # Emissive-material mask per triangle (raytracer.odin:63-66).
    if host.materials:
        mat_emission = np.stack([m.emission_factor for m in host.materials])
    else:
        mat_emission = np.zeros((1, 3), np.float32)
        host.materials = [HostMaterial()]
    emissive_mat = np.abs(mat_emission).sum(axis=1) > EMISSIVE_EPS
    light_sel = emissive_mat[host.mat_index] if n_tri else np.zeros(0, bool)

    light_p = host.p[light_sel]
    light_u = host.u[light_sel]
    light_v = host.v[light_sel]
    light_ng = host.ng[light_sel]
    # Morton order: consecutive lights are spatial neighbours, the basis
    # of the light clusters K5 culls.
    order = light_cull.morton_order(light_p + (light_u + light_v) / 3.0)
    light_p = light_p[order]
    light_u = light_u[order]
    light_v = light_v[order]
    light_ng = light_ng[order]
    cross = np.cross(light_u, light_v)
    area2 = np.linalg.norm(cross, axis=-1)  # |cross| = 2 * area
    light_pdf_factor = 2.0 / np.where(area2 > 0, area2, 1.0)
    light_rows = light_cull.pack_light_rows(
        light_p, light_u, light_v, light_ng, light_pdf_factor)
    lcl_lo, lcl_hi = light_cull.light_cluster_aabbs(light_rows)

    with profiling.span("bvh_build") as built:
        lo, hi = aabb_of_triangles(host.p, host.u, host.v)
        flat = bvh_mod.build_flat_bvh(lo, hi)
    if verbose:
        print(f"Scene BVH built in {built.seconds:.3f}s "
              f"({flat.num_nodes} nodes over {n_tri} triangles)")
    perm = flat.perm if n_tri else np.zeros(0, np.int64)

    def g(a):
        return np.asarray(a)[perm] if n_tri else np.asarray(a)

    if n_tri:
        tri_n = np.stack([g(host.n1), g(host.n2), g(host.n3)], axis=1)
        tri_tex = np.stack([g(host.tex1), g(host.tex2), g(host.tex3)], axis=1)
        tri_tan = np.stack([g(host.tan1), g(host.tan2), g(host.tan3)], axis=1)
    else:
        tri_n = np.zeros((0, 3, 3), np.float32)
        tri_tex = np.zeros((0, 3, 2), np.float32)
        tri_tan = np.zeros((0, 3, 4), np.float32)

    mats = host.materials
    mat_color = np.stack([m.color_factor for m in mats]).astype(np.float32)
    mat_emission = np.stack([m.emission_factor for m in mats]).astype(np.float32)
    mat_metallic = np.array([m.metallic_factor for m in mats], np.float32)
    mat_roughness = np.array([m.roughness_factor for m in mats], np.float32)
    mat_tex = np.array(
        [[m.color_tex, m.emission_tex, m.metallic_roughness_tex, m.normal_tex]
         for m in mats],
        np.int32,
    )

    # Texture atlas; the env map is appended as one more atlas entry.
    textures = list(host.textures)
    env_tex_id = -1
    if env_map is not None:
        env_tex_id = len(textures)
        textures.append(env_map)
    atlas = texture_mod.build_atlas(textures)

    # Kernel triangle rows + treelet-cluster AABBs over the BVH order.
    ptri = pi.pad_triangles(g(host.p), g(host.u), g(host.v))
    if n_tri:
        plo, phi = aabb_of_triangles(g(host.p), g(host.u), g(host.v))
    else:
        plo = np.zeros((0, 3), np.float32)
        phi = np.zeros((0, 3), np.float32)
    cl_lo, cl_hi = culling.cluster_aabbs(plo, phi)

    # One shading row per triangle, scene-specialised: blocks the scene
    # cannot use are not packed (integrator._point_material skips them).
    tmat = g(host.mat_index) if n_tri else np.zeros(0, np.int32)
    if n_tri:
        tex_kinds = tuple(bool(k) for k in (mat_tex[tmat] >= 0).any(axis=0))
    else:
        tex_kinds = (False, False, False, False)
    need_tex = any(tex_kinds)
    need_tan = tex_kinds[3]

    blocks = [("ng", 3), ("n", 9)]
    if need_tex:
        blocks.append(("tex", 6))
    if need_tan:
        blocks.append(("tan", 12))
    blocks += [("color", 3), ("emission", 3), ("metallic", 1),
               ("roughness", 1)]
    if need_tex:
        blocks.append(("texids", 4))
    # Triangle geometry rides the row: the winner's barycentrics are
    # recomputed at shade time (the sweep kernel returns t and index only).
    blocks += [("tri_p", 3), ("tri_u", 3), ("tri_v", 3)]
    row_spec, off = [], 0
    for name, width in blocks:
        row_spec.append((name, off))
        off += width
    row_width = -(-off // 8) * 8
    row_spec = tuple(row_spec)
    spec = dict(row_spec)

    shade_row = np.zeros((n_tri, row_width), np.float32)
    if n_tri:
        def put(name, data):
            data = data.reshape(n_tri, -1)
            shade_row[:, spec[name]:spec[name] + data.shape[1]] = data

        put("ng", g(host.ng))
        put("n", tri_n)
        if need_tex:
            put("tex", tri_tex)
        if need_tan:
            put("tan", tri_tan)
        put("color", mat_color[tmat])
        put("emission", mat_emission[tmat])
        put("metallic", mat_metallic[tmat])
        put("roughness", mat_roughness[tmat])
        if need_tex:
            put("texids", mat_tex[tmat].astype(np.float32))
        put("tri_p", g(host.p))
        put("tri_u", g(host.u))
        put("tri_v", g(host.v))

    arrays = {
        "tri_p": g(host.p), "tri_u": g(host.u), "tri_v": g(host.v),
        "tri_ng": g(host.ng), "tri_n": tri_n, "tri_tex": tri_tex,
        "tri_tan": tri_tan, "tri_mat": g(host.mat_index),
        "mat_color": mat_color, "mat_emission": mat_emission,
        "mat_metallic": mat_metallic, "mat_roughness": mat_roughness,
        "mat_tex": mat_tex,
        "tex_texels": atlas["tex_texels"],
        # sRGB-sampled kinds are color (0) and emission (1) only.
        "tex_texels_srgb": (
            texture_mod.srgb_decode_pool(atlas["tex_texels"])
            if (tex_kinds[0] or tex_kinds[1])
            else np.ones((1, 16), np.float32)
        ),
        "tex_offset": atlas["tex_offset"],
        "tex_width": atlas["tex_width"],
        "tex_height": atlas["tex_height"],
        "light_p": light_p, "light_u": light_u, "light_v": light_v,
        "light_ng": light_ng, "light_pdf_factor": light_pdf_factor,
        "light_mask": np.ones(light_p.shape[0], np.float32),
        "light_rows": light_rows, "light_cluster_lo": lcl_lo,
        "light_cluster_hi": lcl_hi,
        "ptri": ptri, "cluster_lo": cl_lo, "cluster_hi": cl_hi,
        "shade_row": shade_row,
        "cam_pos": host.cam.pos, "cam_basis": host.cam.basis,
        "bvh": {"lo": flat.lo, "hi": flat.hi, "first": flat.first,
                "count": flat.count, "hit_link": flat.hit_link,
                "miss_link": flat.miss_link},
    }
    statics = {"env_tex": env_tex_id, "row_spec": row_spec,
               "tex_kinds": tex_kinds,
               "stream": ptri.shape[0] > pi.stream_tris()}
    return arrays, statics


def finish_scene(host: HostScene, env_map: HostTexture | None = None,
                 verbose: bool = False, device="cuda") -> DeviceScene:
    """Build light list + BVH order + kernel layouts and upload everything
    as a DeviceScene on `device`. Tallied as the "scene_build" span (the
    BVH's build within it as "bvh_build")."""
    with profiling.span("scene_build"):
        arrays, statics = scene_arrays(host, env_map, verbose=verbose)
        return scene_from_numpy(arrays, device=device, **statics)
