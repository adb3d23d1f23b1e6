"""The reference's own glTF reader: the triangles, materials, textures,
light triangles and camera of a glTF 2.0 file as torch tensors.

It reads what the benchmark's writer (benchmark/scenes/gltf_writer.py)
writes, and refuses what it does not implement (tangents, normal,
emissive or metallic-roughness textures, JPEG images, filtered PNG rows)
rather than render it wrongly. Its rules are the glTF specification's and
those of the renderer being measured, restated here:

  * node transforms T*R*S (or `matrix`), accumulated from the scene's roots;
  * world positions, normals through the cofactor matrix, renormalized;
    a missing normal is the flat geometric normal;
  * one material a primitive: baseColorFactor (default white), metallic
    and roughness factors (default 1), emissiveFactor times
    KHR_materials_emissive_strength;
  * light triangles are those whose material's emission has an L1 norm
    above 1e-6, each sampled by area (pdf factor 2 / |u x v|);
  * the camera: position and the basis (right, up, -forward) of its node,
    its vertical field of view used as the horizontal one before the
    aspect scaling, as the renderer's command line does.
"""

from __future__ import annotations

import base64
import json
import struct
import zlib
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

EMISSIVE_EPS = 1e-6

_DTYPES = {5121: np.uint8, 5123: np.uint16, 5125: np.uint32, 5126: np.float32}
_WIDTH = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4}


@dataclass
class RefScene:
    tri_p: torch.Tensor      # [T, 3] first vertex
    tri_u: torch.Tensor      # [T, 3] p2 - p1
    tri_v: torch.Tensor      # [T, 3] p3 - p1
    tri_ng: torch.Tensor     # [T, 3] unit geometric normal
    tri_n: torch.Tensor      # [T, 3, 3] unit vertex normals
    tri_uv: torch.Tensor     # [T, 3, 2] texcoords
    tri_mat: torch.Tensor    # [T] int64
    mat_color: torch.Tensor  # [M, 3]
    mat_emission: torch.Tensor
    mat_metallic: torch.Tensor
    mat_roughness: torch.Tensor
    mat_tex: torch.Tensor    # [M] int64 base-color texture, -1 none
    texels: torch.Tensor     # [P, 4] every texture's rows, sRGB-decoded rgb
    tex_offset: torch.Tensor  # [K] int64
    tex_width: torch.Tensor
    tex_height: torch.Tensor
    light_p: torch.Tensor    # [L, 3]
    light_u: torch.Tensor
    light_v: torch.Tensor
    light_ng: torch.Tensor
    light_pdf_factor: torch.Tensor  # [L]
    cam_pos: torch.Tensor    # [3]
    cam_basis: torch.Tensor  # [3, 3] columns right, up, forward
    yfov: float

    @property
    def num_triangles(self) -> int:
        return self.tri_p.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_p.shape[0]


def decode_png(data: bytes) -> np.ndarray:
    """8-bit gray/RGB/RGBA PNG with unfiltered rows -> uint8 [H, W, C]."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = hdr
    channels = {0: 1, 2: 3, 6: 4}.get(ctype)
    if depth != 8 or channels is None or interlace:
        raise NotImplementedError(f"PNG depth {depth} type {ctype}")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    rows = raw.reshape(h, 1 + w * channels)
    if rows[:, 0].any():
        raise NotImplementedError("filtered PNG rows")
    return rows[:, 1:].reshape(h, w, channels)


def _local(node) -> np.ndarray:
    if "matrix" in node:
        return np.array(node["matrix"], np.float64).reshape(4, 4, order="F")
    m = np.eye(4)
    if "scale" in node:
        m = np.diag(list(node["scale"]) + [1.0]) @ m
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.eye(4)
        r[:3, :3] = [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
        m = r @ m
    if "translation" in node:
        t = np.eye(4)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def _unit(v):
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return v / np.where(n > 0, n, 1.0)


def read(path, device) -> RefScene:
    path = Path(path)
    doc = json.loads(path.read_text())
    buffers = []
    for b in doc.get("buffers", []):
        uri = b["uri"]
        buffers.append(base64.b64decode(uri.split(",", 1)[1])
                       if uri.startswith("data:")
                       else (path.parent / uri).read_bytes())

    def accessor(i):
        acc = doc["accessors"][i]
        view = doc["bufferViews"][acc["bufferView"]]
        if "byteStride" in view or "sparse" in acc:
            raise NotImplementedError("strided or sparse accessor")
        dt = np.dtype(_DTYPES[acc["componentType"]])
        k = _WIDTH[acc["type"]]
        off = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        a = np.frombuffer(buffers[view["buffer"]], dt, acc["count"] * k, off)
        return a.reshape(acc["count"], k)

    textures, tex_of_image = [], {}

    def texture(info):
        if info is None:
            return -1
        src = doc["textures"][info["index"]]["source"]
        if src not in tex_of_image:
            uri = doc["images"][src]["uri"]
            data = (base64.b64decode(uri.split(",", 1)[1])
                    if uri.startswith("data:")
                    else (path.parent / uri).read_bytes())
            img = decode_png(data).astype(np.float32) / 255.0
            rgba = np.ones(img.shape[:2] + (4,), np.float32)
            rgba[..., :img.shape[2]] = img
            tex_of_image[src] = len(textures)
            textures.append(rgba)
        return tex_of_image[src]

    tris = {k: [] for k in ("p", "u", "v", "ng", "n", "uv", "mat")}
    mats = []
    cam = {}

    def visit(i, parent):
        node = doc["nodes"][i]
        m = parent @ _local(node)
        if "camera" in node:
            cam["pos"] = m[:3, 3]
            cam["basis"] = np.stack([m[:3, 0], m[:3, 1], -m[:3, 2]], axis=1)
            cam["yfov"] = float(
                doc["cameras"][node["camera"]]["perspective"]["yfov"])
        for prim in (doc["meshes"][node["mesh"]]["primitives"]
                     if "mesh" in node else []):
            attrs = prim["attributes"]
            if "TANGENT" in attrs:
                raise NotImplementedError("tangents")
            mdef = doc["materials"][prim["material"]] if "material" in prim else {}
            for key in ("normalTexture", "emissiveTexture"):
                if key in mdef:
                    raise NotImplementedError(key)
            pbr = mdef.get("pbrMetallicRoughness", {})
            if "metallicRoughnessTexture" in pbr:
                raise NotImplementedError("metallicRoughnessTexture")
            strength = (mdef.get("extensions", {})
                        .get("KHR_materials_emissive_strength", {})
                        .get("emissiveStrength", 1.0))
            mats.append((
                np.array(pbr.get("baseColorFactor", [1, 1, 1, 1])[:3]),
                np.array(mdef.get("emissiveFactor", [0, 0, 0])) * strength,
                float(pbr.get("metallicFactor", 1.0)),
                float(pbr.get("roughnessFactor", 1.0)),
                texture(pbr.get("baseColorTexture")),
            ))
            pos = accessor(attrs["POSITION"]).astype(np.float64)
            idx = (accessor(prim["indices"]).reshape(-1).astype(np.int64)
                   if "indices" in prim else np.arange(pos.shape[0]))
            tri = idx[: idx.shape[0] // 3 * 3].reshape(-1, 3)
            w = pos[tri] @ m[:3, :3].T + m[:3, 3]          # [T, 3, 3]
            e1, e2 = w[:, 1] - w[:, 0], w[:, 2] - w[:, 0]
            ng = _unit(np.cross(e1, e2))
            if "NORMAL" in attrs:
                cof = np.linalg.det(m[:3, :3]) * np.linalg.inv(m[:3, :3]).T
                nrm = _unit(accessor(attrs["NORMAL"])[tri].astype(np.float64)
                            @ cof.T)
            else:
                nrm = np.repeat(ng[:, None], 3, axis=1)
            uv = (accessor(attrs["TEXCOORD_0"])[tri] if "TEXCOORD_0" in attrs
                  else np.zeros((tri.shape[0], 3, 2)))
            for k, a in (("p", w[:, 0]), ("u", e1), ("v", e2), ("ng", ng),
                         ("n", nrm), ("uv", uv)):
                tris[k].append(np.asarray(a, np.float32))
            tris["mat"].append(np.full(tri.shape[0], len(mats) - 1))
        for c in node.get("children", []):
            visit(c, m)

    roots = doc["scenes"][doc.get("scene", 0)]["nodes"]
    for r in roots:
        visit(r, np.eye(4))
    if not cam:
        raise ValueError(f"{path} has no camera")

    def cat(k):
        return np.concatenate(tris[k], axis=0)

    p, u, v, ng, mat = cat("p"), cat("u"), cat("v"), cat("ng"), cat("mat")
    emission = np.stack([e for _, e, _, _, _ in mats]).astype(np.float32)
    light = (np.abs(emission).sum(axis=1) > EMISSIVE_EPS)[mat]
    area2 = np.linalg.norm(np.cross(u[light], v[light]), axis=-1)
    if not textures:
        textures = [np.ones((1, 1, 4), np.float32)]
    texels = np.concatenate([t.reshape(-1, 4) for t in textures])
    # sRGB decode of the colour channels before the bilinear lerp
    texels[:, :3] = np.power(np.maximum(texels[:, :3], 0.0), 2.2)
    sizes = np.array([t.shape[0] * t.shape[1] for t in textures])

    def T(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    return RefScene(
        tri_p=T(p), tri_u=T(u), tri_v=T(v), tri_ng=T(ng), tri_n=T(cat("n")),
        tri_uv=T(cat("uv")), tri_mat=T(mat, torch.int64),
        mat_color=T(np.stack([c for c, _, _, _, _ in mats])),
        mat_emission=T(emission),
        mat_metallic=T([x for _, _, x, _, _ in mats]),
        mat_roughness=T([x for _, _, _, x, _ in mats]),
        mat_tex=T([x for _, _, _, _, x in mats], torch.int64),
        texels=T(texels),
        tex_offset=T(np.cumsum(sizes) - sizes, torch.int64),
        tex_width=T([t.shape[1] for t in textures], torch.int64),
        tex_height=T([t.shape[0] for t in textures], torch.int64),
        light_p=T(p[light]), light_u=T(u[light]), light_v=T(v[light]),
        light_ng=T(ng[light]),
        light_pdf_factor=T(2.0 / np.where(area2 > 0, area2, 1.0)),
        cam_pos=T(cam["pos"]), cam_basis=T(cam["basis"]), yfov=cam["yfov"],
    )
