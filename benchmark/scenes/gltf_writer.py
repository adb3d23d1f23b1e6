# Frozen copy of raytracer_odin_tpu_torch/models/assets.py (GltfBuilder and
# the primitives) and io/png.py (encode) at commit 6dc2ca8.
"""The benchmark's glTF writer: a minimal glTF 2.0 writer with an embedded
base64 buffer, the mesh primitives and an 8-bit PNG encoder. The scenes of
the benchmark's configurations are written with it, so that an edit to the
program's own asset generator cannot change them."""

from __future__ import annotations

import base64
import json
import math
import struct
import zlib
from pathlib import Path

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def png_encode(img: np.ndarray) -> bytes:
    """Encode uint8 [H, W] / [H, W, {1,2,3,4}] to PNG bytes."""
    img = np.asarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload))
            + tag
            + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1
    )
    idat = zlib.compress(rows.tobytes(), 6)
    return (
        _PNG_SIG
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", idat)
        + chunk(b"IEND", b"")
    )


def _mat3_to_quat(m: np.ndarray) -> list[float]:
    """Rotation matrix -> quaternion (x, y, z, w)."""
    t = np.trace(m)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = math.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = math.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = math.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    return [float(x), float(y), float(z), float(w)]


class GltfBuilder:
    """Minimal glTF 2.0 writer with an embedded base64 buffer."""

    def __init__(self):
        self.buffer = bytearray()
        self.buffer_views = []
        self.accessors = []
        self.meshes = []
        self.materials = []
        self.nodes = []
        self.cameras = []
        self.images = []
        self.textures = []
        self.scene_nodes = []
        self.extensions_used = set()

    def _add_accessor(self, data: np.ndarray, type_str: str, target=None) -> int:
        data = np.ascontiguousarray(data)
        offset = len(self.buffer)
        self.buffer.extend(data.tobytes())
        while len(self.buffer) % 4:
            self.buffer.append(0)
        self.buffer_views.append(
            {"buffer": 0, "byteOffset": offset, "byteLength": data.nbytes}
        )
        comp = {np.dtype(np.float32): 5126, np.dtype(np.uint32): 5125}[data.dtype]
        acc = {
            "bufferView": len(self.buffer_views) - 1,
            "componentType": comp,
            "count": data.shape[0],
            "type": type_str,
        }
        if comp == 5126:
            acc["min"] = data.min(axis=0).tolist() if data.ndim > 1 else [float(data.min())]
            acc["max"] = data.max(axis=0).tolist() if data.ndim > 1 else [float(data.max())]
        self.accessors.append(acc)
        return len(self.accessors) - 1

    def add_material(
        self,
        color=(1, 1, 1),
        metallic=0.0,
        roughness=1.0,
        emissive=(0, 0, 0),
        emissive_strength=None,
        color_tex=None,
        mr_tex=None,
        normal_tex=None,
        emissive_tex=None,
    ) -> int:
        pbr = {
            "baseColorFactor": list(color) + [1.0],
            "metallicFactor": metallic,
            "roughnessFactor": roughness,
        }
        if color_tex is not None:
            pbr["baseColorTexture"] = {"index": color_tex}
        if mr_tex is not None:
            pbr["metallicRoughnessTexture"] = {"index": mr_tex}
        mat = {"pbrMetallicRoughness": pbr, "emissiveFactor": list(emissive)}
        if normal_tex is not None:
            mat["normalTexture"] = {"index": normal_tex}
        if emissive_tex is not None:
            mat["emissiveTexture"] = {"index": emissive_tex}
        if emissive_strength is not None:
            mat["extensions"] = {
                "KHR_materials_emissive_strength": {
                    "emissiveStrength": emissive_strength
                }
            }
            self.extensions_used.add("KHR_materials_emissive_strength")
        self.materials.append(mat)
        return len(self.materials) - 1

    def add_image_png(self, rgb: np.ndarray) -> int:
        """Embed a uint8 image as a data-URI PNG; returns glTF texture index."""
        data = png_encode(rgb)
        uri = "data:image/png;base64," + base64.b64encode(data).decode()
        self.images.append({"uri": uri})
        self.textures.append({"source": len(self.images) - 1})
        return len(self.textures) - 1

    def add_mesh(
        self,
        positions: np.ndarray,
        indices: np.ndarray,
        normals=None,
        uvs=None,
        tangents=None,
        material: int = 0,
    ) -> int:
        attrs = {"POSITION": self._add_accessor(positions.astype(np.float32), "VEC3")}
        if normals is not None:
            attrs["NORMAL"] = self._add_accessor(normals.astype(np.float32), "VEC3")
        if uvs is not None:
            attrs["TEXCOORD_0"] = self._add_accessor(uvs.astype(np.float32), "VEC2")
        if tangents is not None:
            attrs["TANGENT"] = self._add_accessor(tangents.astype(np.float32), "VEC4")
        idx_acc = self._add_accessor(
            indices.astype(np.uint32).reshape(-1, 1), "SCALAR"
        )
        self.meshes.append(
            {
                "primitives": [
                    {"attributes": attrs, "indices": idx_acc, "material": material}
                ]
            }
        )
        return len(self.meshes) - 1

    def add_node(self, mesh=None, translation=None, rotation=None, scale=None, camera=None) -> int:
        node = {}
        if mesh is not None:
            node["mesh"] = mesh
        if camera is not None:
            node["camera"] = camera
        if translation is not None:
            node["translation"] = [float(x) for x in translation]
        if rotation is not None:
            node["rotation"] = [float(x) for x in rotation]
        if scale is not None:
            node["scale"] = [float(x) for x in scale]
        self.nodes.append(node)
        self.scene_nodes.append(len(self.nodes) - 1)
        return len(self.nodes) - 1

    def add_camera_lookat(self, pos, target, up=(0, 1, 0), yfov=0.8) -> int:
        """Place a perspective camera looking at `target` (glTF looks down -z)."""
        pos = np.asarray(pos, np.float64)
        fwd = np.asarray(target, np.float64) - pos
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, np.asarray(up, np.float64))
        right /= np.linalg.norm(right)
        true_up = np.cross(right, fwd)
        rot = np.stack([right, true_up, -fwd], axis=1)
        self.cameras.append(
            {"type": "perspective", "perspective": {"yfov": yfov, "znear": 0.01}}
        )
        return self.add_node(
            camera=len(self.cameras) - 1,
            translation=pos.tolist(),
            rotation=_mat3_to_quat(rot),
        )

    def write(self, path) -> None:
        doc = {
            "asset": {"version": "2.0", "generator": "raytracer_odin_tpu"},
            "scene": 0,
            "scenes": [{"nodes": self.scene_nodes}],
            "nodes": self.nodes,
            "meshes": self.meshes,
            "materials": self.materials,
            "accessors": self.accessors,
            "bufferViews": self.buffer_views,
            "buffers": [
                {
                    "byteLength": len(self.buffer),
                    "uri": "data:application/octet-stream;base64,"
                    + base64.b64encode(bytes(self.buffer)).decode(),
                }
            ],
        }
        if self.cameras:
            doc["cameras"] = self.cameras
        if self.images:
            doc["images"] = self.images
            doc["textures"] = self.textures
            doc["samplers"] = [{}]
        if self.extensions_used:
            doc["extensionsUsed"] = sorted(self.extensions_used)
        Path(path).write_text(json.dumps(doc))


# ---------------------------------------------------------------------------
# Geometry primitives.
# ---------------------------------------------------------------------------


def box_mesh(size=(1.0, 1.0, 1.0), center=(0, 0, 0)):
    """24-vertex box with per-face normals and uvs."""
    sx, sy, sz = [s / 2 for s in size]
    cx, cy, cz = center
    faces = [
        # normal, corner order (CCW seen from outside)
        ((1, 0, 0), [(1, -1, -1), (1, 1, -1), (1, 1, 1), (1, -1, 1)]),
        ((-1, 0, 0), [(-1, -1, 1), (-1, 1, 1), (-1, 1, -1), (-1, -1, -1)]),
        ((0, 1, 0), [(-1, 1, -1), (-1, 1, 1), (1, 1, 1), (1, 1, -1)]),
        ((0, -1, 0), [(-1, -1, 1), (-1, -1, -1), (1, -1, -1), (1, -1, 1)]),
        ((0, 0, 1), [(-1, -1, 1), (1, -1, 1), (1, 1, 1), (-1, 1, 1)]),
        ((0, 0, -1), [(1, -1, -1), (-1, -1, -1), (-1, 1, -1), (1, 1, -1)]),
    ]
    positions, normals, uvs, indices = [], [], [], []
    uv_quad = [(0, 0), (1, 0), (1, 1), (0, 1)]
    for n, corners in faces:
        base = len(positions)
        for (ux, uy, uz), uv in zip(corners, uv_quad):
            positions.append((cx + ux * sx, cy + uy * sy, cz + uz * sz))
            normals.append(n)
            uvs.append(uv)
        indices += [base, base + 1, base + 2, base, base + 2, base + 3]
    return (
        np.array(positions, np.float32),
        np.array(normals, np.float32),
        np.array(uvs, np.float32),
        np.array(indices, np.uint32),
    )


def quad_mesh(p0, p1, p2, p3):
    """Two-triangle quad; normal from winding."""
    positions = np.array([p0, p1, p2, p3], np.float32)
    n = np.cross(positions[1] - positions[0], positions[3] - positions[0])
    n = n / np.linalg.norm(n)
    normals = np.tile(n, (4, 1)).astype(np.float32)
    uvs = np.array([(0, 0), (1, 0), (1, 1), (0, 1)], np.float32)
    indices = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    return positions, normals, uvs, indices


def uv_sphere(radius=1.0, center=(0, 0, 0), n_lat=12, n_lon=24):
    positions, normals, uvs, indices = [], [], [], []
    for i in range(n_lat + 1):
        theta = math.pi * i / n_lat
        for j in range(n_lon + 1):
            phi = 2 * math.pi * j / n_lon
            n = (
                math.sin(theta) * math.cos(phi),
                math.cos(theta),
                math.sin(theta) * math.sin(phi),
            )
            positions.append(
                (center[0] + radius * n[0], center[1] + radius * n[1], center[2] + radius * n[2])
            )
            normals.append(n)
            uvs.append((j / n_lon, i / n_lat))
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * (n_lon + 1) + j
            b = a + n_lon + 1
            # CCW from outside: geometric normals must point outward, or the
            # renderer's inside-test (dot(ng, d) > 0) flips shading normals
            # inward and the surface goes black.
            indices += [a, a + 1, b, a + 1, b + 1, b]
    return (
        np.array(positions, np.float32),
        np.array(normals, np.float32),
        np.array(uvs, np.float32),
        np.array(indices, np.uint32),
    )


def checker_texture(n=64, c0=(230, 230, 230), c1=(40, 60, 160)) -> np.ndarray:
    yy, xx = np.mgrid[0:n, 0:n]
    mask = ((xx // 8 + yy // 8) % 2).astype(bool)
    img = np.zeros((n, n, 3), np.uint8)
    img[~mask] = c0
    img[mask] = c1
    return img
