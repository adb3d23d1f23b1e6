"""Procedural glTF scene generation.

The reference repo ships no scene assets (its demo .png is stripped from the
mirror; see BASELINE.md), so the test/benchmark scenes for the five
BASELINE.json configs are generated here as real .gltf files — exercising the
full from-scratch ingest path (io/gltf.py) exactly the way user scenes would.

Scenes:
  * cube           — config 1: single diffuse cube + area light
  * cornell        — config 2: Cornell-box-style diffuse scene
  * textured       — config 3: checker/PNG textured metallic-roughness scene
  * envmap         — config 4: HDR-environment-lit spheres
  * demo           — config 5: the "meme scene" stand-in: a room full of
                     boxes/spheres with mixed materials, textures and lights
                     (a few thousand triangles)
  * city           — a grid city of tessellated towers, two area lights
                     (blocks=12: 51,858 triangles; blocks=24: 207,234)
  * citynight      — the city with emissive windows (1,728 lights)
"""

from __future__ import annotations

import base64
import json
import math
from pathlib import Path

import numpy as np

from raytracer_odin_tpu_torch.io import hdr as hdr_codec
from raytracer_odin_tpu_torch.io import png as png_codec


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
        data = png_codec.encode(rgb)
        uri = "data:image/png;base64," + base64.b64encode(data).decode()
        self.images.append({"uri": uri})
        self.textures.append({"source": len(self.images) - 1})
        return len(self.textures) - 1

    def add_image_jpeg(self, rgb: np.ndarray, quality: int = 95) -> int:
        """Embed a uint8 image as a data-URI JPEG (io/jpeg.py encoder);
        exercises the from-scratch baseline JPEG decode path end-to-end."""
        from raytracer_odin_tpu_torch.io import jpeg as jpeg_codec

        data = jpeg_codec.encode(rgb, quality=quality)
        uri = "data:image/jpeg;base64," + base64.b64encode(data).decode()
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


def normalmap_texture(n=64, bump=0.35) -> np.ndarray:
    """A wavy tangent-space normal map."""
    yy, xx = np.mgrid[0:n, 0:n] / n
    nx = bump * np.sin(xx * 8 * math.pi)
    ny = bump * np.sin(yy * 8 * math.pi)
    nz = np.sqrt(np.maximum(1.0 - nx * nx - ny * ny, 0.0))
    nm = np.stack([nx, ny, nz], axis=-1)
    return np.clip((nm * 0.5 + 0.5) * 255, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Scene builders.
# ---------------------------------------------------------------------------

def make_cube_scene(path) -> None:
    """Config 1: one diffuse cube on a floor, one emissive ceiling quad."""
    b = GltfBuilder()
    white = b.add_material(color=(0.8, 0.8, 0.8), roughness=1.0)
    red = b.add_material(color=(0.8, 0.2, 0.2), roughness=0.6)
    light = b.add_material(color=(1, 1, 1), emissive=(1, 1, 1), emissive_strength=12.0)
    p, n, uv, i = box_mesh((1, 1, 1), (0, 0.5, 0))
    b.add_node(mesh=b.add_mesh(p, i, n, uv, material=red))
    p, n, uv, i = quad_mesh((-4, 0, -4), (4, 0, -4), (4, 0, 4), (-4, 0, 4))
    b.add_node(mesh=b.add_mesh(p, i, n, uv, material=white))
    p, n, uv, i = quad_mesh((-1, 3, 1), (1, 3, 1), (1, 3, -1), (-1, 3, -1))
    b.add_node(mesh=b.add_mesh(p, i, n, uv, material=light))
    b.add_camera_lookat((2.5, 1.8, 2.5), (0, 0.5, 0), yfov=0.9)
    b.write(path)


def make_cornell_scene(path) -> None:
    """Config 2: Cornell-box-style diffuse scene with two boxes."""
    b = GltfBuilder()
    white = b.add_material(color=(0.73, 0.73, 0.73))
    red = b.add_material(color=(0.65, 0.05, 0.05))
    green = b.add_material(color=(0.12, 0.45, 0.15))
    light = b.add_material(color=(1, 1, 1), emissive=(1, 0.85, 0.7), emissive_strength=18.0)

    s = 1.0  # half box scale
    # floor / ceiling / back / left / right (normals inward)
    for pts, m in [
        ([(-s, 0, -s), (s, 0, -s), (s, 0, s), (-s, 0, s)], white),
        ([(-s, 2 * s, s), (s, 2 * s, s), (s, 2 * s, -s), (-s, 2 * s, -s)], white),
        ([(-s, 0, -s), (-s, 2 * s, -s), (s, 2 * s, -s), (s, 0, -s)], white),
        ([(-s, 0, s), (-s, 2 * s, s), (-s, 2 * s, -s), (-s, 0, -s)], red),
        ([(s, 0, -s), (s, 2 * s, -s), (s, 2 * s, s), (s, 0, s)], green),
    ]:
        p, n, uv, i = quad_mesh(*pts)
        b.add_node(mesh=b.add_mesh(p, i, n, uv, material=m))
    # Light panel slightly below the ceiling.
    lp = 0.3
    p, n, uv, i = quad_mesh(
        (-lp, 2 * s - 0.01, lp), (lp, 2 * s - 0.01, lp),
        (lp, 2 * s - 0.01, -lp), (-lp, 2 * s - 0.01, -lp),
    )
    b.add_node(mesh=b.add_mesh(p, i, n, uv, material=light))
    # Two boxes (axis-aligned stand-ins for the classic rotated blocks).
    p, n, uv, i = box_mesh((0.6, 1.2, 0.6), (-0.35, 0.6, -0.35))
    b.add_node(mesh=b.add_mesh(p, i, n, uv, material=white))
    p, n, uv, i = box_mesh((0.55, 0.55, 0.55), (0.4, 0.275, 0.35))
    b.add_node(mesh=b.add_mesh(p, i, n, uv, material=white))
    b.add_camera_lookat((0, 1.0, 3.4), (0, 1.0, 0), yfov=0.66)
    b.write(path)


def make_textured_scene(path) -> None:
    """Config 3: PNG/JPEG-textured metallic-roughness scene with a normal
    map. The floor checker is a JPEG (BASELINE config 3 names "PNG/JPEG
    textures"): it exercises the from-scratch baseline JPEG decoder in the
    actual render path; the normal/mr maps stay PNG (lossless — JPEG
    artifacts on a normal map would be a geometry bug, not a texture)."""
    b = GltfBuilder()
    checker = b.add_image_jpeg(checker_texture(), quality=97)
    nmap = b.add_image_png(normalmap_texture())
    # metallic-roughness texture: G = roughness ramp, B = metallic ramp
    n = 64
    mr = np.zeros((n, n, 3), np.uint8)
    mr[..., 1] = np.linspace(40, 220, n, dtype=np.uint8)[None, :]
    mr[..., 2] = np.linspace(220, 10, n, dtype=np.uint8)[:, None]
    mr_tex = b.add_image_png(mr)

    floor_mat = b.add_material(color=(1, 1, 1), color_tex=checker, roughness=0.9)
    shiny = b.add_material(
        color=(0.9, 0.7, 0.3), metallic=1.0, roughness=1.0, mr_tex=mr_tex
    )
    bumpy = b.add_material(
        color=(0.4, 0.5, 0.9), roughness=0.35, normal_tex=nmap
    )
    light = b.add_material(emissive=(1, 1, 1), emissive_strength=10.0)

    p, n_, uv, i = quad_mesh((-5, 0, -5), (5, 0, -5), (5, 0, 5), (-5, 0, 5))
    tangents = np.tile(np.array([1, 0, 0, 1], np.float32), (4, 1))
    b.add_node(mesh=b.add_mesh(p, i, n_, uv, tangents=tangents, material=floor_mat))

    p, n_, uv, i = uv_sphere(0.7, (-1.0, 0.7, 0))
    b.add_node(mesh=b.add_mesh(p, i, n_, uv, material=shiny))
    p, n_, uv, i = box_mesh((1.1, 1.1, 1.1), (1.1, 0.55, -0.3))
    tangents = np.tile(np.array([1, 0, 0, 1], np.float32), (p.shape[0], 1))
    b.add_node(mesh=b.add_mesh(p, i, n_, uv, tangents=tangents, material=bumpy))
    p, n_, uv, i = quad_mesh((-2, 4, 2), (2, 4, 2), (2, 4, -2), (-2, 4, -2))
    b.add_node(mesh=b.add_mesh(p, i, n_, uv, material=light))
    b.add_camera_lookat((3.2, 2.2, 3.6), (0, 0.6, 0), yfov=0.8)
    b.write(path)


def make_envmap_scene(path, hdr_path) -> None:
    """Config 4: HDR-environment-lit metallic/dielectric spheres. Writes both
    the .gltf and a procedural .hdr sky next to it."""
    b = GltfBuilder()
    mats = [
        b.add_material(color=(0.9, 0.9, 0.9), metallic=1.0, roughness=0.08),
        b.add_material(color=(0.95, 0.64, 0.54), metallic=1.0, roughness=0.3),
        b.add_material(color=(0.2, 0.3, 0.8), metallic=0.0, roughness=0.5),
        b.add_material(color=(0.8, 0.8, 0.8), metallic=0.0, roughness=0.95),
    ]
    for k, m in enumerate(mats):
        p, n, uv, i = uv_sphere(0.6, (-2.1 + 1.4 * k, 0.6, 0), n_lat=16, n_lon=32)
        b.add_node(mesh=b.add_mesh(p, i, n, uv, material=m))
    floor = b.add_material(color=(0.6, 0.6, 0.6), roughness=0.8)
    p, n, uv, i = quad_mesh((-8, 0, -8), (8, 0, -8), (8, 0, 8), (-8, 0, 8))
    b.add_node(mesh=b.add_mesh(p, i, n, uv, material=floor))
    b.add_camera_lookat((0, 1.6, 4.5), (0, 0.6, 0), yfov=0.7)
    b.write(path)
    Path(hdr_path).write_bytes(hdr_codec.encode(procedural_sky(256, 128)))


def procedural_sky(w=256, h=128, sun_dir=(0.4, 0.6, 0.5), sun_power=60.0) -> np.ndarray:
    """Simple analytic HDR sky: gradient + sun disk, equirectangular."""
    v, u = np.mgrid[0:h, 0:w]
    phi = (u / w - 0.5) * 2 * math.pi
    theta = (0.5 - v / h) * math.pi  # +pi/2 at top
    d = np.stack(
        [np.cos(theta) * np.cos(phi), np.sin(theta), np.cos(theta) * np.sin(phi)],
        axis=-1,
    )
    sd = np.asarray(sun_dir, np.float64)
    sd = sd / np.linalg.norm(sd)
    cos_sun = np.clip(d @ sd, 0, 1)
    horizon = np.clip(1.0 - np.abs(d[..., 1]), 0, 1) ** 3
    sky = (
        np.stack([0.25 + 0.2 * horizon, 0.45 + 0.25 * horizon, 0.9 - 0.1 * horizon], axis=-1)
        * (0.4 + 0.6 * np.clip(d[..., 1] + 0.3, 0, 1))[..., None]
    )
    sun = (cos_sun**400)[..., None] * np.array([1.0, 0.9, 0.7]) * sun_power
    ground = np.array([0.18, 0.15, 0.12]) * np.clip(-d[..., 1], 0, 1)[..., None]
    return (sky + sun + ground).astype(np.float32)


def make_demo_scene(path, seed=7) -> None:
    """Config 5: the demo 'meme scene' stand-in — a room with dozens of mixed
    boxes and spheres, textured floor, several emissive panels (~6k tris)."""
    rng = np.random.default_rng(seed)
    b = GltfBuilder()
    checker = b.add_image_png(checker_texture(128, (210, 200, 190), (90, 70, 60)))
    floor_mat = b.add_material(color=(1, 1, 1), color_tex=checker, roughness=0.8)
    wall = b.add_material(color=(0.7, 0.7, 0.72))
    lights = [
        b.add_material(emissive=(1, 0.9, 0.8), emissive_strength=16.0),
        b.add_material(emissive=(0.6, 0.7, 1), emissive_strength=12.0),
    ]

    W, H, D = 10.0, 5.0, 10.0
    p, n, uv, i = quad_mesh((-W/2, 0, -D/2), (W/2, 0, -D/2), (W/2, 0, D/2), (-W/2, 0, D/2))
    b.add_node(mesh=b.add_mesh(p, i, n, uv, material=floor_mat))
    for pts in [
        [(-W/2, H, D/2), (W/2, H, D/2), (W/2, H, -D/2), (-W/2, H, -D/2)],
        [(-W/2, 0, -D/2), (-W/2, H, -D/2), (W/2, H, -D/2), (W/2, 0, -D/2)],
        [(-W/2, 0, D/2), (-W/2, H, D/2), (-W/2, H, -D/2), (-W/2, 0, -D/2)],
        [(W/2, 0, -D/2), (W/2, H, -D/2), (W/2, H, D/2), (W/2, 0, D/2)],
    ]:
        p, n, uv, i = quad_mesh(*pts)
        b.add_node(mesh=b.add_mesh(p, i, n, uv, material=wall))

    for k in range(2):
        x = -2.5 + 5 * k
        p, n, uv, i = quad_mesh(
            (x - 1, H - 0.02, 1), (x + 1, H - 0.02, 1),
            (x + 1, H - 0.02, -1), (x - 1, H - 0.02, -1),
        )
        b.add_node(mesh=b.add_mesh(p, i, n, uv, material=lights[k]))

    for _ in range(40):
        kind = rng.integers(0, 2)
        cx = float(rng.uniform(-W/2 + 0.8, W/2 - 0.8))
        cz = float(rng.uniform(-D/2 + 0.8, D/2 - 0.8))
        color = tuple(float(c) for c in rng.uniform(0.2, 0.95, 3))
        metallic = float(rng.integers(0, 2))
        roughness = float(rng.uniform(0.05, 0.9))
        m = b.add_material(color=color, metallic=metallic, roughness=roughness)
        if kind == 0:
            size = rng.uniform(0.3, 1.2, 3)
            p, n, uv, i = box_mesh(tuple(size), (0, 0, 0))
            rot = _mat3_to_quat(_rot_y(float(rng.uniform(0, math.pi))))
            b.add_node(mesh=b.add_mesh(p, i, n, uv, material=m), rotation=rot,
                       translation=(cx, float(size[1]) / 2, cz))
        else:
            r = float(rng.uniform(0.25, 0.7))
            p, n, uv, i = uv_sphere(r, (cx, r, cz), n_lat=10, n_lon=20)
            b.add_node(mesh=b.add_mesh(p, i, n, uv, material=m))
    b.add_camera_lookat((0, 2.6, 4.6), (0, 1.0, 0), yfov=0.9)
    b.write(path)


def _rot_y(a: float) -> np.ndarray:
    c, s = math.cos(a), math.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def make_city_scene(path, blocks=12, seed=11) -> None:
    """Scale-test scene: a grid city of tessellated towers + spheres
    (~`blocks`^2 * ~700 triangles; blocks=12 -> ~100k) with two area lights.
    Used to exercise the DMA-streamed intersector beyond VMEM residency."""
    rng = np.random.default_rng(seed)
    b = GltfBuilder()
    ground = b.add_material(color=(0.45, 0.45, 0.47), roughness=0.9)
    lights = [
        b.add_material(emissive=(1, 0.95, 0.85), emissive_strength=25.0),
        b.add_material(emissive=(0.7, 0.8, 1), emissive_strength=18.0),
    ]
    span = blocks * 3.0
    p, n, uv, i = quad_mesh(
        (-span, 0, -span), (span, 0, -span), (span, 0, span), (-span, 0, span)
    )
    b.add_node(mesh=b.add_mesh(p, i, n, uv, material=ground))
    for k, x in enumerate((-span / 3, span / 3)):
        p, n, uv, i = quad_mesh(
            (x - 2, blocks * 1.8, 2), (x + 2, blocks * 1.8, 2),
            (x + 2, blocks * 1.8, -2), (x - 2, blocks * 1.8, -2),
        )
        b.add_node(mesh=b.add_mesh(p, i, n, uv, material=lights[k]))
    for gx in range(blocks):
        for gz in range(blocks):
            cx = (gx - blocks / 2 + 0.5) * 3.0
            cz = (gz - blocks / 2 + 0.5) * 3.0
            color = tuple(float(c) for c in rng.uniform(0.25, 0.9, 3))
            m = b.add_material(
                color=color,
                metallic=float(rng.integers(0, 2)),
                roughness=float(rng.uniform(0.1, 0.9)),
            )
            hgt = float(rng.uniform(1.0, 6.0))
            # tessellated tower: stack of jittered boxes + a sphere cap
            nseg = int(rng.integers(2, 5))
            for s_ in range(nseg):
                w = float(rng.uniform(0.6, 1.2)) * (1 - 0.15 * s_)
                p, n, uv, i = box_mesh(
                    (w, hgt / nseg, w),
                    (cx, hgt / nseg * (s_ + 0.5), cz),
                )
                b.add_node(mesh=b.add_mesh(p, i, n, uv, material=m))
            p, n, uv, i = uv_sphere(
                0.45, (cx, hgt + 0.45, cz), n_lat=9, n_lon=18
            )
            b.add_node(mesh=b.add_mesh(p, i, n, uv, material=m))
    b.add_camera_lookat(
        (span * 0.8, blocks * 1.2, span * 0.8), (0, 1.5, 0), yfov=0.8
    )
    b.write(path)


def make_citynight_scene(path, blocks=12, seed=11,
                         windows_per_tower=6) -> None:
    """Many-light scale scene: the city grid with emissive window quads on
    every tower (~blocks^2 * windows_per_tower lights, > the
    RT_TPU_LIGHT_CULL_MIN=512 threshold) — exercises the Morton-clustered
    light-cull pdf path (ops/light_cull.py) on a benchmark-shaped scene,
    not just the synthetic unit-test grid."""
    rng = np.random.default_rng(seed)
    b = GltfBuilder()
    ground = b.add_material(color=(0.3, 0.3, 0.34), roughness=0.9)
    span = blocks * 3.0
    p, n, uv, i = quad_mesh(
        (-span, 0, -span), (span, 0, -span), (span, 0, span), (-span, 0, span)
    )
    b.add_node(mesh=b.add_mesh(p, i, n, uv, material=ground))
    window_tints = [(1.0, 0.9, 0.7), (0.8, 0.9, 1.0), (1.0, 0.75, 0.5)]
    for gx in range(blocks):
        for gz in range(blocks):
            cx = (gx - blocks / 2 + 0.5) * 3.0
            cz = (gz - blocks / 2 + 0.5) * 3.0
            color = tuple(float(c) for c in rng.uniform(0.1, 0.45, 3))
            m = b.add_material(color=color, roughness=float(rng.uniform(0.3, 0.9)))
            hgt = float(rng.uniform(2.0, 7.0))
            w = float(rng.uniform(0.7, 1.1))
            p, n, uv, i = box_mesh((w, hgt, w), (cx, hgt / 2, cz))
            b.add_node(mesh=b.add_mesh(p, i, n, uv, material=m))
            # Emissive windows on the +x and +z faces, lit at random floors.
            for _k in range(windows_per_tower):
                tint = window_tints[int(rng.integers(len(window_tints)))]
                wm = b.add_material(
                    emissive=tint,
                    emissive_strength=float(rng.uniform(4.0, 20.0)),
                )
                y = float(rng.uniform(0.3, hgt - 0.4))
                s = 0.14
                if rng.random() < 0.5:
                    x0 = cx + w / 2 + 0.01
                    z0 = cz + float(rng.uniform(-w / 2 + s, w / 2 - s))
                    p, n, uv, i = quad_mesh(
                        (x0, y - s, z0 - s), (x0, y - s, z0 + s),
                        (x0, y + s, z0 + s), (x0, y + s, z0 - s),
                    )
                else:
                    z0 = cz + w / 2 + 0.01
                    x0 = cx + float(rng.uniform(-w / 2 + s, w / 2 - s))
                    p, n, uv, i = quad_mesh(
                        (x0 + s, y - s, z0), (x0 - s, y - s, z0),
                        (x0 - s, y + s, z0), (x0 + s, y + s, z0),
                    )
                b.add_node(mesh=b.add_mesh(p, i, n, uv, material=wm))
    b.add_camera_lookat(
        (span * 0.8, blocks * 1.1, span * 0.8), (0, 1.5, 0), yfov=0.8
    )
    b.write(path)


GENERATORS = {
    "cube": make_cube_scene,
    "cornell": make_cornell_scene,
    "textured": make_textured_scene,
    "demo": make_demo_scene,
    "city": make_city_scene,
    "citynight": make_citynight_scene,
}


def generate(name: str, out_dir) -> dict:
    """Generate scene `name` into out_dir; returns {'gltf': path, 'env': path?}."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    gltf_path = out_dir / f"{name}.gltf"
    if name == "envmap":
        hdr_path = out_dir / "sky.hdr"
        make_envmap_scene(gltf_path, hdr_path)
        return {"gltf": str(gltf_path), "env": str(hdr_path)}
    GENERATORS[name](gltf_path)
    return {"gltf": str(gltf_path)}
