"""From-scratch glTF 2.0 ingest.

Replaces the reference's cgltf binding (input.odin:13-259): parses the glTF
JSON (and GLB containers), loads .bin buffers / data URIs, walks the node
hierarchy accumulating 4x4 transforms, extracts the camera, builds per-
primitive materials, and assembles world-space triangles — reproducing every
ingest behavior documented in SURVEY.md section 2 component 4:

  * camera basis from transform columns with -z forward (input.odin:103-109)
  * one new material appended per primitive (input.odin:161-162)
  * emissive_strength extension multiplying emission (input.odin:157-159)
  * world-space positions via the accumulated transform; tangents transformed
    as directions and renormalized (input.odin:191-196)
  * geometric normal from the edge cross product (input.odin:197)
  * missing normals -> flat ng; present normals via the cofactor matrix,
    renormalized (input.odin:198-207)
  * texture cache keyed by resolved path, percent-decoded URIs
    (input.odin:55-72)
  * scene selection chain: gltf.scene -> scenes[0] -> all nodes
    (input.odin:236-248)
"""

from __future__ import annotations

import base64
import json
import struct
import urllib.parse
from pathlib import Path

import numpy as np

from raytracer_odin_tpu_torch.io import images as images_io
from raytracer_odin_tpu_torch.models.scene import Camera, HostMaterial, HostScene, HostTexture
from raytracer_odin_tpu_torch.utils import profiling

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}

_TYPE_COUNTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT2": 4,
    "MAT3": 9,
    "MAT4": 16,
}


class GltfError(ValueError):
    pass


def _load_buffer(buf: dict, root: Path) -> bytes:
    uri = buf.get("uri")
    if uri is None:
        raise GltfError("buffer without uri outside GLB")
    if uri.startswith("data:"):
        header, b64 = uri.split(",", 1)
        return base64.b64decode(b64)
    path = root / urllib.parse.unquote(uri)
    return path.read_bytes()


class _Gltf:
    def __init__(self, doc: dict, buffers: list[bytes], root: Path):
        self.doc = doc
        self.buffers = buffers
        self.root = root

    def accessor_data(self, index: int) -> np.ndarray:
        """Read an accessor as float32 [count, n] (or uint32 for indices);
        handles byteStride and normalized integer components, matching
        cgltf.accessor_read_float semantics."""
        acc = self.doc["accessors"][index]
        count = acc["count"]
        n = _TYPE_COUNTS[acc["type"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        item = np.dtype(dtype).itemsize * n

        if "bufferView" not in acc:
            data = np.zeros((count, n), dtype)
        else:
            bv = self.doc["bufferViews"][acc["bufferView"]]
            buf = self.buffers[bv["buffer"]]
            offset = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
            stride = bv.get("byteStride", item)
            if stride == item:
                data = np.frombuffer(
                    buf, dtype, count=count * n, offset=offset
                ).reshape(count, n)
            else:
                raw = np.frombuffer(
                    buf, np.uint8, count=stride * (count - 1) + item, offset=offset
                )
                rows = np.lib.stride_tricks.as_strided(
                    raw, shape=(count, item), strides=(stride, 1)
                )
                data = rows.copy().view(dtype).reshape(count, n)

        if "sparse" in acc:
            # Sparse accessors patch the (possibly zero) base data with
            # (index, value) pairs; cgltf resolves these inside
            # accessor_read_float (input.odin:171-224 reads through it).
            sp = acc["sparse"]
            scount = sp["count"]
            idx_def = sp["indices"]
            ibv = self.doc["bufferViews"][idx_def["bufferView"]]
            idx_dtype = _COMPONENT_DTYPES[idx_def["componentType"]]
            indices = np.frombuffer(
                self.buffers[ibv["buffer"]],
                idx_dtype,
                count=scount,
                offset=ibv.get("byteOffset", 0) + idx_def.get("byteOffset", 0),
            ).astype(np.int64)
            val_def = sp["values"]
            vbv = self.doc["bufferViews"][val_def["bufferView"]]
            values = np.frombuffer(
                self.buffers[vbv["buffer"]],
                dtype,
                count=scount * n,
                offset=vbv.get("byteOffset", 0) + val_def.get("byteOffset", 0),
            ).reshape(scount, n)
            data = data.copy()
            data[indices] = values

        if acc["componentType"] == 5126:
            return data.astype(np.float32)
        if acc.get("normalized", False):
            info = np.iinfo(dtype)
            if info.min < 0:
                return np.maximum(
                    data.astype(np.float32) / info.max, -1.0
                ).astype(np.float32)
            return (data.astype(np.float32) / info.max).astype(np.float32)
        return data

    def accessor_indices(self, index: int) -> np.ndarray:
        return self.accessor_data(index).reshape(-1).astype(np.int64)


def _parse_container(path: Path) -> tuple[dict, list[bytes]]:
    data = path.read_bytes()
    if data[:4] == b"glTF":
        # GLB: 12-byte header then chunks (JSON, BIN).
        _, _, _ = struct.unpack("<III", data[:12])
        pos = 12
        doc = None
        bin_chunk = None
        while pos < len(data):
            clen, ctype = struct.unpack("<II", data[pos : pos + 8])
            chunk = data[pos + 8 : pos + 8 + clen]
            pos += 8 + clen
            if ctype == 0x4E4F534A:  # 'JSON'
                doc = json.loads(chunk)
            elif ctype == 0x004E4942:  # 'BIN'
                bin_chunk = bytes(chunk)
        if doc is None:
            raise GltfError("GLB without JSON chunk")
        buffers = []
        for i, buf in enumerate(doc.get("buffers", [])):
            if "uri" not in buf and i == 0:
                buffers.append(bin_chunk or b"")
            else:
                buffers.append(_load_buffer(buf, path.parent))
        return doc, buffers
    doc = json.loads(data)
    buffers = [_load_buffer(b, path.parent) for b in doc.get("buffers", [])]
    return doc, buffers


def _node_local_transform(node: dict) -> np.ndarray:
    """Local transform: `matrix` (column-major) or T*R*S, like
    cgltf.node_transform_local (input.odin:100)."""
    if "matrix" in node:
        return np.array(node["matrix"], np.float32).reshape(4, 4, order="F")
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m = np.diag(list(node["scale"]) + [1.0]).astype(np.float32) @ m
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ],
            np.float32,
        )
        m4 = np.eye(4, dtype=np.float32)
        m4[:3, :3] = r
        m = m4 @ m
    if "translation" in node:
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def _cofactor3(m: np.ndarray) -> np.ndarray:
    """Cofactor matrix of the upper-left 3x3 (normal transform,
    input.odin:203)."""
    c = np.zeros((3, 3), np.float32)
    for i in range(3):
        for j in range(3):
            minor = np.delete(np.delete(m, i, axis=0), j, axis=1)
            c[i, j] = ((-1) ** (i + j)) * np.linalg.det(minor)
    return c


def read_gltf(path) -> HostScene:
    """Parse a glTF/GLB file into a HostScene (read_gltf, input.odin:13).
    Tallied as the "gltf_read" span."""
    with profiling.span("gltf_read"):
        return _read_gltf(Path(path))


def _read_gltf(path: Path) -> HostScene:
    doc, buffers = _parse_container(path)
    g = _Gltf(doc, buffers, path.parent)
    scene = HostScene()
    # Each primitive's triangle arrays, joined once at the end: appending
    # them one primitive at a time copies the arrays so far each time, which
    # grows with the square of the primitives.
    parts: list[dict] = []

    texture_cache: dict[str, int] = {}

    def load_image_cached(image_index: int) -> int:
        img = doc["images"][image_index]
        if "uri" in img and not img["uri"].startswith("data:"):
            key = str(path.parent / urllib.parse.unquote(img["uri"]))
        else:
            key = f"<image#{image_index}>"
        if key in texture_cache:
            return texture_cache[key]
        if "uri" in img:
            uri = img["uri"]
            if uri.startswith("data:"):
                data = base64.b64decode(uri.split(",", 1)[1])
            else:
                data = (path.parent / urllib.parse.unquote(uri)).read_bytes()
        elif "bufferView" in img:
            bv = doc["bufferViews"][img["bufferView"]]
            buf = buffers[bv["buffer"]]
            off = bv.get("byteOffset", 0)
            data = buf[off : off + bv["byteLength"]]
        else:
            raise GltfError("image without uri or bufferView")
        loaded = images_io.decode_image(data)
        idx = len(scene.textures)
        scene.textures.append(HostTexture(loaded.data, loaded.is_hdr))
        texture_cache[key] = idx
        return idx

    def load_sampler(tex_info) -> int:
        """Texture slot from a glTF textureInfo dict; -1 when absent
        (load_sampler, input.odin:75-90)."""
        if not tex_info:
            return -1
        tex = doc["textures"][tex_info["index"]]
        if "source" not in tex:
            return -1
        return load_image_cached(tex["source"])

    def populate(node_index: int, parent_transform: np.ndarray):
        node = doc["nodes"][node_index]
        transform = parent_transform @ _node_local_transform(node)

        if "camera" in node:
            cam_def = doc["cameras"][node["camera"]]
            basis = np.stack(
                [transform[:3, 0], transform[:3, 1], -transform[:3, 2]], axis=1
            ).astype(np.float32)
            scene.cam = Camera(
                pos=transform[:3, 3].astype(np.float32),
                basis=basis,
                fov_x=float(cam_def["perspective"]["yfov"]),
            )

        if "mesh" in node:
            mesh = doc["meshes"][node["mesh"]]
            for prim in mesh.get("primitives", []):
                _ingest_primitive(prim, transform)

        for child in node.get("children", []):
            populate(child, transform)

    def _ingest_primitive(prim: dict, transform: np.ndarray):
        attrs = prim.get("attributes", {})
        if "POSITION" not in attrs:
            raise GltfError("No position accessor found in mesh primitive")
        positions = g.accessor_data(attrs["POSITION"])[:, :3]
        normals = (
            g.accessor_data(attrs["NORMAL"])[:, :3] if "NORMAL" in attrs else None
        )
        texcoords = (
            g.accessor_data(attrs["TEXCOORD_0"])[:, :2]
            if "TEXCOORD_0" in attrs
            else None
        )
        tangents = (
            g.accessor_data(attrs["TANGENT"]) if "TANGENT" in attrs else None
        )

        # Material: a fresh entry per primitive (input.odin:161-162).
        mat = HostMaterial()
        mdef = (
            doc["materials"][prim["material"]] if "material" in prim else {}
        )
        pbr = mdef.get("pbrMetallicRoughness", {})
        mat.color_factor = np.array(
            pbr.get("baseColorFactor", [1, 1, 1, 1])[:3], np.float32
        )
        mat.color_tex = load_sampler(pbr.get("baseColorTexture"))
        mat.emission_factor = np.array(
            mdef.get("emissiveFactor", [0, 0, 0]), np.float32
        )
        mat.emission_tex = load_sampler(mdef.get("emissiveTexture"))
        mat.roughness_factor = float(pbr.get("roughnessFactor", 1.0))
        mat.metallic_factor = float(pbr.get("metallicFactor", 1.0))
        mat.metallic_roughness_tex = load_sampler(
            pbr.get("metallicRoughnessTexture")
        )
        mat.normal_tex = load_sampler(mdef.get("normalTexture"))
        strength = (
            mdef.get("extensions", {})
            .get("KHR_materials_emissive_strength", {})
            .get("emissiveStrength")
        )
        if strength is not None:
            mat.emission_factor = mat.emission_factor * np.float32(strength)
        material_index = len(scene.materials)
        scene.materials.append(mat)

        if "indices" in prim:
            idx = g.accessor_indices(prim["indices"])
        else:
            idx = np.arange(positions.shape[0], dtype=np.int64)
        ntri = idx.shape[0] // 3
        tri_idx = idx[: ntri * 3].reshape(ntri, 3)

        # Gather per-corner attributes, then transform to world space.
        pos = positions[tri_idx]  # [T, 3, 3]
        pos_w = pos @ transform[:3, :3].T + transform[:3, 3]

        if tangents is not None:
            tan = tangents[tri_idx].astype(np.float32)  # [T, 3, 4]
            tan_dir = tan[..., :3] @ transform[:3, :3].T
            norm = np.linalg.norm(tan_dir, axis=-1, keepdims=True)
            tan_dir = tan_dir / np.where(norm > 0, norm, 1.0)
            tan = np.concatenate([tan_dir, tan[..., 3:4]], axis=-1)
        else:
            tan = np.zeros((ntri, 3, 4), np.float32)

        e1 = pos_w[:, 1] - pos_w[:, 0]
        e2 = pos_w[:, 2] - pos_w[:, 0]
        ng = np.cross(e1, e2)
        ng_norm = np.linalg.norm(ng, axis=-1, keepdims=True)
        ng = ng / np.where(ng_norm > 0, ng_norm, 1.0)

        if normals is None:
            nrm = np.repeat(ng[:, None, :], 3, axis=1)
        else:
            cof = _cofactor3(transform[:3, :3])
            nrm = normals[tri_idx] @ cof.T
            nn = np.linalg.norm(nrm, axis=-1, keepdims=True)
            nrm = nrm / np.where(nn > 0, nn, 1.0)

        tc = (
            texcoords[tri_idx]
            if texcoords is not None
            else np.zeros((ntri, 3, 2), np.float32)
        )

        parts.append(dict(
            p=pos_w[:, 0].astype(np.float32),
            u=e1.astype(np.float32),
            v=e2.astype(np.float32),
            ng=ng.astype(np.float32),
            n1=nrm[:, 0].astype(np.float32),
            n2=nrm[:, 1].astype(np.float32),
            n3=nrm[:, 2].astype(np.float32),
            tex1=tc[:, 0].astype(np.float32),
            tex2=tc[:, 1].astype(np.float32),
            tex3=tc[:, 2].astype(np.float32),
            tan1=tan[:, 0].astype(np.float32),
            tan2=tan[:, 1].astype(np.float32),
            tan3=tan[:, 2].astype(np.float32),
            mat_index=np.full(ntri, material_index, np.int32),
        ))

    identity = np.eye(4, dtype=np.float32)
    if "scene" in doc:
        roots = doc["scenes"][doc["scene"]].get("nodes", [])
    elif doc.get("scenes"):
        roots = doc["scenes"][0].get("nodes", [])
    else:
        roots = list(range(len(doc.get("nodes", []))))
    for r in roots:
        populate(r, identity)

    if parts:
        scene.append_triangles(**{k: np.concatenate([p[k] for p in parts])
                                  for k in parts[0]})
    return scene
