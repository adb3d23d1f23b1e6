"""Scene data model (PyTorch port of raytracer_odin_tpu/models/scene.py).

The reference keeps an AoS ``Scene`` of ``Triangle`` structs plus materials,
textures and two BVHs (raytracer.odin:18-60). The port splits this as the
JAX package does:

  * ``HostScene`` — numpy staging area filled by the glTF ingest
    (io/gltf.py), mirroring the reference's Scene fields. The host
    dataclasses are copied unchanged.
  * ``DeviceScene`` — a dataclass of SoA torch tensors on one device:
    triangle soup, material table, one flat texture atlas, light list, and
    the Pallas-layout arrays the intersection and light kernels read, and
    the flattened BVH (``DeviceBVH``) that the BVH intersector walks.

Triangle parameterization matches the reference exactly: p + u*b1 + v*b2 with
u = p2-p1, v = p3-p1 (input.odin:209-224), shading normals n1..n3, texcoords
tex1..tex3, tangents tan1..tan3 (xyzw, w = bitangent sign), geometric normal
ng, material index.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch


@dataclass
class Camera:
    """Camera (raytracer.odin:45-49): position, 3x3 basis (columns = right,
    up, forward; forward already negated at ingest like input.odin:107),
    horizontal field of view in radians."""

    pos: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    basis: np.ndarray = field(default_factory=lambda: np.eye(3, dtype=np.float32))
    fov_x: float = 1.0


@dataclass
class HostTexture:
    """Decoded image + atlas placement."""

    data: np.ndarray  # float32 [H, W, C] raw (LDR already /255)
    is_hdr: bool

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def height(self) -> int:
        return self.data.shape[0]


@dataclass
class HostMaterial:
    """glTF metallic-roughness material (raytracer.odin:34-43). Texture slots
    are indices into HostScene.textures, -1 = absent sampler (the reference's
    nil-texture Sampler, textures.odin:21-23)."""

    color_factor: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    emission_factor: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    metallic_factor: float = 1.0
    roughness_factor: float = 1.0
    color_tex: int = -1
    emission_tex: int = -1
    metallic_roughness_tex: int = -1
    normal_tex: int = -1


@dataclass
class HostScene:
    """Staging scene: AoS numpy triangle fields (SoA-ified on upload)."""

    cam: Camera = field(default_factory=Camera)
    # Triangle arrays, each [T, ...]:
    p: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    u: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    v: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    ng: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    n1: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    n2: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    n3: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))
    tex1: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.float32))
    tex2: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.float32))
    tex3: np.ndarray = field(default_factory=lambda: np.zeros((0, 2), np.float32))
    tan1: np.ndarray = field(default_factory=lambda: np.zeros((0, 4), np.float32))
    tan2: np.ndarray = field(default_factory=lambda: np.zeros((0, 4), np.float32))
    tan3: np.ndarray = field(default_factory=lambda: np.zeros((0, 4), np.float32))
    mat_index: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    materials: list = field(default_factory=list)
    textures: list = field(default_factory=list)
    env_map: Optional[HostTexture] = None

    @property
    def num_triangles(self) -> int:
        return self.p.shape[0]

    def append_triangles(self, **arrays) -> None:
        for name, arr in arrays.items():
            cur = getattr(self, name)
            setattr(self, name, np.concatenate([cur, np.asarray(arr)], axis=0))


@dataclass
class DeviceBVH:
    """Flattened stackless BVH (built by ops/bvh.py). Traversal state is
    just a node index; per ray-direction octant links give near-child-first
    order. Node 0 is the root; a link equal to the node count ends the
    walk."""

    lo: Any          # [B, 3] f32
    hi: Any          # [B, 3] f32
    first: Any       # [B] i32: a leaf's first triangle (BVH order)
    count: Any       # [B] i32: a leaf's triangle count (0 for a branch)
    hit_link: Any    # [8, B] i32
    miss_link: Any   # [8, B] i32


BVH_FIELDS = ("lo", "hi", "first", "count", "hit_link", "miss_link")
_BVH_INT_FIELDS = ("first", "count", "hit_link", "miss_link")


@dataclass
class DeviceScene:
    """Device-resident SoA scene (torch tensors on one device). Field
    meanings and layouts are those of the JAX package's DeviceScene; the
    static fields `env_tex`, `row_spec` and `tex_kinds` select code paths
    exactly as its pytree aux data does."""

    # Triangles (BVH-permuted order):
    tri_p: Any       # [T, 3]
    tri_u: Any       # [T, 3]
    tri_v: Any       # [T, 3]
    tri_ng: Any      # [T, 3]
    tri_n: Any       # [T, 3, 3] shading normals (n1, n2, n3)
    tri_tex: Any     # [T, 3, 2] texcoords
    tri_tan: Any     # [T, 3, 4] tangents
    tri_mat: Any     # [T] i32
    # Materials:
    mat_color: Any            # [M, 3]
    mat_emission: Any         # [M, 3]
    mat_metallic: Any         # [M]
    mat_roughness: Any        # [M]
    mat_tex: Any              # [M, 4] i32: color, emission, mr, normal (-1 none)
    # Texture atlas (ops/texture.build_atlas, quad-packed rows):
    tex_texels: Any           # [P, 16] f32
    tex_texels_srgb: Any      # [P, 16] or [1, 16] f32 (pre-decoded sRGB)
    tex_offset: Any           # [K] i32
    tex_width: Any            # [K] i32
    tex_height: Any           # [K] i32
    # Lights (emissive triangles, Morton-ordered):
    light_p: Any              # [L, 3]
    light_u: Any              # [L, 3]
    light_v: Any              # [L, 3]
    light_ng: Any             # [L, 3]
    light_pdf_factor: Any     # [L] = 2 / |cross(u, v)|
    light_mask: Any           # [L] 1.0 for real lights
    # Many-light cull (ops/light_cull.py, K5): Morton-ordered light rows
    # in LEAF_L-light clusters and the clusters' AABBs.
    light_rows: Any           # [Lpad, 16] p u v ng fac valid pad
    light_cluster_lo: Any     # [CL, 3]
    light_cluster_hi: Any     # [CL, 3]
    # Intersection-kernel data (ops/pallas_intersect.py, ops/culling.py):
    ptri: Any                 # [Tpad, 12] packed p/u/v rows, LEAF-padded
    cluster_lo: Any           # [C, 3] treelet-cluster AABBs
    cluster_hi: Any           # [C, 3]
    # Hit-shading row (models/build.py): per-triangle attributes with the
    # material inlined; the layout is `row_spec`.
    shade_row: Any            # [T, RW] f32
    cam_pos: Any              # [3]
    cam_basis: Any            # [3, 3]
    # Flattened BVH over the triangles (the "bvh" intersector).
    bvh: DeviceBVH
    env_tex: int = -1
    row_spec: tuple = ()
    tex_kinds: tuple = (False, False, False, False)
    # Streamed scene (above pallas_intersect.STREAM_TRIS padded triangles,
    # decided at build): RB-lane cluster lists swept by K4 instead of K2.
    stream: bool = False

    @property
    def num_triangles(self) -> int:
        return self.tri_p.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_p.shape[0]

    @property
    def device(self) -> torch.device:
        return self.ptri.device


# Tensor fields and their dtypes, in declaration order.
_INT_FIELDS = ("tri_mat", "mat_tex", "tex_offset", "tex_width", "tex_height")
_STATIC_FIELDS = ("env_tex", "row_spec", "tex_kinds", "stream")
TENSOR_FIELDS = tuple(
    f.name for f in dataclasses.fields(DeviceScene)
    if f.name not in _STATIC_FIELDS + ("bvh",)
)


def scene_from_numpy(arrays: dict, *, env_tex: int, row_spec: tuple,
                     tex_kinds: tuple, stream: bool = False,
                     device="cuda") -> DeviceScene:
    """Build a DeviceScene on `device` from numpy arrays keyed by field
    name (every name in TENSOR_FIELDS), and the BVH from `arrays["bvh"]`,
    a dict of numpy arrays keyed by BVH_FIELDS. The arrays may come from
    this package's finish_scene or from the JAX package's DeviceScene, so
    both renderers can be fed one and the same scene (the JAX package's
    streamed `ptri` is 128 wide: pass its first 12 columns)."""
    dev = torch.device(device)

    def put(a, is_int):
        return torch.tensor(np.asarray(a), device=dev,
                            dtype=torch.int32 if is_int else torch.float32)

    kw = {name: put(arrays[name], name in _INT_FIELDS)
          for name in TENSOR_FIELDS}
    kw["bvh"] = DeviceBVH(**{name: put(arrays["bvh"][name],
                                       name in _BVH_INT_FIELDS)
                             for name in BVH_FIELDS})
    return DeviceScene(**kw, env_tex=int(env_tex), row_spec=tuple(row_spec),
                       tex_kinds=tuple(bool(k) for k in tex_kinds),
                       stream=bool(stream))
