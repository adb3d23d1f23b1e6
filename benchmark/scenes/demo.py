# Frozen copy of raytracer_odin_tpu_torch/models/assets.py (make_demo_scene)
# at commit 6dc2ca8.
"""The demo scene: a room of mixed boxes and spheres on a textured floor,
lit by two emissive panels (7,090 triangles, 4 light triangles at seed 7)."""

from __future__ import annotations

import math

import numpy as np

from benchmark.scenes.gltf_writer import (GltfBuilder, _mat3_to_quat,
                                          box_mesh, checker_texture,
                                          quad_mesh, uv_sphere)


def write(path, seed=7) -> None:
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
