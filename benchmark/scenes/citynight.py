# Frozen copy of raytracer_odin_tpu_torch/models/assets.py
# (make_citynight_scene) at commit 1f256f1.
"""The night city: a grid of box towers lit by emissive window quads, the
many-light scene of the culled light pdf (blocks=12: 3,458 triangles,
1,728 light triangles in 54 clusters of 32)."""

from __future__ import annotations

import numpy as np

from benchmark.scenes.gltf_writer import GltfBuilder, box_mesh, quad_mesh


def write(path, blocks=12, seed=11, windows_per_tower=6) -> None:
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
