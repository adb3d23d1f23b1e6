# Frozen copy of raytracer_odin_tpu_torch/models/assets.py (make_city_scene)
# at commit 6dc2ca8.
"""The city scene: a grid of tessellated towers with sphere caps under two
area lights (blocks=24: 207,234 triangles, 4 light triangles)."""

from __future__ import annotations

import numpy as np

from benchmark.scenes.gltf_writer import GltfBuilder, box_mesh, quad_mesh, uv_sphere


def write(path, blocks=12, seed=11) -> None:
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
