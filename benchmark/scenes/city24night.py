"""The streamed night city: city.py's towers and ground, lit only by
emissive window quads on the towers' boxes (blocks=24, windows_per_tower=6:
214,142 triangles, 6,912 light triangles in 216 clusters of 32).

The towers take city.py's draws in city.py's order from the same seed, so
every box and sphere cap is that scene's, bit for bit, and its triangles
come in its order; city.py's two area-light quads are left out. The
windows draw from a second generator, [seed, 1], after every tower is
written. Each face of a box is a grid of slots of at least WINDOW_PITCH a
side; a tower's windows take distinct slots of its boxes' four side faces,
so no two windows overlap and none reaches past its box's top or bottom
into the box above or below.
"""

from __future__ import annotations

import numpy as np

from benchmark.scenes.gltf_writer import GltfBuilder, box_mesh, quad_mesh, uv_sphere

# Half the side of a window quad, as in citynight.py.
WINDOW_HALF = 0.14
# Least side of a slot: a window and a gap of at least 0.02 to the next.
WINDOW_PITCH = 0.30
# How far a window stands out of its face.
WINDOW_PROUD = 0.01
WINDOW_TINTS = [(1.0, 0.9, 0.7), (0.8, 0.9, 1.0), (1.0, 0.75, 0.5)]
# The side faces of a box: (axis of the normal, sign).
FACES = ((0, 1.0), (0, -1.0), (2, 1.0), (2, -1.0))


def window_slots(box):
    """Every slot of box (cx, cz, w, y0, h): (axis, sign, tangent offset,
    y of the centre, half-height) over its four side faces. A face w wide
    and h high has floor(w / PITCH) columns and max(1, floor(h / PITCH))
    rows; a window's half-height is WINDOW_HALF, or less where the box is
    lower than one pitch, so that it ends 0.01 inside the box."""
    _cx, _cz, w, y0, h = box
    cols = int(w // WINDOW_PITCH)
    rows = max(1, int(h // WINDOW_PITCH))
    half_h = min(WINDOW_HALF, h / (2 * rows) - 0.01)
    return [(axis, sign, -w / 2 + (c + 0.5) * w / cols,
             y0 + (r + 0.5) * h / rows, half_h)
            for axis, sign in FACES for r in range(rows) for c in range(cols)]


def window_quad(box, slot):
    """The four corners of the window in `slot` of `box`, wound so that its
    normal points out of the face."""
    cx, cz, w, _y0, _h = box
    axis, sign, off, y, half_h = slot
    centre = np.array([cx, y, cz], np.float64)
    centre[axis] += sign * (w / 2 + WINDOW_PROUD)
    tangent = np.zeros(3)
    tangent[2 - axis] = WINDOW_HALF
    up = np.array([0.0, half_h, 0.0])
    centre[2 - axis] += off
    corners = [centre - tangent - up, centre + tangent - up,
               centre + tangent + up, centre - tangent + up]
    # (tangent x up) is -x on an x face and +z on a z face
    if (axis == 0) == (sign > 0):
        corners.reverse()
    return [tuple(float(x) for x in c) for c in corners]


def write(path, blocks=24, seed=11, windows_per_tower=6) -> None:
    rng = np.random.default_rng(seed)
    b = GltfBuilder()
    ground = b.add_material(color=(0.45, 0.45, 0.47), roughness=0.9)
    span = blocks * 3.0
    p, n, uv, i = quad_mesh(
        (-span, 0, -span), (span, 0, -span), (span, 0, span), (-span, 0, span)
    )
    b.add_node(mesh=b.add_mesh(p, i, n, uv, material=ground))
    towers = []
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
            nseg = int(rng.integers(2, 5))
            boxes = []
            for s_ in range(nseg):
                w = float(rng.uniform(0.6, 1.2)) * (1 - 0.15 * s_)
                p, n, uv, i = box_mesh(
                    (w, hgt / nseg, w),
                    (cx, hgt / nseg * (s_ + 0.5), cz),
                )
                b.add_node(mesh=b.add_mesh(p, i, n, uv, material=m))
                boxes.append((cx, cz, w, hgt / nseg * s_, hgt / nseg))
            p, n, uv, i = uv_sphere(
                0.45, (cx, hgt + 0.45, cz), n_lat=9, n_lon=18
            )
            b.add_node(mesh=b.add_mesh(p, i, n, uv, material=m))
            towers.append(boxes)
    wrng = np.random.default_rng([seed, 1])
    for boxes in towers:
        slots = [(box, slot) for box in boxes for slot in window_slots(box)]
        for k in wrng.choice(len(slots), size=windows_per_tower,
                             replace=False):
            tint = WINDOW_TINTS[int(wrng.integers(len(WINDOW_TINTS)))]
            wm = b.add_material(
                emissive=tint,
                emissive_strength=float(wrng.uniform(4.0, 20.0)))
            p, n, uv, i = quad_mesh(*window_quad(*slots[int(k)]))
            b.add_node(mesh=b.add_mesh(p, i, n, uv, material=wm))
    b.add_camera_lookat(
        (span * 0.8, blocks * 1.2, span * 0.8), (0, 1.5, 0), yfov=0.8
    )
    b.write(path)
