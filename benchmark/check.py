"""The comparison that decides `correct`.

What is judged is the window's own render: the accumulated image the
program's render_scene call returned, and the live path segments it
counted (the numerator of mrays_per_s). The plain reference
(benchmark/reference/) renders the same rows of the same image from the
glTF file with its own paths; the two are estimates of one image, so they
are compared statistically:

  * count_off: pixels whose sample count is not the number of samples the
    window rendered (the whole image; exact, limit 0);
  * z2_mean: over segments of `segment_px` pixels of the sampled rows
    (the cells take whole rows), each colour channel apart, the mean of
    z^2, where z is the difference of the two segment means over its
    standard error (each side's per-pixel sample variance over its sample
    count); about 1 where both render one image;
  * image_z: the same difference over every segment at once, each colour
    channel apart, the largest |z| of the three: a bias of the whole
    image shows here long before it shows segment by segment;
  * segments_gap: the relative gap between the program's live segments a
    path (rays_cast over samples x pixels) and the reference's on the
    sampled rows, or where the cell asks for it (`segments`) on more
    rows at fewer samples: a scene whose rows differ widely, sky against
    towers, needs more of them for the whole image's mean.

The rows are drawn from the seed, one from each of `rows` equal bands of
the image, so their mean estimates the whole image's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NUMBERS = ("count_off", "z2_mean", "image_z", "segments_gap")


def _entropy(seed: int, salt: int) -> list:
    s = seed % (1 << 64)
    return [s & 0xFFFFFFFF, s >> 32, salt]


def sample_rows(seed: int, height: int, n: int, salt: int = 0x0B0E) -> list:
    rng = np.random.default_rng(_entropy(seed, salt))
    band = height / n
    return [min(height - 1, int(i * band + rng.random() * band))
            for i in range(n)]


def _segments(total, total_sq, count, seg):
    """Per segment and channel: (mean of pixel means, variance of that
    mean). total, total_sq [R, W, 3], count [R, W] float64."""
    R, W, _ = total.shape
    W = W // seg * seg
    n = count[:, :W, None].clamp(min=1.0)
    mean = total[:, :W] / n
    var = (total_sq[:, :W] / n - mean * mean).clamp(min=0.0) / n
    mean = mean.reshape(R, W // seg, seg, 3)
    var = var.reshape(R, W // seg, seg, 3)
    return mean.mean(2), var.sum(2) / (seg * seg)


def _z2(diff, var):
    z2 = torch.where(var > 0, diff * diff / var.clamp(min=1e-300),
                     torch.where(diff == 0, 0.0, math.inf))
    return torch.nan_to_num(z2, nan=math.inf)


def z_numbers(prog, ref, seg: int):
    """(z2_mean, image_z)."""
    mp, vp = _segments(prog["total"], prog["total_sq"], prog["count"], seg)
    mr, vr = _segments(ref["total"], ref["total_sq"], ref["count"], seg)
    diff = mp - mr
    var = vp + vr
    image = _z2(diff.sum((0, 1)), var.sum((0, 1))).max()
    return float(_z2(diff, var).mean()), math.sqrt(float(image))


def numbers(prog, ref, seg: int) -> dict:
    """prog, ref: dicts of the sampled rows' 'total', 'total_sq' [R, W, 3]
    and 'count' [R, W] (float64, CPU), and 'segments_per_path'; prog also
    'count_off'."""
    gap = (abs(prog["segments_per_path"] - ref["segments_per_path"])
           / ref["segments_per_path"])
    z2, image_z = z_numbers(prog, ref, seg)
    return {"count_off": float(prog["count_off"]), "z2_mean": z2,
            "image_z": image_z,
            "segments_gap": float(gap) if math.isfinite(gap) else math.inf}


def judge(values: dict, limits: dict):
    """(correct, checks): checks maps each number to its value and limit;
    a number above its limit, or not a number, fails."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


def segments_rows(chk: dict, seed: int, height: int):
    """(rows, spp) of the pass that estimates the live segments a path:
    the cell's own `segments` rows and spp, or None to take the main
    pass's count."""
    seg = chk.get("segments")
    if seg is None:
        return None
    return sample_rows(seed, height, seg["rows"], salt=0x5E6), seg["spp"]


def reference_rows(tracer, rows, width, height, fov_x, depth, spp, seed,
                   salt: int) -> dict:
    """The reference's render of `rows` at `spp` samples a pixel, its
    generator seeded from (seed, salt)."""
    gen = torch.Generator(device=tracer.dev)
    state = np.random.SeedSequence(_entropy(seed, salt)).generate_state(
        1, np.uint64)[0]
    gen.manual_seed(int(state) >> 1)
    total, total_sq, segs = tracer.render_rows(rows, width, height, fov_x,
                                               depth, spp, gen)
    count = torch.full(total.shape[:2], float(spp), dtype=torch.float64)
    return {"total": total.cpu(), "total_sq": total_sq.cpu(), "count": count,
            "segments_per_path": segs / (spp * len(rows) * width)}
