"""Per-pixel ray-path logging, the EXPENSIVE_DEBUG equivalent (port of
raytracer_odin_tpu/render/debug_rays.py).

The reference, compiled with EXPENSIVE_DEBUG, records up to 256 Cast_Info
entries per pixel and draws the hovered pixel's paths in the debug window
(main.odin:42-47, debug_log_ray main.odin:118-124, overlay
debug.odin:102-125). Anomalous (firefly) segments are color-coded
(raytracer.odin:502-515).

Two sources:

  * `trace_pixel_paths_device` (the preview's default): the paths the
    renderer actually sampled. Its draws are a pure per-(pixel, sample,
    bounce) counter chain and its per-ray intersection and shading do not
    depend on the batch, so re-tracing the pixel's ray alone with its true
    stream id (integrator.trace with log_paths) reproduces the full
    render's path for that pixel.
  * `trace_pixel_paths`: the numpy oracle with its own RNG, an independent
    second opinion on the same pixel.

The HTTP preview (?pixel=x,y[&src=oracle]) and library callers use them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from raytracer_odin_tpu_torch.oracle import cpu_reference as oracle


@dataclass
class RaySegment:
    origin: np.ndarray
    end: np.ndarray
    t: float
    color: tuple  # white: normal; red: ||exitance||>1e3; green: value/pdf>1e3
    bounce: int
    sample: int


def trace_pixel_paths(dscene, width, height, fov_x, depth, px, py,
                      samples=8, seed=0):
    """Trace `samples` paths through pixel (px, py) (reference pixel
    coords, y up) with the numpy oracle and return their segments."""
    sc = oracle.OracleScene(dscene)
    rng = np.random.default_rng(seed)
    segments: list[RaySegment] = []

    aspect = width / height
    tan_fx = np.tan(fov_x / 2)
    tan_fy = tan_fx / aspect

    for s in range(samples):
        jx, jy = rng.random(2)
        x = (px + jx) / (width / 2) - 1
        y = (py + jy) / (height / 2) - 1
        v = np.array([x * tan_fx, y * tan_fy, 1.0], np.float32)
        d = (sc.cam_basis @ v).astype(np.float32)
        d /= np.linalg.norm(d)
        o = sc.cam_pos.astype(np.float32).copy()

        throughput = np.ones(3, np.float32)
        for b in range(depth):
            t, idx, bu, bv = oracle.intersect_brute(sc, o[None], d[None])
            t, idx = float(t[0]), int(idx[0])
            if idx < 0:
                far = o + d * 100.0
                segments.append(RaySegment(o.copy(), far, np.inf,
                                           (0.6, 0.6, 1.0), b, s))
                break
            m = oracle.point_material(sc, d[None], np.array([idx]), bu, bv)
            hit_pos = m["pos"][0]
            n = -m["normal"][0] if m["inside"][0] else m["normal"][0]

            tsel = rng.random()
            if tsel <= 0.33333:
                nd = oracle.cosine_sample(rng, n[None])[0]
            elif tsel < 0.666666 and sc.light_p.shape[0] > 0:
                nd = oracle.light_sample(rng, sc, hit_pos[None])[0]
            else:
                nh = oracle.vndf_sample(rng, n[None], -d[None],
                                        m["roughness"][:1] ** 2)[0]
                nd = d - 2 * float(np.dot(nh, d)) * nh
            with np.errstate(all="ignore"):
                p_cos = oracle.cosine_pdf(n[None], nd[None])[0]
                p_v = oracle.vndf_pdf(n[None], -d[None],
                                      m["roughness"][:1] ** 2, nd[None])[0]
                if sc.light_p.shape[0] > 0:
                    p_l = oracle.light_pdf(sc, hit_pos[None], nd[None])[0]
                    pdf = (p_cos + p_l + p_v) / 3
                else:
                    pdf = (p_cos + 2 * p_v) / 3
                val = oracle.shade(
                    m["color"][:1], n[None], m["metallic"][:1],
                    m["roughness"][:1], d[None], nd[None],
                )[0]
                ratio = np.abs(val).sum() / pdf

            color = (1.0, 1.0, 1.0)
            if ratio > 1e3:
                color = (0.0, 1.0, 0.0)   # value/pdf anomaly (raytracer.odin:509)
            segments.append(RaySegment(o.copy(), hit_pos.copy(), t, color,
                                       b, s))

            if not (ratio > 1e-5):
                break
            throughput = throughput * val / max(pdf, 1e-30)
            if np.abs(throughput).sum() > 1e3:
                segments[-1].color = (1.0, 0.0, 0.0)  # exitance anomaly
            o, d = hit_pos.astype(np.float32), nd.astype(np.float32)
    return segments


def trace_pixel_paths_device(dscene, width, height, fov_x, depth, px, py,
                             samples=8, seed=0, intersector="auto"):
    """The paths the renderer sampled through pixel (px, py) for samples
    [0, samples) of the render with `seed`: the pixel's ray traced alone
    with its true stream id, on the scene's device, through `intersector`
    ("auto" resolves by the device, as the render's does). `py` is in
    reference pixel coords (y up), matching trace_pixel_paths."""
    import torch

    from raytracer_odin_tpu_torch.ops.integrator import TraceOptions, trace
    from raytracer_odin_tpu_torch.render.runtime import generate_rays
    from raytracer_odin_tpu_torch.utils import prng

    dev = dscene.device
    row = height - 1 - py  # image row of this reference pixel
    sid = torch.tensor([row * width + px], dtype=torch.int32, device=dev)
    opts = TraceOptions(depth=depth, intersector=intersector, log_paths=True)
    key = prng.key_from_seed(seed)
    segments: list[RaySegment] = []
    for s in range(samples):
        jitter = prng.uniforms(key, s, prng.JITTER_TAG, sid, 2)
        o, d = generate_rays(dscene.cam_pos, dscene.cam_basis, fov_x, width,
                             height, jitter[:, None, :], row_offset=row,
                             n_rows=1)
        # the row's rays share this pixel's jitter; keep its column
        _, aux = trace(dscene, o[:, px], d[:, px], key, s, opts,
                       stream_ids=sid)
        log = {k: v[:, 0].cpu().numpy() for k, v in aux["ray_log"].items()}
        for b in range(depth):
            if not bool(log["alive"][b]):
                break
            o_b, d_b, t = log["o"][b], log["d"][b], float(log["t"][b])
            if not bool(log["hit"][b]):
                segments.append(RaySegment(
                    o_b, o_b + d_b * 100.0, np.inf, (0.6, 0.6, 1.0), b, s))
                break
            color = (1.0, 1.0, 1.0)
            if float(log["value_over_pdf"][b]) > 1e3:
                color = (0.0, 1.0, 0.0)  # value/pdf anomaly
            elif float(log["throughput_l1"][b]) > 1e3:
                color = (1.0, 0.0, 0.0)  # exitance anomaly
            segments.append(RaySegment(o_b, o_b + d_b * t, t, color, b, s))
    return segments
