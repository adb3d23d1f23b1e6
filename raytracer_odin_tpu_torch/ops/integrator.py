"""Wavefront path-tracing integrator (port of
raytracer_odin_tpu/ops/integrator.py).

The reference's recursive `raytrace` (raytracer.odin:432-518) becomes an
iterative fixed-depth loop with a running throughput and accumulated
radiance. Per bounce, for every live lane: nearest-hit cast, env lookup on
a miss (the lane dies), material + emission on a hit, one direction from
the cosine/light/VNDF mixture with its combined pdf and BRDF value, and the
continuation rule ||value||_1 / pdf > 1e-5 (NaN compares false).

Two schedules, with identical physics (`_shade_vertex`) and sample sets
(counter-addressed RNG on the carried stream ids):
  * `trace` — full-width lanes every bounce, dead lanes masked;
  * `_trace_compacted` — dead-lane compaction: the state is sorted each
    bounce by (dead|octant, mask words), sliced to a static lane budget and
    the dead tail retired; one scatter by lane id restores image order.
The persistent pool (ops/wavefront.py) and cross-sample refill
(ops/refill.py) schedule the same physics and draws over a step's samples.
The debug surface rides the full-width trace: registered probes
(want_aux, ops/probes.py), the per-lane ray log (log_paths) and the live-
lane NaN check (check_nans) each turn compaction off.

The compacted trace holds its lane state in one of two layouts (Layout),
chosen at each call from COLS, read at import from the JAX package's
RT_TPU_COLS (0 by default): ROWS, packed rows [N, 12], shaded by
first_segment and later_segment; or COLUMNS, the JAX package's columnar
trace, a [12, N] column table shaded through ops/shading_cols.py by
first_segment_cols and later_segment_cols. Both run the same loop, the
same sorts and draws, and the same shading graphs on the card.

The row layout's segments and their halves run their PyTorch here on the
CPU and the shade kernel (ops/shade_kernel.py, csrc/shade_kernels.cu) on a
CUDA device, which computes the same values in one pass over the lanes;
any other device raises. The device is read in one place
(_kernel_serves). A segment composes its head, the light pdf and its tail
in both cases, but on the card a scene on the dense light pdf takes the
kernel's one fused launch. The column layout's segments keep their
PyTorch code everywhere.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from raytracer_odin_tpu_torch.ops import pallas_intersect as pi
from raytracer_odin_tpu_torch.ops import (
    light_cull,
    probes,
    shade_graph,
    shade_kernel,
    shading,
    shading_cols,
    texture,
    traverse,
)
from raytracer_odin_tpu_torch.ops.geometry import BIG, RAY_EPS
from raytracer_odin_tpu_torch.utils import prng, profiling
from raytracer_odin_tpu_torch.utils import vec3c as v3c
from raytracer_odin_tpu_torch.utils.env import env_int
from raytracer_odin_tpu_torch.utils.math3d import (
    cross,
    device_vector,
    dot,
    norm_l1,
    normalize,
)

# The JAX package's re-sort cadence (RT_TPU_SORT_EVERY=k: sort and compact
# every k-th bounce only) is not ported: on the H100 its skip-sort bounces
# measured slower. The variable is read to refuse any other value than 1.
env_int("RT_TPU_SORT_EVERY", 1, lambda v: v == 1,
        "1 only: the skip-sort cadence is not ported, since it measured "
        "slower on the H100")
# Columnar compacted trace (1) or the packed [N, 12] row state (0).
COLS = env_int("RT_TPU_COLS", 0, lambda v: v in (0, 1), "0 or 1")


class TraceOptions(NamedTuple):
    """The JAX package's TraceOptions, field for field and default for
    default, and the port's NaN check (check_nans) last."""
    depth: int = 8
    intersector: str = "auto"
    # The "brute" intersector's triangles per chunk, and the triangle count
    # up to which "auto" means "brute" on the CPU (traverse.cast_rays).
    brute_chunk: int = 512
    brute_max_tris: int = 512
    # Lights a step of the dense light pdf (shading.light_pdf_sum).
    light_chunk: int = 256
    # Accumulate every registered debug probe (ops/probes.py) into aux.
    want_aux: bool = False
    # Re-bucket the rays of bounces 1.. by the coherence sort before the
    # cast ("pallas" only); False also turns compaction off.
    sort_rays: bool = True
    # Record the per-bounce ray log (aux["ray_log"]) of every lane: re-traced
    # with its true stream id, one pixel's log is the full render's path
    # (render/debug_rays.py). Use on small batches only.
    log_paths: bool = False
    # Dead-lane compaction: static lane budgets for bounces 1..depth-1
    # (runtime.auto_lane_schedule). Lanes beyond a budget that are still
    # alive are counted in aux["overflow"]: the render is then invalid and
    # runtime.render_scene re-renders uncompacted. Ignored where
    # compaction_applies is false.
    lane_schedule: tuple = None
    # Raise FloatingPointError at the first NaN on a live lane after a
    # bounce's cast or shade (--debug-nans' second pass,
    # runtime.make_render_step); full-width trace only.
    check_nans: bool = False


def _point_material(scene, o, d, t, tri_idx):
    """Evaluate the hit-point material (raytracer.odin:448-488) from one
    gather of the triangle's shade row. The hit position is o + d*t; the
    barycentrics are recomputed from the row's triangle geometry (the
    sweep kernel returns only t and the index). Blocks the scene's row
    layout lacks compile out, as in the JAX package.

    Returns dict with pos, normal (possibly normal-mapped, not yet
    inside-flipped), ng, color, emission, metallic, roughness, inside."""
    ti = torch.clamp(tri_idx, min=0).long()
    spec = dict(scene.row_spec)
    kinds = scene.tex_kinds

    row = scene.shade_row[ti]  # [..., RW] single gather

    def blk(name, width):
        s = spec[name]
        return row[..., s:s + width]

    oo = o + d * RAY_EPS
    u3 = blk("tri_u", 3)
    v3 = blk("tri_v", 3)
    pv = cross(d, v3)
    det = torch.sum(u3 * pv, dim=-1)
    # Miss lanes (index clamped to 0) get zero barycentrics, not NaN.
    inv = torch.where(det != 0, 1.0 / det, 0.0)
    tv = oo - blk("tri_p", 3)
    bu = torch.sum(tv * pv, dim=-1) * inv
    qv = cross(tv, u3)
    bv = torch.sum(d * qv, dim=-1) * inv

    w0 = (1.0 - bu - bv)[..., None]
    w1 = bu[..., None]
    w2 = bv[..., None]

    def vblk(name, i, k):
        s = spec[name] + i * k
        return row[..., s:s + k]

    pos = o + d * t[..., None]

    if "texids" in spec:
        texcoords = (
            vblk("tex", 0, 2) * w0 + vblk("tex", 1, 2) * w1
            + vblk("tex", 2, 2) * w2
        )
        mtex = blk("texids", 4).to(torch.int32)
    else:
        texcoords = torch.zeros(ti.shape + (2,), dtype=torch.float32,
                                device=row.device)
        mtex = None

    ones = torch.ones(ti.shape + (4,), dtype=torch.float32, device=row.device)
    mr = texture.sample(scene, mtex[..., 2], texcoords) if kinds[2] else ones
    col_tex = (
        texture.sample(scene, mtex[..., 0], texcoords, srgb=True)
        if kinds[0] else ones
    )
    emi_tex = (
        texture.sample(scene, mtex[..., 1], texcoords, srgb=True)
        if kinds[1] else ones
    )

    n_interp = (
        vblk("n", 0, 3) * w0 + vblk("n", 1, 3) * w1 + vblk("n", 2, 3) * w2
    )
    n_smooth = normalize(n_interp, eps=1e-20)

    if kinds[3]:
        # Normal mapping (raytracer.odin:458-470): the interpolated tangent4
        # is normalized as a 4-vector, as the reference does.
        tan4 = (
            vblk("tan", 0, 4) * w0 + vblk("tan", 1, 4) * w1
            + vblk("tan", 2, 4) * w2
        )
        tan4 = tan4 / torch.clamp(
            torch.sqrt(torch.sum(tan4 * tan4, dim=-1, keepdim=True)),
            min=1e-20,
        )
        local_x = tan4[..., :3]
        local_z = n_smooth
        local_y = cross(local_z, local_x) * tan4[..., 3:4]
        nrm_sample = texture.sample(
            scene, mtex[..., 3], texcoords, default=(0.5, 1.0, 0.5, 0.0)
        )[..., :3]
        local_n = nrm_sample * 2.0 - 1.0
        n_mapped = normalize(
            local_x * local_n[..., 0:1]
            + local_y * local_n[..., 1:2]
            + local_z * local_n[..., 2:3],
            eps=1e-20,
        )
        has_nmap = mtex[..., 3] >= 0
        normal = torch.where(has_nmap[..., None], n_mapped, n_smooth)
    else:
        normal = n_smooth

    ng = blk("ng", 3)
    inside = dot(ng, d) > 0

    return {
        "pos": pos,
        "normal": normal,
        "ng": ng,
        "inside": inside,
        "texcoords": texcoords,
        "color": blk("color", 3) * col_tex[..., :3],
        "emission": blk("emission", 3) * emi_tex[..., :3],
        "roughness": torch.clamp(
            blk("roughness", 1)[..., 0] * mr[..., 1], min=0.03),
        "metallic": blk("metallic", 1)[..., 0] * mr[..., 2],
    }


def eval_head(scene, o, d, t, tri_idx, uniforms, has_lights: bool):
    """eval_bounce up to the light pdf: material, the inside-flipped
    normal, the mixture sample new_d, its cosine and VNDF pdfs (p_cos,
    p_vndf) and the BRDF value; eval_tail completes it."""
    m = _point_material(scene, o, d, t, tri_idx)
    flip = m["inside"][..., None]
    normal = torch.where(flip, -m["normal"], m["normal"])

    new_d = shading.sample_direction(
        scene, m["pos"], normal, m["roughness"], d, uniforms, has_lights
    )
    p_cos, p_vndf = shading.bsdf_pdfs(normal, m["roughness"], d, new_d)
    value = shading.shade(
        m["color"], normal, m["metallic"], m["roughness"], d, new_d
    )
    return {
        "material": m,
        "normal": normal,
        "new_d": new_d,
        "p_cos": p_cos,
        "p_vndf": p_vndf,
        "value": value,
    }


def eval_tail(ev, p_light):
    """eval_head's fields with the mixture pdf of its terms and the light
    pdf p_light (None without lights), and the continuation rule."""
    pdf = shading.mix_pdfs(ev["p_cos"], p_light, ev["p_vndf"])
    # Continuation rule (raytracer.odin:495): NaN compares false.
    return dict(ev, pdf=pdf, cont=norm_l1(ev["value"]) / pdf > 1e-5)


def eval_bounce(scene, o, d, t, tri_idx, uniforms, has_lights: bool,
                light_chunk: int = 256):
    """Per-vertex shading: material, mixture sample, pdf, BRDF value and the
    continuation rule. Fields are garbage on misses (callers mask)."""
    ev = eval_head(scene, o, d, t, tri_idx, uniforms, has_lights)
    return eval_tail(ev, _light_pdf(scene, ev["material"]["pos"],
                                    ev["new_d"], has_lights, light_chunk))


def _light_pdf(scene, pos, new_d, has_lights, light_chunk):
    return (shading.light_pdf(scene, pos, new_d, light_chunk)
            if has_lights else None)


def _shade_head(scene, o, d, t, tri_idx, alive, uniforms, has_lights,
                throughput, radiance):
    """_shade_vertex up to the light pdf: the env term on a miss, eval_head
    and the emission on a hit. Returns (ev, hit, missed, radiance)."""
    hit = (tri_idx >= 0) & alive
    missed = (~(tri_idx >= 0)) & alive

    if scene.env_tex >= 0:
        env = texture.sample_env(scene, d, scene.env_tex)
        radiance = radiance + torch.where(
            missed[..., None], throughput * env, 0.0
        )

    ev = eval_head(scene, o, d, t, tri_idx, uniforms, has_lights)
    radiance = radiance + torch.where(
        hit[..., None], throughput * ev["material"]["emission"], 0.0
    )
    return ev, hit, missed, radiance


def _shade_tail(ev, hit, throughput, p_light):
    """_shade_vertex from the light pdf p_light on: eval_tail, the
    continuation of hit lanes and the throughput update. Returns (ev,
    cont, throughput)."""
    ev = eval_tail(ev, p_light)
    cont = ev["cont"] & hit
    ratio = ev["value"] / ev["pdf"][..., None]
    throughput = torch.where(cont[..., None], throughput * ratio,
                             throughput)
    return ev, cont, throughput


def _shade_vertex(scene, o, d, t, tri_idx, alive, uniforms, has_lights,
                  throughput, radiance, light_chunk: int = 256):
    """One path vertex after the cast: env contribution on a miss, emission
    on a hit, mixture sample + continuation rule, throughput update.

    Returns (new_o, new_d, throughput, radiance, alive, ev, hit, missed);
    new_o/new_d are garbage on dead lanes (masked by `alive`). ev, hit and
    missed are what the shade computed anyway: the probes and the ray log
    read them, the compacted trace drops them. Callers tally it as the
    "shade" span."""
    ev, hit, missed, radiance = _shade_head(
        scene, o, d, t, tri_idx, alive, uniforms, has_lights, throughput,
        radiance)
    ev, cont, throughput = _shade_tail(
        ev, hit, throughput, _light_pdf(scene, ev["material"]["pos"],
                                        ev["new_d"], has_lights,
                                        light_chunk))
    return (ev["material"]["pos"], ev["new_d"], throughput, radiance, cont,
            ev, hit, missed)


# A segment is its head, the light pdf and its tail (the segment's
# `halves`, each a segment of its own to shade_graph): the head returns
# (pos, new_d, p_cos, p_vndf, value, hit, throughput, radiance), the tail
# takes them and then the light pdf p_light of pos along new_d.
def _segment_head(scene, o, d, t, tri_idx, alive, uniforms, throughput,
                  radiance):
    ev, hit, _missed, radiance = _shade_head(
        scene, o, d, t, tri_idx, alive, uniforms,
        scene.light_p.shape[0] > 0, throughput, radiance)
    return (ev["material"]["pos"], ev["new_d"], ev["p_cos"], ev["p_vndf"],
            ev["value"], hit, throughput, radiance)


def _segment_tail(p_cos, p_vndf, value, hit, throughput, p_light):
    ev = {"p_cos": p_cos, "p_vndf": p_vndf, "value": value}
    _ev, cont, throughput = _shade_tail(ev, hit, throughput, p_light)
    return cont, throughput


def _head_light_pdf(scene, head, light_chunk):
    """The light pdf a segment's tail takes: of HEAD's pos along new_d."""
    return _light_pdf(scene, head[0], head[1], scene.light_p.shape[0] > 0,
                      light_chunk)


def _kernel_serves(x) -> bool:
    """Whether the shade kernel shades the row layout's lanes of x: on a
    CUDA device (shade_kernel.engages). On the CPU the PyTorch below does;
    any other device raises, and nothing falls back."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no shading for tensors on {x.device}")
    return shade_kernel.engages(x.device)


def first_head(scene, o, d, t, tri_idx, uniforms, light_chunk: int):
    """Bounce 0's segment up to the light pdf: the shade of the camera rays
    o, d [..., 3] at their hits t, tri_idx [...] with draws uniforms
    [..., 6], as HEAD. On the card the shade kernel's HEAD (the same eight
    tensors, flat over the lanes)."""
    if _kernel_serves(t):
        return shade_kernel.head(scene, True, o, d, t, tri_idx, None,
                                 uniforms, light_chunk)
    batch_shape = tuple(o.shape[:-1])
    dev = o.device
    alive = torch.ones(batch_shape, dtype=torch.bool, device=dev)
    throughput = torch.ones(batch_shape + (3,), dtype=torch.float32,
                            device=dev)
    radiance = torch.zeros(batch_shape + (3,), dtype=torch.float32,
                           device=dev)
    return _segment_head(scene, o, d, t, tri_idx, alive, uniforms,
                         throughput, radiance)


def first_tail(scene, pos, new_d, p_cos, p_vndf, value, hit, throughput,
               radiance, p_light, light_chunk: int):
    """Bounce 0's segment from the light pdf on, flattened into the lane
    state [Npad, 12] (o, d, throughput, radiance; Npad is the lane count
    rounded up to RB) with its alive mask [Npad]. Padding lanes are
    dead. On the card the shade kernel's TAIL."""
    if _kernel_serves(hit):
        return shade_kernel.tail(scene, True, pos, new_d, p_cos, p_vndf,
                                 value, hit, throughput, radiance, p_light,
                                 light_chunk)
    dev = pos.device
    n0 = pos.shape[:-1].numel()
    n0p = -(-n0 // pi.RB) * pi.RB
    alive, throughput = _segment_tail(p_cos, p_vndf, value, hit, throughput,
                                      p_light)
    state = torch.zeros((n0p, 12), dtype=torch.float32, device=dev)
    state[:n0, 0:3] = pos.reshape(n0, 3)
    state[:n0, 3:6] = new_d.reshape(n0, 3)
    state[:n0, 6:9] = throughput.reshape(n0, 3)
    state[:n0, 9:12] = radiance.reshape(n0, 3)
    alive = torch.cat([alive.reshape(n0),
                       torch.zeros(n0p - n0, dtype=torch.bool, device=dev)])
    return state, alive


def first_segment(scene, o, d, t, tri_idx, uniforms, light_chunk: int):
    """Bounce 0's shading segment, first_head then first_tail: the shade of
    the camera rays o, d [..., 3] at their hits t, tri_idx [...] with
    draws uniforms [..., 6], flattened into the lane state [Npad, 12]
    with its alive mask [Npad]. On the card a scene on the dense light pdf
    takes one FUSED launch of the shade kernel."""
    if _kernel_serves(t) and not light_cull.serves(scene):
        return shade_kernel.fused(scene, True, o, d, t, tri_idx, None,
                                  uniforms, light_chunk)
    head = first_head(scene, o, d, t, tri_idx, uniforms, light_chunk)
    return first_tail(scene, *head, _head_light_pdf(scene, head,
                                                    light_chunk),
                      light_chunk)


first_segment.halves = (first_head, first_tail)


def later_head(scene, state, t, tri_idx, alive, uniforms, light_chunk: int):
    """A later compacted bounce's segment up to the light pdf: the shade of
    the packed lane state [N, 12] at its hits t, tri_idx [N] with draws
    uniforms [N, 6], as HEAD. On the card the shade kernel's HEAD."""
    if _kernel_serves(t):
        return shade_kernel.head(scene, False, state, None, t, tri_idx,
                                 alive, uniforms, light_chunk)
    return _segment_head(scene, state[:, 0:3], state[:, 3:6], t, tri_idx,
                         alive, uniforms, state[:, 6:9], state[:, 9:12])


def later_tail(scene, pos, new_d, p_cos, p_vndf, value, hit, throughput,
               radiance, p_light, light_chunk: int):
    """A later bounce's segment from the light pdf on, packed again:
    (state [N, 12], alive [N]). On the card the shade kernel's TAIL."""
    if _kernel_serves(hit):
        return shade_kernel.tail(scene, False, pos, new_d, p_cos, p_vndf,
                                 value, hit, throughput, radiance, p_light,
                                 light_chunk)
    alive, throughput = _segment_tail(p_cos, p_vndf, value, hit, throughput,
                                      p_light)
    return torch.cat([pos, new_d, throughput, radiance], dim=1), alive


def later_segment(scene, state, t, tri_idx, alive, uniforms,
                  light_chunk: int):
    """The shading segment of a later compacted bounce, later_head then
    later_tail: the shade of the packed lane state [N, 12] at its hits t,
    tri_idx [N] with draws uniforms [N, 6], packed again. Returns
    (state [N, 12], alive [N]); refill shades its lanes with it too. On
    the card a scene on the dense light pdf takes one FUSED launch of the
    shade kernel."""
    if _kernel_serves(t) and not light_cull.serves(scene):
        return shade_kernel.fused(scene, False, state, None, t, tri_idx,
                                  alive, uniforms, light_chunk)
    head = later_head(scene, state, t, tri_idx, alive, uniforms,
                      light_chunk)
    return later_tail(scene, *head, _head_light_pdf(scene, head,
                                                    light_chunk),
                      light_chunk)


later_segment.halves = (later_head, later_tail)


def later_head_cols(scene, state, t, tri_idx, alive, uniforms,
                    light_chunk: int):
    """later_head of the column state [12, N], whose o, d, throughput and
    radiance are [3, N] column triples; draws uniforms [N, 6], read as six
    columns. The same operations in the same order as the row form, the
    shade through ops/shading_cols.py. `_point_material` keeps its [N, k]
    row form: o and d are stacked once for it, and its normal, color and
    emission come back in one splat. pos and new_d are returned as [N, 3]
    rows, which the light pdf takes (shading.light_pdf)."""
    o, d = state[0:3], state[3:6]
    throughput, radiance = state[6:9], state[9:12]
    hit = (tri_idx >= 0) & alive
    missed = (~(tri_idx >= 0)) & alive

    if scene.env_tex >= 0:
        env = texture.sample_env_cols(scene, d, scene.env_tex)
        radiance = radiance + torch.where(missed, throughput * env, 0.0)

    m = _point_material(scene, v3c.stack(o), v3c.stack(d), t, tri_idx)
    rows = v3c.splat(torch.cat([m["normal"], m["color"], m["emission"]],
                               dim=-1))
    normal = torch.where(m["inside"], -rows[0:3], rows[0:3])
    color, emission = rows[3:6], rows[6:9]
    pos = o + d * t
    rough, metal = m["roughness"], m["metallic"]

    new_d = shading_cols.sample_direction(scene, pos, normal, rough, d,
                                          uniforms.unbind(-1),
                                          scene.light_p.shape[0] > 0)
    p_cos, p_vndf = shading_cols.bsdf_pdfs(normal, rough, d, new_d)
    value = shading_cols.shade(color, normal, metal, rough, d, new_d)
    radiance = radiance + torch.where(hit, throughput * emission, 0.0)
    return (v3c.stack(pos), v3c.stack(new_d), p_cos, p_vndf, value, hit,
            throughput, radiance)


def later_tail_cols(scene, pos, new_d, p_cos, p_vndf, value, hit,
                    throughput, radiance, p_light, light_chunk: int):
    """later_tail of the column state: (state [12, N], alive [N])."""
    pdf = shading.mix_pdfs(p_cos, p_light, p_vndf)
    # Continuation rule (raytracer.odin:495): NaN compares false.
    cont = (v3c.norm_l1(value) / pdf > 1e-5) & hit
    throughput = torch.where(cont, throughput * (value / pdf), throughput)
    return torch.cat([pos.T, new_d.T, throughput, radiance]), cont


def later_segment_cols(scene, state, t, tri_idx, alive, uniforms,
                       light_chunk: int):
    """later_segment of the column state [12, N]: later_head_cols, the
    light pdf, later_tail_cols."""
    head = later_head_cols(scene, state, t, tri_idx, alive, uniforms,
                           light_chunk)
    return later_tail_cols(scene, *head, _head_light_pdf(scene, head,
                                                         light_chunk),
                           light_chunk)


later_segment_cols.halves = (later_head_cols, later_tail_cols)


def first_head_cols(scene, o, d, t, tri_idx, uniforms, light_chunk: int):
    """first_head of the column state: the camera rays o, d [..., 3], their
    hits t, tri_idx [...] and draws uniforms [..., 6] are flattened and
    padded to whole RB blocks before the shade, as the JAX package's
    columnar trace does (padding lanes dead: alive false, tri_idx -1). On
    the CPU this padding can change a live lane's bits: an elementwise
    op's vector loop leaves its last lanes to a scalar loop, and atan2
    (the env map) rounds apart in the two."""
    dev = t.device
    n0 = t.numel()
    n0p = -(-n0 // pi.RB) * pi.RB
    state = torch.zeros((12, n0p), dtype=torch.float32, device=dev)
    state[0:3, :n0] = o.reshape(n0, 3).T
    state[3:6, :n0] = d.reshape(n0, 3).T
    state[6:9] = 1.0
    t0 = torch.zeros(n0p, dtype=torch.float32, device=dev)
    t0[:n0] = t.reshape(n0)
    idx0 = torch.full((n0p,), -1, dtype=tri_idx.dtype, device=dev)
    idx0[:n0] = tri_idx.reshape(n0)
    u0 = torch.zeros((n0p, 6), dtype=torch.float32, device=dev)
    u0[:n0] = uniforms.reshape(n0, 6)
    alive = torch.arange(n0p, device=dev) < n0
    return later_head_cols(scene, state, t0, idx0, alive, u0, light_chunk)


def first_tail_cols(scene, *args):
    """first_tail of the column state: later_tail_cols of bounce 0's padded
    lanes, (state [12, Npad], alive [Npad]); a function of its own, so that
    bounce 0's graph is its own (shade_graph keys a graph by the segment's
    name and its inputs' shapes)."""
    return later_tail_cols(scene, *args)


def first_segment_cols(scene, o, d, t, tri_idx, uniforms, light_chunk: int):
    """first_segment of the column state: first_head_cols, the light pdf,
    first_tail_cols; (state [12, Npad], alive [Npad])."""
    head = first_head_cols(scene, o, d, t, tri_idx, uniforms, light_chunk)
    return first_tail_cols(scene, *head, _head_light_pdf(scene, head,
                                                         light_chunk),
                           light_chunk)


first_segment_cols.halves = (first_head_cols, first_tail_cols)


class Layout(NamedTuple):
    """The compacted trace's lane state: its lane axis (0: packed rows
    [N, 12]; 1: a [12, N] column table) and the segments that shade and
    pack it. Its fields are o 0:3, d 3:6, throughput 6:9, radiance 9:12."""
    axis: int
    first: Callable
    later: Callable

    def lanes(self, state, ix):
        """The state's lanes ix (a slice or a permutation)."""
        return state[ix] if self.axis == 0 else state[:, ix]

    def field(self, state, a: int, b: int):
        """Fields a:b of every lane, an [N, b - a] view."""
        return state[:, a:b] if self.axis == 0 else state[a:b].T


ROWS = Layout(0, first_segment, later_segment)
COLUMNS = Layout(1, first_segment_cols, later_segment_cols)


def check_live_nans(sample, bounce: int, stage: str, stream_ids, checks):
    """Raise FloatingPointError if a live lane holds a NaN: `checks` is a
    list of (name, values [..., k] or [...], live mask [...]). Dead lanes
    carry garbage by design and are not read. The message names the
    sample, the bounce, the stage and the first pixel (stream) ids."""
    for name, v, live in checks:
        nan = torch.isnan(v)
        if nan.dim() > live.dim():
            nan = nan.any(dim=-1)
        bad = nan & live
        profiling.count("host_syncs")
        if bool(bad.any()):
            ids = stream_ids[bad].reshape(-1)[:8].tolist()
            raise FloatingPointError(
                f"NaN in {name} of {int(bad.sum())} live lanes at sample "
                f"{int(sample)}, bounce {bounce}, after the {stage}; first "
                f"pixel ids {ids}")


def trace(scene, o, d, key, sample, opts: TraceOptions, stream_ids=None,
          stream_base=None):
    """Trace radiance for a batch of rays.

    o, d: [..., 3] origins/directions (d normalized). key: the seed's word
    pair (prng.key_from_seed); sample: this batch's sample index.
    stream_ids: [...] int32 per-lane stream ids (the pixel index); by
    default a lane's flat position in the batch, which is the pixel index
    for a full frame. A lane's draws are prng.uniforms(key, sample,
    bounce, stream_id) - the JAX package's addressing, so both draw the
    same bits, and a lane traced alone with its pixel's stream id draws
    what it draws in the full frame.
    stream_base: with stream_ids None, the default ids are stream_base +
    the flat position (a row window of a full frame: a tile shard draws
    what the full frame draws for the same pixels). The compacted trace
    carries the stream ids through its sorts.

    Returns (radiance [..., 3], aux) with aux "rays_cast" (live path
    segments cast, int64 scalar tensor), "overflow" and "alive_counts"
    ([depth] live lanes entering each bounce). With opts.want_aux, aux
    also holds every registered probe's accumulator by name
    (ops/probes.py); with opts.log_paths, "ray_log": per bounce and lane
    o, d, t (inf unless a hit), alive, hit, value_over_pdf and
    throughput_l1, each [depth, ...] (the Cast_Info log, main.odin:42-47).
    With opts.check_nans, a NaN on a live lane after a bounce's cast or
    shade raises FloatingPointError (check_live_nans)."""
    batch_shape = tuple(o.shape[:-1])
    dev = o.device
    if stream_ids is None:
        n_lanes = 1
        for s in batch_shape:
            n_lanes *= s
        stream_ids = (int(stream_base or 0) + torch.arange(
            n_lanes, dtype=torch.int32, device=dev)).reshape(batch_shape)
    if opts.lane_schedule is not None and compaction_applies(opts, dev):
        return _trace_compacted(scene, o, d, key, sample, opts, stream_ids,
                                tile=stream_base or 0)

    has_lights = scene.light_p.shape[0] > 0
    throughput = torch.ones(batch_shape + (3,), dtype=torch.float32,
                            device=dev)
    radiance = torch.zeros(batch_shape + (3,), dtype=torch.float32,
                           device=dev)
    alive = torch.ones(batch_shape, dtype=torch.bool, device=dev)
    aux = {}
    folded = []
    if opts.want_aux:
        folded = [p for p in probes.active() if p.reduce != "final"]
        aux = {p.name: p.init(batch_shape, dev) for p in folded}
        # lanes that have had no live vertex yet (the first / first_hit
        # reductions)
        virgin = torch.ones(batch_shape, dtype=torch.bool, device=dev)
    ylogs = []
    alive_counts = []
    for b in range(opts.depth):
        # One path segment per live lane per cast (dead lanes ride the
        # kernels masked but are not credited).
        alive_counts.append(alive.sum())
        # Camera rays are tile-coherent; later bounces are re-bucketed.
        t, tri_idx = traverse.cast_rays(
            scene, o, d, intersector=opts.intersector,
            brute_chunk=opts.brute_chunk,
            brute_max_tris=opts.brute_max_tris,
            sort=b > 0 and opts.sort_rays, alive=alive,
        )
        if opts.check_nans:
            check_live_nans(sample, b, "cast", stream_ids,
                            [("t", t, alive)])
        uniforms = prng.uniforms(key, sample, b, stream_ids, 6)
        with profiling.span("shade"):
            new_o, new_d, throughput, radiance, cont, ev, hit, missed = (
                _shade_vertex(scene, o, d, t, tri_idx, alive, uniforms,
                              has_lights, throughput, radiance,
                              opts.light_chunk))
        if opts.check_nans:
            check_live_nans(sample, b, "shade", stream_ids, [
                ("radiance", radiance, alive),
                ("throughput", throughput, alive),
                ("the next origin", new_o, cont),
                ("the next direction", new_d, cont)])
        if opts.log_paths:
            ylogs.append({
                "o": o, "d": d,
                "t": torch.where(hit, t, torch.inf),
                "alive": alive, "hit": hit,
                "value_over_pdf": norm_l1(ev["value"]) / ev["pdf"],
                "throughput_l1": norm_l1(
                    torch.where(cont[..., None], throughput, 0.0)),
            })
        if folded:
            ctx = probes.ProbeCtx(
                bounce=b, o=o, d=d, t=t, hit=hit, missed=missed,
                alive=alive, material=ev["material"], normal=ev["normal"],
                pdf=ev["pdf"], value=ev["value"], new_d=new_d,
                throughput=throughput, radiance=radiance,
            )
            for p in folded:
                aux[p.name] = p.fold(aux[p.name], ctx, virgin)
            virgin = virgin & ~alive
        o, d, alive = new_o, new_d, cont
    counts = (torch.stack(alive_counts) if alive_counts
              else torch.zeros(0, dtype=torch.int64, device=dev))
    aux.update({
        "rays_cast": counts.sum(),
        "overflow": torch.zeros((), dtype=torch.int64, device=dev),
        "alive_counts": counts,
    })
    if opts.want_aux:
        fctx = probes.ProbeCtx(radiance=radiance)
        for p in probes.active():
            if p.reduce == "final":
                aux[p.name] = p.value_of(fctx, dev)
    if opts.log_paths and ylogs:
        aux["ray_log"] = {k: torch.stack([y[k] for y in ylogs])
                          for k in ylogs[0]}
    return radiance, aux


def compaction_applies(opts: TraceOptions, device) -> bool:
    """Dead-lane compaction needs depth > 1, no per-lane instrumentation
    (AOVs and ray logs need full-width lanes every bounce; the NaN check
    reads every live lane), sort_rays, and the exact-culled sorted cast:
    "pallas", or "auto" on the card, where it resolves to "pallas". "auto"
    on the CPU ("brute" or "bvh"), "pallas_brute", "brute" and "bvh" run
    uncompacted, as in the JAX package (integrator._compaction_applies)."""
    if (opts.depth <= 1 or opts.want_aux or opts.log_paths
            or opts.check_nans or not opts.sort_rays):
        return False
    if opts.intersector == "pallas":
        return True
    return (opts.intersector == "auto"
            and torch.device(device).type != "cpu")


def first_bounce(scene, o, d, key, sample, stream_ids=None,
                 light_chunk: int = 256, tile=None, widths=None,
                 layout: Layout = ROWS):
    """Bounce 0 of the compacted wavefront: the tiled full-width cast of the
    camera rays o, d [..., 3] and their shading segment (layout.first),
    run by shade_graph.run: the lane state (o, d, throughput, radiance of
    Npad lanes, the lane count rounded up to RB, in the layout) with its
    alive mask [Npad]. Padding lanes are dead; a lane draws with its stream
    id (stream_ids [...], by default its flat position). tile and widths
    place the sample in the graph cache (shade_graph.run); on the card the
    two tensors are a graph's outputs, rewritten by the next call with the
    same key."""
    batch_shape = tuple(o.shape[:-1])
    t, tri_idx = traverse.cast_rays(
        scene, o, d, intersector="pallas", sort=False
    )
    if stream_ids is None:
        stream_ids = torch.arange(o.shape[:-1].numel(), dtype=torch.int32,
                                  device=o.device).reshape(batch_shape)
    uniforms = prng.uniforms(key, sample, 0, stream_ids, 6)
    return shade_graph.run(layout.first, scene,
                           (o, d, t, tri_idx, uniforms), light_chunk,
                           tile=tile, widths=widths)


def sort_lanes(state, alive, aabb8, n_super: int, budget: int,
               layout: Layout = ROWS):
    """The front half of one compacted bounce: dead lanes become degenerate
    far rays (empty masks; their o, d in `state` are overwritten in place),
    K1 masks every lane, and the lanes are sorted by (dead|octant, mask
    words), so the alive lanes form a prefix. The bounce's batch is the
    first `budget` lanes, rounded down to RB and kept within [RB, N].

    Returns (the sorted state, perm [N] source lane of each sorted lane,
    the batch's RAY_EPS-offset kernel rows [8, s_width] and their mask
    words [W, s_width]). Tallied as the "sort" span."""
    rb = pi.RB
    width = state.shape[layout.axis]
    s_width = max(rb, min(width, (int(budget) // rb) * rb))
    with profiling.span("sort"):
        rays_pre = _far_rows(state, alive, layout)
        words_p = pi.cluster_masks_rows(aabb8, rays_pre, n_super)
        keys, word_slots = traverse._lex_sort_keys(
            alive, traverse._ray_octant(layout.field(state, 3, 6)),
            [words_p[i] for i in range(words_p.shape[0])], n_super,
        )
        perm = traverse.lex_sort_perm(keys)
        state = layout.lanes(state, perm)
        words = torch.stack([keys[i][perm[:s_width]] for i in word_slots],
                            dim=0)
        return (state, perm,
                _rows(layout.lanes(state, slice(None, s_width)), layout),
                words)


def _rows(state, layout: Layout):
    """RAY_EPS-offset kernel rows [8, N] of the lane state."""
    o, d = layout.field(state, 0, 3), layout.field(state, 3, 6)
    rows = torch.zeros((8, o.shape[0]), dtype=torch.float32,
                       device=state.device)
    rows[0:3] = (o + d * RAY_EPS).T
    rows[3:6] = d.T
    return rows


def _far_rows(state, alive, layout: Layout):
    """Dead lanes of the lane state become far rays (BIG, 0, 0) along +x
    (empty masks), in place; returns the lanes' kernel rows [8, N] in their
    order."""
    dev = state.device
    far_o = device_vector((BIG, 0.0, 0.0), device=dev)
    unit_x = device_vector((1.0, 0.0, 0.0), device=dev)
    o, d = layout.field(state, 0, 3), layout.field(state, 3, 6)
    o.copy_(torch.where(alive[:, None], o, far_o))
    d.copy_(torch.where(alive[:, None], d, unit_x))
    return _rows(state, layout)


def _trace_compacted(scene, o, d, key, sample, opts: TraceOptions,
                     stream_ids, tile=None):
    """Dead-lane-compacted wavefront (TraceOptions.lane_schedule).

      bounce 0   tiled full-width cast + shade (camera rays, image order)
      bounce b   K1 masks -> lexicographic (dead|octant, masks) sort of the
                 whole state -> slice to schedule[b-1] lanes (alive lanes
                 are a sorted prefix; the dead tail retires its radiance)
                 -> presorted cast (no unsort) -> shade in sorted order
      merge      every lane retires exactly once; one scatter by lane id
                 rebuilds image order.

    The JAX package moves the state through the sort as lax.sort payload
    columns; here one permutation gathers the lane state, and the stream
    ids [...] ride the same permutation (the JAX package recomputes them
    from the lane id under its stream_base promise). The state's layout is
    COLUMNS where COLS is set at the call, else ROWS: only its lane axis,
    its kernel rows and its segments differ.

    Each bounce's shade and the packing of its outputs is one segment
    (layout.first, layout.later) of static shapes, run by shade_graph.run:
    on the card from CUDA graphs, keyed by `tile` (the sample's place in
    the frame, trace's stream_base) and the lane budgets."""
    layout = COLUMNS if COLS else ROWS
    batch_shape = tuple(o.shape[:-1])
    dev = o.device
    schedule = opts.lane_schedule

    n0 = 1
    for s in batch_shape:
        n0 *= s

    def shade(state, t, tri_idx, alive, uniforms):
        return shade_graph.run(layout.later, scene,
                               (state, t, tri_idx, alive, uniforms),
                               opts.light_chunk, tile=tile, widths=schedule)

    # ---- bounce 0: full width, image order ----
    state, alive = first_bounce(scene, o, d, key, sample, stream_ids,
                                opts.light_chunk, tile=tile, widths=schedule,
                                layout=layout)
    n0p = state.shape[layout.axis]
    rays = torch.full((), n0, dtype=torch.int64, device=dev)
    alive_counts = [rays]
    # A lane's id is its flat position in the batch; padding lanes carry
    # ids >= n0, which the merge drops. Stream ids are carried through the
    # sorts.
    iota = torch.arange(n0p, dtype=torch.int32, device=dev)
    stream = torch.zeros(n0p, dtype=torch.int32, device=dev)
    stream[:n0] = stream_ids.reshape(n0)
    _g, n_super, aabb8 = traverse.exact_cull_layout(scene)

    retired_iota = []
    retired_rad = []
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    for b in range(1, opts.depth):
        n_alive = alive.sum()
        budget = schedule[b - 1] if b - 1 < len(schedule) else schedule[-1]
        state, perm, rays_sorted, s_words = sort_lanes(
            state, alive, aabb8, n_super, budget, layout
        )
        s_width = rays_sorted.shape[1]
        alive_counts.append(n_alive)
        overflow = overflow + torch.clamp(n_alive - s_width, min=0)

        iota = iota[perm]
        stream = stream[perm][:s_width]
        # The tail is dead (or overflow, which poisons the render): its
        # radiance is final.
        retired_iota.append(iota[s_width:])
        retired_rad.append(layout.field(
            layout.lanes(state, slice(s_width, None)), 9, 12))
        state = layout.lanes(state, slice(None, s_width)).contiguous()
        iota = iota[:s_width]
        alive = torch.arange(s_width, device=dev) < n_alive
        # Alive lanes are a sorted prefix: min(n_alive, s_width) are cast.
        rays = rays + torch.clamp(n_alive, max=s_width)

        t, tri_idx = traverse.cast_presorted_rows(
            scene, rays_sorted, words=s_words
        )
        uniforms = prng.uniforms(key, sample, b, stream, 6)
        state, alive = shade(state, t, tri_idx, alive, uniforms)

    # ---- merge: each lane id appears exactly once ----
    with profiling.span("merge"):
        retired_iota.append(iota)
        retired_rad.append(layout.field(state, 9, 12))
        all_iota = torch.cat(retired_iota).long()
        merged = torch.empty((n0p, 3), dtype=torch.float32, device=dev)
        merged[all_iota] = torch.cat(retired_rad, dim=0)
        radiance = merged[:n0].reshape(batch_shape + (3,))
    aux = {
        "rays_cast": rays,
        "overflow": overflow,
        "alive_counts": torch.stack(alive_counts),
    }
    return radiance, aux
