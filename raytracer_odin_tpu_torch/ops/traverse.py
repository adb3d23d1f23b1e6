"""Nearest-hit ray casting (port of raytracer_odin_tpu/ops/traverse.py).

Every cast follows `cast_ray` semantics (raytracer.odin:416-430): the
origin is pushed forward by RAY_EPS along the direction, the nearest hit
with t > 0 wins, and RAY_EPS is added back to the returned t (BIG on a
miss). Four intersectors:

  * "pallas" — exact culling through the kernels: K1 gives each ray its
    (super-)cluster mask, the masks are OR-ed per list block into cluster
    lists, and K2 (resident scenes) or K4 (streamed scenes, whose lists
    are uncapped) sweeps them.
    Scenes above MAX_EXACT_CLUSTERS clusters take the two-level layout:
    mask bits cover super-clusters of g consecutive clusters, refined per
    block by the conservative interval cull. With TWO_PHASE_K > 0 a
    presorted cast of a resident one-level scene culls in two phases
    (_two_phase_exact).
  * "pallas_brute" — every cluster for every ray through K3.
  * "brute" — the chunked all-rays x all-triangles sweep
    (cast_ray_through_trigs, raytracer.odin:351-369), plain torch.
  * "bvh" — the stackless walk over the flattened BVH's per-octant hit/miss
    links (cast_ray_through_bvh, raytracer.odin:371-414), plain torch.

"auto" picks by the device the rays live on, as the JAX package picks by
its backend: "pallas" on the card; on the CPU "brute" up to brute_max_tris
triangles and "bvh" above.
"""

from __future__ import annotations

import torch

from raytracer_odin_tpu_torch.ops import culling
from raytracer_odin_tpu_torch.ops import pallas_intersect as pi
from raytracer_odin_tpu_torch.ops.bvh import LEAF_SIZE
from raytracer_odin_tpu_torch.ops.geometry import (
    BIG,
    RAY_EPS,
    intersect_aabb,
    intersect_triangle,
)
from raytracer_odin_tpu_torch.utils import profiling
from raytracer_odin_tpu_torch.utils.env import env_int
from raytracer_odin_tpu_torch.utils.math3d import device_vector

# Exact per-ray culling works on at most this many mask bits (read at
# import from RT_TPU_MAX_EXACT, as the JAX package reads it). K1 stages one
# 32-byte box a bit in shared memory, 48 KiB at most without opting in.
MAX_EXACT_CLUSTERS = env_int(
    "RT_TPU_MAX_EXACT", 256, lambda v: 1 <= v <= 1536,
    "an integer from 1 to 1536 (mask bits; K1's box table)")

# Two-phase t-bounded culling of presorted exact-mask casts (0 = off), read
# from the JAX package's own switch: phase A sweeps each block's K nearest
# listed clusters, then every cluster whose per-ray slab entry lies beyond
# the hit found is pruned, and phase B sweeps the rest.
TWO_PHASE_K = env_int("RT_TPU_TWO_PHASE", 0, lambda v: v >= 0,
                      "an integer >= 0 (clusters phase A sweeps; 0: off)")

# Brute sweep working set: rays per chunk are chosen so that one [rays,
# brute_chunk] intermediate holds at most this many elements.
_BRUTE_ELEMS = 1 << 22


def _ray_octant(d):
    """Octant index from direction signs: bit k set iff d[k] < 0."""
    return (
        (d[..., 0] < 0).to(torch.int32)
        + 2 * (d[..., 1] < 0).to(torch.int32)
        + 4 * (d[..., 2] < 0).to(torch.int32)
    )


def _lex_sort_keys(alive_f, octant, w_ops, n_clusters: int):
    """Lexicographic coherence-sort keys (dead|octant, mask words), most
    significant first. When the last mask word has >= 5 free top bits
    (C % 32 <= 27) the dead|octant header rides in them; it sits above
    every used mask bit, so dead lanes still sort last.

    PRECONDITION: mask bits >= n_clusters are zero (cluster_masks_rows
    with n_clusters). Returns (keys, word_slots): the sorted mask words are
    [sorted_keys[i] for i in word_slots]."""
    used_top = n_clusters - (len(w_ops) - 1) * 32  # bits used in last word
    hdr = ((~alive_f).to(torch.int32) << 3) | octant
    w_ops = list(w_ops)
    if used_top <= 27:
        w_last = w_ops[-1] | (hdr << used_top)
        keys = [w_last] + w_ops[:-1]
        word_slots = list(range(1, len(w_ops))) + [0]
        return keys, word_slots
    return [hdr] + w_ops, list(range(1, 1 + len(w_ops)))


def lex_sort_perm(keys):
    """Permutation sorting lanes lexicographically by `keys` ([N] int32,
    most significant first), each compared as signed int32 as lax.sort
    compares it. torch has no multi-key sort: key pairs are packed into one
    int64 (high word signed, low word biased to unsigned order) and the
    packed keys are sorted least significant first with stable sorts. Ties
    keep lane order; lax.sort's tie order is unspecified, and per-lane
    results do not depend on it."""
    packed = []
    for i in range(0, len(keys), 2):
        hi = keys[i].to(torch.int64)
        if i + 1 < len(keys):
            lo = keys[i + 1].to(torch.int64) + (1 << 31)
            packed.append((hi << 32) | lo)
        else:
            packed.append(hi)
    perm = None
    for key in reversed(packed):
        k = key if perm is None else key[perm]
        order = torch.sort(k, stable=True).indices
        perm = order if perm is None else perm[order]
    return perm


def exact_cull_layout(scene):
    """Two-level exact-cull layout (g, n_super, aabb8): g clusters per mask
    bit (1 when the scene has at most MAX_EXACT_CLUSTERS clusters, else
    ceil(C / MAX_EXACT_CLUSTERS)); aabb8 [S_pad, 8] holds lo.xyz, hi.xyz,
    2 pad columns per (super-)cluster, row s bounding clusters
    [s*g, (s+1)*g) (consecutive clusters are BVH-ordered treelets), padded
    to a multiple of 32 rows with (BIG, -BIG) boxes."""
    n_clusters = scene.cluster_lo.shape[0]
    g = -(-n_clusters // MAX_EXACT_CLUSTERS)
    n_super = -(-n_clusters // g)
    lo, hi = scene.cluster_lo, scene.cluster_hi
    dev = lo.device
    if g > 1:
        pad = n_super * g - n_clusters
        lo = torch.cat([lo, torch.full((pad, 3), BIG, dtype=torch.float32,
                                       device=dev)])
        hi = torch.cat([hi, torch.full((pad, 3), -BIG, dtype=torch.float32,
                                       device=dev)])
        lo = lo.reshape(n_super, g, 3).amin(dim=1)
        hi = hi.reshape(n_super, g, 3).amax(dim=1)
    s_pad = -(-n_super // 32) * 32
    aabb8 = torch.zeros((s_pad, 8), dtype=torch.float32, device=dev)
    aabb8[:, 0:3] = BIG
    aabb8[:, 3:6] = -BIG
    aabb8[:n_super, 0:3] = lo
    aabb8[:n_super, 3:6] = hi
    return g, n_super, aabb8


def _sweep_exact(scene, words_packed, rays, g: int, n_super: int,
                 cap: int = 256):
    """Cluster lists from per-ray (super-)masks (sweep_lists) + the sweep:
    K4 over RB-lane lists for streamed scenes, K2 over RB_SUB-lane lists
    otherwise. words_packed: [W, Npad] int32 masks of `rays` ([8, Npad]
    RAY_EPS-offset kernel rows). Returns the [8, Npad] kernel output rows.

    Tie rule: across clusters only a strictly smaller t replaces, so among
    equal-t hits the first listed cluster wins. At g == 1 the lists are
    ascending ids, and one sweep equals the JAX package's chunked resident
    sweep (chunks merged by strict min-t in ascending chunk order). At
    g > 1 the JAX package's chunk lists are nearest-first and uncapped: one
    sweep equals its chunks, equal-t ties included, only over uncapped
    chunk-major lists (chunk, then near), which is what sweep_lists builds
    for resident scenes above CHUNK_TRIS.

    Streamed scenes' overflowing lists. Where a block's mask `bmask` holds
    more than `cap` clusters, the JAX package gives it count -1: its kernel
    sweeps every cluster in id order (the cap keeps the lists inside TPU
    scalar prefetch). The port lists that block's `bmask` clusters in
    ascending id order, uncapped, with their true count, and the hits are
    the same bit for bit, equal-t ties included: a cluster outside `bmask`
    holds no hit for any ray of the block, so it never changes a ray's
    best t or index, and leaving it out keeps the other clusters in the
    same relative (ascending id) order, so every ray meets the same hits
    in the same order and strict min-t picks the same winner. The premise,
    that `bmask` holds every cluster a ray of the block hits, is the one
    every list that does not overflow already rests on, in both packages:
    K1's exact slab masks (of the super-boxes at g > 1) and the
    conservative interval cull `culling.cull_clusters`. A grazing hit on a
    box face that the slab test rounds out would break it, and would
    equally be lost from every listed block of either package (ROADMAP.md,
    queue C)."""
    counts, lists = sweep_lists(scene, words_packed, rays, g, n_super, cap)
    if scene.stream:
        return pi.intersect_stream_rows(scene.ptri, counts, lists, rays)
    return pi.intersect_culled_rows(scene.ptri, counts, lists, rays)


def sweep_lists(scene, words_packed, rays, g: int, n_super: int,
                cap: int = 256):
    """(counts, lists) of the sweep of `rays` with masks `words_packed`, one
    row per list block (pallas_intersect.list_block).

    g == 1: the mask bits are the clusters; the OR-union per block is the
    exact list, ascending ids.
    g > 1: each block's super bits expand to their g member clusters, ANDed
    with the conservative interval cull (culling.cull_clusters), whose
    entry distance orders the survivors nearest-first. Streamed scenes and
    scenes of at most CHUNK_TRIS / LEAF clusters get one list capped at
    `cap` (count -1 beyond it: sweep every cluster); larger resident scenes
    get uncapped chunk-major lists (see _sweep_exact), and a streamed
    scene's rows beyond `cap` list their clusters in ascending id order,
    uncapped, with their true count (see _sweep_exact). At g == 1 no row
    exceeds the default cap (n_super <= MAX_EXACT_CLUSTERS)."""
    lb = pi.list_block(scene)
    if g == 1:
        return exact_lists(words_packed, n_super, cap, lb)
    n_clusters = scene.cluster_lo.shape[0]
    smask = culling.unpack_mask(
        culling.or_blocks_packed(words_packed, lb), n_super
    )
    cmask = smask.repeat_interleave(g, dim=1)[:, :n_clusters]
    imask, near = culling.cull_clusters(
        *culling.block_bounds_rows(rays, lb), scene.cluster_lo,
        scene.cluster_hi,
    )
    bmask = cmask & imask
    chunk_c = max(1, pi.chunk_tris() // pi.LEAF)
    if scene.stream or n_clusters <= chunk_c:
        return culling.build_lists(bmask, cap=cap, near=near,
                                   overflow_ids=scene.stream)
    return culling.build_lists(bmask, near=near, chunk=chunk_c)


def exact_lists(words_packed, n_super: int, cap: int = 256,
                block: int = pi.RB_SUB):
    """(counts [NB], lists [NB, <= cap]) of one-level exact culling: the OR
    of the [W, Npad] ray masks over each `block`-lane block, as ascending
    cluster ids (count -1 when a list would exceed cap)."""
    smask = culling.unpack_mask(
        culling.or_blocks_packed(words_packed, block), n_super
    )
    return culling.build_lists(smask, cap=cap)


def tiled_rows(o, d):
    """[H, W, 3] RAY_EPS-offset origins and directions -> ([8, Npad] kernel
    rows in the (16 x 32) image-tile order, lane count). Padding lanes are
    dead rays: far origins and null directions."""
    h, w = o.shape[:2]
    rays, _, n = pi.pack_rays(culling.to_tiles(o, h, w, pad_value=BIG),
                              culling.to_tiles(d, h, w, pad_value=0.0))
    return rays, n


def swept_words(lists, counts, n_words: int):
    """The clusters a sweep of (counts, lists [NB, k]) tests, every count
    at most k, as mask words per block [n_words, NB] i32. A list holds each
    id once, so adding the bits of a block's first counts entries sets each
    bit once: the sum is their OR, and no carry crosses a bit."""
    dev = lists.device
    use = torch.arange(lists.shape[1], device=dev) < counts[:, None]
    bit = torch.where(
        use, torch.bitwise_left_shift(torch.ones_like(lists), lists % 32), 0)
    word = torch.arange(n_words, dtype=lists.dtype, device=dev)
    return torch.where((lists // 32)[None] == word[:, None, None], bit[None],
                       0).sum(dim=-1, dtype=torch.int32)


def _two_phase_exact(scene, rays, words, n_super: int, aabb8,
                     cap: int = 256):
    """Two-phase t-bounded exact culling (TWO_PHASE_K; one-level resident
    scenes). Phase A sweeps each block's K nearest listed clusters through
    K2; its t rides ray row 6 into K1 with tmax_row, which prunes every
    cluster entered beyond the hit found; the clusters phase A swept are
    cleared for the whole block (phase A tested them for every lane of
    it), and phase B sweeps the rest through K2. Returns the [8, N] kernel
    output rows.

    Tie rule: lists are nearest-first, equal entry distances by ascending
    id (culling.build_lists; the JAX package's unstable sort leaves that
    order open), and the merge keeps phase A unless phase B's t is strictly
    smaller. So among equal-t hits phase A's cluster wins, and a hit index
    can differ from the single sweep's (ascending ids) only at exact-t
    ties."""
    k = TWO_PHASE_K
    lb = pi.list_block(scene)
    smask = culling.unpack_mask(culling.or_blocks_packed(words, lb), n_super)
    _, near = culling.cull_clusters(
        *culling.block_bounds_rows(rays, lb), scene.cluster_lo,
        scene.cluster_hi,
    )
    counts, lists = culling.build_lists(smask, cap=cap, near=near)
    counts_a = torch.where(counts < 0, k, torch.clamp(counts, max=k))
    out_a = pi.intersect_culled_rows(scene.ptri, counts_a, lists, rays)

    rays_b = rays.clone()
    rays_b[6] = out_a[0]
    words_b = pi.cluster_masks_rows(aabb8, rays_b, n_super, tmax_row=True)
    tested = swept_words(lists[:, :k], counts_a, words_b.shape[0])
    words_b &= ~tested.repeat_interleave(lb, dim=1)
    counts_b, lists_b = culling.build_lists(
        culling.unpack_mask(culling.or_blocks_packed(words_b, lb), n_super),
        cap=cap, near=near,
    )
    out_b = pi.intersect_culled_rows(scene.ptri, counts_b, lists_b, rays)
    return torch.where(out_b[0:1] < out_a[0:1], out_b, out_a)


def cast_presorted_rows(scene, rays, words):
    """Nearest hit for rays already packed as [8, N] kernel rows WITH the
    RAY_EPS offset applied (N % RB == 0), coherence-sorted by the caller,
    with their [W, N] exact masks. Returns (t, idx) flat [N] in the given
    lane order. The kernels return only the hit decision (the JAX
    package's zero bu/bv are not carried: barycentrics are recomputed at
    shade time). With TWO_PHASE_K > 0 a one-level resident scene culls in
    two phases. Tallied as the "cast" span."""
    n = rays.shape[1]
    with profiling.span("cast"):
        g, n_super, aabb8 = exact_cull_layout(scene)
        if TWO_PHASE_K > 0 and g == 1 and not scene.stream:
            out = _two_phase_exact(scene, rays, words, n_super, aabb8)
        else:
            out = _sweep_exact(scene, words, rays, g, n_super)
        t, idx = pi.unpack_hits(out, (n,), n)
        return torch.where(idx >= 0, t + RAY_EPS, BIG), idx


def sort_exact(scene, o2, d2, alive_f, aabb8, n_super: int):
    """The sorted branch's front half: dead lanes become far +x rays, K1
    masks every ray, and the lanes are sorted lexicographically by
    (dead|octant, mask words). o2 is RAY_EPS-offset, [N, 3].

    Returns (rays2 [8, Npad] sorted kernel rows, words [W, Npad] sorted
    masks, perm [N] int64 source lane of each sorted lane)."""
    dev = o2.device
    scene_lo = torch.amin(scene.cluster_lo, dim=0)
    scene_hi = torch.amax(
        torch.where(scene.cluster_hi > -BIG, scene.cluster_hi, scene_lo),
        dim=0,
    )
    far = scene_hi + 1000.0
    unit_x = device_vector((1.0, 0.0, 0.0), d2.dtype, dev)
    o2 = torch.where(alive_f[:, None], o2, far)
    d2 = torch.where(alive_f[:, None], d2, unit_x)
    n = o2.shape[0]
    rays_pre, _, _ = pi.pack_rays(o2, d2)
    words_p = pi.cluster_masks_rows(aabb8, rays_pre, n_super)
    w_ops = [words_p[i, :n] for i in range(words_p.shape[0])]
    keys, word_slots = _lex_sort_keys(alive_f, _ray_octant(d2), w_ops,
                                      n_super)
    perm = lex_sort_perm(keys)
    npad = rays_pre.shape[1]
    words = torch.zeros((len(w_ops), npad), dtype=torch.int32, device=dev)
    for j, slot in enumerate(word_slots):
        words[j, :n] = keys[slot][perm]
    rays2 = torch.zeros((8, npad), dtype=torch.float32, device=dev)
    rays2[0:3, :n] = o2[perm].T
    rays2[3:6, :n] = d2[perm].T
    if npad != n:
        # padding lanes: degenerate far rays (empty masks, no hits)
        rays2[0, n:] = BIG
        rays2[3, n:] = 1.0
    return rays2, words, perm


def sort_coherent(scene, o2, d2, alive_f):
    """The sorted branch without masks: dead lanes become far +x rays and
    the lanes are sorted by culling.coherence_keys. o2 is RAY_EPS-offset,
    [N, 3]. Returns (rays2 [8, Npad] sorted kernel rows, perm [N] int64
    source lane of each sorted lane)."""
    dev = o2.device
    scene_lo = torch.amin(scene.cluster_lo, dim=0)
    scene_hi = torch.amax(
        torch.where(scene.cluster_hi > -BIG, scene.cluster_hi, scene_lo),
        dim=0,
    )
    unit_x = device_vector((1.0, 0.0, 0.0), d2.dtype, dev)
    o2 = torch.where(alive_f[:, None], o2, scene_hi + 1000.0)
    d2 = torch.where(alive_f[:, None], d2, unit_x)
    keys = culling.coherence_keys(o2, d2, alive_f, scene_lo, scene_hi)
    perm = torch.sort(keys, stable=True).indices
    rays2, _, _ = pi.pack_rays(o2[perm], d2[perm])
    return rays2, perm


def cast_rays_pallas(scene, o, d, culled: bool = True, sort: bool = False,
                     alive=None):
    """Cast through the kernels (cast_ray semantics).

    culled=True: exact culling through K1 and the list sweep (K2, or K4
    for streamed scenes). culled=False: every cluster through K3, without
    masks.
    sort=False: an [H, W] batch goes through the (16 x 32) image-tile order
    (camera rays are coherent), any other batch in lane order.
    sort=True: lanes are re-bucketed before the sweep and the results
    scattered back; dead lanes (alive=False) come back as misses. Culled,
    the sort is lexicographic by (dead|octant, mask words); unculled, by
    culling.coherence_keys (dead|octant|origin cell|direction cell), as in
    the JAX package. K3 tests every cluster, so the unculled sorted cast
    equals the unsorted one lane for lane (the JAX package's scatters its
    results back by the wrong permutation: ROADMAP.md queue C). Returns
    (t, idx) in the batch shape (the JAX package's zero bu/bv are not
    carried)."""
    o = o + d * RAY_EPS
    batch_shape = tuple(o.shape[:-1])
    if culled:
        g, n_super, aabb8 = exact_cull_layout(scene)

    perm = None
    tiled = False
    if sort:
        o2 = o.reshape(-1, 3)
        d2 = d.reshape(-1, 3)
        alive_f = (torch.ones(o2.shape[0], dtype=torch.bool, device=o.device)
                   if alive is None else alive.reshape(-1))
        if culled:
            rays2, words, perm = sort_exact(scene, o2, d2, alive_f, aabb8,
                                            n_super)
        else:
            rays2, perm = sort_coherent(scene, o2, d2, alive_f)
        n = o2.shape[0]
    else:
        tiled = len(batch_shape) == 2
        if tiled:
            rays2, n = tiled_rows(o, d)
        else:
            rays2, _, n = pi.pack_rays(o.reshape(-1, 3), d.reshape(-1, 3))
        if culled:
            words = pi.cluster_masks_rows(aabb8, rays2, n_super)

    if culled:
        out = _sweep_exact(scene, words, rays2, g, n_super)
    else:
        out = pi.intersect_brute_rows(scene.ptri, rays2)
    t, idx = pi.unpack_hits(out, (n,), n)

    if perm is not None:
        # back to the original lane order (perm is a permutation)
        t_src = torch.empty_like(t)
        i_src = torch.empty_like(idx)
        t_src[perm] = t
        i_src[perm] = idx
        t = t_src.reshape(batch_shape)
        idx = i_src.reshape(batch_shape)
    elif tiled:
        h, w = batch_shape
        t = culling.from_tiles(t[:, None], h, w)[..., 0]
        idx = culling.from_tiles(idx[:, None], h, w)[..., 0]
    else:
        t = t.reshape(batch_shape)
        idx = idx.reshape(batch_shape)

    return torch.where(idx >= 0, t + RAY_EPS, BIG), idx


def cast_rays_brute(scene, o, d, chunk: int = 512):
    """Nearest hit over every triangle, `chunk` triangles at a time (the
    JAX package's cast_rays_brute). Within a chunk the first minimum wins
    (torch.argmin, as jnp.argmin); across chunks only a strictly smaller t
    replaces. Rays are processed in groups that keep one [rays, chunk]
    intermediate near _BRUTE_ELEMS elements; each ray's result does not
    depend on the grouping. Returns (t, idx int32) in the batch shape; t
    includes the RAY_EPS re-add, BIG and -1 on a miss."""
    n_tri = scene.tri_p.shape[0]
    o = o + d * RAY_EPS
    batch_shape = tuple(o.shape[:-1])
    o2 = o.reshape(-1, 3)
    d2 = d.reshape(-1, 3)
    n = o2.shape[0]
    dev = o.device
    chunk = min(chunk, max(n_tri, 1))
    best_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    best_i = torch.full((n,), -1, dtype=torch.int32, device=dev)
    group = max(1, _BRUTE_ELEMS // chunk)
    for a in range(0, n_tri, chunk):
        b = min(n_tri, a + chunk)
        p, u, v = scene.tri_p[a:b], scene.tri_u[a:b], scene.tri_v[a:b]
        for r0 in range(0, n, group):
            r1 = min(n, r0 + group)
            bt = best_t[r0:r1]
            t, _, _, ok = intersect_triangle(
                o2[r0:r1, None, :], d2[r0:r1, None, :], p, u, v)
            ok = ok & (t > 0) & (t < bt[:, None])
            t = torch.where(ok, t, BIG)
            kmin = torch.argmin(t, dim=-1)
            tk = torch.gather(t, 1, kmin[:, None])[:, 0]
            better = tk < bt
            best_i[r0:r1] = torch.where(better, (a + kmin).to(torch.int32),
                                        best_i[r0:r1])
            best_t[r0:r1] = torch.where(better, tk, bt)
    t = torch.where(best_i >= 0, best_t + RAY_EPS, BIG)
    return t.reshape(batch_shape), best_i.reshape(batch_shape)


def cast_rays_bvh(scene, o, d):
    """Stackless BVH walk (the JAX package's cast_rays_bvh): every ray
    follows its own node chain through the per-octant hit/miss links; a
    leaf whose box is hit tests its (<= LEAF_SIZE) triangles, a strictly
    smaller t replacing. The loop runs while any lane is active; each step
    works on the active lanes only (their index list shrinks as lanes end),
    which changes no lane's result. Returns (t, idx int32) as
    cast_rays_brute."""
    bvh = scene.bvh
    n_nodes = bvh.lo.shape[0]
    n_tri = scene.tri_p.shape[0]
    o = o + d * RAY_EPS
    batch_shape = tuple(o.shape[:-1])
    o = o.reshape(-1, 3)
    d = d.reshape(-1, 3)
    dev = o.device
    inv_d = 1.0 / d
    hit_link = bvh.hit_link.reshape(-1)
    miss_link = bvh.miss_link.reshape(-1)
    oct_base = _ray_octant(d).long() * n_nodes
    node = torch.zeros(o.shape[0], dtype=torch.int32, device=dev)
    best_t = torch.full((o.shape[0],), BIG, dtype=torch.float32, device=dev)
    best_i = torch.full((o.shape[0],), -1, dtype=torch.int32, device=dev)
    live = torch.arange(o.shape[0], device=dev)  # lanes with node < n_nodes
    while live.numel() > 0:
        nidx = node[live].long()
        lo, lt, ld = o[live], best_t[live], d[live]
        bi = best_i[live]
        _, box_hit = intersect_aabb(lo, inv_d[live], bvh.lo[nidx],
                                    bvh.hi[nidx], lt)
        first = bvh.first[nidx]
        count = bvh.count[nidx]
        do_tris = box_hit & (count > 0)
        for k in range(LEAF_SIZE):
            ti = torch.clamp(first + k, max=n_tri - 1)
            tl = ti.long()
            t, _, _, ok = intersect_triangle(
                lo, ld, scene.tri_p[tl], scene.tri_u[tl], scene.tri_v[tl])
            ok = ok & do_tris & (k < count) & (t > 0) & (t < lt)
            lt = torch.where(ok, t, lt)
            bi = torch.where(ok, ti, bi)
        best_t[live] = lt
        best_i[live] = bi
        links = oct_base[live] + nidx
        nxt = torch.where(box_hit, hit_link[links], miss_link[links])
        node[live] = nxt
        live = live[nxt < n_nodes]
    t = torch.where(best_i >= 0, best_t + RAY_EPS, BIG)
    return t.reshape(batch_shape), best_i.reshape(batch_shape)


def resolve_intersector(intersector: str, n_tri: int, device,
                        brute_max_tris: int = 512) -> str:
    """The intersector "auto" stands for on `device`: "pallas" on the
    card; on the CPU "brute" up to brute_max_tris triangles, else "bvh"
    (the JAX package decides the same by its backend). Other names are
    returned as they are."""
    if intersector != "auto":
        return intersector
    if torch.device(device).type == "cpu":
        return "brute" if n_tri <= brute_max_tris else "bvh"
    return "pallas"


def cast_rays(scene, o, d, *, intersector: str = "auto",
              brute_chunk: int = 512, brute_max_tris: int = 512,
              sort: bool = False, alive=None):
    """Intersector dispatch: "pallas", "pallas_brute", "brute", "bvh", or
    "auto" (resolve_intersector). sort and alive are honoured by "pallas"
    only (the coherent re-bucketing of secondary rays); the other
    intersectors do not depend on lane order. Tallied as the "cast"
    span."""
    which = resolve_intersector(intersector, scene.tri_p.shape[0], o.device,
                                brute_max_tris)
    with profiling.span("cast"):
        if which == "pallas":
            return cast_rays_pallas(scene, o, d, sort=sort, alive=alive)
        if which == "pallas_brute":
            return cast_rays_pallas(scene, o, d, culled=False)
        if which == "brute":
            return cast_rays_brute(scene, o, d, chunk=brute_chunk)
        if which == "bvh":
            return cast_rays_bvh(scene, o, d)
    raise ValueError(f"unknown intersector {intersector!r}")
