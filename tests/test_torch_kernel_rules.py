"""The exactness arguments of the port's redesigned CUDA kernels K1 (mask),
the sweep of K2, K3 and K4, and K5 (light-cluster pdf), checked on the CPU
on adversarial float32 values: NaN, +-0, +-inf, subnormals, BIG pad rows
and direction components at the 1e-30 clamp; for K5 also |ng.d| = 0,
fac < 0 and invalid light rows with real geometry.

* The sweep's warp skip: a warp skips the rest of a triangle's test when no
  ray of it has 0 <= bu <= 1. That is exact because the inside test, as
  the plain sweep computes it (`pallas_intersect.inside_triangle`), implies
  0 <= bu <= 1. The second skip, after bv when no ray is inside, needs no
  argument; a CPU model of both (`kernel_batches.sweep_with_warp_skips`)
  is held bit-equal to the plain sweep, at 256- and 512-ray lists and
  over every cluster.
* K5's warp skips: the same implication for the plain light test's inside
  form (`light_cull.light_inside`, bu + bv <= 1), and the rule that makes
  a skipped light exact: the partial starts at +0, no add makes it -0, and
  adding +0 to it changes no bit. A CPU model of the kernel's skips
  (`kernel_batches.light_with_warp_skips`) is held bit-equal to the plain
  sum.
* K1's PTX min.NaN / max.NaN: they propagate NaN as torch.minimum /
  torch.maximum do, but for a -0 / +0 pair may return the other zero. A
  numpy model of K1 with each choice of zero gives the plain version's
  words.

The CUDA kernels themselves are held against the plain versions on the
card (tests/test_torch_gpu.py, same batches)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from raytracer_odin_tpu_torch.ops import light_cull as lc
from raytracer_odin_tpu_torch.ops import pallas_intersect as pi
import kernel_batches as kb

F32 = np.float32
SUB = np.nextafter(F32(0), F32(1))     # smallest subnormal
TINY_N = np.finfo(F32).tiny            # smallest normal
SPECIAL = np.array([
    0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0, 0.5, 2.0, 3.0, 0.25,
    np.nextafter(F32(1), F32(2)), np.nextafter(F32(1), F32(0)),
    SUB, -SUB, TINY_N, -TINY_N, TINY_N - SUB, 2.0 ** -24, 2.0 ** -25,
    1e-30, -1e-30, 1e30, -1e30, pi.BIG, -pi.BIG, np.finfo(F32).max,
    -np.finfo(F32).max,
], F32)


def _ulps_around(x, k):
    out = [F32(x)]
    for _ in range(k):
        out.append(np.nextafter(out[-1], F32(np.inf)))
    lo = F32(x)
    for _ in range(k):
        lo = np.nextafter(lo, F32(-np.inf))
        out.append(lo)
    return np.array(out, F32)


def _skip_pairs(case):
    """(bu, bv) float32 tensors of one case of the warp-skip argument."""
    if case == "special_pairs":
        bu, bv = np.meshgrid(SPECIAL, SPECIAL)
    elif case == "near_one":
        # bu within 6 ulp of 0 and 1, bv tiny, subnormal, +-0 or near 1
        bus = np.concatenate([_ulps_around(1.0, 6), _ulps_around(0.0, 6)])
        bvs = np.concatenate([SPECIAL, _ulps_around(0.0, 6),
                              _ulps_around(1.0, 6), _ulps_around(2.0 ** -24, 3)])
        bu, bv = np.meshgrid(bus, bvs)
    elif case == "sweep_terms":
        # bu, bv as the plain sweep computes them: every adversarial ray
        # batch against every triangle row, BIG pad rows included
        tris = torch.from_numpy(kb.triangles())
        tri9 = tris[:, :9]
        bus, bvs = [], []
        for rc in kb.RAY_CASES:
            r = kb.rays(rc)
            bu, bv, _ = pi.moller_trumbore(tri9, *(r[i][None]
                                                   for i in range(6)))
            bus.append(bu.flatten())
            bvs.append(bv.flatten())
        return torch.cat(bus), torch.cat(bvs)
    elif case == "light_terms":
        # bu, bv as the plain light sum computes them: every adversarial
        # ray batch against every light row, zero pad rows included
        lr = torch.from_numpy(kb.light_rows())
        bus, bvs = [], []
        for rc in kb.RAY_CASES:
            r = kb.rays(rc)
            bu, bv, _ = lc.light_terms(lr, *(r[i][None] for i in range(6)))
            bus.append(bu.flatten())
            bvs.append(bv.flatten())
        return torch.cat(bus), torch.cat(bvs)
    else:
        raise ValueError(case)
    return (torch.from_numpy(np.ascontiguousarray(bu, F32).ravel()),
            torch.from_numpy(np.ascontiguousarray(bv, F32).ravel()))


# The inside test whose implication each kernel's first warp skip rests on:
# the sweep's min(min(bu, bv), 1 - (bu + bv)) >= 0 form, and K5's
# bu + bv <= 1 form.
INSIDE = {"sweep": pi.inside_triangle, "K5": lc.light_inside}


def _check_skip(bu, bv, inside_fn):
    inside = inside_fn(bu, bv)
    passes = (bu >= 0) & (bu <= 1)
    assert bool(passes[inside].all()), (bu[inside & ~passes],
                                        bv[inside & ~passes])
    return inside


def _check_skip_drawn(inside_fn):
    @settings(max_examples=3000, deadline=None, derandomize=True,
              database=None)
    @given(st.floats(width=32), st.floats(width=32))
    def check(bu, bv):
        _check_skip(torch.tensor([bu], dtype=torch.float32),
                    torch.tensor([bv], dtype=torch.float32), inside_fn)

    check()


SKIP_CASES = ([("sweep", c) for c in ("special_pairs", "near_one",
                                      "sweep_terms", "hypothesis")]
              + [("K5", c) for c in ("special_pairs", "near_one",
                                     "light_terms", "hypothesis")])


@pytest.mark.parametrize("kernel, case", [
    pytest.param(k, c, id=c if k == "sweep" else f"{k}-{c}")
    for k, c in SKIP_CASES])
def test_inside_implies_warp_skip_predicate(kernel, case):
    """Wherever the plain sweep's (or the plain light sum's) inside test
    holds, 0 <= bu <= 1 holds: a warp with no ray at 0 <= bu <= 1 has no
    ray inside."""
    inside_fn = INSIDE[kernel]
    if case == "hypothesis":
        _check_skip_drawn(inside_fn)
        return
    bu, bv = _skip_pairs(case)
    inside = _check_skip(bu, bv, inside_fn)
    assert bool(inside.any()) and not bool(inside.all())
    if case.endswith("_terms"):
        assert bool(torch.isnan(bu).any()) and bool(torch.isinf(bu).any())


@pytest.mark.parametrize("kernel, case", [
    pytest.param(k, c, id=c if k == "K2" else f"{k}-{c}")
    for k, c in kb.KERNEL_CASES])
def test_warp_skip_model_matches_plain_sweep(kernel, case):
    """The CPU model of the sweep kernel's two warp skips gives the plain
    sweep's hits bit for bit on every adversarial batch, for each instance
    of the kernel: K2's 256-ray lists, K4's 512-ray lists and K3's sweep
    of every cluster."""
    block, _ = kb.SWEEPS[kernel]
    tris, counts, lists, r = kb.sweep_batch(case, kernel)
    want = pi._culled_plain(counts, lists, r, tris, block)
    got = kb.sweep_with_warp_skips(counts, lists, r, tris, block)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert int((want[1] >= 0).sum()) > 50
    if case == "one_lane":
        # some warp has exactly one ray passing bu for a listed triangle
        assert bool((kb.lanes_passing_bu(counts, lists, r, tris, block)
                     == 1).any())
    if case == "equal_t" or kernel == "K3":
        # the copy of the mesh rows gives equal t in two listed clusters:
        # blocks listing the copy first report it (every-cluster sweeps
        # list the mesh first: clusters 0-1 win)
        hit = want[1] >= 0
        copy = hit & (want[1] >= 2 * pi.LEAF) & (want[1] < 4 * pi.LEAF)
        assert bool(copy.any()) != (kernel == "K3")
        assert bool((hit & (want[1] < 2 * pi.LEAF)).any())


@pytest.mark.parametrize("case", kb.LIGHT_CASES)
def test_light_warp_skip_model_matches_plain(case):
    """The CPU model of K5's two warp skips gives the plain light sum bit
    for bit on every adversarial batch: NaN dead lanes, +-0 and clamped
    directions, rays through shared edges, warps where one lane alone
    passes bu, counts -1 and 0, one-entry lists; lights with |ng.d| = 0
    and fac of both signs (+-inf, a NaN partial), invalid rows with real
    geometry, subnormal edges, fac NaN, +inf, -0 and subnormal, pad rows."""
    lr, counts, lists, r = kb.light_batch(case)
    want = lc._light_sums_plain(counts, lists, r, lr)
    got = kb.light_with_warp_skips(counts, lists, r, lr)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert int((want > 0).sum()) > 40 and int((want < 0).sum()) > 40
    if case == "zero_dirs":
        # rays straight down meet the lights with |ng.d| = 0: +-inf
        # contributions, and +inf + -inf partials
        assert bool(torch.isinf(want).any()) and bool(torch.isnan(want).any())


def _partials():
    """Values a partial sum can hold, and values added to it: the special
    float32 values, the default NaN of +inf + -inf, and every contribution
    of the adversarial light batches."""
    inf = torch.tensor([np.inf], dtype=torch.float32)
    contribs = []
    for case in kb.RAY_CASES:
        r = kb.rays(case)
        _, _, c = lc.light_terms(torch.from_numpy(kb.light_rows()),
                                 *(r[i][None] for i in range(6)))
        contribs.append(torch.unique(c.flatten()))
    c = torch.cat(contribs)
    assert bool((c == 0).any() & torch.signbit(c).any())   # -0 among them
    assert bool(torch.isposinf(c).any() & torch.isneginf(c).any())
    return torch.cat([torch.from_numpy(SPECIAL), inf + -inf, c])


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("rule", ["no_sum_is_negative_zero",
                                  "plus_zero_is_identity"])
def test_light_partial_zero_rule(rule):
    """A skipped K5 test adds nothing where the plain sum adds +0: exact
    because a partial that starts at +0 never becomes -0 (a sum of a value
    that is not -0 and any value is not -0), and adding +0 to a value that
    is not -0 leaves every bit as it was, +-inf and NaN included."""
    v = _partials()
    neg_zero = (v == 0) & torch.signbit(v)
    x = v[~neg_zero]
    if rule == "no_sum_is_negative_zero":
        for x0 in range(0, x.numel(), 1024):
            s = x[x0:x0 + 1024, None] + v[None, :]
            assert not bool(((s == 0) & torch.signbit(s)).any())
    else:
        assert torch.equal(_bits(x + torch.zeros_like(x)), _bits(x))
        assert bool(torch.isnan(x).any() & torch.isinf(x).any())


# ---------------------------------------------------------------------------
# K1: NaN-propagating min / max whose zero results differ in sign.
# ---------------------------------------------------------------------------

ZERO_RULES = {
    # (min of a -0 / +0 pair, max of it): IEEE 754-2019 minimum/maximum,
    # the reverse, and either operand
    "ieee": (lambda a, b: F32(-0.0), lambda a, b: F32(0.0)),
    "reversed": (lambda a, b: F32(0.0), lambda a, b: F32(-0.0)),
    "first": (lambda a, b: a, lambda a, b: a),
    "second": (lambda a, b: b, lambda a, b: b),
}


def _nan_min_max(rule):
    zmin, zmax = ZERO_RULES[rule]

    def fmin(a, b):
        both = (a == 0) & (b == 0)
        return np.where(both, zmin(a, b), np.minimum(a, b)).astype(F32)

    def fmax(a, b):
        both = (a == 0) & (b == 0)
        return np.where(both, zmax(a, b), np.maximum(a, b)).astype(F32)

    return fmin, fmax


def _k1_model(aabb, rays, n_bits, tmax_row, rule):
    """K1's words in numpy float32, min/max with the zero rule `rule`.
    Also returns how many min/max operand pairs were -0 / +0."""
    fmin, fmax = _nan_min_max(rule)
    aabb, rays = aabb.numpy(), rays.numpy()
    n_words = aabb.shape[0] // 32
    lo = aabb[:n_bits, 0:3, None]
    hi = aabb[:n_bits, 3:6, None]
    o = rays[None, 0:3]
    d = rays[3:6]
    tiny = F32(pi.TINY)
    d = np.where(np.abs(d) >= tiny, d, np.where(d < 0, -tiny, tiny))
    with np.errstate(all="ignore"):
        iv = (F32(1) / d.astype(F32))[None]
        t1 = ((lo - o) * iv).astype(F32)
        t2 = ((hi - o) * iv).astype(F32)
    signed = int(((t1 == 0) & (t2 == 0)
                  & (np.signbit(t1) != np.signbit(t2))).sum())
    tn, tx = fmin(t1, t2), fmax(t1, t2)
    near = fmax(fmax(tn[:, 0], tn[:, 1]), tn[:, 2])
    far = fmin(fmin(tx[:, 0], tx[:, 1]), tx[:, 2])
    with np.errstate(invalid="ignore"):
        hit = (near <= far) & (far >= 0)
        if tmax_row:
            hit &= near <= rays[6][None]
    words = np.zeros((n_words, rays.shape[1]), np.int64)
    for b in range(n_bits):
        words[b // 32] |= hit[b].astype(np.int64) << (b % 32)
    words = ((words + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)
    return torch.from_numpy(words), signed


@pytest.mark.parametrize("rule", sorted(ZERO_RULES))
@pytest.mark.parametrize("case", kb.MASK_CASES)
@pytest.mark.parametrize("tmax_row", [False, True])
def test_nan_min_max_zero_sign_keeps_mask_bits(rule, case, tmax_row):
    """K1's words do not depend on which zero a NaN-propagating min or max
    returns for a -0 / +0 pair: they equal the plain version's under every
    rule."""
    aabb, r, n_bits = kb.mask_batch(case, tmax_row)
    want = pi._cluster_masks_plain(aabb, r, n_bits, tmax_row)
    got, signed = _k1_model(aabb, r, n_bits, tmax_row, rule)
    assert torch.equal(got, want)
    assert bool(want.any())
    if case == "signed_zeros":
        assert signed > 0


def test_dead_lane_frame_sorts_dead_last():
    """The uncompacted trace's sorted cast on the CPU (plain K1 and K2, the
    batch the card tests hold the kernels on): sort_exact turns the NaN
    dead lanes into far rays with empty masks, sorts them after every live
    lane, and the sweep gives them misses and the live lanes their hits."""
    from raytracer_odin_tpu_torch.ops import traverse

    scene, o, d, alive, aabb, n_bits, tris = kb.dead_lane_frame()
    rays2, words, perm = traverse.sort_exact(scene, o, d, alive, aabb,
                                             n_bits)
    n, n_alive = o.shape[0], int(alive.sum())
    assert torch.equal(alive[perm], torch.arange(n) < n_alive)
    assert torch.isfinite(rays2).all()
    # one mask word; the bits above n_bits hold the (dead|octant) sort key
    assert words.shape[0] == 1 and n_bits < 27
    bits = words[0] & ((1 << n_bits) - 1)
    assert not bits[n_alive:].any()
    assert (words[0, n_alive:n] >> n_bits == 8).all()  # dead, octant 0
    assert (bits[:n_alive] != 0).float().mean() > 0.5
    counts, lists = traverse.exact_lists(words, n_bits)
    out = pi._culled_plain(counts, lists, rays2, tris)
    assert (out[1, n_alive:] < 0).all()
    assert (out[1, :n_alive] >= 0).float().mean() > 0.5
