# Frozen copy of chip_smoke.py's K1 work count (measure_k1) at commit
# 6dc2ca8.
"""K1, the exact per-ray cluster masks: a slab test of every ray against
every real cluster box."""

MODULE = "raytracer_odin_tpu_torch.ops.pallas_intersect"
# fp32 operations a ray-box slab test: per axis 2 sub, 2 mul, 1 min, 1 max;
# near/far 2 max + 2 min; 2 compares; one more compare with the tmax row.
OPS_PER_TEST = 24
TMAX_OPS_PER_TEST = 25


def capture(args, kwargs):
    """cluster_masks_rows(aabb8 [S_pad, 8], rays [8, Npad], n_clusters=None,
    tmax_row=False) -> words [S_pad // 32, Npad] int32."""
    aabb8, rays = args[0], args[1]
    n_clusters = args[2] if len(args) > 2 else kwargs.get("n_clusters")
    tmax = bool(args[3] if len(args) > 3 else kwargs.get("tmax_row", False))
    n = rays.shape[1]
    s_pad = aabb8.shape[0]
    n_bits = s_pad if n_clusters is None else int(n_clusters)
    # only the n_bits real boxes need a test: pad boxes' bits are cleared
    nbytes = (7 if tmax else 6) * 4 * n + n_bits * 8 * 4 + s_pad // 32 * 4 * n
    per_test = TMAX_OPS_PER_TEST if tmax else OPS_PER_TEST
    return {"ops": per_test * n * n_bits + 3 * n, "bytes": nbytes}
