"""Combine the card's halves (OUT_DIR) with the JAX package's CPU renders
and the oracle's arrays (REF_DIR) into the accuracy report (the port's
copy of the JAX repo's tools/rmse_report.py, every statistic, gate and
threshold unchanged; where a key names the device it says "card").

Writes OUT_DIR/report.jsonl (one line per config) and prints it. See
configs.py for what each column means and why the oracle comparison is
judged against the Monte-Carlo noise floor.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from raytracer_odin_tpu_torch.accuracy import configs


def _same_seed(rec, out, ref, name, ss_spp):
    """The same-seed half: out's card arrays against ref's CPU arrays."""
    t = out / f"{name}_card_sameseed.npy"
    c = ref / f"{name}_cpu_sameseed.npy"
    if not (t.exists() and c.exists()):
        return
    a = np.load(t).astype(np.float64)
    b = np.load(c).astype(np.float64)
    d2 = (a - b) ** 2
    rec["same_seed_spp"] = ss_spp
    rec["same_seed_rmse"] = float(np.sqrt(d2.mean()))
    rec["same_seed_p99_abs"] = float(np.percentile(np.abs(a - b), 99))
    rec["same_seed_frac_gt_1e3"] = float((np.abs(a - b) > 1e-3).mean())
    # Gate (see configs.py): a flipped hit decision decorrelates that path
    # like an independent draw, so the difference is bounded by the
    # independent-render noise floor; a ratio above ~1.2 would indicate
    # systematic bias beyond path divergence.
    tv = out / f"{name}_card_sameseed_var.npy"
    cv = ref / f"{name}_cpu_sameseed_var.npy"
    if not (tv.exists() and cv.exists()):
        return
    var_t = np.load(tv).astype(np.float64)
    var_c = np.load(cv).astype(np.float64)
    indep_floor = float(np.sqrt(((var_t + var_c) / ss_spp).mean()))
    rec["same_seed_indep_floor"] = indep_floor
    rec["same_seed_over_indep_floor"] = round(
        rec["same_seed_rmse"] / max(indep_floor, 1e-12), 3)
    # Mean-shift z: the image-wide mean of (a - b) averages the per-pixel
    # noise down by sqrt(Npix), so a systematic energy bias far smaller
    # than the per-pixel floor is still many sigma here. This is the test
    # that catches a brightness bias hiding under a large per-pixel floor.
    mean_se = indep_floor / np.sqrt(d2.size)
    rec["same_seed_mean_shift"] = float((a - b).mean())
    rec["same_seed_mean_shift_z"] = round(
        float((a - b).mean() / max(mean_se, 1e-12)), 1)
    rec["same_seed_pass"] = bool(
        rec["same_seed_over_indep_floor"] < 1.2
        and abs(rec["same_seed_mean_shift_z"]) < 6.0)


def _pool_side(primary_im, primary_spp, draw_files):
    """Equal-footing empirical noise of one side: its image mean pooled
    over the primary render and every draw, and c = Var[draw mean] * spp
    from the draws (None under 4 draws)."""
    ims, spps = [primary_im], [float(primary_spp)]
    c_num = c_dof = 0.0
    for f in draw_files:
        if not f.exists():
            continue
        dz = np.load(f)
        im = dz["means"].astype(np.float64).mean(axis=(1, 2, 3))
        ch = float(dz["chunk"])
        if len(im) >= 4:
            c_num += im.var(ddof=1) * ch * (len(im) - 1)
            c_dof += len(im) - 1
        ims.extend(im)
        spps.extend([ch] * len(im))
    w = np.asarray(spps)
    pooled_im = float((w * np.asarray(ims)).sum() / w.sum())
    c_hat = c_num / c_dof if c_dof else None
    return pooled_im, float(w.sum()), c_hat


def _converged(rec, out, ref, name, proxy):
    """The converged row; returns False where the shapes are stale (the
    row is then reported without a comparison)."""
    om = ref / f"{name}_oracle_mean.npy"
    tm = out / f"{name}_card_proxy_mean.npy"
    if not (om.exists() and tm.exists()):
        return True
    o_mean = np.load(om).astype(np.float64)
    o_var = np.load(ref / f"{name}_oracle_var.npy").astype(np.float64)
    o_spp = int(np.load(ref / f"{name}_oracle_spp.npy"))
    # Second independent oracle draw: pool the means AND measure the
    # image-mean noise empirically (|mean(o1-o2)|/sqrt(2) is an
    # assumption-free draw of the per-run sigma; the variance-map floor
    # understates image-mean noise for skewed estimators).
    emp_mean_se = None
    o2m = ref / f"{name}_oracle2_mean.npy"
    if o2m.exists():
        o2_mean = np.load(o2m).astype(np.float64)
        o2_var = np.load(ref / f"{name}_oracle2_var.npy").astype(np.float64)
        o2_spp = int(np.load(ref / f"{name}_oracle2_spp.npy"))
        if o2_mean.shape == o_mean.shape:
            rec["oracle_two_draws"] = {
                "spp": [o_spp, o2_spp],
                "true_null_mean_diff": float((o_mean - o2_mean).mean()),
            }
            emp_mean_se = float(abs((o_mean - o2_mean).mean()) / np.sqrt(2.0))
            w1, w2 = o_spp, o2_spp
            o_mean = (w1 * o_mean + w2 * o2_mean) / (w1 + w2)
            o_var = (w1 * o_var + w2 * o2_var) / (w1 + w2)
            o_spp = w1 + w2
    t_mean = np.load(tm).astype(np.float64)
    t_var = np.load(out / f"{name}_card_proxy_var.npy").astype(np.float64)
    if t_mean.shape != o_mean.shape:
        # One side is stale (e.g. rendered before a proxy-resolution
        # bump): no comparison rather than a wrong one.
        rec["oracle_stale_shapes"] = (
            f"card {t_mean.shape} vs oracle {o_mean.shape}")
        return False
    diff = t_mean - o_mean
    rmse = float(np.sqrt((diff**2).mean()))
    # Monte-Carlo noise floor of the comparison itself.
    floor_map = np.sqrt(o_var / o_spp + t_var / configs.PROXY_SPP)
    floor = float(np.sqrt((floor_map**2).mean()))
    z = diff / np.maximum(floor_map, 1e-9)
    pw, ph, _pspp = proxy
    rec["oracle_proxy"] = f"{pw}x{ph}"
    rec["oracle_spp"] = o_spp
    rec["card_proxy_spp"] = configs.PROXY_SPP
    rec["converged_rmse"] = rmse
    rec["noise_floor_rmse"] = floor
    rec["rmse_over_floor"] = round(rmse / max(floor, 1e-12), 3)
    rec["frac_z_gt4"] = float((np.abs(z) > 4).mean())
    # Image-wide energy-bias test. Denominator: the claimed floor, widened
    # to the empirically measured per-draw image-mean sigma when two
    # independent oracle draws exist.
    mean_se = floor / np.sqrt(diff.size)
    if emp_mean_se is not None:
        rec["oracle_mean_se_claimed"] = float(mean_se)
        rec["oracle_mean_se_empirical"] = emp_mean_se
        mean_se = max(mean_se, emp_mean_se)
    rec["oracle_mean_shift_z"] = round(
        float(diff.mean() / max(mean_se, 1e-12)), 1)
    # Equal-footing empirical z: K independent draws a side measure each
    # implementation's true image-mean draw noise (c = Var[draw mean] *
    # spp is exact at any spp), so se(side) = sqrt(c_pooled / spp_total)
    # with the image mean pooled over the primary render and every draw.
    # The per-pixel maps stay primary-only; only the image-mean test pools.
    o_im, o_spp_t, c_o = _pool_side(
        float(o_mean.mean()), o_spp,
        [ref / f"{name}_oracle_draws.npz",
         ref / f"{name}_oracle_draws_b.npz"])
    t_im, t_spp_t, c_t = _pool_side(
        float(t_mean.mean()), configs.PROXY_SPP,
        [out / f"{name}_card_draws.npz"])
    z_emp = None
    if c_o is not None and c_t is not None:
        se_o = np.sqrt(c_o / o_spp_t)
        se_t = np.sqrt(c_t / t_spp_t)
        z_emp = float((t_im - o_im) / max(np.sqrt(se_o**2 + se_t**2), 1e-12))
        rec["oracle_emp"] = {
            "oracle_spp_pooled": o_spp_t,
            "card_spp_pooled": t_spp_t,
            "se_oracle": float(se_o),
            "se_card": float(se_t),
            "mean_diff": float(t_im - o_im),
            "mean_shift_z_emp": round(z_emp, 2),
        }
    # Firefly check: does the device path carry extra variance?
    lum_t = t_var.mean(-1)
    lum_o = o_var.mean(-1)
    rec["variance_ratio_card_over_oracle"] = float(
        lum_t.mean() / max(lum_o.mean(), 1e-12))
    # Gate thresholds. On scenes with mirror-metallic fireflies the
    # low-spp side's image mean is heavily right-skewed, so |z| of several
    # sigma arises with zero true difference. Where an A/A null
    # distribution has been rendered at a matching reference spp, the gate
    # widens to 1.3x the null's envelope. The envelope only ever widens
    # these limits and is consulted only as a fallback: a row that passes
    # the strict default limits has passed a sufficient test.
    z_lim, fr_lim, fz_lim = 6.0, 1.5, 0.005
    needs_envelope = not (
        abs(rec["oracle_mean_shift_z"]) < z_lim
        and rec["rmse_over_floor"] < fr_lim
        and rec["frac_z_gt4"] < fz_lim)
    nf = ref / f"{name}_aa_null.json"
    if nf.exists() and needs_envelope:
        null = json.loads(nf.read_text())
        ratio = null["low_spp"] / max(o_spp, 1)
        if 1 / 1.5 <= ratio <= 1.5:
            z_lim = max(z_lim, 1.3 * max(
                abs(z_) for z_ in null["mean_shift_z"]))
            fr_lim = max(fr_lim, 1.15 * max(null["rmse_over_floor"]))
            fz_lim = max(fz_lim, 1.5 * max(null["frac_z_gt4"]))
            rec["aa_null"] = {
                "n": null["n"], "low_spp": null["low_spp"],
                "z_max": max(abs(z_) for z_ in null["mean_shift_z"]),
                "z_limit": round(z_lim, 1),
            }
        else:
            rec["aa_null_stale"] = (
                f"null at {null['low_spp']} spp vs oracle {o_spp}")
    # Agreement verdict: means indistinguishable from sampling noise,
    # per-pixel (rmse/floor, z outliers) AND image-wide. The image-wide
    # test is the equal-footing empirical z (< 3) when both sides have
    # measured draw noise; otherwise the claimed-SE z under the
    # A/A-calibrated skew envelope.
    if z_emp is not None:
        mean_test = abs(z_emp) < 3.0
        rec["mean_test"] = "empirical_two_sample"
    else:
        mean_test = abs(rec["oracle_mean_shift_z"]) < z_lim
        rec["mean_test"] = "claimed_se_aa_envelope"
    rec["distribution_agrees"] = bool(
        rec["rmse_over_floor"] < fr_lim
        and rec["frac_z_gt4"] < fz_lim
        and mean_test)
    return True


def report(out_dir=None, ref_dir=None, rows=None, device="cpu",
           log=print) -> list:
    """One record per config of `rows` (CONFIGS by default): the same-seed
    half against the JAX package's CPU render, the converged half against
    the oracle; `device` (the card's name and power limit, or "cpu") is
    written into each. Writes out_dir/report.jsonl and logs each line."""
    out = Path(out_dir or configs.OUT_DIR)
    ref = Path(ref_dir or configs.REF_DIR)
    lines = []
    for name, _scene, w, h, depth, cfg_spp, ss_spp, proxy in (
            rows if rows is not None else configs.CONFIGS):
        rec = {"config": name, "resolution": f"{w}x{h}", "depth": depth,
               "config_spp": cfg_spp, "device": device}
        _same_seed(rec, out, ref, name, ss_spp)
        _converged(rec, out, ref, name, proxy)
        lines.append(rec)
    rp = out / "report.jsonl"
    with open(rp, "w") as f:
        for rec in lines:
            f.write(json.dumps(rec) + "\n")
            log(json.dumps(rec))
    log(f"wrote {rp}")
    return lines


def failures(records) -> list:
    """(config, gate) of every gate a record fails or lacks: same_seed_pass
    where the row has a same-seed half, and distribution_agrees on every
    row."""
    bad = []
    for rec in records:
        name = rec["config"]
        if (name not in configs.NO_SAME_SEED
                and rec.get("same_seed_pass") is not True):
            bad.append((name, "same_seed_pass"))
        if rec.get("distribution_agrees") is not True:
            bad.append((name, "distribution_agrees"))
    return bad
