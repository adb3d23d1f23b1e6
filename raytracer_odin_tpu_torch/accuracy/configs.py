"""Shared config table for the accuracy (RMSE) harness (the port's copy
of the JAX package's tools/rmse_common.py).

The BASELINE.json accuracy target is "per-pixel RMSE < 1e-3 vs the CPU
reference at equal spp". Two separable claims are measured per config:

1. **Numerical parity (same seed)**: the card's render and the JAX
   package's CPU render draw identical sample sets (counter-based
   per-pixel RNG, the same addressing in both packages), so their
   difference is pure numerics (ULP divergence on hit decisions between
   the card's K1 + K2 and the CPU's BVH intersector). Full config
   resolution, reduced spp for the heavy configs (equal on both sides).

   Gate: once a single hit decision flips by an ULP, that path and every
   pixel it feeds decorrelate chaotically: the difference between the two
   renders then behaves like *independent* sampling noise, bounded by the
   independent-render floor sqrt(mean((var_card + var_cpu) / spp)). A
   correct pair therefore satisfies same_seed_rmse <= that floor (ratio
   ~1 when most paths diverge, << 1 when few do); a ratio above ~1.2
   would mean systematic bias beyond path decorrelation. A tolerance
   tighter than the floor is unpassable by construction: the floor itself
   is 1e-2..1e-1 at these sample counts, so any ULP divergence anywhere
   would fail it regardless of implementation quality. The converged row
   (claim 2) measures the residual-bias question at high spp.

2. **Distribution agreement vs the independent oracle (converged)**: the
   numpy oracle is an independent implementation with its own sampler;
   means can only agree up to the Monte-Carlo noise floor sqrt(var_a/N_a
   + var_b/N_b). At practical sample counts that floor is >> 1e-3 (e.g.
   ~3e-2 at 1024 spp), so the report states the measured RMSE of means,
   the noise floor, their ratio (~1 means the implementations agree to
   within sampling noise), a z-outlier fraction, and the firefly variance
   ratio. Proxy resolution keeps the single-core oracle tractable.

The references (REF_DIR) are the JAX repo's committed arrays and are only
read; the card's arrays go to OUT_DIR (gitignored).
"""

from __future__ import annotations

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
# The JAX package's CPU renders, the oracle's arrays and the A/A nulls.
REF_DIR = ROOT / "out" / "rmse"
# The card's (or the CPU's, with device="cpu") arrays and report.jsonl.
OUT_DIR = ROOT / "out" / "rmse_card"
# Where load_scene generates the procedural scenes.
SCENE_DIR = OUT_DIR / "scenes"

# name, scene, W, H, depth, cfg_spp, same_seed_spp, proxy (w, h, spp)
CONFIGS = [
    # cfg1/cfg2 oracle spp run deep (cheap scenes: seconds/iter) — at 96 spp
    # the per-pixel variance *estimate* is noisy enough on cornell's heavy
    # firefly tails to inflate the z-scores (frac_z_gt4 read 0.0060 at 96
    # spp); 1024 spp calibrates the floor map properly.
    ("cfg1_cube", "cube", 256, 256, 2, 16, 16, (128, 96, 1024)),
    # Full-resolution independent row (VERDICT r3 item 6): the oracle at
    # cfg1's NATIVE 256x256 — no proxy. Oracle-vs-device only (the same-seed
    # arrays keep the cfg1_cube name).
    ("cfg1_cube_full", "cube", 256, 256, 2, 16, 16, (256, 256, 1024)),
    ("cfg2_cornell", "cornell", 512, 512, 6, 64, 16, (128, 96, 1024)),
    ("cfg3_textured", "textured", 800, 600, 8, 128, 8, (128, 96, 96)),
    ("cfg4_envmap", "envmap", 1024, 768, 8, 256, 8, (128, 96, 96)),
    ("cfg5_demo", "demo", 1920, 1080, 8, 256, 2, (128, 72, 96)),
]

# Card side of the converged comparison (the JAX repo's TPU_PROXY_SPP).
PROXY_SPP = 1024

# Rows whose same-seed half is absent: their arrays keep another row's
# name (cfg1_cube_full's are cfg1_cube's).
NO_SAME_SEED = ("cfg1_cube_full",)

# Rows whose oracle has independent draws (out/rmse/{cfg}_oracle_draws
# {,_b}.npz): their card draws give the report's image-mean test its
# empirical two-sample form.
DRAW_CONFIGS = ("cfg5_demo",)


def row(name: str) -> tuple:
    for r in CONFIGS:
        if r[0] == name:
            return r
    raise KeyError(f"unknown config {name!r}: one of "
                   f"{[r[0] for r in CONFIGS]}")


def reference_files(rows=None, ref_dir=None) -> list:
    """The files of `ref_dir` (REF_DIR) that a run over `rows` (names or
    CONFIGS rows; all of them by default) reads, as (path, required)
    pairs: the CPU same-seed pair and the oracle's mean, variance and spp
    are required; the second oracle draw, the oracle's draw files and the
    A/A null are read where they exist (the report pools or consults
    them)."""
    ref = Path(ref_dir or REF_DIR)
    out = []
    for r in rows if rows is not None else CONFIGS:
        name = r if isinstance(r, str) else r[0]
        row(name)
        if name not in NO_SAME_SEED:
            out += [(ref / f"{name}_cpu_sameseed{s}.npy", True)
                    for s in ("", "_var")]
        out += [(ref / f"{name}_oracle_{s}.npy", True)
                for s in ("mean", "var", "spp")]
        out += [(ref / f"{name}_oracle2_{s}.npy", False)
                for s in ("mean", "var", "spp")]
        out += [(ref / f"{name}_oracle_draws{s}.npz", False)
                for s in ("", "_b")]
        out.append((ref / f"{name}_aa_null.json", False))
    return out


def require_references(rows=None, ref_dir=None) -> list:
    """reference_files that exist; raises FileNotFoundError naming the
    first required one that is missing."""
    have = []
    for path, required in reference_files(rows, ref_dir):
        if path.exists():
            have.append(path)
        elif required:
            raise FileNotFoundError(f"accuracy reference {path} is missing")
    return have


def load_scene(scene_name: str, device="cuda"):
    """(host scene, DeviceScene on `device`) of a procedural scene,
    generated into SCENE_DIR; the env map goes through HostTexture."""
    from raytracer_odin_tpu_torch.io import gltf, images
    from raytracer_odin_tpu_torch.models import assets, build
    from raytracer_odin_tpu_torch.models.scene import HostTexture

    info = assets.generate(scene_name, SCENE_DIR)
    host = gltf.read_gltf(info["gltf"])
    env = None
    if "env" in info:
        li = images.load_image(info["env"])
        env = HostTexture(li.data, li.is_hdr)
    scene = build.finish_scene(host, env_map=env, verbose=False,
                               device=device)
    return host, scene
