"""The light lists K5 is handed, bounce by bounce, in a benchmark cell's
render on the card.

Builds the cell's scene as the benchmark does (its generator under
benchmark/scenes/, the port's glTF ingest and scene build), renders
`--steps` steps of 1 spp at the cell's size through render_scene, and
keeps the counts of every list that light_cull.light_lists builds. In a
step after the first, the k-th light pdf call is bounce k. Prints, and
writes to chiprun_out/light_list_census_<cell>.json, for each bounce: the
lanes, the 512-ray blocks, the share of lists past the cap (count -1),
the mean clusters a list with -1 counted as every cluster (what the
benchmark's light_list_clusters_mean reads), and the mean of the lists
within the cap.

    python3 tools/light_list_census.py [--workload city24night_1080p.preview]
        [--steps 4] [--device cuda]

On the CPU, rehearse at a small size: --device cpu --width 64 --height 32
--blocks 3, with RT_TPU_LIGHT_CULL_MIN=64 and RT_TPU_STREAM_TRIS=1 in the
environment (the cell's own RT_TPU_* overrides are set over it).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def census(calls: list, n_clusters: int) -> list:
    """calls: a step's (lanes, counts) in call order -> one dict a
    bounce."""
    out = []
    for bounce, (lanes, counts) in enumerate(calls):
        over = counts < 0
        swept = counts.clamp(min=0).sum() + n_clusters * over.sum()
        within = counts[~over]
        out.append({
            "bounce": bounce, "lanes": lanes, "blocks": counts.numel(),
            "overflow_share": float(over.float().mean()),
            "clusters_mean": float(swept) / max(counts.numel(), 1),
            "within_cap_mean": float(within.float().mean())
            if within.numel() else None})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", default="city24night_1080p.preview")
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--device", default="cuda")
    p.add_argument("--width", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--blocks", type=int)
    args = p.parse_args(argv)

    import torch

    from benchmark import run
    from raytracer_odin_tpu_torch.config import RenderConfig
    from raytracer_odin_tpu_torch.io import gltf
    from raytracer_odin_tpu_torch.models import build
    from raytracer_odin_tpu_torch.ops import light_cull
    from raytracer_odin_tpu_torch.render import runtime

    cell = run.load_cell(args.workload)
    os.environ.update({k: str(v) for k, v in
                       cell.settings.get("env", {}).items()})
    conf = dict(cell.config, scene=dict(cell.config["scene"]))
    for k in ("width", "height"):
        conf[k] = getattr(args, k) or conf[k]
    if args.blocks:
        conf["scene"]["blocks"] = args.blocks
    dev = torch.device(args.device)
    with tempfile.TemporaryDirectory(prefix="rt_census_") as tmp:
        spec = dict(conf["scene"])
        path = Path(tmp) / "scene.gltf"
        run.load_module(cell.bench_dir / "scenes"
                        / f"{spec.pop('generator')}.py").write(path, **spec)
        host = gltf.read_gltf(path)
    scene = build.finish_scene(host, device=dev)
    n_clusters = scene.light_rows.shape[0] // light_cull.LEAF_L
    calls, steps = [], []
    lists = light_cull.light_lists

    def kept(scene, o, d, cap=light_cull.LIST_CAP):
        out = lists(scene, o, d, cap)
        calls.append((int(out[3]), out[0].cpu()))
        return out

    def on_step(stats, samples_done):
        steps.append(list(calls))
        calls.clear()

    light_cull.light_lists = kept
    cfg = RenderConfig(
        width=conf["width"], height=conf["height"],
        ray_depth=conf["ray_depth"], samples=args.steps,
        samples_per_step=1, seed=args.seed,
        intersector=conf["intersector"], compact=conf["compact"])
    runtime.render_scene(scene, cfg, host.cam.fov_x * cfg.width / cfg.height,
                         device=dev, on_step=on_step)
    light_cull.light_lists = lists
    per_step = [census(s, n_clusters) for s in steps[1:]]
    result = {"workload": args.workload, "device": str(dev),
              "kind": torch.cuda.get_device_name(dev)
              if dev.type == "cuda" else "cpu",
              "lights": int(scene.light_p.shape[0]),
              "clusters": n_clusters, "cap": light_cull.LIST_CAP,
              "steps": per_step}
    for s, rows in enumerate(per_step, 2):
        for r in rows:
            print(f"step {s} bounce {r['bounce']}: {r['lanes']} lanes, "
                  f"{r['blocks']} lists, overflow {r['overflow_share']:.4f}, "
                  f"clusters a list {r['clusters_mean']:.2f}, within the "
                  f"cap {r['within_cap_mean']}", flush=True)
    out = ROOT / "chiprun_out" / f"light_list_census_{args.workload}.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
