"""Command-line driver (port of raytracer_odin_tpu/cli.py).

Mirrors the reference CLI (main.odin:174-253): positional input scene and
output image, plus --debug --times --continious --threads --width --height
--ray-depth --num-samples --env-map (including the reference's spelling of
"continious"), and the JAX package's additions: --preview-port/
--preview-file/--preview-every (the headless replacements of the SDL2
window, with --debug), --checkpoint/--resume, --layer/--mode output
selection, --oracle (render with the numpy reference implementation),
--seed, --spp-per-step, --intersector, --compact, --converge-se,
--debug-nans, --profile-dir, --devices/--spp-devices (the mesh's shape,
parallel/mesh.py), --pool and --compact refill. The flags, their defaults
and the config resolution are the JAX CLI's.

Run on the card:  python -m raytracer_odin_tpu_torch scene.gltf out.png ...
From Python:      cli.main([...], device="cpu") renders on the CPU.

Devices of the mesh. With device="cuda" the mesh takes the cards:
--devices 0 means every card (torch.cuda.device_count() // --spp-devices
tiles, as the JAX CLI takes every device), and a mesh larger than the
cards there are raises ValueError. With one named device ("cpu",
"cuda:0", ...) the mesh repeats that device: --devices 0 means one tile,
--devices 2 two shards on it (how the CPU tests, and one card, rehearse a
mesh).
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time

import numpy as np

def _layer_arg(v: str) -> int:
    """--layer accepts an index or a registered probe name (ops/probes)."""
    try:
        return int(v)
    except ValueError:
        from raytracer_odin_tpu_torch.ops import probes

        names = probes.layer_names()
        if v in names:
            return names.index(v)
        raise argparse.ArgumentTypeError(
            f"unknown layer {v!r}; known: {', '.join(names)}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytracer_odin_tpu_torch",
        description="Wavefront path tracer on an NVIDIA GPU (PyTorch/CUDA)",
    )
    p.add_argument("input_file", help="Input scene (glTF/GLB)")
    p.add_argument("output_file", nargs="?", default="",
                   help="Output image (.png/.ppm)")
    p.add_argument("--debug", action="store_true",
                   help="Enable debug preview (HTTP + snapshots) and AOV "
                        "layers")
    p.add_argument("--times", type=int, default=0,
                   help="Number of times to render the scene (benchmark "
                        "trials)")
    p.add_argument("--continious", action="store_true",
                   help="Ignore sample limit and render until interrupted")
    p.add_argument("--threads", type=int, default=0,
                   help="Accepted for parity and ignored")
    p.add_argument("--width", type=int, default=0,
                   help="Width of the output image")
    p.add_argument("--height", type=int, default=0,
                   help="Height of the output image")
    p.add_argument("--ray-depth", type=int, default=0,
                   help="Max depth of rays")
    p.add_argument("--num-samples", type=int, default=0,
                   help="Samples per pixel")
    p.add_argument("--env-map", default="", help="Environment map file")
    p.add_argument("--seed", type=int, default=0, help="Render seed")
    p.add_argument("--spp-per-step", type=int, default=0,
                   help="Samples per device step (default: auto)")
    p.add_argument("--devices", type=int, default=0,
                   help="Image-tile devices (default: all)")
    p.add_argument("--spp-devices", type=int, default=1,
                   help="Sample-sharding devices (mesh second axis)")
    p.add_argument("--intersector",
                   choices=["auto", "bvh", "brute", "pallas",
                            "pallas_brute"],
                   default="auto")
    p.add_argument("--pool", action="store_true",
                   help="Persistent wavefront pool (ops/wavefront.py): a "
                        "fixed lane pool over the step's (sample, pixel) "
                        "queue; implies no debug layers")
    p.add_argument("--pool-fraction", type=float, default=0.5)
    p.add_argument("--compact", choices=["auto", "off", "refill"],
                   default="auto",
                   help="Dead-lane scheduling: 'auto' slices the sorted "
                        "wavefront to calibrated per-bounce lane budgets "
                        "(overflow triggers an uncompacted re-render); "
                        "'off' keeps full-width lanes; 'refill' runs the "
                        "cross-sample refill scheduler (ops/refill.py; the "
                        "exact-culled path, no debug layers; the batched "
                        "step elsewhere; overflow triggers an uncompacted "
                        "re-render)")
    p.add_argument("--layer", type=_layer_arg, default=0,
                   help="Output layer: index or probe name (beauty, "
                        "normal, depth, ... - any name registered via "
                        "ops/probes.register); AOV layers need --debug")
    p.add_argument("--mode", default="mean",
                   choices=["mean", "variance", "first", "last", "count",
                            "weight", "hash", "naninf"])
    p.add_argument("--preview-port", type=int, default=0,
                   help="Serve a live HTTP preview on this port of "
                        "127.0.0.1 (with --debug)")
    p.add_argument("--preview-file", default="",
                   help="Write periodic snapshot to this file (with --debug)")
    p.add_argument("--preview-every", type=float, default=2.0,
                   help="Snapshot period in seconds")
    p.add_argument("--converge-se", type=float, default=0.0,
                   help="With --continious: stop when the MEDIAN per-pixel "
                        "standard error of the beauty mean drops below this "
                        "(median, not mean: firefly samples make the mean SE "
                        "non-convergent)")
    p.add_argument("--checkpoint", default="",
                   help="Checkpoint file; saved periodically and on exit")
    p.add_argument("--resume", action="store_true",
                   help="Resume accumulation from --checkpoint")
    p.add_argument("--oracle", action="store_true",
                   help="Render with the independent numpy reference "
                        "implementation")
    p.add_argument("--debug-nans", action="store_true",
                   help="Check every sample's values for NaN; on one, "
                        "re-trace the sample checking live lanes after each "
                        "bounce's cast and shade, and stop with "
                        "FloatingPointError naming the bounce, the stage "
                        "and pixels")
    p.add_argument("--profile-dir", default="",
                   help="Write a torch.profiler Chrome trace into this dir")
    p.add_argument("--quiet", action="store_true")
    return p


def mesh_devices(n_tile: int, n_spp: int, device) -> tuple:
    """The mesh shape (tiles, spp shards) and the devices it is built from,
    for --devices n_tile (0: all) and --spp-devices n_spp on `device` (see
    the module docstring)."""
    import torch

    n_spp = max(1, n_spp)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        n_avail = torch.cuda.device_count()
        n_tile = n_tile or max(1, n_avail // n_spp)
        if n_tile * n_spp == 1:
            return 1, 1, [dev]
        if n_tile * n_spp > n_avail:
            raise ValueError(
                f"--devices {n_tile} x --spp-devices {n_spp} needs "
                f"{n_tile * n_spp} cards; {n_avail} CUDA device(s) found")
        return n_tile, n_spp, [torch.device("cuda", i)
                               for i in range(n_tile * n_spp)]
    n_tile = n_tile or 1
    return n_tile, n_spp, [dev] * (n_tile * n_spp)


def main(argv=None, device="cuda") -> int:
    """Run the CLI on `argv` (sys.argv by default). Everything runs on
    `device`: the card unless the caller asks for "cpu"."""
    args = build_parser().parse_args(argv)
    n_tile, n_spp, mesh_pool = mesh_devices(args.devices, args.spp_devices,
                                            device)
    log = (lambda *a: None) if args.quiet else print

    from raytracer_odin_tpu_torch.config import RenderConfig
    from raytracer_odin_tpu_torch.io import gltf, images, writers
    from raytracer_odin_tpu_torch.models import build as build_mod
    from raytracer_odin_tpu_torch.models.scene import HostTexture
    from raytracer_odin_tpu_torch.render import output

    t0 = time.perf_counter()
    host = gltf.read_gltf(args.input_file)
    log(f"Scene loaded: {host.num_triangles} triangles, "
        f"{len(host.materials)} materials, {len(host.textures)} textures "
        f"({time.perf_counter() - t0:.2f}s)")

    env_tex = None
    if args.env_map:
        li = images.load_image(args.env_map)
        env_tex = HostTexture(li.data, li.is_hdr)

    # Config resolution (defaults applied like main.odin:199-212).
    width = args.width or 512
    height = args.height or 512
    fov_x = host.cam.fov_x
    if args.height:
        fov_x *= width / height
    elif width != height:
        fov_x *= width / height
    depth = args.ray_depth or 8
    samples = args.num_samples or 64

    spp_step = args.spp_per_step
    if spp_step <= 0:
        # Auto: keep device steps short; divide the sample count evenly.
        spp_step = 4
        while samples % spp_step:
            spp_step -= 1
    cfg = RenderConfig(
        width=width, height=height, ray_depth=depth, samples=samples,
        continuous=args.continious, samples_per_step=spp_step,
        seed=args.seed, debug_features=args.debug and not args.pool,
        intersector=args.intersector, wavefront_pool=args.pool,
        pool_fraction=args.pool_fraction, compact=args.compact,
        num_devices=n_tile * n_spp,
    )
    if not 0 <= args.layer < cfg.num_layers:
        # The JAX CLI's indexing clamps an index past the last layer.
        raise ValueError(
            f"--layer {args.layer}: the render has {cfg.num_layers} "
            "layer(s); the AOV layers need --debug")

    scene = build_mod.finish_scene(host, env_map=env_tex,
                                   verbose=not args.quiet, device=device)

    if args.oracle:
        from raytracer_odin_tpu_torch.oracle import cpu_reference as oracle

        t0 = time.perf_counter()
        img = oracle.render(scene, width, height, fov_x, depth, samples,
                            seed=args.seed)
        log(f"Oracle rendered in {time.perf_counter() - t0:.2f}s")
        rgb = output.tone_map_aces(np.maximum(np.nan_to_num(img), 0))
        rgb = np.clip(np.round(rgb ** (1 / 2.2) * 255), 0, 255).astype(
            np.uint8)
        if args.output_file:
            writers.save_image(args.output_file, rgb)
            log(f"Saved {args.output_file}")
        return 0

    from raytracer_odin_tpu_torch.render import (accum, checkpoint, preview,
                                                 runtime)
    from raytracer_odin_tpu_torch.utils import profiling

    initial_stats = None
    initial_samples = 0
    if args.resume and args.checkpoint and checkpoint.exists(args.checkpoint):
        initial_stats, initial_samples, _ = checkpoint.load(
            args.checkpoint, device=device)
        log(f"Resumed {initial_samples} samples from {args.checkpoint}")

    hooks = []
    pv = None
    if args.debug:
        pv = preview.Preview(
            scene.cam_pos.cpu().numpy(), scene.cam_basis.cpu().numpy(),
            fov_x, (width, height), flat_bvh=scene.bvh, scene=scene,
            ray_depth=depth, seed=args.seed, intersector=args.intersector,
        )
        if args.preview_port:
            port = pv.serve(args.preview_port)
            log(f"Preview at http://127.0.0.1:{port}/")
        if args.preview_file:
            hooks.append(preview.SnapshotWriter(
                pv, args.preview_file, args.preview_every,
                layer=args.layer, mode=args.mode,
            ))
        else:
            hooks.append(pv.update)
    ckpt_state = {"last": time.time()}
    if args.checkpoint:
        def ckpt_hook(stats, samples_done):
            now = time.time()
            if now - ckpt_state["last"] > 30:
                ckpt_state["last"] = now
                checkpoint.save(args.checkpoint, stats, samples_done)
        hooks.append(ckpt_hook)

    def on_step(stats, samples_done):
        stats = accum.crop(stats, height, width)
        for h in hooks:
            h(stats, samples_done)

    trials = args.times if args.times > 0 else 1
    step_fn = None
    make_stats = None
    if n_tile * n_spp > 1:
        from raytracer_odin_tpu_torch.parallel import mesh as pmesh

        mesh = pmesh.make_mesh(n_tile=n_tile, n_spp=n_spp,
                               devices=mesh_pool)
        scene = pmesh.replicate_scene(scene, mesh)
        step_fn = pmesh.make_sharded_render_step(cfg, fov_x, mesh, scene)
        # Rows pad to the tile axis internally; the user's resolution is
        # never changed (crop at every readout).
        h_pad = pmesh.padded_height(height, n_tile)

        def make_stats():
            return pmesh.shard_stats(
                accum.init_stats(cfg.num_layers, h_pad, width,
                                 device=mesh.devices[0][0]), mesh)

        if initial_stats is not None:
            initial_stats = pmesh.shard_stats(initial_stats, mesh)
        log(f"Mesh: {n_tile} tile x {n_spp} spp devices"
            + (f" (rows padded {height} -> {h_pad})" if h_pad != height
               else "")
            + ("" if len(mesh.distinct) == n_tile * n_spp else
               f" on {len(mesh.distinct)} device(s)"))
    prof = (profiling.trace(args.profile_dir, device)
            if args.profile_dir else contextlib.nullcontext())
    interrupt = runtime.InterruptFlag().install()
    try:
        with prof:
            res = runtime.render_scene(
                scene, cfg, fov_x, device=device, trials=trials,
                interrupt=interrupt, on_step=on_step if hooks else None,
                step_fn=step_fn, make_stats=make_stats,
                initial_stats=initial_stats, initial_samples=initial_samples,
                verbose=not args.quiet, converge_se=args.converge_se,
                debug_nans=args.debug_nans,
            )
    finally:
        interrupt.uninstall()
        if pv is not None:
            pv.stop()
    res.stats = accum.crop(res.stats, height, width)
    if not args.quiet and res.trial_seconds:
        # Measured path segments (dead lanes not credited), not
        # depth * pixels.
        mrays = res.rays_cast / max(sum(res.trial_seconds), 1e-9) / 1e6
        print(f"Throughput: {mrays:.2f} Mrays/s "
              f"({res.rays_cast / 1e6:.1f}M rays cast)")
    if not args.quiet:
        print(res.phases.report())

    if args.checkpoint:
        checkpoint.save(args.checkpoint, res.stats, res.samples_done)
        log(f"Checkpoint saved to {args.checkpoint}")

    if args.output_file:
        img = output.layer_to_rgb(res.stats, args.layer, args.mode)
        writers.save_image(args.output_file, img)
        log(f"Saved {args.output_file} ({res.samples_done} spp)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
