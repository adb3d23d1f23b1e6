"""Host time of the program's scene ingest over the whole run: the
process's tally of rt::gltf_read (io.gltf.read_gltf), rt::scene_build
(models.build.finish_scene: lights, BVH, kernel layouts, upload) and
rt::replicate (parallel.mesh.replicate_scene: the copies to the other
cards)."""

SPANS = ("gltf_read", "scene_build", "replicate")


def read(ctx):
    from raytracer_odin_tpu_torch.utils import profiling

    tally = getattr(profiling, "PROCESS", None)
    if tally is None:
        return None
    return sum(tally.spans[k].total_s for k in SPANS if k in tally.spans)
