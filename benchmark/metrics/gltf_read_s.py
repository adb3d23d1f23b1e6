"""Host time of the program's glTF ingest over the whole run: the
process's tally of rt::gltf_read (io.gltf.read_gltf: the file's parse,
each primitive's world-space triangles, their arrays joined once), the
part of scene_build_s that grows with the scene's primitives."""


def read(ctx):
    from raytracer_odin_tpu_torch.utils import profiling

    tally = getattr(profiling, "PROCESS", None)
    s = tally.spans.get("gltf_read") if tally is not None else None
    return s.total_s if s else None
