"""Host time of the program's lane-budget calibration over the whole run
(rt::calibrate: runtime._calibration_counts, one uncompacted sample of
the frame or of a tile, read back): the process's tally, which holds the
warm-up's, the window's and a mesh's per-tile calibrations."""


def read(ctx):
    from raytracer_odin_tpu_torch.utils import profiling

    tally = getattr(profiling, "PROCESS", None)
    if tally is None:
        return None
    s = tally.spans.get("calibrate")
    return s.total_s if s else 0.0
