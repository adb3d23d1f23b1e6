"""Live path segments over the lanes the wavefront traced: bounce 0 at
full width, then each bounce's lane budget (one tuple a tile on a mesh;
full width every bounce when uncompacted), a sample a step."""


def read(ctx):
    res = ctx.result
    full = ctx.width * ctx.height_pad
    sched = res.lane_schedule
    if sched is None:
        lanes = full * ctx.ray_depth
    elif sched and isinstance(sched[0], tuple):
        lanes = full + sum(sum(t) for t in sched)
    else:
        lanes = full + sum(sched)
    traced = lanes * ctx.steps * ctx.samples_per_step
    return res.rays_cast / traced if traced else None
