"""Mean host time of one tile's enqueue (rt::tile: a tile's body in
parallel.mesh.ShardedStep), inclusive, over the `tile` spans recorded
inside `step` spans of the window's render_scene call
(RenderResult.phases); the traced steps open no step part and are left
out."""


def read(ctx):
    ph = getattr(ctx.result, "phases", None)
    s = ph.step_spans.get("tile") if ph is not None else None
    if s is None or not s.calls:
        return None
    return 1e3 * s.total_s / s.calls
