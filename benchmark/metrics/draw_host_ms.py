"""Host time a step inside the program's `draw` spans (rt::draw: each call
of utils/prng's uniforms or uniforms_cols, the lanes' PCG4D draws: the
camera jitter and each bounce's six draws a lane), inclusive: the part
recorded inside `step` spans of the window's render_scene call
(RenderResult.phases) over their count. The traced steps open no step
part and are left out. A program without the span reports nothing."""


def read(ctx):
    ph = getattr(ctx.result, "phases", None)
    step = ph.step_spans.get("step") if ph is not None else None
    draw = ph.step_spans.get("draw") if ph is not None else None
    if step is None or not step.calls or draw is None:
        return None
    return 1e3 * draw.total_s / step.calls
