"""Host time a step inside the program's `light` spans (rt::light: the
culled light pdf, light_cull.light_pdf_sum_culled: the block bounds, the
cluster cull, the lists and K5, inside each bounce's shade), inclusive:
the part recorded inside `step` spans of the window's render_scene call
(RenderResult.phases) over their count. The traced steps open no step
part and are left out. A program without the span reports nothing."""


def read(ctx):
    ph = getattr(ctx.result, "phases", None)
    step = ph.step_spans.get("step") if ph is not None else None
    light = ph.step_spans.get("light") if ph is not None else None
    if step is None or not step.calls or light is None:
        return None
    return 1e3 * light.total_s / step.calls
