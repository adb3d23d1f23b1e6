"""Host syncs a step: the program's `host_syncs` counter (every site on
the render path where the host waits for the card) as counted inside
`step` spans of the window's render_scene call (RenderResult.phases),
over their count; the traced steps open no step part and are left out."""


def read(ctx):
    ph = getattr(ctx.result, "phases", None)
    step = ph.step_spans.get("step") if ph is not None else None
    if step is None or not step.calls:
        return None
    return ph.step_counters.get("host_syncs", 0) / step.calls
