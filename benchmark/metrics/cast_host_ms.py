"""Host time a step inside the program's `cast` spans (rt::cast: each
bounce's traverse.cast_rays / cast_presorted_rows: the lists, the sweep
entry, K1 where the cast computes it), inclusive: the part recorded
inside `step` spans of the window's render_scene call
(RenderResult.phases) over their count. A step that starts under the
profiler opens no step part, so the traced steps are left out."""


def read(ctx):
    ph = getattr(ctx.result, "phases", None)
    step = ph.step_spans.get("step") if ph is not None else None
    if step is None or not step.calls:
        return None
    s = ph.step_spans.get("cast")
    return 1e3 * (s.total_s if s else 0.0) / step.calls
