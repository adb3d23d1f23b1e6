"""Share of the shading segments in which the shade kernel ran: the
program's `shade_kernel` counter (a `shade` span in which the kernel's
launches grew, eagerly or by a replayed graph) inside `step` spans of the
window's render_scene call (RenderResult.phases), over its `shade` spans
inside them; the traced steps open no step part and are left out. A program
without the kernel (no ops/shade_kernel.py) reports nothing."""

import importlib.util


def read(ctx):
    if importlib.util.find_spec(
            "raytracer_odin_tpu_torch.ops.shade_kernel") is None:
        return None
    ph = getattr(ctx.result, "phases", None)
    step = ph.step_spans.get("step") if ph is not None else None
    shade = ph.step_spans.get("shade") if ph is not None else None
    if step is None or not step.calls or shade is None or not shade.calls:
        return None
    return ph.step_counters.get("shade_kernel", 0) / shade.calls
