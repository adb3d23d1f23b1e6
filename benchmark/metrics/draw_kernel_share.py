"""Share of the draw calls that the draw kernel served: the program's
`draw_kernel` counter (one a launch of ops/prng_kernel.py's kernel: a call
of utils/prng's uniforms or uniforms_cols on the card) inside `step` spans
of the window's render_scene call (RenderResult.phases), over its `draw`
spans (each such call) inside them; the traced steps open no step part and
are left out. A program without the kernel (no ops/prng_kernel.py) reports
nothing."""

import importlib.util


def read(ctx):
    if importlib.util.find_spec(
            "raytracer_odin_tpu_torch.ops.prng_kernel") is None:
        return None
    ph = getattr(ctx.result, "phases", None)
    step = ph.step_spans.get("step") if ph is not None else None
    draw = ph.step_spans.get("draw") if ph is not None else None
    if step is None or not step.calls or draw is None or not draw.calls:
        return None
    return ph.step_counters.get("draw_kernel", 0) / draw.calls
