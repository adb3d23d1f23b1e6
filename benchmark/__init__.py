"""The benchmark of raytracer_odin_tpu_torch (see run.py)."""
