"""Multi-device rendering (port of raytracer_odin_tpu/parallel)."""
