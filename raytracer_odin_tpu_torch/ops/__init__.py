# Device ops: geometry, BVH permutation, culling glue, the CUDA intersection
# kernels and their plain versions, texture sampling, shading, integrator.
