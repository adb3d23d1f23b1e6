# Scene data model (host staging + torch device scene), upload, and the
# procedural scene generators (copied from the JAX package).
