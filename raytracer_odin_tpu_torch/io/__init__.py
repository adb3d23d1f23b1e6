# Host ingest, copied from the JAX package so the port imports none of it:
# gltf, images, png, hdr, jpeg, native.
