"""InstantAvatar in PyTorch for NVIDIA Hopper GPUs.

A port of the JAX package ``instantavatar_tpu`` (which stays the
reference): same module layout, same public layouts (xyz coordinates,
(C, D, H, W) voxels, corner-packed rows with corner = dz*4+dy*2+dx), and
hand-written CUDA for the kernels the JAX package wrote in Pallas
(``kernels/``, sources in ``csrc/``). Every function takes its device from
its inputs or an explicit ``device`` argument; nothing sets a global
default device. Importing this package never imports jax.
"""
