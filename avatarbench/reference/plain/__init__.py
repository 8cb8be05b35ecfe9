"""The plain reference: a frozen copy of the plain PyTorch modules of
``instantavatar_torch`` that a training step and a flat frame run through
(body, Fast-SNARF, the density grid, the marcher, compositing, the
fields, the losses, Adam, the training batch assembly), cut to those
paths and kept here so that the program may change and this may not.

What differs from the program: everything runs eagerly (no CUDA graph,
no session, no budget: a frame keeps every sample it selects), the hash
encode is its plain gather-and-lerp on every device, the field head is
its plain version (bf16 operands, fp32 sums), and the matmul operands'
precision can be lowered for the control (``precision.lowered``).
Nothing here imports the program, JAX or the JAX package; the tests hold
that.
"""
