"""PyTorch/CUDA port of the JURASSIC EGA forward model.

The package mirrors ``jurassic_tpu``'s module names (``geometry``,
``forward``, ``ops.continua``, ``ops.turbo_fit``, ``ops.ega_fused``,
``cli.formod``) so each port sits beside its reference.  It imports
``torch`` and never ``jax``: the framework-free host modules of
``jurassic_tpu`` (``config``, ``io_tab``, ``tables``, ``constants``,
``ops.planck``, ``models``) are imported, not copied.

The fused EGA radiative-transfer pass runs as a hand-written CUDA kernel
(``csrc/ega_fused_turbo.cu``) on CUDA tensors and as its plain PyTorch
version on CPU tensors.
"""
