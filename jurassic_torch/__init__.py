"""PyTorch/CUDA port of the JURASSIC EGA forward model.

The package mirrors ``jurassic_tpu``'s module names (``config``,
``io_tab``, ``tables``, ``geometry``, ``forward``, ``ops.continua``,
``ops.turbo_fit``, ``ops.ega_fused``, ``cli.formod``, ...) so each port
sits beside its reference.  It imports ``torch`` and never ``jax``, and
nothing of ``jurassic_tpu``: the NumPy host modules (control files,
table and observation I/O, the synthetic workloads) are its own copies.

The fused EGA radiative-transfer pass runs as hand-written CUDA kernels
(``csrc/ega_fused_turbo.cu``, ``csrc/ega_fused_table.cu``) on CUDA
tensors and as their plain PyTorch versions on CPU tensors;
``tools.peak`` measures the card's FP32, special-function and memory
rates with CUDA probes (``csrc/peak_probes.cu``).
"""
