"""PyTorch/CUDA port of the LATMiX MX serving path.

A second package beside the JAX reference ``repro``: it imports ``torch``
and numpy only, keeps the reference's layouts and names at every public
function, and runs its kernels as hand-written CUDA for Hopper
(``kernels/csrc``). Entry points run on the card unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper takes its plain PyTorch
version.
"""
