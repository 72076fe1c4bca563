"""Hopper kernels of the serving path (``csrc/``), their plain PyTorch
versions (``ref``), the byte layouts (``packing``) and the public wrappers
(``ops``)."""
