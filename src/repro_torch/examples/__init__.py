"""The user-facing examples in the port (``examples/`` of the JAX
package); each runs as ``python -m repro_torch.examples.<name>``."""
