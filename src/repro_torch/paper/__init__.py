"""The paper's experiments in the port (``benchmarks/`` of the JAX package:
Fig. 2, Tables 1–3 and 8/9/12); ``python -m repro_torch.paper.run``."""
