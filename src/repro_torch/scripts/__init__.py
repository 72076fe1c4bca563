"""The CI smokes in the port (``scripts/chaos_smoke.py``,
``server_smoke.py`` and ``artifact_report.py`` of the JAX package); each
runs as ``python -m repro_torch.scripts.<name>``."""
