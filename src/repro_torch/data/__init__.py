"""Calibration and evaluation data sources (numpy)."""
