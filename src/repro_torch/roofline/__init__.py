"""Roofline analysis of the port."""
