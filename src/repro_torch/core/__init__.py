"""MX numerics, transforms and the quantized-linear dispatch."""
