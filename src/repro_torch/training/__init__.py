"""The optimizer of the transform-learning stage."""
