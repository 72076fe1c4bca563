"""Serving engine of the port (continuous scheduler, paged MX KV cache)."""
