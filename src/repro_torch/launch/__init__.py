"""Serving step functions of the transformer zoo (prefill and decode)."""
