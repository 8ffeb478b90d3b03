"""Step functions of the transformer zoo (train, prefill and decode)."""
