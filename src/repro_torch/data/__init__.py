"""Datasets of the port (numpy only)."""
