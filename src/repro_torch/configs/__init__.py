"""Copies of the reference's config dataclasses (plain Python, no jax)."""
