"""Deterministic token pipelines."""
