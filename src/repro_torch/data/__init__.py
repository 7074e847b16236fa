"""Synthetic data pipelines (port of ``repro/data``)."""
