"""Resilience: deterministic fault injection for the pipeline."""
