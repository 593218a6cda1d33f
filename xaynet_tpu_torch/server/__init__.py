"""Coordinator-side aggregation strategy on the port's device path."""
