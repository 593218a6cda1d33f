"""Coordinator runtime on the port: state machine, services, REST API,
settings, metrics, and the aggregation seam onto the device.

The port's copy of ``xaynet_tpu/server`` (``runner.serve``; with
``[tenancy] enabled``, ``runner.serve_tenants`` serves several tenants on
one device); the rounds' folds and unmasks run on CUDA
(``aggregation.StagedAggregator``).
"""
