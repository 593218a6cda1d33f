"""Coordinator runtime on the port: state machine, services, REST API,
settings, metrics, and the aggregation seam onto the device.

The port's copy of ``xaynet_tpu/server`` for one tenant (``runner.serve``);
the round's fold and unmask run on CUDA (``aggregation.StagedAggregator``).
"""
