"""Command-line tools of the port, copies of the JAX package's ``tools/``
on this package:

    python -m xaynet_tpu_torch.tools.sim_check [--combos N] [--seed S] [--json]
    python -m xaynet_tpu_torch.tools.loadgen_soak [--identity] [--legacy-control N]

Each runs on ``--device`` (default ``cuda``; ``cpu`` runs the plain
versions) and neither touches JAX's environment variables.
"""
