"""PyTorch/CUDA port of xaynet-tpu.

The coordinator (``server``: REST API, phase machine, ``python -m
xaynet_tpu_torch.server.runner``) and one PET round's device work — the
Update fold, the Sum2 mask derive+fold and the Unmask subtract — on an
NVIDIA H100, with the device kernels written by hand in CUDA C++
(``csrc/``). The layout mirrors the JAX package (``core``, ``ops``,
``parallel``, ``resilience``, ``server``, ``storage``, ``telemetry``,
``tenancy``) so
each module's counterpart is found at the same path; this package imports
``torch`` and numpy only and keeps its own copy of every host module it
needs.

Entry points run on ``cuda`` unless the caller passes a CPU device
(``device.resolve_device``); asking for CUDA where there is none raises.
"""
