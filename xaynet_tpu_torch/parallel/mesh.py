"""Device meshes for the aggregation buffers.

Port of ``xaynet_tpu/parallel/mesh.py`` over ``torch.device`` lists. The
aggregation buffer ``uint32[L, padded_len]`` is split over the model-length
axis of a 1-D mesh: each mesh entry owns a contiguous column slice, and
modular aggregation and unmasking are elementwise over that axis, so the
shards fold with no collective at all.

A mesh is a tuple of devices. By default it holds every visible CUDA
device, as the JAX package's ``make_mesh()`` takes ``jax.devices()``. A mesh
may name one device more than once (``[cuda:0] * 4``, ``[cpu] * 8``): each
entry is still a shard of its own, with its own accumulator and stream, so
the N-shard path runs on one card, and on the CPU, which torch exposes as
one device. The coordinator never builds such a mesh on its own.
"""

from __future__ import annotations

import torch

from ..device import DeviceUnavailable

MODEL_AXIS = "model"


def make_mesh(devices=None) -> tuple[torch.device, ...]:
    """A 1-D mesh over every visible CUDA device, or over ``devices``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                "make_mesh() spans the visible CUDA devices and there is no CUDA "
                "device; pass devices (e.g. [torch.device('cpu')] * 2) to mesh others"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    if any(d.type == "cuda" for d in mesh) and not torch.cuda.is_available():
        raise DeviceUnavailable("a mesh names a CUDA device and there is no CUDA device")
    # cuda without an index is the current device: named, so shards compare
    return tuple(
        torch.device("cuda", torch.cuda.current_device() if d.index is None else d.index)
        if d.type == "cuda" else d
        for d in mesh
    )


def serve_mesh(device: torch.device) -> tuple[torch.device, ...]:
    """The mesh a coordinator folds on: every visible card for ``cuda``
    without an index (the default), else the one device named (``cuda:1``,
    ``cpu``). It never repeats a device."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return make_mesh()
    return make_mesh([device])


def pad_to_multiple(n: int, k: int) -> int:
    """Model length padded so every shard holds an equal slice."""
    return -(-n // k) * k


def shard_slices(padded_len: int, n_dev: int) -> list[tuple[int, int]]:
    """The contiguous model-axis column slice ``[lo, hi)`` each mesh entry
    owns, in mesh order. ``padded_len`` must already be a multiple of
    ``n_dev`` (``pad_to_multiple`` guarantees it), so the slices are
    equal-width and shard d's slice of a serialized wire block is
    element-aligned."""
    if padded_len % n_dev:
        raise ValueError("padded length must divide evenly across devices")
    width = padded_len // n_dev
    return [(d * width, (d + 1) * width) for d in range(n_dev)]
