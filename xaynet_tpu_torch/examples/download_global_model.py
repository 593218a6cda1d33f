"""Fetch the latest global model from a running coordinator.

Port of ``examples/download_global_model.py`` (the analogue of the
reference's download_global_model.py example), on this package's
participant client. It reaches no device.

Run:  python -m xaynet_tpu_torch.examples.download_global_model http://localhost:8081
      [--out model.f64]   # also write the model's float64 bytes
"""

from __future__ import annotations

import argparse
import asyncio
import sys
from typing import Optional

import numpy as np

from ..sdk.client import HttpClient


async def fetch(url: str) -> Optional[np.ndarray]:
    """The coordinator's latest global model (float64), or None (204)."""
    client = HttpClient(url, keep_alive=False)
    try:
        model = await client.get_model()
    finally:
        client.close()
    return None if model is None else np.asarray(model, dtype=np.float64)


def main(argv=None) -> Optional[np.ndarray]:
    """Prints the model's size and norm; returns the model (None when the
    coordinator has none yet)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("url", nargs="?", default="http://localhost:8081")
    ap.add_argument("--out", default=None, help="write the model's float64 bytes here")
    args = ap.parse_args(argv)
    model = asyncio.run(fetch(args.url))
    if model is None:
        print("no global model available yet (204)")
        return None
    print(f"global model: {model.shape[0]} parameters, "
          f"norm {float((model ** 2).sum()) ** 0.5:.4f}")  # fmt: skip
    if args.out:
        with open(args.out, "wb") as f:
            f.write(model.tobytes())
    return model


if __name__ == "__main__":
    main()
    sys.exit(0)
