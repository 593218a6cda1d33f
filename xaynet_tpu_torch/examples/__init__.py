"""The federated training examples on the port, one module each:

    python -m xaynet_tpu_torch.examples.house_prices [--check-loss]
    python -m xaynet_tpu_torch.examples.cifar_lenet [--check-loss]
    python -m xaynet_tpu_torch.examples.shakespeare_lstm [--check-loss]
    python -m xaynet_tpu_torch.examples.lora_federated [--check-loss]

Copies of the JAX package's ``examples/`` on this package's coordinator
(``server``), participant SDK (``sdk``) and models (``models``), with the
same flags and defaults plus ``--device`` (default ``cuda``; ``cpu`` runs
the plain versions). Without a card and without ``--device cpu`` an example
exits non-zero with ``DeviceUnavailable``. Data is synthetic, made from
seeds: nothing is downloaded.
"""
