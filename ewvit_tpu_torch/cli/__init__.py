"""Command-line entry points of the port: ``python -m ewvit_tpu_torch.cli.train``
and ``python -m ewvit_tpu_torch.cli.eval`` (the root ``train.py`` and
``eval.py`` of the JAX package)."""
