"""The benchmark's plain PyTorch reference: imports neither JAX nor the
measured program."""
