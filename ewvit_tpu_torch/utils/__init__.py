"""Weight conversion from the JAX package's variables; the metric suite."""
