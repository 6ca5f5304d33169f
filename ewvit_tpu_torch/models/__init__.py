"""Model modules of the port (NCHW, reference torch names)."""
