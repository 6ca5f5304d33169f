"""The benchmark of ewvit_tpu_torch on one NVIDIA GPU (``run.py``)."""
