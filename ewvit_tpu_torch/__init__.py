"""ewvit_tpu_torch: the PyTorch/CUDA port of ewvit_tpu for NVIDIA Hopper.

Serves the ``dynamic`` DeepfakeDetector on hand-written CUDA kernels (Haar
DWT, depthwise+BN+SiLU+SE-mean, DAMA cross-attention; ``csrc/``). Imports
torch and numpy only, never JAX or the ewvit_tpu package. Entry points run on
the GPU unless the caller passes ``device="cpu"``.
"""

from ewvit_tpu_torch.configs import ArchConfig, ModelConfig
from ewvit_tpu_torch.models.detector import (
    DeepfakeDetector,
    build_detector,
    video_forward,
)
from ewvit_tpu_torch.serving import InferenceEngine

__all__ = ["ArchConfig", "ModelConfig", "DeepfakeDetector", "build_detector",
           "video_forward", "InferenceEngine"]
