"""ewvit_tpu_torch: the PyTorch/CUDA port of ewvit_tpu for NVIDIA Hopper.

Serves the DeepfakeDetector in its three ablation modes (``dynamic``,
``sfe_only``, ``sfe_mwt``; ``InferenceEngine(mode=...)``, also
``InferenceEngine.from_checkpoint`` on a reference ``.pth``) on hand-written
CUDA kernels (Haar DWT, depthwise+BN+SiLU+SE-mean, the Winograd MWT tail,
DAMA cross-attention; ``csrc/``), evaluates it (``evaluation.evaluate``:
the eval losses and the metric suite), and trains it (``train.steps.
train_step`` with ``train.optimizer.make_optimizer``: gradient accumulation,
per-chunk remat, bf16 autocast; K1 runs in the training forward, K2-K4 are
inference-only as in the JAX package), and runs the training run
(``train.loop.Trainer`` over ``data/``'s datasets and loaders, with
``train.checkpoint``'s checkpoints; ``python -m ewvit_tpu_torch.cli.train``
and ``.cli.eval``), and is measured and studied through ``.cli.test``
(latency), ``.cli.bench`` (frames/s), ``.cli.calculate_gflops``,
``.cli.ablation``, ``.cli.plot_celebdf_roc`` and
``.cli.visualize_feature_maps``; data-parallel over ``torch.distributed``
(``parallel.make_mesh``: ``mesh=`` in the engine, ``evaluate``,
``train_step`` and the ``Trainer``, ``--mesh`` in the CLIs under
``torchrun``). Imports torch and numpy only (cv2 where a
frame is decoded, matplotlib inside a plot), never JAX or the ewvit_tpu
package. Entry points run on the GPU
unless the caller passes ``device="cpu"``.
"""

from ewvit_tpu_torch.configs import ArchConfig, ModelConfig
from ewvit_tpu_torch.evaluation import evaluate, load_model
from ewvit_tpu_torch.models.detector import (
    ABLATION_MODES,
    DeepfakeDetector,
    build_detector,
    video_forward,
)
from ewvit_tpu_torch.serving import InferenceEngine

__all__ = ["ABLATION_MODES", "ArchConfig", "ModelConfig", "DeepfakeDetector",
           "build_detector", "evaluate", "load_model", "video_forward",
           "InferenceEngine"]
