"""Host data pipeline (ewvit_tpu/data): dataset manifests with the FF++
curriculum, frame transforms, the native frame decoder, the batch loader and
the CUDA prefetcher. numpy and cv2 (imported where a frame is decoded or
resized); torch only in ``pipeline.DevicePrefetcher``."""

from ewvit_tpu_torch.data.datasets import (  # noqa: F401
    CelebDFDataset,
    DiffusionDataset,
    FaceForensicsDataset,
)
from ewvit_tpu_torch.data.pipeline import BatchLoader, DevicePrefetcher  # noqa: F401
from ewvit_tpu_torch.data.transforms import FaceAligner, FrameTransform  # noqa: F401
from ewvit_tpu_torch.data import native  # noqa: F401
