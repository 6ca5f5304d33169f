"""Inference engine: uint8 clips in, sigmoid probabilities out (ewvit_tpu/serving.py).

- ships uint8 ``[B, K, H, W, 3]`` clips (4x fewer bytes than float32) from
  pinned host memory with ``non_blocking`` copies, and normalises on the
  device (``ops/preprocess.py``);
- casts every conv and linear weight to the compute dtype once (norms keep
  fp32 parameters and fold them per call), as ewvit_tpu's
  ``cast_kernels_for_inference`` pre-casts kernels;
- runs the eval ``video_forward`` (``dynamic`` mode, the one ported);
- ``predict_stream`` enqueues batch N+1 before it waits for batch N, whose
  probabilities were queued for a device-to-host copy right after its
  forward, so host transfer and compute overlap.

Data-parallel serving (``mesh=``) waits.
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np
import torch
import torch.nn as nn

from ewvit_tpu_torch.device import DeviceLike, compute_dtype, resolve_device
from ewvit_tpu_torch.models.detector import DeepfakeDetector, video_forward
from ewvit_tpu_torch.ops.preprocess import preprocess_batch


def cast_for_inference(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast conv and linear weights and biases to ``dtype`` in place."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.to(dtype)
    return model


class InferenceEngine:
    def __init__(self, model: DeepfakeDetector, *, frame_chunk: int = 32,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.dtype = compute_dtype(model.cfg.compute_dtype)
        self.model = cast_for_inference(model.to(self.device).eval(), self.dtype)
        self.frame_chunk = frame_chunk

    def _place(self, clips_u8: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(clips_u8))
        if host.dtype != torch.uint8:
            raise ValueError(f"expected uint8 clips, got {host.dtype}")
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host

    @torch.no_grad()
    def _forward(self, clips: torch.Tensor) -> torch.Tensor:
        x = preprocess_batch(clips, self.dtype)
        k = clips.shape[1]
        out = video_forward(self.model, x, frame_chunk=min(self.frame_chunk, k))
        return torch.sigmoid(out["logits"].float())[:, 0]

    def _dispatch(self, clips_u8: np.ndarray):
        """Enqueue one batch; returns (host tensor, completion event or None)."""
        probs = self._forward(self._place(clips_u8))
        if self.device.type != "cuda":
            return probs, None
        host = torch.empty(probs.shape, dtype=probs.dtype, pin_memory=True)
        host.copy_(probs, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @staticmethod
    def _collect(pending) -> np.ndarray:
        host, done = pending
        if done is not None:
            done.synchronize()
        return host.numpy().copy()

    def warmup(self, batch: int, frames: int, image_size: int = 224) -> None:
        clip = np.zeros((batch, frames, image_size, image_size, 3), np.uint8)
        self._collect(self._dispatch(clip))

    def predict(self, clips_u8: np.ndarray) -> np.ndarray:
        """``[B, K, H, W, 3]`` uint8 -> probabilities ``[B]`` (float32)."""
        return self._collect(self._dispatch(clips_u8))

    def predict_stream(self, batches: Iterable[np.ndarray]) -> Iterator[np.ndarray]:
        """Pipelined :meth:`predict` over a stream of batches, in order."""
        pending = None
        for batch in batches:
            nxt = self._dispatch(batch)
            if pending is not None:
                yield self._collect(pending)
            pending = nxt
        if pending is not None:
            yield self._collect(pending)
