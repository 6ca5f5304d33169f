"""Inference engine: uint8 clips in, sigmoid probabilities out (ewvit_tpu/serving.py).

- ships uint8 ``[B, K, H, W, 3]`` clips (4x fewer bytes than float32) from
  pinned host memory with ``non_blocking`` copies, and normalises on the
  device (``ops/preprocess.py``);
- casts every conv and linear weight to the compute dtype once (norms keep
  fp32 parameters and fold them per call, except where a kernel keeps its
  folded weights: K3's U, K2's depthwise weights, K4's packed weights), as
  ewvit_tpu's ``cast_kernels_for_inference`` pre-casts kernels;
- runs the eval ``video_forward`` in the engine's ablation ``mode``
  (``dynamic``, ``sfe_only`` or ``sfe_mwt``);
- ``predict_stream`` enqueues batch N+1 before it waits for batch N, whose
  probabilities were queued for a device-to-host copy right after its
  forward, so host transfer and compute overlap;
- ``from_checkpoint`` builds the engine from a ``.pth``/``.pt`` file in the
  reference layout (``checkpoint.load_model``).

- ``mesh=`` (``parallel.make_mesh``) serves data-parallel, as the JAX
  engine's ``mesh=`` (serving.py:43-85): every rank is given the same host
  batch (the JAX single controller holds it whole); the tail batch is
  zero-padded to the batch divisor (dcn x data); the rank copies to its card
  only its rows and, with ``frame_axis``, its ``K/F`` contiguous frames (a
  ``K`` that the frames axis does not divide raises); its forward walks the
  global chunk grid over them, the per-clip sums are all-reduced over the
  frames group before the head, the probabilities are all-gathered over the
  batch group, and every rank returns the ``[B]`` of the unsplit run, the
  pad rows dropped. The weights are broadcast from rank 0 before
  ``cast_for_inference``.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional

import numpy as np
import torch
import torch.nn as nn

from ewvit_tpu_torch.checkpoint import load_model
from ewvit_tpu_torch.configs import ModelConfig
from ewvit_tpu_torch.device import DeviceLike, compute_dtype, resolve_device
from ewvit_tpu_torch.models.detector import DeepfakeDetector, check_mode, video_forward
from ewvit_tpu_torch.models.kept import KeepsWeights
from ewvit_tpu_torch.ops.preprocess import preprocess_batch


def cast_for_inference(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast conv and linear weights and biases to ``dtype`` in place, then
    fold and pack once (eval mode) what every kernel-running module keeps:
    K2's depthwise weights in the V2-S and B0 blocks, the fused MWT tail's U
    in both MWTs, K4's weights."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            m.to(dtype)
    if not model.training:
        for m in model.modules():
            if isinstance(m, KeepsWeights):
                m.kept_weights(dtype)
    return model


class InferenceEngine:
    def __init__(self, model: DeepfakeDetector, *, mode: str = "dynamic",
                 frame_chunk: int = 32, device: DeviceLike = "cuda", mesh=None,
                 frame_axis: bool = False):
        self.mode = check_mode(mode)
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.dtype = compute_dtype(model.cfg.compute_dtype)
        model = model.to(self.device).eval()
        if mesh is not None:
            mesh.replicate_(model)
        self.model = cast_for_inference(model, self.dtype)
        self.frame_chunk = frame_chunk
        self.mesh, self.frame_axis = mesh, bool(frame_axis and mesh is not None)

    @classmethod
    def from_checkpoint(cls, path: str, cfg: Optional[ModelConfig] = None, *,
                        device: DeviceLike = "cuda", **kw) -> "InferenceEngine":
        """Engine over the weights of a ``.pth``/``.pt`` checkpoint
        (``checkpoint.load_model``); ``kw`` go to the constructor."""
        return cls(load_model(path, cfg, device=device), device=device, **kw)

    def _local(self, clips_u8: np.ndarray) -> np.ndarray:
        """This rank's rows (and frames) of a host batch, the tail batch
        zero-padded to the batch divisor."""
        m = self.mesh
        b, k = clips_u8.shape[:2]
        frames = m.frame_size if self.frame_axis else 1
        if k % frames:
            raise ValueError(
                f"frame count {k} not divisible by the mesh 'frames' axis ({frames}); "
                "frame padding would bias the video mean: resample the clip instead")
        pad = -b % m.batch_size
        if pad:
            clips_u8 = np.concatenate(
                [clips_u8, np.zeros((pad, *clips_u8.shape[1:]), clips_u8.dtype)])
        kf = k // frames
        f0 = m.frame_index * kf if self.frame_axis else 0
        return clips_u8[m.local_rows(b + pad), f0:f0 + kf]

    def _place(self, clips_u8: np.ndarray) -> torch.Tensor:
        if self.mesh is not None:
            clips_u8 = self._local(clips_u8)
        host = torch.from_numpy(np.ascontiguousarray(clips_u8))
        if host.dtype != torch.uint8:
            raise ValueError(f"expected uint8 clips, got {host.dtype}")
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device, non_blocking=True)
        return host

    @torch.no_grad()
    def _forward(self, clips: torch.Tensor) -> torch.Tensor:
        x = preprocess_batch(clips, self.dtype)
        k = clips.shape[1] * (self.mesh.frame_size if self.frame_axis else 1)
        out = video_forward(self.model, x, mode=self.mode,
                            frame_chunk=min(self.frame_chunk, k), mesh=self.mesh,
                            frame_axis=self.frame_axis)
        probs = torch.sigmoid(out["logits"].float())[:, 0]
        return self.mesh.gather(probs) if self.mesh is not None else probs

    def _dispatch(self, clips_u8: np.ndarray):
        """Enqueue one batch; returns (host tensor, completion event or None,
        rows to keep)."""
        probs = self._forward(self._place(clips_u8))
        n = clips_u8.shape[0]
        if self.device.type != "cuda":
            return probs, None, n
        host = torch.empty(probs.shape, dtype=probs.dtype, pin_memory=True)
        host.copy_(probs, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done, n

    @staticmethod
    def _collect(pending) -> np.ndarray:
        host, done, n = pending
        if done is not None:
            done.synchronize()
        return host.numpy()[:n].copy()

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
