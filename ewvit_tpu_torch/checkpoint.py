"""Reading a reference checkpoint (ewvit_tpu/utils/torch_convert.py:36-55,
ewvit_tpu/evaluation.py:41-92).

:func:`load_model` builds the detector and loads a ``.pth``/``.pt`` file in
the reference layout: a raw state dict or one under ``model_state_dict`` or
``state_dict``, with or without DataParallel's ``module.`` prefixes. The
port's module names are the reference's, so no conversion runs. Orbax
checkpoint directories stay with the JAX package: restore one there and
convert its variables with ``ewvit_tpu_torch.utils.convert.jax_to_state_dict``.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional

import torch

from ewvit_tpu_torch.configs import ModelConfig
from ewvit_tpu_torch.device import DeviceLike
from ewvit_tpu_torch.models.detector import DeepfakeDetector, build_detector


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pth`` as a flat ``{name: tensor}`` dict on the CPU, from
    any of its three layouts, with ``module.`` prefixes stripped. Loads
    tensors only (``weights_only=True``)."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, Mapping):
        for key in ("model_state_dict", "state_dict"):
            if key in obj:
                obj = obj[key]
                break
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in obj.items() if isinstance(v, torch.Tensor)}


def _check_checkpoint(path: str, sd: Mapping[str, torch.Tensor],
                      model: DeepfakeDetector) -> None:
    """Raise on missing keys or shape mismatches; warn on unexpected keys."""
    cfg, own = model.cfg, model.state_dict()
    needed = [k for k in own if not k.endswith("num_batches_tracked")]
    missing = [k for k in needed if k not in sd]
    if missing:
        raise ValueError(
            f"{path}: {len(missing)} keys of the DeepfakeDetector are absent "
            f"(first few: {missing[:5]}) — not a DeepfakeDetector checkpoint?")
    unexpected = sorted(set(sd) - set(own))
    if unexpected:
        print(f"Warning: {path}: {len(unexpected)} unexpected keys ignored "
              f"(e.g. {unexpected[:3]})")
    for k in needed:
        if tuple(sd[k].shape) != tuple(own[k].shape):
            raise ValueError(
                f"{path}: {k} has shape {tuple(sd[k].shape)} but the configured "
                f"model (dama_dim={cfg.dama_dim}, image_size={cfg.arch.image_size}) "
                f"expects {tuple(own[k].shape)} — check the dim and image size "
                "against the checkpoint's training config")


def load_model(path: str, cfg: Optional[ModelConfig] = None, *,
               device: DeviceLike = "cuda") -> DeepfakeDetector:
    """The detector on ``device`` (CUDA unless the caller names the CPU), in
    eval mode, with the weights of the ``.pth``/``.pt`` file at ``path``."""
    if os.path.isdir(path) or not str(path).endswith((".pth", ".pt")):
        raise ValueError(
            f"{path}: not a torch checkpoint (.pth/.pt). Orbax checkpoint "
            "directories belong to the JAX package: restore the variables there "
            "and convert them with ewvit_tpu_torch.utils.convert.jax_to_state_dict")
    model = build_detector(cfg or ModelConfig(), device=device)
    sd = load_torch_state_dict(path)
    _check_checkpoint(path, sd, model)
    own = model.state_dict()
    model.load_state_dict({k: sd.get(k, own[k]) for k in own}, strict=True)
    return model
