"""The one place the harness reaches into the measured program,
``ewvit_tpu_torch``: its configuration, model, engine, optimizer,
preprocessing and train step, and the functions a metric names. Nothing
else of the harness imports it (``lib/faults.py`` patches it for tests).
"""

from __future__ import annotations

from typing import Dict

import torch


def model_config(cfg: dict, frame_chunk: int):
    """The program's ``ModelConfig`` for a configuration file."""
    from ewvit_tpu_torch.configs import ArchConfig, BackboneSpec, BlockCfg, ModelConfig

    def spec(s):
        return BackboneSpec(tuple(BlockCfg(r, k, st, e, i, o, se_ratio=se, fused=fu)
                                  for r, k, st, e, i, o, se, fu in s["blocks"]),
                            stem_ch=s["stem_ch"], head_ch=s["head_ch"])

    arch = ArchConfig(image_size=cfg["image_size"], patch_size=cfg["patch_size"],
                      num_classes=cfg["num_classes"], dim=cfg["dim"], depth=cfg["depth"],
                      dim_head=cfg["dim_head"], heads=cfg["heads"], mlp_dim=cfg["mlp_dim"],
                      emb_dim=cfg["emb_dim"], dropout=cfg["dropout"],
                      emb_dropout=cfg["emb_dropout"])
    return ModelConfig(arch=arch, in_channels=cfg["in_channels"], dama_dim=cfg["dama_dim"],
                       num_heads=cfg["num_heads"], levels=cfg["levels"],
                       frame_chunk=frame_chunk, compute_dtype=cfg["compute_dtype"],
                       remat_frames=bool(cfg["remat"]), pos_mode=cfg["pos_mode"],
                       backbone_spec=(spec(cfg["b0"]), spec(cfg["v2s"])),
                       **{k: bool(v) for k, v in cfg["kernels"].items()})


def load_model(cfg: dict, state: Dict[str, torch.Tensor], frame_chunk: int, device):
    """The program's detector holding ``state`` (strict), fp32, eval mode."""
    from ewvit_tpu_torch.models.detector import DeepfakeDetector

    with torch.device("meta"):
        model = DeepfakeDetector(model_config(cfg, frame_chunk))
    model = model.to_empty(device=device)
    model.load_state_dict(state, strict=True)
    return model.eval()


def engine(model, mode: str, frame_chunk: int, device):
    from ewvit_tpu_torch.serving import InferenceEngine

    return InferenceEngine(model, mode=mode, frame_chunk=frame_chunk, device=device)


def optimizer(model, cfg: dict):
    """Adam with the frozen prefixes at the recipe's rate, held constant over
    the run (the schedule's epoch never turns)."""
    from ewvit_tpu_torch.train.optimizer import make_optimizer

    return make_optimizer(model, lr=cfg["lr"], weight_decay=cfg["weight_decay"],
                          epochs=cfg["epochs"], steps_per_epoch=1 << 40)


def preprocess_train(clips_u8, dtype_name: str, generator):
    from ewvit_tpu_torch.device import compute_dtype
    from ewvit_tpu_torch.ops.preprocess import preprocess_batch

    return preprocess_batch(clips_u8, compute_dtype(dtype_name), train=True,
                            generator=generator)


def train_step(model, opt, frames, labels, **kw):
    from ewvit_tpu_torch.train.steps import train_step as step

    return step(model, opt, frames, labels, **kw)


def preprocess_eval(clips_u8, dtype):
    from ewvit_tpu_torch.ops.preprocess import preprocess_batch

    return preprocess_batch(clips_u8, dtype)


def function(path: str):
    """``"module:attr"`` -> the program's function (a metric names what it times)."""
    import importlib

    mod, attr = path.split(":")
    return getattr(importlib.import_module(mod), attr)
