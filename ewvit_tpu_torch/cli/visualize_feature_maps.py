"""Feature maps and attention of one image: ``python -m ewvit_tpu_torch.cli.visualize_feature_maps``.

The JAX package's ``visualize_feature_maps.py`` (the reference's
utils/visualize_feature_maps.py:25-198) on the port. The image is read with
cv2, face-aligned, resized and cropped (``FrameTransform``), normalised in
fp32 (eval ``preprocess_batch``), and run through DAMA's per-frame forward
with its intermediates. :func:`collect` returns, for that one frame:

- ``stem``: the V2-S stem's activation ``[C, S/2, S/2]``, taken by a forward
  hook on the stem (the JAX CLI captures ``stem.__call__``);
- ``hf_level0``: the MWT's level-0 highpass map ``[dim, S/2, S/2]`` (DAMA's
  MWT run alone with ``return_intermediates``);
- ``gate_weights``: DAMA's (space, freq, fused) gate ``[3]``;
- ``attention``: the cross-attention's four softmax maps ``[4, heads, q, k]``
  (layer 0 space->freq, freq->space, then layer 1);
- ``crop``: the uint8 frame the model saw.

``main`` writes ``backbone_stem.png`` and ``mwt_hf_level0.png`` (heat
overlays of the channel-mean absolute activation), ``gate_weights.txt`` and
``cross_attention.png`` (the head-averaged maps); the plots need matplotlib.
``--device`` (default ``cuda``) is the port's own.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Visualize DAMA feature maps (GPU)")
    p.add_argument("--image", required=True, help="Input image path")
    p.add_argument("--model-path", default=None,
                   help="Checkpoint .pth/.pt (omit for seeded random weights)")
    p.add_argument("--output", default="./output/feature_maps")
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--tiny", action="store_true",
                   help="ModelConfig.tiny() (64px): smoke runs only")
    p.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


@torch.no_grad()
def collect(model, cfg, image: np.ndarray) -> Dict[str, np.ndarray]:
    """The arrays above for an RGB uint8 ``image`` ``[H, W, 3]``, from
    ``model`` (a detector built for ``cfg``) in fp32 on its device."""
    from ewvit_tpu_torch.data.transforms import FrameTransform
    from ewvit_tpu_torch.ops.preprocess import preprocess_batch

    size = cfg.arch.image_size
    crop = FrameTransform(resize=max(1, round(size * 450 / 224)), crop=size)(image)
    dama = model.dama.eval()
    dev = next(dama.parameters()).device
    x = preprocess_batch(torch.from_numpy(crop[None, None]).to(dev), torch.float32)[:, 0]
    captured = []
    hook = dama.sfe.efficient_net.features[0].register_forward_hook(
        lambda mod, inp, out: captured.append(out))
    try:
        inter = dama(x, return_intermediates=True)["intermediates"]
    finally:
        hook.remove()
    _, mwt_inter = dama.mwt(x, return_intermediates=True)

    def host(t):
        return t.float().cpu().numpy()

    return {"crop": crop, "stem": host(captured[0][0]),
            "hf_level0": host(mwt_inter["hf_level0"][0]),
            "gate_weights": host(inter["gate_weights"][0]),
            "attention": np.stack([host(a[0]) for a in inter["attention"]])}


def overlay(img_u8: np.ndarray, heat: np.ndarray, path: str, title: str) -> None:
    from ewvit_tpu_torch.utils.visualization import pyplot

    plt = pyplot()
    heat = heat.astype(np.float32)
    heat = (heat - heat.min()) / (np.ptp(heat) + 1e-8)
    fig, axes = plt.subplots(1, 2, figsize=(8, 4))
    axes[0].imshow(img_u8); axes[0].set_title("input"); axes[0].axis("off")
    axes[1].imshow(img_u8)
    axes[1].imshow(heat, cmap="jet", alpha=0.5,
                   extent=(0, img_u8.shape[1], img_u8.shape[0], 0))
    axes[1].set_title(title); axes[1].axis("off")
    fig.tight_layout(); fig.savefig(path, dpi=120); plt.close(fig)


def grid(mats, path: str, title: str) -> None:
    from ewvit_tpu_torch.utils.visualization import pyplot

    plt = pyplot()
    fig, axes = plt.subplots(1, len(mats), figsize=(3 * len(mats), 3))
    axes = np.atleast_1d(axes)
    for ax, (name, m) in zip(axes, mats):
        ax.imshow(m, cmap="viridis"); ax.set_title(name, fontsize=8)
    fig.suptitle(title)
    fig.tight_layout(); fig.savefig(path, dpi=120); plt.close(fig)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
    args = parse_args(argv)
    from ewvit_tpu_torch.checkpoint import load_model
    from ewvit_tpu_torch.configs import ModelConfig
    from ewvit_tpu_torch.data.transforms import cv2_module
    from ewvit_tpu_torch.device import resolve_device
    from ewvit_tpu_torch.models.detector import build_detector

    os.makedirs(args.output, exist_ok=True)
    device = resolve_device(args.device)
    cfg = ModelConfig.tiny() if args.tiny else ModelConfig(dama_dim=args.dim)
    model = (load_model(args.model_path, cfg, device=device) if args.model_path
             else build_detector(cfg, device=device, seed=0))
    cv2 = cv2_module()
    if cv2 is None:
        raise RuntimeError("reading the image needs cv2")
    bgr = cv2.imread(args.image)
    if bgr is None:
        raise FileNotFoundError(f"could not read an image from {args.image}")
    maps = collect(model, cfg, cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB))

    crop, gate = maps["crop"], maps["gate_weights"]
    with open(os.path.join(args.output, "gate_weights.txt"), "w") as f:
        f.write(f"space={gate[0]:.4f} freq={gate[1]:.4f} fused={gate[2]:.4f}\n")
    print(f"gate weights: space={gate[0]:.4f} freq={gate[1]:.4f} fused={gate[2]:.4f}")
    overlay(crop, np.abs(maps["stem"]).mean(0),
            os.path.join(args.output, "backbone_stem.png"), "V2-S stem |activation|")
    overlay(crop, np.abs(maps["hf_level0"]).mean(0),
            os.path.join(args.output, "mwt_hf_level0.png"), "MWT level-0 highpass")
    mats = [(f"L{i // 2} {'space->freq' if i % 2 == 0 else 'freq->space'}", a.mean(0))
            for i, a in enumerate(maps["attention"])]
    grid(mats, os.path.join(args.output, "cross_attention.png"),
         "bidirectional cross-attention (head-avg)")
    print(f"Wrote visualizations to {args.output}")
    return maps


if __name__ == "__main__":
    main()
