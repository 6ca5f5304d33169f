"""DeepfakeDetector and the video forward (ewvit_tpu/models/detector.py).

Modules, with the reference's names (model.py:35-68):

- ``dama``: DAMA (V2-S SFE + MWT + cross-attention), the ``dynamic`` mode;
- ``mwt``: a standalone MWT, the frequency half of ``sfe_mwt``;
- ``sfe``: a B0 EfficientViT with the feature-map head (``sfe_mwt``);
- ``sfe_cls``: a B0 EfficientViT with the cls head (``sfe_only``);
- ``fusion_gate``: ``Linear(2*dim, 2)``, ReLU, Dropout 0.1 (``sfe_mwt``);
- ``classifier``: ``Linear(dim, 64)``, ReLU, Dropout 0.3, ``Linear(64, 1)``.

Every mode's modules are built, so a checkpoint in the reference layout
loads with ``strict=True``; a forward runs only its mode's modules.

:func:`video_forward` is the chunk loop of the JAX ``video_forward``
(detector.py:171-305): chunk = ``min(frame_chunk, K)``, each chunk is
flattened B-major (``[B, chunk] -> B*chunk``, so flattened row ``b*chunk + t``
meets positional row ``b*chunk + t`` as in the reference), the mode's
per-frame outputs (:func:`feat_dims`) are summed in fp32, divided by K and
cast to the compute dtype, and the mode's head runs on the means.

- Eval mode (``model.eval()``, under ``no_grad``): the ragged tail chunk is
  zero-padded to full size and masked out of the sums.
- Train mode (``model.train()``, with autograd): the tail runs as a true,
  smaller chunk, since pad rows would enter every BN's batch statistics
  (detector.py:203-215). Dropout and stochastic depth draw from torch's
  default generators, seeded per chunk from ``seed`` (:func:`chunk_seeds`,
  as the JAX package splits its key per chunk), so a step is a function of
  its seed and a remat recompute draws the forward's masks. With ``remat``
  (``ModelConfig.remat_frames``) each chunk runs under
  ``torch.utils.checkpoint`` (the counterpart of ``jax.checkpoint``,
  detector.py:259-265): its activations are recomputed in the backward, with
  every BN's momentum at 0 so that the running statistics move once per
  chunk, as in the functional JAX recompute.
- With a mesh (``parallel.make_mesh``) a rank runs its rows of the global
  batch and each chunk states them (:class:`Split`): dropout, stochastic
  depth and the positional embedding follow the global row, and in train
  mode BN takes its statistics over every rank that holds rows of the chunk,
  so the rank's outputs are its rows of the unsplit run's (the JAX package's
  GSPMD keeps the single-device meaning the same way). On a frames axis in
  training each rank runs its share of every chunk (``parallel/mesh.py``):
  BN syncs over the whole mesh, a rank with no row of a ragged tail chunk
  still runs it (its zero rows join the collectives, forward and backward),
  and the per-clip sums are all-reduced over the frames group, with an
  autograd all-reduce, before the head.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ewvit_tpu_torch.configs import ModelConfig
from ewvit_tpu_torch.device import DeviceLike, compute_dtype, resolve_device
from ewvit_tpu_torch.models.dama import DAMA
from ewvit_tpu_torch.models.mwt import MWT
from ewvit_tpu_torch.models.norm import calibrate_batchnorm_, synced_batch_stats
from ewvit_tpu_torch.models.rows import Dropout, global_rows
from ewvit_tpu_torch.models.sfe import EfficientViT
from ewvit_tpu_torch.ops.preprocess import preprocess_batch
from ewvit_tpu_torch.parallel.mesh import all_reduce_sum

ABLATION_MODES = ("dynamic", "sfe_only", "sfe_mwt")


def check_mode(mode: str) -> str:
    if mode not in ABLATION_MODES:
        raise ValueError(f"Invalid ablation config: {mode} (use one of {ABLATION_MODES})")
    return mode


def feat_dims(cfg: ModelConfig, mode: str) -> Dict[str, int]:
    """Per-frame outputs that ``video_forward`` averages over K, by width."""
    d = cfg.dama_dim
    return {"dynamic": {"fused": d, "space": d, "freq": d},
            "sfe_only": {"logits": 1},
            "sfe_mwt": {"sfe": d, "mwt": d}}[check_mode(mode)]


class DeepfakeDetector(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.backbone_factory is not None:
            raise NotImplementedError("backbone_factory is a JAX-package test hook")
        self.cfg = cfg
        d = cfg.dama_dim
        self.dama = DAMA(cfg)
        self.mwt = MWT(cfg.in_channels, d, cfg.levels,
                       use_pallas_dwt=cfg.use_pallas_dwt,
                       use_fused_tail=cfg.use_fused_mwt_tail)
        b0 = dict(feat_dim=d, use_pallas_dwse=cfg.use_pallas_dwse,
                  pos_mode=cfg.pos_mode, backbone="b0", backbone_spec=cfg.b0_spec)
        self.sfe = EfficientViT(cfg.arch, output_mode="feature_map", **b0)
        self.sfe_cls = EfficientViT(cfg.arch, output_mode="cls", **b0)
        self.fusion_gate = nn.Sequential(nn.Linear(2 * d, 2), nn.ReLU(), Dropout(0.1))
        self.classifier = nn.Sequential(
            nn.Linear(d, 64), nn.ReLU(), Dropout(0.3), nn.Linear(64, 1))

    def forward(self, frames, mode: str = "dynamic") -> Dict[str, torch.Tensor]:
        """One flattened chunk ``[N, 3, H, W]`` -> the mode's per-frame outputs:
        ``dynamic`` ``{'fused', 'space', 'freq'}`` ``[N, dim]``; ``sfe_only``
        ``{'logits'}`` ``[N, 1]``; ``sfe_mwt`` ``{'sfe', 'mwt'}`` ``[N, dim]``
        (the feature map averaged over H, W; the MWT's ``[N, dim, 1, 1]``)."""
        if check_mode(mode) == "dynamic":
            return self.dama(frames)
        if mode == "sfe_only":
            return {"logits": self.sfe_cls(frames)}
        return {"sfe": self.sfe(frames).mean(dim=(2, 3)),
                "mwt": self.mwt(frames).reshape(frames.shape[0], -1)}

    def head(self, feats: Dict[str, torch.Tensor], mode: str = "dynamic"):
        """Video-level head on the K-means of :meth:`forward`'s outputs."""
        if check_mode(mode) == "dynamic":
            return {"logits": self.classifier(feats["fused"]), **feats}
        if mode == "sfe_only":
            return {"logits": feats["logits"]}
        s, m = feats["sfe"], feats["mwt"]
        g = self.fusion_gate(torch.cat([s, m], dim=-1))
        gate = g.float().softmax(dim=-1).to(g.dtype)
        fused = s * gate[:, 0:1] + m * gate[:, 1:2]
        return {"logits": self.classifier(fused), "sfe": s, "mwt": m}


# flax's lecun_normal() draws a unit normal truncated at +-2 and divides by
# the truncated normal's standard deviation, so that the variance is 1/fan_in
TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_weights_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded init on the model's device, as the JAX package's initialisers
    draw: conv and linear weights from flax's ``lecun_normal()`` (a unit
    normal truncated at +-2, times ``1/sqrt(fan_in) / TRUNC_STD``, fan-in
    ``kh*kw*cin/groups``), zero biases, identity norms, N(0, 1) positional
    embedding and CLS token (ewvit_tpu/models/sfe.py:98, :113)."""
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            nn.init.trunc_normal_(m.weight, 0.0, 1.0, -2.0, 2.0, generator=g)
            m.weight.mul_(1.0 / math.sqrt(fan_in) / TRUNC_STD)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()
        elif isinstance(m, EfficientViT):
            m.pos_embedding.normal_(0.0, 1.0, generator=g)
            m.cls_token.normal_(0.0, 1.0, generator=g)
    return model


def build_detector(cfg: ModelConfig, *, device: DeviceLike = "cuda",
                   seed: int = 0) -> DeepfakeDetector:
    """Build the detector on ``device`` (CUDA unless the caller names the CPU)
    with seeded random weights, in eval mode. Load trained or converted
    weights with ``load_state_dict(..., strict=True)``, or a checkpoint file
    with ``checkpoint.load_model``."""
    dev = resolve_device(device)
    with torch.device("meta"):
        model = DeepfakeDetector(cfg)
    model.to_empty(device=dev)
    return init_weights_(model, seed).eval()


@torch.no_grad()
def random_detector(cfg: ModelConfig, *, device: DeviceLike = "cuda", seed: int = 0,
                    calib_frames: int = 16) -> DeepfakeDetector:
    """Seeded random weights that keep a full-depth forward well scaled.

    With identity BatchNorm statistics the activations of a deep backbone
    stack vanish and every request gets the same answer; so the BNs of the
    three backbones (DAMA's V2-S, the B0s of ``sfe`` and ``sfe_cls``) are
    calibrated on ``calib_frames`` seeded random uint8 frames (one train-mode
    pass each, fp32), and the output layers of the two logit heads
    (``classifier``, ``sfe_cls``'s cls head) are scaled by 0.1 so the logits
    stay O(1) and the probabilities unsaturated. Smoke tests and profiling
    use this; served weights come from ``load_state_dict``.
    """
    model = build_detector(cfg, device=device, seed=seed)
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    s = cfg.arch.image_size
    clips = torch.randint(0, 256, (1, calib_frames, s, s, cfg.in_channels),
                          generator=g, device=dev, dtype=torch.uint8)
    frames = preprocess_batch(clips, torch.float32)[0]
    for sfe in (model.dama.sfe, model.sfe, model.sfe_cls):
        calibrate_batchnorm_(sfe.efficient_net, frames)
    model.classifier[3].weight.mul_(0.1)
    model.sfe_cls.mlp_head[2].weight.mul_(0.1)
    return model


def chunk_seeds(seed: int, n: int) -> List[int]:
    """``n`` independent seeds derived from ``seed`` (numpy's SeedSequence)."""
    return [int(v) for v in np.random.SeedSequence(int(seed)).generate_state(n)]


@contextlib.contextmanager
def seeded(seed: int, device: torch.device):
    """Run the block with torch's default generators (the CPU's and
    ``device``'s) seeded to ``seed``, and restore them after: dropout and
    stochastic depth then draw the same masks for the same seed, in the
    forward and in its remat recompute alike."""
    devices = [device.index if device.index is not None else torch.cuda.current_device()] \
        if device.type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        torch.random.default_generator.manual_seed(seed)
        if devices:
            with torch.cuda.device(devices[0]):
                torch.cuda.manual_seed(seed)
        yield


@contextlib.contextmanager
def _running_stats_frozen(bns: List[nn.modules.batchnorm._BatchNorm]):
    """A remat recompute: every BN normalises with its batch statistics as
    in the forward, but leaves its running statistics (momentum 0) and its
    ``num_batches_tracked`` (set aside) as they are."""
    saved = [(bn.momentum, bn.num_batches_tracked) for bn in bns]
    for bn in bns:
        bn.momentum, bn.num_batches_tracked = 0.0, None
    try:
        yield
    finally:
        for bn, (momentum, tracked) in zip(bns, saved):
            bn.momentum, bn.num_batches_tracked = momentum, tracked


class Split(NamedTuple):
    """This rank's share of a global batch inside a forward: the global row
    of each local row (``models/rows.global_rows``), the global row count,
    and the process group over which train-mode BN takes its statistics
    (``models/norm.synced_batch_stats``)."""
    index: torch.Tensor
    total: int
    group: object


@contextlib.contextmanager
def _in_split(split: Optional[Split]):
    if split is None:
        yield
        return
    with global_rows(split.index, split.total), synced_batch_stats(split.group):
        yield


def _train_chunk(model: DeepfakeDetector, flat: torch.Tensor, mode: str, seed: int,
                 split: Optional[Split] = None):
    with seeded(seed, flat.device), _in_split(split):
        return model(flat, mode)


def video_forward(model: DeepfakeDetector, x: torch.Tensor, *, mode: str = "dynamic",
                  frame_chunk: int = 8, seed: int = 0, remat: Optional[bool] = None,
                  mesh=None, frame_axis: bool = False) -> Dict[str, torch.Tensor]:
    """``x`` ``[B, K, 3, H, W]`` preprocessed frames -> the mode's head
    outputs: ``{'logits': [B, 1]}`` plus ``'fused', 'space', 'freq'``
    (``dynamic``) or ``'sfe', 'mwt'`` (``sfe_mwt``), each ``[B, dim]``.

    In eval mode it runs under ``no_grad``. In train mode it records the
    graph; ``seed`` seeds dropout and stochastic depth, and ``remat``
    (default ``model.cfg.remat_frames``) checkpoints each chunk.

    ``mesh`` (``parallel.make_mesh``): ``x`` holds this rank's ``B/W`` clips
    of a global batch of ``B`` (rows ``[i*B/W, (i+1)*B/W)`` for batch index
    ``i``), and the outputs are this rank's rows of the global run's. Every
    chunk states its global rows (dropout, stochastic depth, the positional
    embedding) and, in train mode, takes BN statistics over the ranks that
    hold rows of it. ``frame_axis`` on a mesh with ``frames > 1``: in eval
    mode (serving) ``x`` holds this rank's ``K/F`` contiguous frames, and the
    rank walks the global chunk grid over them; in train mode ``x`` holds all
    ``K`` frames of the rank's clips, and the rank runs its share
    ``mesh.frame_share(n)`` of every chunk of ``n`` frames, with BN synced
    over the whole mesh. Either way the per-clip sums are all-reduced over
    the frames group before the head."""
    if model.training:
        return _train_video_forward(model, x, mode, frame_chunk, seed,
                                    model.cfg.remat_frames if remat is None else remat, mesh,
                                    frame_axis)
    with torch.no_grad():
        return _eval_video_forward(model, x, mode, frame_chunk, mesh, frame_axis)


def _batch_split(mesh, b: int, rows_per_clip: int, device) -> Optional[Split]:
    """This rank's rows of a global batch of ``b * W`` clips of
    ``rows_per_clip`` rows each (rank-major, so contiguous)."""
    if mesh is None:
        return None
    first = mesh.batch_index * b * rows_per_clip
    return Split(torch.arange(first, first + b * rows_per_clip, device=device),
                 b * mesh.batch_size * rows_per_clip, mesh.batch_group)


def _frames_split(mesh, b: int, n: int, lo: int, width: int, device) -> Split:
    """This rank's rows of a training chunk of ``n`` frames split over the
    frames axis: its clips ``c`` (global) and frames ``lo + t`` are the
    global rows ``c*n + lo + t``; BN syncs over the whole mesh."""
    clips = torch.arange(mesh.batch_index * b, (mesh.batch_index + 1) * b, device=device)
    index = clips[:, None] * n + lo + torch.arange(width, device=device)
    return Split(index.reshape(-1), b * mesh.batch_size * n, mesh.world_group)


def _reduce_over_frames(sums: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """The per-clip sums of every frames rank, summed (differentiably, for
    the train forward)."""
    flat = all_reduce_sum(torch.cat(list(sums.values()), dim=1), mesh.frames_group)
    return dict(zip(sums, flat.split([v.shape[1] for v in sums.values()], dim=1)))


def _train_video_forward(model, x, mode, frame_chunk, seed, remat, mesh, frame_axis=False):
    b, k = x.shape[:2]
    chunk = min(frame_chunk, k)
    starts = range(0, k, chunk)
    seeds = chunk_seeds(seed, len(starts) + 1)      # one per chunk, one for the head
    by_frames = mesh is not None and frame_axis and mesh.frame_size > 1
    run = _train_chunk
    if remat:
        bns = [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
        contexts = lambda: (contextlib.nullcontext(), _running_stats_frozen(bns))  # noqa: E731
        run = functools.partial(checkpoint, _train_chunk, use_reentrant=False,
                                preserve_rng_state=False, context_fn=contexts)
    sums = {key: torch.zeros(b, d, dtype=torch.float32, device=x.device)
            for key, d in feat_dims(model.cfg, check_mode(mode)).items()}
    for start, s in zip(starts, seeds):
        n = min(chunk, k - start)         # the tail chunk is smaller
        if by_frames:                     # this rank's share, maybe none
            lo, hi = mesh.frame_share(n)
            split = _frames_split(mesh, b, n, lo, hi - lo, x.device)
        else:
            lo, hi = 0, n
            split = _batch_split(mesh, b, n, x.device)
        fr = x[:, start + lo:start + hi]
        out = run(model, fr.reshape(b * (hi - lo), *x.shape[2:]), mode, s, split)
        # a zero-row share still adds its (empty) sum, so that its backward,
        # and the collectives in it, run on this rank as on the others
        sums = {key: v + out[key].float().reshape(b, hi - lo, v.shape[1]).sum(dim=1)
                for key, v in sums.items()}
    if by_frames:
        sums = _reduce_over_frames(sums, mesh)
    dt = compute_dtype(model.cfg.compute_dtype)
    with seeded(seeds[-1], x.device), _in_split(_batch_split(mesh, b, 1, x.device)):
        return model.head({key: (v / k).to(dt) for key, v in sums.items()}, mode)


def _eval_video_forward(model, x, mode, frame_chunk, mesh=None, frame_axis=False):
    """The unsplit loop pads its ragged tail chunk to full size; on a frames
    axis a rank runs its part of each global chunk unpadded, with the
    global rows ``b*chunk + (t mod chunk)`` of its clips ``b`` and frames
    ``t``."""
    b, k_local = x.shape[:2]
    frames = mesh.frame_size if mesh is not None and frame_axis else 1
    k = k_local * frames
    f0 = mesh.frame_index * k_local if frames > 1 else 0
    chunk = min(frame_chunk, k)
    b0 = mesh.batch_index * b if mesh is not None else 0
    total = b * mesh.batch_size * chunk if mesh is not None else b * chunk
    sums = {key: torch.zeros(b, d, dtype=torch.float32, device=x.device)
            for key, d in feat_dims(model.cfg, mode).items()}
    for start in range(0, k, chunk):
        lo, hi = max(start, f0), min(start + chunk, k, f0 + k_local)
        if lo >= hi:
            continue
        fr = x[:, lo - f0:hi - f0]
        valid = hi - lo
        width = chunk if frames == 1 else valid
        if valid < width:
            pad = fr.new_zeros((b, width - valid) + tuple(x.shape[2:]))
            fr = torch.cat([fr, pad], dim=1)
        split = None
        if mesh is not None:
            clips = torch.arange(b0, b0 + b, device=x.device)[:, None]
            index = clips * chunk + (lo - start) + torch.arange(width, device=x.device)
            split = Split(index.reshape(-1), total, mesh.batch_group)
        with _in_split(split):
            out = model(fr.reshape(b * width, *x.shape[2:]), mode)
        for key in sums:
            sums[key] += out[key].float().reshape(b, width, -1)[:, :valid].sum(dim=1)
    if mesh is not None and frame_axis:
        sums = _reduce_over_frames(sums, mesh)
    dt = compute_dtype(model.cfg.compute_dtype)
    return model.head({key: (v / k).to(dt) for key, v in sums.items()}, mode)
