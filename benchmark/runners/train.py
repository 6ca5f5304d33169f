"""Training: ``train_step`` with ``make_optimizer`` on pinned uint8 batches.

Set-up builds one model and optimizer from the seed and drives them through
the first ``checked_steps`` updates with the window's own feed and call
(copy a pool batch to the device, the colour jitter, ``train_step``); the
same objects then run the window. The window opens at the first timed
update and closes, synchronised, at the end of the first update dispatched
after ``--seconds``; every frame of every update in it counts.

``correct``: the fp32 reference follows the checked updates from the same
weights, clips, labels, jitter draws and dropout seeds, and ``check``
returns these numbers (the cell file says which are held to a limit; the
rest are read by ``benchmark/calibrate.py`` alone):

- ``grad_rel``: the first update's gradient as Adam takes it (the
  program's worked out from its first moment, ``exp_avg / (1 - beta1)``),
  over the counted leaves together: the norm of its gap to the
  reference's over the reference's norm; ``grad_rel_median``: the median
  leaf's gap norm over the larger of that leaf's and the median counted
  leaf's reference norm;
- ``grad_gap``: per counted leaf, the gap between the two gradients'
  norms over the same denominator; the worst leaf; ``grad_gap_median``
  the median leaf's;
- ``update_gap``, ``update_gap_median``: the same of the parameters'
  change over the checked updates;
- ``logit_gap_first_rms``: the root mean square over the first update's
  clips of the gap between the training forward's logits (the program's
  from its returned ``preds``) and the reference's;
- ``loss_gap_first``, ``loss_gap``: the relative gap of the first
  update's mean loss, and the largest over the checked updates.

A leaf counts where the mode uses it (its loss gradient is not zero) and
its reference gradient is at least a thousandth of the median used leaf's:
the rest (conv biases under train-mode BN) have a gradient of round-off
alone, which Adam turns into steps of about ``lr``.

Traffic parameters: ``frame_chunk``, ``pool`` (distinct update batches),
``epoch`` (of the configuration's ``epochs``), ``checked_steps``,
``traced_steps``. The recipe (batch, accumulation, frames, rate, decay) is
the configuration's.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from benchmark.lib import inputs, program, weights
from benchmark.lib.common import derive
from benchmark.reference import model as ref
from benchmark.reference import train as reftrain

BETA1 = 0.9


def _clips_per_update(cfg) -> int:
    return cfg["batch_size"] * cfg["accum_steps"]


def prepare(run) -> None:
    """The benchmark's own inputs: the weights (kept on the host), the pool
    of update batches and their labels."""
    cfg, t, dev = run.cfg, run.traffic, run.device
    run.data["state"] = {k: v.cpu() for k, v in weights.make_state(cfg, run.seed, dev).items()}
    n = _clips_per_update(cfg)
    pool = [inputs.clips(n, cfg["frame_count"], cfg["image_size"], derive(run.seed, 20, i), dev)
            for i in range(t["pool"])]
    run.data["pool"] = [p.cpu().pin_memory() if run.on_card else p.cpu() for p in pool]
    run.data["labels"] = [inputs.balanced_labels(cfg["accum_steps"], cfg["batch_size"],
                                                 derive(run.seed, 21, i), dev)
                          for i in range(t["pool"])]
    del pool


def setup(run) -> None:
    prepare(run)
    run.reset_peak()
    cfg, t = run.cfg, run.traffic
    model = program.load_model(cfg, run.data["state"], t["frame_chunk"], run.device)
    opt = program.optimizer(model, cfg)
    run.program.update(model=model, opt=opt)
    losses = []
    for i in range(t["checked_steps"]):
        out = update(run, i)
        losses.append(out["loss"])
        if i == 0:
            run.data["grad_first"] = _adam_grads(model, opt)
            p = out["preds"].double().clamp(1e-12, 1 - 1e-12)
            run.data["logits_first"] = (p.log() - (-p).log1p()).cpu()
    run.data["losses"] = torch.stack(losses).double().cpu()
    run.data["change_norms"] = _change_norms(model, run.data["state"],
                                             list(run.data["grad_first"]))
    run.data["next"] = t["checked_steps"]
    run.sync()


def update(run, i: int) -> Dict[str, torch.Tensor]:
    """Update ``i``: the window's feed and call."""
    cfg, t, dev = run.cfg, run.traffic, run.device
    p = len(run.data["pool"])
    x = run.data["pool"][i % p].to(dev, non_blocking=True)
    gen = torch.Generator(device=dev).manual_seed(derive(run.seed, 22, i))
    frames = program.preprocess_train(x, cfg["compute_dtype"], gen)
    return program.train_step(run.program["model"], run.program["opt"], frames,
                              run.data["labels"][i % p], seed=derive(run.seed, 23, i),
                              mode=cfg["mode"], frame_chunk=t["frame_chunk"],
                              accum_steps=cfg["accum_steps"], pos_weight=cfg["pos_weight"],
                              epoch=t["epoch"], max_epochs=cfg["epochs"], remat=cfg["remat"])


def _names(model, opt) -> Dict[int, str]:
    ids = {id(p) for g in opt.param_groups for p in g["params"]}
    return {id(p): n for n, p in model.named_parameters() if id(p) in ids}


@torch.no_grad()
def _adam_grads(model, opt) -> Dict[str, torch.Tensor]:
    """The first update's gradient as Adam took it, from its first moment,
    on the host, per trainable leaf (zero where no step was taken)."""
    names = _names(model, opt)
    out = {}
    for g in opt.param_groups:
        for p in g["params"]:
            m = opt.state.get(p, {}).get("exp_avg")
            out[names[id(p)]] = (m.float() / (1.0 - BETA1) if m is not None
                                 else torch.zeros_like(p, dtype=torch.float32)).cpu()
    return out


@torch.no_grad()
def _change_norms(model, state, keys) -> Dict[str, float]:
    params = dict(model.named_parameters())
    dev = next(model.parameters()).device
    norms = torch.stack([(params[k].float() - state[k].to(dev).float()).norm() for k in keys])
    return dict(zip(keys, norms.double().cpu().tolist()))


def _run_updates(run, first: int, seconds: float, limit: int = 0):
    done = 0
    t0 = time.perf_counter()
    run.window.setdefault("t0", t0)
    while True:
        update(run, first + done)
        done += 1
        if (limit and done >= limit) or (not limit and time.perf_counter() - t0 >= seconds):
            break
    run.sync()
    return done, time.perf_counter() - t0


def measure(run, seconds: float) -> None:
    done, elapsed = _run_updates(run, run.data["next"], seconds)
    run.data["next"] += done
    cfg = run.cfg
    run.window.update(units=done, frames=done * _clips_per_update(cfg) * cfg["frame_count"],
                      seconds=elapsed)


def checked(run) -> None:
    """The checked updates ran in set-up; their readings are in ``run.data``."""
    return None


def traced(run) -> dict:
    done, elapsed = _run_updates(run, run.data["next"], 0.0, limit=run.traffic["traced_steps"])
    run.data["next"] += done
    cfg = run.cfg
    return dict(frames=done * _clips_per_update(cfg) * cfg["frame_count"], seconds=elapsed)


def model(run):
    return run.program["model"]


def release(run) -> None:
    run.program.clear()
    if run.on_card:
        torch.cuda.empty_cache()


def _reference(run, precision: str):
    """The reference follows the checked updates at ``precision``; returns
    (losses, the first update's gradients as Adam took them, the loss
    gradients' norms, the change norms, the first update's logits), keyed
    like the program's."""
    cfg, t, dev = run.cfg, run.traffic, run.device
    state = {k: v.to(dev) for k, v in run.data["state"].items()}
    m = ref.build(cfg, dev)
    m.load_state_dict(state, strict=True)
    ref.set_precision(m, precision)
    ref.set_draw_dtype(m, getattr(torch, cfg["compute_dtype"]))
    frozen = set(reftrain.frozen_names())
    params = {n: p for n, p in m.named_parameters() if n not in frozen}
    for n, p in m.named_parameters():
        p.requires_grad_(n not in frozen)
    opt = reftrain.Adam(params, cfg["lr"], cfg["weight_decay"])
    losses, taken, data, first = [], None, None, None
    for i in range(t["checked_steps"]):
        p = len(run.data["pool"])
        out = reftrain.train_update(
            m, opt, run.data["pool"][i % p].to(dev), run.data["labels"][i % p],
            seed=derive(run.seed, 23, i),
            jitter=torch.Generator(device=dev).manual_seed(derive(run.seed, 22, i)),
            mode=cfg["mode"], frame_chunk=t["frame_chunk"], accum_steps=cfg["accum_steps"],
            epoch=t["epoch"], max_epochs=cfg["epochs"], pos_weight=cfg["pos_weight"],
            remat=bool(cfg["remat"]))
        losses.append(out["loss"][0])
        if i == 0:
            taken = out["grads"]
            data = {k: float(v.float().norm()) for k, v in out["data"].items()}
            first = out["logits"].double().cpu()
    with torch.no_grad():
        change = {k: float((p - state[k]).norm()) for k, p in params.items()}
    return torch.stack(losses).double().cpu(), taken, data, change, first


def control_answers(run, precision: str):
    """The control's readings: the reference at ``precision`` in the
    program's place (after ``prepare``)."""
    losses, taken, _, change, first = _reference(run, precision)
    run.data.update(losses=losses, change_norms=change, logits_first=first,
                    grad_first={k: v.float().cpu() for k, v in taken.items()})
    return None


def _median(values: List[float]) -> float:
    return float(torch.tensor(values, dtype=torch.float64).median())


def counted_leaves(data: Dict[str, float]) -> List[str]:
    """The leaves the numbers count: those the mode uses (a nonzero
    gradient of the loss) whose reference gradient is at least a thousandth
    of the median used leaf's."""
    used = [k for k, v in data.items() if v > 0]
    floor = 1e-3 * _median([data[k] for k in used])
    return [k for k in used if data[k] >= floor]


@torch.no_grad()
def _grad_numbers(run, taken, moved) -> Dict[str, float]:
    got = run.data["grad_first"]
    rows = []
    for k in moved:
        want = taken[k].float()
        have = got[k].to(want.device).float()
        rows.append(torch.stack([want.norm(), have.norm(), (have - want).norm()]))
    want, have, gap = torch.stack(rows).double().cpu().unbind(1)
    den = want.clamp_min(float(want.median()))
    return {"grad_rel": float(gap.square().sum().sqrt() / want.square().sum().sqrt()),
            "grad_rel_median": float((gap / den).median()),
            "grad_gap": float(((have - want).abs() / den).max()),
            "grad_gap_median": float(((have - want).abs() / den).median())}


def check(run, answers=None) -> Dict[str, float]:
    losses, taken, data, change, first = _reference(run, "fp32")
    got_first = run.data["logits_first"]
    logit_rms = float((got_first - first).pow(2).mean().sqrt()) \
        if got_first.shape == first.shape else float("inf")     # answers missing
    got = run.data["losses"]
    rel = (got - losses).abs() / losses.abs().clamp_min(1e-3)
    moved = counted_leaves(data)
    med_c = _median([change[k] for k in moved])
    c = [abs(run.data["change_norms"][k] - change[k]) / max(change[k], med_c) for k in moved]
    run.data["compared"] = len(got)
    run.data["left_out"] = sorted(set(data) - set(moved))
    return {**_grad_numbers(run, taken, moved),
            "update_gap": max(c), "update_gap_median": _median(c),
            "logit_gap_first_rms": logit_rms,
            "loss_gap_first": float(rel[0]), "loss_gap": float(rel.max())}
