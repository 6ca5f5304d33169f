"""Screening: uint8 clips through ``InferenceEngine.predict_stream``.

A closed loop over a pool of distinct batches made from the seed: the engine
keeps the next batch dispatched before it collects the last (its own
pipelining). The window opens at the first dispatch and closes when the
first batch completes after ``--seconds``; every completed batch's real
frames count (a padded tail chunk's slots are not frames). The traced
window (``traced``) counts every batch it dispatched, all of which complete
inside it: the device's work there is theirs.

``correct``: every served probability of the sampled pool batches within
the window, on the logit scale, against the fp32 reference's logits of the
same clips from the same weights, as the numbers of ``check``; the cell
file says which are held to a limit (the rest ``benchmark/calibrate.py``
alone reads).

Traffic parameters: ``clips_per_batch``, ``frames_per_clip``,
``frame_chunk``, ``pool`` (distinct batches), ``traced_batches``.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.lib import inputs, program, weights
from benchmark.lib.common import derive
from benchmark.reference import model as ref

def _pool(run) -> List[np.ndarray]:
    t, size = run.traffic, run.cfg["image_size"]
    return [inputs.clips(t["clips_per_batch"], t["frames_per_clip"], size,
                         derive(run.seed, 10, i), run.device).cpu().numpy()
            for i in range(t["pool"])]


def _sampled(run) -> List[int]:
    """Pool batches whose answers are checked, drawn from the seed."""
    n = run.cell.limits["check"]["batches"]
    rng = np.random.default_rng(derive(run.seed, 11))
    return sorted(rng.choice(run.traffic["pool"], size=n, replace=False).tolist())


def prepare(run) -> None:
    """The benchmark's own inputs: the weights and the pool."""
    run.data["state"] = weights.make_state(run.cfg, run.seed, run.device)
    run.data["pool"] = _pool(run)
    run.data["sampled"] = _sampled(run)


def setup(run) -> None:
    prepare(run)
    cfg, t = run.cfg, run.traffic
    model = program.load_model(cfg, run.data["state"], t["frame_chunk"], run.device)
    run.data["state"] = {k: v.cpu() for k, v in run.data["state"].items()}
    run.reset_peak()             # from here on, the device holds the program's
    run.program["engine"] = eng = program.engine(model, cfg["mode"], t["frame_chunk"],
                                                 run.device)
    eng.warmup(t["clips_per_batch"], t["frames_per_clip"], cfg["image_size"])
    for _ in eng.predict_stream(run.data["pool"][:2]):
        pass
    run.sync()


def _serve(run, seconds: float, limit: int = 0):
    """Serve pool batches in turn until ``seconds`` have passed (or
    ``limit`` batches completed); returns (batches completed, batches
    dispatched, window s, answers of sampled batches by pool index,
    seconds from the start at which each batch completed)."""
    eng, pool = run.program["engine"], run.data["pool"]
    sampled = set(run.data["sampled"])
    answers: Dict[int, list] = {}
    dispatched = 0

    def batches():
        nonlocal dispatched
        while True:
            dispatched += 1          # the engine dispatches each batch it takes
            yield pool[(dispatched - 1) % len(pool)]

    stream = eng.predict_stream(batches())
    done, ends = 0, []
    t0 = time.perf_counter()
    run.window.setdefault("t0", t0)
    for probs in stream:
        if done % len(pool) in sampled:
            answers.setdefault(done % len(pool), []).append(probs)
        done += 1
        now = time.perf_counter()
        ends.append(now - t0)
        if (limit and done >= limit) or (not limit and now - t0 >= seconds):
            break
    stream.close()
    run.sync()           # the one batch dispatched after the close
    return done, dispatched, now - t0, answers, ends


def measure(run, seconds: float) -> None:
    done, _, elapsed, answers, ends = _serve(run, seconds)
    t = run.traffic
    run.window.update(units=done * t["clips_per_batch"],
                      frames=done * t["clips_per_batch"] * t["frames_per_clip"],
                      seconds=elapsed, answers=answers, ends=ends)


def checked(run) -> Dict[int, list]:
    """The answers of one pass over the pool, outside a window (the
    correctness readings of ``benchmark/calibrate.py``)."""
    return _serve(run, 0.0, limit=run.traffic["pool"])[3]


def traced(run) -> dict:
    """A short window for the profiler: ``traced_batches`` batches completed;
    its frames are those of every batch dispatched in it (one more), whose
    device work all lies inside it."""
    _, dispatched, elapsed, _, _ = _serve(run, 0.0, limit=run.traffic["traced_batches"])
    t = run.traffic
    return dict(frames=dispatched * t["clips_per_batch"] * t["frames_per_clip"],
                seconds=elapsed)


def chunk_input(run) -> torch.Tensor:
    """One full chunk of the cell's inputs, preprocessed as the engine does:
    ``[clips * frame_chunk, 3, S, S]`` in the compute dtype."""
    t, eng = run.traffic, run.program["engine"]
    clips = torch.from_numpy(run.data["pool"][0][:, :t["frame_chunk"]]).to(run.device)
    x = program.preprocess_eval(clips, eng.dtype)
    return x.reshape(-1, *x.shape[2:])


def model(run):
    return run.program["engine"].model


def release(run) -> None:
    run.program.clear()
    if run.on_card:
        torch.cuda.empty_cache()


def _logit(p: np.ndarray) -> np.ndarray:
    p = np.asarray(p, np.float64)
    return np.log(p) - np.log1p(-p)


def control_answers(run, precision: str) -> Dict[int, list]:
    """The control's answers for the sampled batches: the reference at
    ``precision`` in the program's place (after ``prepare``)."""
    cfg, t = run.cfg, run.traffic
    m = ref.build(cfg, run.device)
    m.load_state_dict(run.data["state"], strict=True)
    ref.set_precision(m.eval(), precision)
    out = {}
    for i in run.data["sampled"]:
        x = ref.preprocess(torch.from_numpy(run.data["pool"][i]).to(run.device))
        logits = ref.eval_video_forward(m, x, cfg["mode"], t["frame_chunk"])["logits"]
        out[i] = [torch.sigmoid(logits.double())[:, 0].cpu().numpy()]
    return out


def check(run, answers: Dict[int, list]) -> Dict[str, float]:
    """``logit_gap``: the largest |logit(served) - reference logit| over every
    answer of the sampled batches (a missing batch is an infinite gap);
    ``logit_gap_rms``: their root mean square; ``logit_gap_rel``: that over
    the reference logits' standard deviation across the clips;
    ``logit_gap_halves``: that over the root mean square, across the clips,
    of the reference's logit on a clip's first half of frames less that on
    its second half (how far the answer moves with the frames seen)."""
    cfg, t = run.cfg, run.traffic
    m = ref.build(cfg, run.device)
    m.load_state_dict({k: v.to(run.device) for k, v in run.data["state"].items()},
                      strict=True)
    ref.set_precision(m.eval(), "fp32")

    def logits(x):
        return ref.eval_video_forward(m, x, cfg["mode"], t["frame_chunk"])[
            "logits"].double()[:, 0].cpu().numpy()

    gap = 0.0
    run.data["clip_gaps"] = gaps = []
    wanted, halves = [], []
    for i in run.data["sampled"]:
        x = ref.preprocess(torch.from_numpy(run.data["pool"][i]).to(run.device))
        want = logits(x)
        k = x.shape[1] // 2
        halves.append(logits(x[:, :k]) - logits(x[:, k:]))
        wanted.append(want)
        for a in answers.get(i) or [np.full_like(want, np.nan)]:     # none came: inf
            a = np.asarray(a)
            d = np.abs(_logit(a) - want) if a.shape == want.shape else np.full_like(want, np.inf)
            d = np.where(np.isfinite(d), d, np.inf)
            gap = max(gap, float(d.max()))
            gaps.append(d)
    run.data["compared"] = sum(len(a) for i in run.data["sampled"] for a in answers.get(i, []))
    rms = float(np.sqrt(np.mean(np.concatenate(gaps) ** 2)))
    moves = float(np.sqrt(np.mean(np.concatenate(halves) ** 2)))
    return {"logit_gap": gap, "logit_gap_rms": rms,
            "logit_gap_rel": rms / max(float(np.std(np.concatenate(wanted))), 1e-12),
            "logit_gap_halves": rms / max(moves, 1e-12)}
