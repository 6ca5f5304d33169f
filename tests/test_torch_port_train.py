"""The port's train step held against the JAX package on the CPU (fp32).

Micro width as in ``test_torch_port_model.py`` (its ``_fill``, ``_sub`` and
``SE_S1``: K2 engages at k3 in V2-S; ``dama_dim`` 128 with 4 heads: K4's gate
passes), B = 2 clips of K = 5 frames, ``frame_chunk`` 2 (chunks of 2, 2 and a
true ragged tail of 1 frame). Dropout and stochastic depth are neutralised on
both sides for the comparisons with JAX: there ``ArchConfig`` dropout 0 and
``flax.linen.Dropout.__call__`` and ``efficientnet._stochastic_depth``
patched to the identity while the JAX functions are traced; in the port
every rate set to 0 (:func:`no_dropout`). The port runs with all four kernel
flags on (their plain versions on the CPU) and remat on; JAX with remat off
(the same math, a cheaper compile).

- ``sfe_only`` and ``sfe_mwt``: ``jax.value_and_grad(_loss_fn, has_aux=True)``
  (``train=True``) against the port's ``video_forward`` + ``combined_loss`` +
  backward.
- ``dynamic``: one whole ``train_step`` (``accum_steps`` 2, so micro-batches
  of 2 clips) against JAX's ``train_step``, whose optimizer is wrapped to
  keep the gradients it was given (the mean of ``value_and_grad(_loss_fn)``
  over the micro-batches), so one compile gives the losses, predictions,
  gradients, running statistics and updated parameters.

Tolerances: losses and predictions 1e-5; BN running statistics 1e-5; a
gradient within 1e-4 of its tensor's max abs, with two floors that fp32
forces (:func:`_grad_tol`: the rounding residue of a gradient that is 0 in
exact arithmetic, and the digits that the JAX package's ``E[x^2] - E[x]^2``
BN variance loses on the ragged tail's 2-row BNs); updated parameters
1e-6 + 1e-2 * lr where |JAX grad| exceeds 1e-3 of its tensor's max abs and
100 times its tolerance, else 2 * lr (Adam's first step is about
``lr * sign(g)``, and on a gradient at noise level the sign is noise). A
ReLU input within rounding of 0 may sit on the other side of its kink in
JAX's compiled program; the comparison then takes it across in the port
(:func:`_check_against_jax`) and says so.
"""

import concurrent.futures
import contextlib
import dataclasses
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from ewvit_tpu.configs import ModelConfig as JaxConfig
from ewvit_tpu.models import efficientnet as je
from ewvit_tpu.models.detector import init_detector_fast
from ewvit_tpu.ops.preprocess import color_jitter
from ewvit_tpu.train import optimizer as jopt
from ewvit_tpu.train.steps import _loss_fn, create_train_state
from ewvit_tpu.train.steps import train_step as jax_train_step
from ewvit_tpu_torch import configs as pc
from ewvit_tpu_torch.models.detector import build_detector, video_forward
from ewvit_tpu_torch.models.efficientnet import (
    EfficientNetB0,
    EfficientNetV2S,
    stochastic_depth,
)
from ewvit_tpu_torch.ops import extension
from ewvit_tpu_torch.ops.haar import haar_dwt2d
from ewvit_tpu_torch.ops.preprocess import apply_jitter, preprocess_batch
from ewvit_tpu_torch.train.losses import combined_loss, weighted_bce_with_logits
from ewvit_tpu_torch.train.optimizer import (
    cosine_annealing_schedule,
    detector_frozen_names,
    make_optimizer,
)
from ewvit_tpu_torch.train.steps import train_step
from ewvit_tpu_torch.utils.convert import jax_to_state_dict

from test_torch_port_model import SE_S1, _fill

B, K, CHUNK, ACCUM = 2, 5, 2, 2
POS_WEIGHT, EPOCH, MAX_EPOCHS = 2.0, 5, 10       # orth lambda 0.6
LR, WD, EPOCHS, STEPS_PER_EPOCH = 1e-3, 1e-4, 3, 2
FLAGS = dict(dama_dim=128, num_heads=4, use_pallas_dwse=True, use_pallas_dama=True)
ALL_FLAGS = dict(use_pallas_dwt=True, use_fused_mwt_tail=True, **FLAGS)
OFF = dict(use_pallas_dwt=False, use_fused_mwt_tail=False, use_pallas_dwse=False,
           use_pallas_dama=False)

_jbase = JaxConfig.micro()
JCFG = _jbase.replace(
    arch=dataclasses.replace(_jbase.arch, dropout=0.0, emb_dropout=0.0),
    backbone_spec=(je.B0_MICRO, je.BackboneSpec(
        je.V2S_MICRO.blocks + (je.BlockCfg(**SE_S1),), stem_ch=8, head_ch=32)),
    **FLAGS)
PCFG = pc.ModelConfig.micro().replace(
    backbone_spec=(pc.B0_MICRO, pc.BackboneSpec(
        pc.V2S_MICRO.blocks + (pc.BlockCfg(**SE_S1),), stem_ch=8, head_ch=32)),
    **ALL_FLAGS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: the suite runs in
    several worker processes that share the cores, and torch's default of
    one OpenMP thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def no_dropout(model: nn.Module) -> nn.Module:
    """Every dropout and stochastic-depth rate of ``model`` to 0."""
    for m in model.modules():
        if isinstance(m, nn.Dropout):
            m.p = 0.0
        if hasattr(m, "drop_rate"):
            m.drop_rate = 0.0
    return model


def _np(t):
    return t.detach().numpy()


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _keeps_grads(tx):
    """``tx`` that also keeps the gradients of its last update in its state
    (its init jitted: one compile is quicker than the init's ops one by one)."""
    @jax.jit
    def init(params):
        return tx.init(params), jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def data():
    g = np.random.default_rng(2)
    x = g.standard_normal((ACCUM * B, K, 32, 32, 3)).astype(np.float32)
    labels = np.array([1.0, 0.0, 0.0, 1.0], np.float32)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 1, 4, 2, 3)))
    return x, labels, xt, torch.from_numpy(labels)


@pytest.fixture(scope="module")
def jax_vars():
    jmodel, shapes = init_detector_fast(JCFG, seed=0)
    return jmodel, _fill(shapes, seed=1)


def _start(pool, jitted, *args, static=(), **kwargs):
    """Trace and lower ``jitted(*args, **kwargs)`` here, and compile it at
    XLA:CPU backend optimisation level 1 (a quarter less compile time than
    the default, the same HLO) in ``pool``: XLA releases the GIL while it
    compiles, so the next program traces meanwhile. ``static`` names the
    static keyword arguments. Returns the future of a function that runs the
    compiled program on ``args`` (or on the arguments it is given)."""
    lowered = jitted.lower(*args, **kwargs)
    dynamic = {k: v for k, v in kwargs.items() if k not in static}

    def compiled():
        run = lowered.compile({"xla_backend_optimization_level": 1})
        return lambda *a: run(*(a or args), **dynamic)

    return pool.submit(compiled)


def _jax_references(pool, jmodel, jvars, x, labels):
    """Every JAX program the comparisons need, each traced once with dropout
    and stochastic depth patched out, and compiled in ``pool`` (the shortest
    compile first: the optimizer test comes first): name -> future of a
    function that runs it."""
    loss_kw = dict(frame_chunk=CHUNK, pos_weight=POS_WEIGHT, epoch=EPOCH,
                   max_epochs=MAX_EPOCHS, train=True, remat=False)
    opt_kw = dict(lr=LR, weight_decay=WD, epochs=EPOCHS, steps_per_epoch=STEPS_PER_EPOCH)
    tx = jopt.make_optimizer(jvars["params"], **opt_kw)

    def update(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    pending = {"update": _start(pool, jax.jit(update), jvars["params"],
                                jax.jit(tx.init)(jvars["params"]), jvars["params"])}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", lambda self, y, *a, **kw: y)
        mp.setattr(je, "_stochastic_depth", lambda y, rate, det, rng: y)
        tx = _keeps_grads(jopt.make_optimizer(jvars["params"], **opt_kw))
        state, _ = create_train_state(jvars, tx)
        pending["dynamic"] = _start(
            pool, jax_train_step, state, x, labels, jax.random.PRNGKey(0), model=jmodel,
            tx=tx, mode="dynamic", frame_chunk=CHUNK, accum_steps=ACCUM,
            pos_weight=POS_WEIGHT, epoch=EPOCH, max_epochs=MAX_EPOCHS, remat=False,
            static=("model", "tx", "mode", "frame_chunk", "accum_steps", "remat"))
        for mode in ("sfe_mwt", "sfe_only"):
            grad_fn = jax.jit(lambda p, bs, fr, lb, m=mode: jax.value_and_grad(
                _loss_fn, has_aux=True)(p, bs, jmodel, fr, lb, mode=m,
                                        rng=jax.random.PRNGKey(0), **loss_kw))
            pending[mode] = _start(pool, grad_fn, jvars["params"], jvars["batch_stats"],
                                   x[:B], labels[:B])
    return pending


@pytest.fixture(scope="module")
def jax_programs(jax_vars, data):
    """The JAX programs, compiling in the background while the tests that
    need none of them run."""
    x, labels, _, _ = data
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        yield _jax_references(pool, *jax_vars, x, labels)


def _jax_run(jax_programs, mode):
    """The results of ``mode``'s JAX program: losses, predictions, running
    statistics and gradients (and, for ``dynamic``, the updated
    parameters)."""
    result = jax_programs[mode].result()()
    if mode == "dynamic":
        new, metrics = result
        return dict(loss=metrics["loss"], preds=np.asarray(metrics["preds"]),
                    parts={k: metrics[k] for k in ("cls_loss", "orth_loss")},
                    stats=_tree_np(new.batch_stats), grads=_tree_np(new.opt_state[1]),
                    params=_tree_np(new.params))
    (loss, (stats, parts, preds)), grads = result
    return dict(loss=loss, parts=_tree_np(parts), preds=np.asarray(preds),
                stats=_tree_np(stats), grads=_tree_np(grads))


def _port(jvars, **flags):
    model = build_detector(PCFG.replace(**flags), device="cpu", seed=0)
    model.load_state_dict(jax_to_state_dict(jvars, PCFG), strict=True)
    return no_dropout(model)


def _jax_variance_bn(x, running_mean, running_var, weight, bias, training, momentum, eps):
    """``F.batch_norm`` with the JAX package's train-mode statistics
    (ewvit_tpu/models/norm.py:74-85): fp32 mean and variance as
    ``max(0, E[x^2] - E[x]^2)``, the running variance moved with the
    unbiased one."""
    assert training
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
    n = x.numel() // x.shape[1]
    with torch.no_grad():
        running_mean.mul_(1 - momentum).add_(momentum * mean)
        running_var.mul_(1 - momentum).add_(momentum * var * n / (n - 1))
    y = (xf - mean[:, None, None]) * torch.rsqrt(var + eps)[:, None, None]
    return (y * weight[:, None, None] + bias[:, None, None]).to(x.dtype)


def _jax_variance_grads(jvars, run):
    """The port's gradients from ``run(model)`` with every BN taking its
    statistics the JAX package's way."""
    model = _port(jvars, **OFF)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.nn.modules.batchnorm.F, "batch_norm", _jax_variance_bn)
        run(model)
    return {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}


def _grad_tol(want, model, g_jaxvar):
    """Per tensor, the largest of:

    - 1e-4 of its max abs;
    - 1e-6 of the largest gradient in the model: a gradient that is 0 in
      exact arithmetic (a conv bias feeding a train-mode BN, which removes
      it) comes out of both as fp32 residue of sums at the model's scale;
    - 4 times the distance between the port's gradient and the same port's
      with the JAX package's BN statistics (:func:`_jax_variance_bn`): the
      JAX package's ``E[x^2] - E[x]^2`` cancels digits where a BN sees few
      rows. The ragged tail chunk of B*1 = 2 rows does that: 1.3e-4 of
      max abs in ``dynamic`` (5e-6 without the tail chunk)."""
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    top = max(float(want[n].abs().max()) for n in names)
    tol = {}
    for n in names:
        p = model.get_parameter(n)
        err = 0.0
        if n in g_jaxvar and p.grad is not None:
            err = float((p.grad - g_jaxvar[n]).abs().max())
        tol[n] = max(1e-4 * float(want[n].abs().max()), 1e-6 * top, 4 * err)
    return tol


def _mismatches(model, ref, g_jaxvar, loss, parts, preds):
    """Names of the outputs, gradients and running statistics outside their
    tolerances (frozen tensors excluded: JAX differentiates them, optax
    zeroes their update)."""
    bad = [k for k, got, w, tol in (
        ("loss", loss, ref["loss"], 1e-5),
        ("cls_loss", parts["cls_loss"], ref["parts"]["cls_loss"], 1e-5),
        ("orth_loss", parts["orth_loss"], ref["parts"]["orth_loss"], 1e-5),
        ("preds", preds, ref["preds"], 1e-5))
        if not np.allclose(_np(torch.as_tensor(got)).reshape(-1),
                           np.asarray(w).reshape(-1), atol=tol, rtol=0)]
    want = jax_to_state_dict({"params": ref["grads"], "batch_stats": ref["stats"]}, PCFG)
    for name, tol in _grad_tol(want, model, g_jaxvar).items():
        p = model.get_parameter(name)
        got = _np(p.grad) if p.grad is not None else np.zeros(p.shape, np.float32)
        if np.abs(got - want[name].numpy()).max() > tol:
            bad.append(name)
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")) and \
                np.abs(_np(buf) - want[name].numpy()).max() > 1e-5:
            bad.append(name)
    return bad


@contextlib.contextmanager
def _relu_hooks(model, hook):
    handles = [m.register_forward_hook(functools.partial(hook, name))
               for name, m in model.named_modules() if isinstance(m, nn.ReLU)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def _near_kinks(model, run):
    """``run()`` with every ReLU input element within 1e-6 of 0 recorded as
    (module, shape, flat index, value)."""
    near = set()

    def probe(name, mod, inp, out):
        x = inp[0].detach().reshape(-1)
        for i in (x.abs() < 1e-6).nonzero().reshape(-1).tolist():
            near.add((name, tuple(inp[0].shape), i, float(x[i])))

    with _relu_hooks(model, probe):
        result = run()
    return result, sorted(near)


def _flipped(model, kink, run):
    """``run()`` with the ReLU element ``kink`` taken to the other side of its
    kink: its output moves by less than 1e-6, its gradient from 0 to 1 or
    from 1 to 0."""
    name, shape, index, value = kink

    def flip(n, mod, inp, out):
        x = inp[0]
        if n != name or tuple(x.shape) != shape or float(x.reshape(-1)[index]) != value:
            return None
        mask = torch.zeros(x.numel(), dtype=torch.bool)
        mask[index] = True
        mask = mask.reshape(x.shape)
        return torch.where(mask, torch.where(x > 0, x * 0, x), out)

    with _relu_hooks(model, flip):
        return run()


def _check_against_jax(make, run, ref, g_jaxvar):
    """Run the port (``run(model)`` -> model, loss, parts, preds) on a fresh
    ``make()`` and hold it to JAX. A ReLU input within rounding of 0 may fall
    on the other side of the kink in JAX's compiled program (whose BN takes
    the variance as E[x^2] - E[x]^2): if the port as it is disagrees, each
    such element is taken to the other side in turn, and one of these runs
    must agree everywhere. Returns the agreeing run and the element flipped
    (or None)."""
    model = make()
    result, near = _near_kinks(model, lambda: run(model))
    bad = _mismatches(result[0], ref, g_jaxvar, *result[1:])
    if not bad:
        return result, None
    for kink in near:
        model = make()
        flipped = _flipped(model, kink, lambda: run(model))
        if not _mismatches(flipped[0], ref, g_jaxvar, *flipped[1:]):
            print(f"agrees with JAX with the ReLU input at {kink} on the other side")
            return flipped, kink
    raise AssertionError(f"outside tolerance: {bad} (ReLU inputs within 1e-6 of 0: {near})")


def _step(model, xt, lt, seed=0, **kw):
    opt = make_optimizer(model, lr=LR, weight_decay=WD, epochs=EPOCHS,
                         steps_per_epoch=STEPS_PER_EPOCH)
    before = dict(extension.LAUNCHES)
    m = train_step(model, opt, xt, lt, seed=seed, mode="dynamic", frame_chunk=CHUNK,
                   accum_steps=ACCUM, pos_weight=POS_WEIGHT, epoch=EPOCH,
                   max_epochs=MAX_EPOCHS, **kw)
    assert extension.LAUNCHES == before      # CPU tensors launch nothing
    return m, opt


def test_optimizer_matches_optax(jax_programs, jax_vars):
    """3 updates across an epoch boundary from the same numpy gradients:
    the lr of each update and the parameters after each."""
    jvars = jax_vars[1]
    tx = jopt.make_optimizer(jvars["params"], lr=LR, weight_decay=WD, epochs=EPOCHS,
                             steps_per_epoch=STEPS_PER_EPOCH)
    update = jax_programs["update"].result()
    schedule = jopt.cosine_annealing_schedule(LR, EPOCHS, STEPS_PER_EPOCH)
    params, opt_state = jvars["params"], jax.jit(tx.init)(jvars["params"])

    model = _port(jvars)
    opt = make_optimizer(model, lr=LR, weight_decay=WD, epochs=EPOCHS,
                         steps_per_epoch=STEPS_PER_EPOCH)
    named = dict(model.named_parameters())
    rng = np.random.default_rng(7)
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32) * 1e-2, params)
        params, opt_state = update(grads, opt_state, params)
        g_sd = jax_to_state_dict({"params": grads, "batch_stats": jvars["batch_stats"]}, PCFG)
        for name, p in named.items():
            p.grad = g_sd[name] if p.requires_grad else None
        opt.step()
        lr = opt.param_groups[0]["lr"]
        np.testing.assert_allclose(lr, float(schedule(step)), rtol=1e-9, atol=0)
        want = jax_to_state_dict({"params": _tree_np(params),
                                  "batch_stats": jvars["batch_stats"]}, PCFG)
        for name, p in named.items():
            np.testing.assert_allclose(_np(p), want[name].numpy(), atol=1e-6, rtol=0,
                                       err_msg=f"step {step}: {name}")
    assert opt.param_groups[0]["count"] == 3


def test_frozen_names_match_jax_paths(jax_vars):
    """Leaves numbered 1..n, converted: the names holding the frozen paths'
    numbers are the port's frozen names, in the same order."""
    jvars = jax_vars[1]
    params = jvars["params"]
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    ids = {tuple(k.key for k in path): i + 1 for i, (path, _) in enumerate(leaves)}
    numbered = jax.tree_util.tree_unflatten(
        treedef, [np.full(leaf.shape, i + 1, np.float32) for i, (_, leaf) in enumerate(leaves)])
    sd = jax_to_state_dict({"params": numbered, "batch_stats": jvars["batch_stats"]}, PCFG)
    by_id = {int(v.reshape(-1)[0]): k for k, v in sd.items()
             if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    assert [by_id[ids[p]] for p in jopt.detector_frozen_paths()] == detector_frozen_names()
    model = _port(jvars)
    opt = make_optimizer(model)
    in_opt = {id(p) for g in opt.param_groups for p in g["params"]}
    for name, p in model.named_parameters():
        frozen = name in detector_frozen_names()
        assert p.requires_grad is not frozen and (id(p) in in_opt) is not frozen, name


def test_remat_and_seed(data):
    """With dropout and stochastic depth on: remat on and off give the same
    loss, gradients and running statistics; the same seed gives the same
    step bit for bit, another seed another loss."""
    _, _, xt, lt = data
    runs = {}
    for key, kw in (("remat", dict(remat=True)), ("plain", dict(remat=False)),
                    ("again", dict(remat=True)), ("other", dict(remat=True, seed=1))):
        model = build_detector(PCFG, device="cpu", seed=3)
        m, _ = _step(model, xt, lt, **kw)
        runs[key] = (m, {n: p.grad.clone() for n, p in model.named_parameters()
                         if p.grad is not None}, model.state_dict())
    (m1, g1, s1), (m2, g2, s2) = runs["remat"], runs["plain"]
    torch.testing.assert_close(m1["loss"], m2["loss"], atol=1e-6, rtol=0)
    assert g1.keys() == g2.keys()
    for n in g1:
        torch.testing.assert_close(g1[n], g2[n], atol=1e-6, rtol=0, msg=n)
    for n in s1:
        if n.endswith(("running_mean", "running_var", "num_batches_tracked")):
            torch.testing.assert_close(s1[n], s2[n], atol=1e-6, rtol=0, msg=n)
    m3, g3, s3 = runs["again"]
    assert all(torch.equal(m1[k], m3[k]) for k in m1)
    assert all(torch.equal(g1[n], g3[n]) for n in g1)
    assert all(torch.equal(s1[n], s3[n]) for n in s1)
    assert not torch.equal(runs["other"][0]["loss"], m1["loss"])


@pytest.mark.parametrize("backbone", [EfficientNetV2S, EfficientNetB0])
def test_stochastic_depth_rates(backbone):
    """0.2 * idx / total, idx flat over the full backbone's blocks."""
    with torch.device("meta"):
        net = backbone()
    blocks = [m for m in net.modules() if hasattr(m, "drop_rate")]
    assert len(blocks) == {EfficientNetV2S: 40, EfficientNetB0: 16}[backbone]
    assert [b.drop_rate for b in blocks] == [0.2 * i / len(blocks) for i in range(len(blocks))]


def test_stochastic_depth_rows():
    x = torch.randn(64, 4, 3, 3, generator=torch.Generator().manual_seed(0))
    with torch.random.fork_rng():
        torch.manual_seed(0)
        y = stochastic_depth(x, 0.25, training=True)
    dropped = (y == 0).flatten(1).all(dim=1)
    assert 0 < int(dropped.sum()) < 64
    for i in range(64):
        assert torch.equal(y[i], torch.zeros_like(x[i]) if dropped[i] else x[i] / 0.75)
    assert stochastic_depth(x, 0.25, training=False) is x


def test_color_jitter_matches_jax():
    """JAX's own draws (keys split as in preprocess.py:52-57) through the
    port's deterministic apply."""
    x = np.random.default_rng(4).uniform(0, 1, (2, 3, 16, 16, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(5)
    kb, kc, ko = jax.random.split(rng, 3)
    shape = x.shape[:-3]
    bf = jax.random.uniform(kb, shape, minval=0.99, maxval=1.01)
    cf = jax.random.uniform(kc, shape, minval=0.99, maxval=1.01)
    order = jax.random.bernoulli(ko, 0.5, shape)
    want = np.asarray(color_jitter(jnp.asarray(x), rng))
    got = apply_jitter(torch.from_numpy(x.transpose(0, 1, 4, 2, 3).copy()),
                       *(torch.from_numpy(np.array(t)) for t in (bf, cf, order)))
    np.testing.assert_allclose(_np(got).transpose(0, 1, 3, 4, 2), want, atol=1e-6, rtol=0)

    clips = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (2, 3, 16, 16, 3),
                                                               dtype=np.uint8))
    plain = preprocess_batch(clips, torch.float32)
    a = preprocess_batch(clips, torch.float32, train=True,
                         generator=torch.Generator().manual_seed(0))
    b = preprocess_batch(clips, torch.float32, train=True,
                         generator=torch.Generator().manual_seed(0))
    assert a.shape == plain.shape == (2, 3, 3, 16, 16) and torch.equal(a, b)
    assert 0 < float((a - plain).abs().max()) < 0.2
    with pytest.raises(ValueError):
        preprocess_batch(clips, train=True)


@pytest.mark.parametrize("flag", ["use_pallas_dwse", "use_fused_mwt_tail", "use_pallas_dama"])
def test_kernel_paths_refuse_autograd(flag):
    """An eval forward with grad enabled through K2, K3 or K4 raises and
    names the flag (it used to leave 28 DAMA parameters without a gradient,
    silently); under no_grad and in train mode it runs."""
    cfg = PCFG.replace(**OFF).replace(**{flag: True, "use_pallas_dwt": True})
    model = build_detector(cfg, device="cpu", seed=0)
    x = torch.randn(4, 3, 32, 32)
    with pytest.raises(RuntimeError, match=flag):
        model(x, "dynamic")
    with torch.no_grad():
        model(x, "dynamic")
    out = model.train()(x, "dynamic")
    out["fused"].sum().backward()
    missing = [n for n, p in model.dama.named_parameters() if p.grad is None]
    assert missing and all(n.startswith("sfe.mlp_head.") for n in missing), missing


def test_haar_refuses_autograd():
    x = torch.randn(2, 3, 8, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="use_pallas_dwt"):
        haar_dwt2d(x)
    with torch.no_grad():
        haar_dwt2d(x)
    haar_dwt2d(x.detach())


@pytest.mark.parametrize("mode", ["sfe_only", "sfe_mwt"])
def test_loss_grads_and_running_stats_match_jax(jax_programs, jax_vars, data, mode):
    _, _, xt, lt = data
    crit = functools.partial(weighted_bce_with_logits, pos_weight=POS_WEIGHT)

    def run(model):
        out = video_forward(model.train(), xt[:B], mode=mode, frame_chunk=CHUNK, seed=0,
                            remat=True)
        loss, parts = combined_loss(out, lt[:B], crit, EPOCH, MAX_EPOCHS)
        loss.backward()
        return model, loss, parts, torch.sigmoid(out["logits"])

    jvars = jax_vars[1]
    _check_against_jax(lambda: _port(jvars, **ALL_FLAGS), run,
                       _jax_run(jax_programs, mode), _jax_variance_grads(jvars, run))


def test_dynamic_train_step_matches_jax(jax_programs, jax_vars, data):
    """accum_steps 2 with the ragged tail: losses, predictions, mean
    gradients, running statistics and the updated parameters (frozen ones
    unchanged, every other one moved as JAX's Adam moves it); then the same
    step with the kernel flags off is bit for bit the same (train mode
    routes around K2, K3 and K4; K1's plain version on the CPU)."""
    _, _, xt, lt = data
    ref, jvars = _jax_run(jax_programs, "dynamic"), jax_vars[1]
    start = _port(jvars).state_dict()
    steps = []

    def run(model):
        m, opt = _step(model, xt, lt)
        steps.append((model, m, opt))
        return model, m["loss"], m, m["preds"]

    g_jaxvar = _jax_variance_grads(jvars, lambda model: _step(model, xt, lt))
    (model, _, m, _), _ = _check_against_jax(lambda: _port(jvars, **ALL_FLAGS), run, ref,
                                             g_jaxvar)
    opt = steps[-1][2]
    assert opt.param_groups[0]["lr"] == cosine_annealing_schedule(LR, EPOCHS, STEPS_PER_EPOCH)(0)

    want = jax_to_state_dict({"params": ref["grads"], "batch_stats": ref["stats"]}, PCFG)
    new = jax_to_state_dict({"params": ref["params"], "batch_stats": ref["stats"]}, PCFG)
    frozen = set(detector_frozen_names())
    grad_tol = _grad_tol(want, model, g_jaxvar)
    worst = 0.0
    for name, p in model.named_parameters():
        got, w, g = _np(p), new[name].numpy(), want[name].numpy()
        if name in frozen:
            np.testing.assert_array_equal(got, start[name].numpy(), err_msg=name)
            np.testing.assert_array_equal(w, start[name].numpy(), err_msg=name)
            continue
        # signal: above 1e-3 of the tensor's max abs and 100 times the
        # gradient's own tolerance, so Adam's step sees it within 1%
        signal = (np.abs(g) > 1e-3 * np.abs(g).max()) & (np.abs(g) > 100 * grad_tol[name])
        tol = np.where(signal, 1e-6 + 1e-2 * LR, 2 * LR)
        diff = np.abs(got - w)
        assert (diff <= tol).all(), (name, float(diff.max()))
        worst = max(worst, float(diff[signal].max()) if signal.any() else 0.0)
        if not name.startswith("dama.") and np.abs(start[name].numpy()).max() > 0:
            assert not np.array_equal(got, start[name].numpy()), f"{name} did not move"
    print(f"largest parameter difference from JAX where the gradient is signal: {worst:.3e}")

    kernels, m_kernels, _ = steps[0]          # the run with nothing flipped
    plain = _port(jvars, **OFF)
    m2, _ = _step(plain, xt, lt)
    for k in ("loss", "cls_loss", "orth_loss", "preds"):
        assert torch.equal(m_kernels[k], m2[k]), k
    sd, sd2 = kernels.state_dict(), plain.state_dict()
    for k in sd:
        assert torch.equal(sd[k], sd2[k]), k
