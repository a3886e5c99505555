"""The port's Trainer against the JAX package's, on the CPU, in float32.

Weights go from the JAX Trainer to the port through
``models.convert.state_dict_from_jax_variables``; the same batch then
runs through both. The exact side is the JAX package's own code in
float64: its ``UNet3D`` and ``Trainer`` train step under ``jax_enable_x64``
with the ``float32`` its modules name outright (BatchNorm's statistics,
the loss's cast) read as ``float64``. That removes the cancellation of
the JAX BatchNorm's ``E[x^2] - E[x]^2`` variance, which puts the JAX
float32 gradients up to ~3e-2 of a tensor's max from float64 on these
batches. Tolerances, the port against the JAX package:

* the loss: relative <= 1e-5 of the float32 JAX Trainer's;
* gradients, per tensor: max-abs difference <= 1e-4 x that tensor's
  max-abs float64 gradient. The batches are seeded ones whose float32
  gradients have no rounding-made routing decision: on about half of
  the seeded batches tried, a max-pool's two largest inputs (or a
  LeakyReLU input and 0) lie within float32 rounding of each other, and
  both float32 packages then lie 1e-3 to 2e-1 of a tensor's max from
  float64 (float64 moved by 1e-7 of its input moves as far);
* the conv biases that feed a train-mode BatchNorm: BatchNorm removes a
  bias, so their true gradient is zero and what is computed is rounding
  noise. The port's and the float32 JAX Trainer's gradients there are
  <= 1e-6 x the largest gradient, and both first steps <= lr plus the
  weight-decay term;
* parameters after AdamW: within 1e-6 of what the JAX package's AdamW
  (``Trainer.tx``) makes of the port's own gradients from the same
  state, every element; and within 1e-5 of the float64 JAX step's.
  Adam's first step is ~lr * sign(g), so where the float64 gradient lies
  within the gradient tolerance of zero (Adam's first moment, in later
  steps) the rule leaves the sign open, and there the allowance is what
  AdamW makes of a gradient within that tolerance, at most ~2 lr. That
  is ~28% of the elements at 16^3 (most gradients of a tensor lie far
  below its largest); ~50 of 810603 do differ by more than 1e-5;
* train-mode forward: logits max-abs <= 3e-5 and MAE <= 5e-6 of float64
  (the port's
  float32 logits, up to ~4 in size, lie 0.9e-5 to 2.1e-5 from float64
  on 20 seeded batches, 16^3-32^3, batch 2-8: float32 rounding over 23
  layers; the JAX float32 logits lie 3e-5 to 1.3e-4); running mean and
  variance rtol 1e-5 / atol 1e-7;
* AdamW alone, three steps of the same gradients: params within 1e-6;
* the deterministic parts (schedule, metrics, targets) exactly, the
  schedule within 1e-7.

One JAX Trainer (``accumulate_grads_quirk=True``, whose first step equals
a plain step) is built per module, so JAX's CPU compile is paid once;
so is its float64 step. Figures print as ``{"parity": ...}`` lines
(``pytest -s``).
"""

import glob
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aind_exaspim_neuron_segmentation_tpu.machine_learning import (
    train as jtrain,
)
from aind_exaspim_neuron_segmentation_tpu.models import convert as jconvert
from aind_exaspim_neuron_segmentation_tpu.models import unet3d as junet
from aind_exaspim_neuron_segmentation_tpu_torch import inference
from aind_exaspim_neuron_segmentation_tpu_torch.machine_learning import (
    data_handling as dh,
)
from aind_exaspim_neuron_segmentation_tpu_torch.machine_learning import (
    train,
)
from aind_exaspim_neuron_segmentation_tpu_torch.models import convert
from aind_exaspim_neuron_segmentation_tpu_torch.models.unet3d import UNet3D
from tests.test_torch_gpu import box_batch, parity_line, pre_bn_bias

torch.set_num_threads(2)

WIDTH = 0.25
LR = 1e-3
SHAPE = (16, 16, 16)
STATE = ("params", "batch_stats", "opt_state", "grad_accum")


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jnp_tree(tree):
    return jax.tree.map(jnp.array, tree)


def _f64_tree(tree):
    return jax.tree.map(
        lambda a: jnp.asarray(a, jnp.float64)
        if np.issubdtype(np.asarray(a).dtype, np.floating) else jnp.asarray(a),
        tree)


class _Float64Numpy:
    """``jax.numpy`` with ``float32`` read as ``float64``."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def jax_float64():
    """A context in which the JAX package's ``UNet3D`` and train step
    compute in float64 (x64 on, their modules' ``float32`` -> float64)."""
    import contextlib

    stack = contextlib.ExitStack()
    stack.enter_context(jax.enable_x64(True))
    mp = stack.enter_context(pytest.MonkeyPatch.context())
    for module in (junet, jtrain):
        mp.setattr(module, "jnp", _Float64Numpy())
    return stack


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    """(JAX Trainer, its initial state as numpy trees, the float64 JAX
    module and train step). The module init is jitted here: eager, it
    compiles op by op for tens of seconds."""
    orig = junet.UNet3D.init

    def jitted_init(self, key, x, train=False):
        return jax.jit(lambda k, v: orig(self, k, v, train=train))(key, x)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(junet.UNet3D, "init", jitted_init)
        jt = jtrain.Trainer(
            str(tmp_path_factory.mktemp("jax_train")), batch_size=2,
            width_multiplier=WIDTH, use_amp=False, device_augment=False,
            accumulate_grads_quirk=True, prefetch=False,
        )
    init = {k: _np_tree(getattr(jt, k)) for k in STATE}
    module64 = junet.UNet3D(output_channels=3, width_multiplier=WIDTH,
                            dtype=jnp.float64)
    step64 = jtrain.Trainer._build_train_step(types.SimpleNamespace(
        module=module64, tx=jt.tx, accumulate_grads_quirk=True,
        device_augment=False, affinity_mode=True,
        _targets_from_labels=jtrain.Trainer._targets_from_labels))
    return types.SimpleNamespace(jt=jt, init=init, module64=module64,
                                 step64=step64)


def _ndhwc(a):
    return jnp.asarray(np.moveaxis(a, 1, -1))


def port_trainer(tmp_path, variables=None, **kw):
    """A CPU port Trainer (width 0.25, batch 2), with the JAX variables'
    weights when given."""
    kw = dict(dict(batch_size=2, width_multiplier=WIDTH, prefetch=False,
                   device="cpu"), **kw)
    tr = train.Trainer(str(tmp_path), **kw)
    if variables is not None:
        tr.model.load_state_dict(
            convert.state_dict_from_jax_variables(variables), strict=True)
    return tr


def _sd(variables):
    """Torch-layout numpy arrays of a JAX ``params`` / ``batch_stats``
    pair (other keys ignored)."""
    pair = {"params": variables["params"],
            "batch_stats": variables["batch_stats"]}
    return {k: v.numpy() for k, v in
            convert.state_dict_from_jax_variables(pair).items()}


# Per tensor, x the tensor's max-abs float64 gradient.
GRAD_TOL = 1e-4


def check_grads(got, exact, jax32, what):
    """The per-tensor gradient rule against the float64 JAX gradient;
    pre-BatchNorm conv biases: the port's and the float32 JAX Trainer's
    gradients <= 1e-6 x the largest. Returns the worst relative figures
    of the port and (not held) of the float32 JAX Trainer."""
    top = max(np.abs(t).max() for t in exact.values())
    worst = {"port": 0.0, "jax_float32": 0.0}
    for name, t in exact.items():
        g = got[name]
        if pre_bn_bias(name):
            assert np.abs(g).max() <= 1e-6 * top, (what, name)
            assert np.abs(jax32[name]).max() <= 1e-6 * top, (what, name)
            continue
        scale = np.abs(t).max()
        rel = float(np.abs(g - t).max() / scale)
        assert rel <= GRAD_TOL, (what, name, rel)
        worst["port"] = max(worst["port"], rel)
        worst["jax_float32"] = max(worst["jax_float32"], float(
            np.abs(jax32[name] - t).max() / scale))
    return worst


def adam_moments(state, names):
    """AdamW's first and second moments and step count in the JAX state
    (torch layout, float64)."""
    adam = state["opt_state"].inner_state[0]
    mu, nu = (_sd({"params": t, "batch_stats": state["batch_stats"]})
              for t in (adam.mu, adam.nu))
    return ({n: mu[n].astype(np.float64) for n in names},
            {n: nu[n].astype(np.float64) for n in names}, int(adam.count))


def adam_update(m, v, t, g):
    """The Adam part of AdamW's step (float64) from moments ``m``, ``v``
    after ``t`` steps, for gradient ``g``."""
    m = 0.9 * m + 0.1 * g
    v = 0.999 * v + 0.001 * g * g
    mhat, vhat = m / (1 - 0.9 ** (t + 1)), v / (1 - 0.999 ** (t + 1))
    return LR * mhat / (np.sqrt(vhat) + 1e-8)


def adam_allowance(m, v, t, g, delta):
    """Per element, the most by which the Adam step moves for a gradient
    within ``delta`` of ``g`` (sampled at 33 points of the interval; the
    step has one turning point in it at most)."""
    u = adam_update(m, v, t, g)
    return np.max([np.abs(adam_update(m, v, t, g + s * delta) - u)
                   for s in np.linspace(-1.0, 1.0, 33)], axis=0)


def check_params(got, exact, given_port, before, exact_total, exact_step,
                 jax32, moments, what):
    """Parameters after an AdamW step from the same state. Against the
    JAX package's AdamW given the port's own gradients (``given_port``,
    :func:`jax_adamw_given`): within 1e-6, every element. Against the
    float64 JAX step: within 1e-5. Where the gradient rule leaves the
    sign of Adam's first moment open (within 0.1 x the tolerance of this
    step's gradient, ``exact_step``, of zero), plus
    :func:`adam_allowance` of the float64 gradient Adam took
    (``exact_total``) with that tolerance as ``delta``. Pre-BatchNorm
    biases: the port's and the float32 JAX Trainer's first steps moved
    at most lr plus the weight-decay term."""
    m, v, t = moments
    fig = dict(adamw_given_port_worst=0.0, worst_beyond_allowance=0.0,
               elements_sign_open=0, elements_over_1e5=0)
    for name, b in before.items():
        step = float(np.abs(got[name] - given_port[name]).max())
        assert step <= 1e-6, (what, name, "AdamW", step)
        fig["adamw_given_port_worst"] = max(fig["adamw_given_port_worst"],
                                            step)
        if pre_bn_bias(name):
            if t == 0:
                bound = LR * (1 + 0.01 * np.abs(b)) + 1e-7
                assert (np.abs(got[name] - b) <= bound).all(), (what, name)
                assert (np.abs(jax32[name] - b) <= bound).all(), (what, name)
            continue
        delta = GRAD_TOL * np.abs(exact_step[name]).max()
        total = exact_total[name]
        open_sign = np.abs(0.9 * m[name] + 0.1 * total) <= 0.1 * delta
        allow = np.where(open_sign, adam_allowance(m[name], v[name], t,
                                                   total, delta), 0.0)
        diff = np.abs(got[name] - exact[name])
        fig["elements_sign_open"] += int(open_sign.sum())
        fig["elements_over_1e5"] += int((diff > 1e-5).sum())
        d = float((diff - allow).max())
        fig["worst_beyond_allowance"] = max(fig["worst_beyond_allowance"], d)
        assert d <= 1e-5, (what, name, d)
    return fig


def jax_adamw_given(jt, tr, state):
    """What the JAX package's AdamW (``Trainer.tx``, in float64) makes of
    the port's gradients (``.grad``, the running sum under the quirk)
    from ``state``: torch-layout parameters."""
    sd = tr.model.state_dict()
    sd.update({n: p.grad for n, p in tr.model.named_parameters()})
    grads = jconvert.torch_state_dict_to_variables(sd)["params"]
    with jax_float64():
        params = _f64_tree(state["params"])
        upd, _ = jt.tx.update(_f64_tree(grads),
                              _f64_tree(state["opt_state"]), params)
        new = _np_tree(optax.apply_updates(params, upd))
    return _sd({"params": new, "batch_stats": state["batch_stats"]})


def check_stats(got, want, what):
    """BatchNorm running statistics: rtol 1e-5 / atol 1e-7."""
    worst = 0.0
    for name in want:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                       atol=1e-7, err_msg=f"{what} {name}")
            worst = max(worst, float(np.max(
                np.abs(got[name] - want[name])
                / np.maximum(np.abs(want[name]), 1e-7))))
    return worst


def _port_weights(tr):
    return {n: p.detach().numpy().copy()
            for n, p in tr.model.named_parameters()}


def _port_grads(tr):
    return {n: p.grad.numpy().copy() for n, p in tr.model.named_parameters()}


def _port_params(tr):
    return {n: v.detach().numpy().copy()
            for n, v in tr.model.state_dict().items()}


def jax_step(jt, state, x, y):
    """One step of the JAX Trainer's own jitted float32 step from
    ``state`` (numpy trees); returns the new state as numpy trees and the
    loss. The Trainer runs the quirk, so ``grad_accum`` after the first
    step is that step's gradient."""
    out = jt._train_step(
        *(_jnp_tree(state[k]) for k in STATE), _ndhwc(x), _ndhwc(y),
        jnp.ones(x.shape[0]), jax.random.PRNGKey(0),
    )
    return dict(zip(STATE, (_np_tree(o) for o in out[:4]))), float(out[4])


def jax_float64_step(ref, state, x, y):
    """The same step of the JAX package in float64 from ``state``: the new
    state (numpy trees, float64) and the loss."""
    with jax_float64():
        out = ref.step64(
            *(_f64_tree(state[k]) for k in STATE),
            jnp.asarray(np.moveaxis(x, 1, -1), jnp.float64), _ndhwc(y),
            jnp.ones(x.shape[0]), jax.random.PRNGKey(0),
        )
        return dict(zip(STATE, (_np_tree(o) for o in out[:4]))), float(
            out[4])


def test_train_mode_forward_and_running_stats_equal_jax(jax_trainer):
    jt, init = jax_trainer.jt, jax_trainer.init
    variables = {"params": init["params"], "batch_stats": init["batch_stats"]}
    x = np.random.default_rng(0).uniform(0, 1, (3, 1) + SHAPE).astype(
        np.float32)
    logits32, _ = jax.jit(lambda v, x: jt.module.apply(
        v, x, train=True, mutable=["batch_stats"]))(variables, _ndhwc(x))
    with jax_float64():
        logits, upd = jax.jit(lambda v, x: jax_trainer.module64.apply(
            v, x, train=True, mutable=["batch_stats"]))(
            _f64_tree(variables), jnp.asarray(np.moveaxis(x, 1, -1),
                                              jnp.float64))
        logits, stats = np.asarray(logits), _np_tree(upd["batch_stats"])
    net = UNet3D(output_channels=3, width_multiplier=WIDTH).train()
    net.load_state_dict(convert.state_dict_from_jax_variables(variables))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    want = np.moveaxis(logits, -1, 1)
    fig = parity_line(
        "train-mode forward logits (3, 16^3), width 0.25, vs JAX float64",
        got, want, jax_float32_max_abs=float(np.abs(
            np.moveaxis(np.asarray(logits32), -1, 1) - want).max()))
    assert fig["max_abs"] <= 3e-5 and fig["mae"] <= 5e-6
    got = {k: v.numpy() for k, v in net.state_dict().items()}
    want = _sd({"params": init["params"], "batch_stats": stats})
    parity_line("train-mode running mean and var vs JAX float64",
                max_rel=check_stats(got, want, "forward"))


def test_one_f32_train_step_equals_jax(jax_trainer, tmp_path):
    init = jax_trainer.init
    x, y = box_batch(1, batch=4)
    variables = {"params": init["params"], "batch_stats": init["batch_stats"]}
    new, jax_loss = jax_step(jax_trainer.jt, init, x, y)
    exact, exact_loss = jax_float64_step(jax_trainer, init, x, y)

    tr = port_trainer(tmp_path, variables, batch_size=4)
    before = _port_weights(tr)
    loss, precision, recall = tr.train_batch(x, y)
    rel = abs(float(loss) - jax_loss) / abs(jax_loss)
    assert rel <= 1e-5
    assert abs(float(loss) - exact_loss) / exact_loss <= 1e-6
    grads = {n: g for n, g in _sd({
        "params": exact["grad_accum"],
        "batch_stats": init["batch_stats"]}).items() if n in before}
    jax_grads = _sd({"params": new["grad_accum"],
                     "batch_stats": init["batch_stats"]})
    grad_worst = check_grads(_port_grads(tr), grads, jax_grads, "step 1")
    got, want = _port_params(tr), _sd(exact)
    params = check_params(
        got, want, jax_adamw_given(jax_trainer.jt, tr, init), before, grads,
        grads, _sd(new), adam_moments(init, before), "step 1")
    parity_line("one f32 train step (4, 16^3), width 0.25, vs JAX float64",
                loss_rel=rel, grad_worst_rel=grad_worst, params=params,
                n_elements=sum(v.size for v in before.values()),
                stats_worst_rel=check_stats(got, want, "step 1"))
    assert precision.shape == recall.shape == (4,)


def load_jax_state(tr, state):
    """Put the JAX Trainer's state into the port's: weights and running
    statistics, the quirk's running gradient sum as ``.grad``, and AdamW's
    moments and step count (optax ``ScaleByAdamState``)."""
    stats = state["batch_stats"]
    tr.model.load_state_dict(convert.state_dict_from_jax_variables(
        {"params": state["params"], "batch_stats": stats}), strict=True)
    adam = state["opt_state"].inner_state[0]
    accum, mu, nu = (_sd({"params": t, "batch_stats": stats})
                     for t in (state["grad_accum"], adam.mu, adam.nu))
    for name, p in tr.model.named_parameters():
        p.grad = torch.from_numpy(accum[name].copy())
        if int(adam.count):
            tr.optimizer.state[p] = {
                "step": torch.tensor(float(adam.count)),
                "exp_avg": torch.from_numpy(mu[name].copy()),
                "exp_avg_sq": torch.from_numpy(nu[name].copy()),
            }


def test_accumulate_grads_quirk_three_steps_equal_jax(jax_trainer, tmp_path):
    """Three quirk steps, each from the float32 JAX Trainer's state before
    it (weights, running sum, Adam moments), held to the one-step rules
    against the float64 JAX step from that state. Free-running
    trajectories are not compared: at 16^3 the bottleneck BatchNorm
    normalizes 4 values a channel, and the float64 gradients at two
    states one step apart, which differ only where Adam stepped
    near-zero gradients by +-lr, already differ by a third of their
    largest value."""
    tr = port_trainer(tmp_path, accumulate_grads_quirk=True, batch_size=4)
    state = jax_trainer.init
    for step in range(3):
        x, y = box_batch(10 + step, batch=4)
        load_jax_state(tr, state)
        before = _port_weights(tr)
        moments = adam_moments(state, before)
        prev = _sd({"params": state["grad_accum"],
                    "batch_stats": state["batch_stats"]})
        exact, _ = jax_float64_step(jax_trainer, state, x, y)
        new, want_loss = jax_step(jax_trainer.jt, state, x, y)
        loss, _, _ = tr.train_batch(x, y, step=step)
        rel = abs(float(loss) - want_loss) / abs(want_loss)
        assert rel <= 1e-5, (step, rel)
        total = {n: g for n, g in _sd({
            "params": exact["grad_accum"],
            "batch_stats": state["batch_stats"]}).items() if n in before}
        grads = {n: g - prev[n] for n, g in total.items()}
        jax32 = _sd({"params": new["grad_accum"],
                     "batch_stats": state["batch_stats"]})
        grad_worst = check_grads(
            {n: g - prev[n] for n, g in _port_grads(tr).items()}, grads,
            {n: a - prev[n] for n, a in jax32.items() if n in before},
            f"quirk step {step} gradient")
        params = check_params(
            _port_params(tr), _sd(exact),
            jax_adamw_given(jax_trainer.jt, tr, state), before, total, grads,
            _sd(new), moments, f"quirk step {step}")
        assert tr.optimizer.state[next(tr.model.parameters())][
            "step"].item() == step + 1
        parity_line(f"accumulate_grads_quirk step {step + 1} (4, 16^3) vs "
                    "JAX float64", loss_rel=rel, grad_worst_rel=grad_worst,
                    params=params)
        state = new


def test_adamw_three_steps_equal_optax():
    rng = np.random.default_rng(0)
    params = [rng.standard_normal(s).astype(np.float32)
              for s in ((4, 3, 3), (7,), (2, 5))]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) * 10.0 ** -e
              for p, e in zip(params, (1, 3, 5))] for _ in range(3)]
    tx = optax.adamw(learning_rate=LR, weight_decay=0.01)
    jp = [jnp.asarray(p) for p in params]
    opt = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    topt = torch.optim.AdamW(tp, lr=LR, weight_decay=0.01)
    for step_grads in grads:
        upd, opt = tx.update([jnp.asarray(g) for g in step_grads], opt, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(tp, step_grads):
            p.grad = torch.from_numpy(g)
        topt.step()
    worst = max(float(np.abs(p.detach().numpy() - np.asarray(j)).max())
                for p, j in zip(tp, jp))
    parity_line("AdamW 3 steps vs optax adamw", max_abs=worst)
    assert worst <= 1e-6


def test_cosine_schedule_equals_jax_and_torch():
    ours = train.cosine_annealing_lr(1e-3, t_max=25)
    ref = jtrain.cosine_annealing_lr(1e-3, t_max=25)
    m = torch.nn.Linear(1, 1)
    opt = torch.optim.AdamW(m.parameters(), lr=1e-3)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=25)
    for epoch in range(60):
        assert abs(ours(epoch) - ref(epoch)) <= 1e-7
        if epoch < 30:
            np.testing.assert_allclose(ours(epoch), opt.param_groups[0]["lr"],
                                       rtol=1e-6)
            sched.step()


def test_batch_precision_recall_equals_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 8, 8, 8)).astype(np.float32)
    labels = (rng.uniform(size=(6, 8, 8, 8)) > 0.5).astype(np.float32)
    logits[1] = -1.0  # no predicted positives: precision nan
    labels[2] = 0.0  # no true positives: recall nan
    logits[3], labels[3] = -1.0, 0.0
    got = train.batch_precision_recall(torch.from_numpy(logits),
                                       torch.from_numpy(labels))
    want = jtrain.batch_precision_recall(jnp.asarray(logits),
                                         jnp.asarray(labels))
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        assert g.tobytes() == w.tobytes()
    assert np.isnan(got[0][1]) and np.isnan(got[1][2])


@pytest.mark.parametrize("affinity", [True, False])
def test_targets_from_labels_equal_jax_and_host(tmp_path, affinity):
    rng = np.random.default_rng(1)
    lab = (rng.integers(0, 5, (2, 1, 10, 11, 12)) * 977).astype(np.uint32)
    compact = np.stack([dh.compact_labels(v) for v in lab])
    tr = port_trainer(tmp_path, affinity_mode=affinity)
    got = tr._targets_from_labels(train._int_to_device(compact, "cpu"))
    want = jtrain.Trainer._targets_from_labels(_ndhwc(compact), affinity)
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == np.ascontiguousarray(
        np.moveaxis(np.asarray(want), -1, 1)).tobytes()
    if affinity:
        ds = dh.BaseDataset([], [])
        host = np.stack([ds._target(v) for v in lab])
        np.testing.assert_array_equal(got.numpy(), host)


def test_raw_wire_upload_bit_identical_to_host_reconstruction(tmp_path):
    rng = np.random.default_rng(5)
    ds = dh.TrainDataset(
        [rng.integers(0, 1500, (40, 40, 40)).astype(np.uint16)],
        [(rng.integers(0, 3, (40, 40, 40)) * 7).astype(np.uint32)],
        patch_shape=SHAPE, seed=0, return_label_patches=True,
    )
    raw, mn, inv = ds.get_raw_input_patch(0, (20, 20, 20))
    want = dh.reconstruct_normalized(raw, mn, inv)
    tr = port_trainer(tmp_path)
    x, y, w, n_real = tr._to_device_batch(
        (raw[None].astype(np.uint16), np.array([[mn, inv]], np.float32)),
        np.full((1,) + raw.shape, 65535, np.uint16))
    assert x.numpy().tobytes() == want[None].tobytes()
    assert y.dtype == torch.int32 and int(y.min()) == 65535
    assert w.tolist() == [1.0] and n_real == 1


@pytest.mark.parametrize("quirk", [False, True])
def test_resume_round_trip_bit_exact(tmp_path, quirk):
    tr = port_trainer(tmp_path / "a", accumulate_grads_quirk=quirk)
    for step in range(2):
        tr.train_batch(*box_batch(20 + step), step=step)
    tr.epoch, tr.best_f1 = 3, 0.25
    path = tr.save_train_state()
    assert os.path.dirname(path) == tr.log_dir
    fresh = port_trainer(tmp_path / "b", accumulate_grads_quirk=quirk)
    fresh.restore_train_state(path)
    assert fresh.epoch == 4 and fresh.best_f1 == 0.25
    for (k, a), b in zip(tr.model.state_dict().items(),
                         fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    sa, sb = tr.optimizer.state_dict(), fresh.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["state"][i][k]), (i, k)
    for p, q in zip(tr.model.parameters(), fresh.model.parameters()):
        if quirk:
            assert torch.equal(p.grad, q.grad)
        else:
            assert q.grad is None
    # the resumed trainer steps on exactly like the original
    batch = box_batch(30)
    la, _, _ = tr.train_batch(*batch, step=2)
    lb, _, _ = fresh.train_batch(*batch, step=2)
    assert float(la) == float(lb)
    for a, b in zip(tr.model.parameters(), fresh.model.parameters()):
        assert torch.equal(a, b)


def test_pth_files_cross_load_both_ways(jax_trainer, tmp_path):
    jt, init = jax_trainer.jt, jax_trainer.init
    x, y = box_batch(3)
    # port .pth -> JAX load_pth_variables: eval logits agree
    tr = port_trainer(tmp_path / "port")
    tr.train_batch(x, y)
    tr.best_f1 = 0.5
    tr.save_model(epoch=2)
    (pth,) = glob.glob(os.path.join(tr.log_dir, "UNet3d-*-2-0.5000.pth"))
    assert set(torch.load(pth, weights_only=True)) == set(
        tr.model.state_dict())
    variables = jconvert.load_pth_variables(pth)
    apply = jax.jit(lambda v, x: jt.module.apply(v, x, train=False))
    want = np.asarray(apply(variables, _ndhwc(x)))
    tr.model.eval()
    with torch.no_grad():
        got = tr.model(torch.from_numpy(x)).numpy()
    fig = parity_line("port Trainer .pth -> JAX eval logits", got,
                      np.moveaxis(want, -1, 1))
    assert fig["max_abs"] <= 1e-5
    # JAX Trainer .pth -> the port, strictly
    jt.params = _jnp_tree(init["params"])
    jt.batch_stats = _jnp_tree(init["batch_stats"])
    jt.best_f1 = 0.75
    jt.save_model(epoch=1)
    (jpth,) = glob.glob(os.path.join(jt.log_dir, "UNet3d-*-1-0.7500.pth"))
    runner = inference.load_model(jpth, device="cpu", width_multiplier=WIDTH)
    want = np.asarray(apply(
        {"params": jt.params, "batch_stats": jt.batch_stats}, _ndhwc(x)))
    fig = parity_line("JAX Trainer .pth -> port load_model logits",
                      runner(x).numpy(), np.moveaxis(want, -1, 1))
    assert fig["max_abs"] <= 1e-5


def make_volumes(n=2, shape=(48, 48, 48), seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    imgs, labs = [], []
    for k in range(n):
        lab = np.zeros(shape, np.uint32)
        lab[8:40, 8 + 4 * k: 24 + 4 * k, 8:40] = k + 1
        img = rng.uniform(0, 80, shape)
        img[lab > 0] += 400
        imgs.append(img.astype(dtype))
        labs.append(lab)
    return imgs, labs


def test_run_writes_checkpoint_that_predicts(tmp_path):
    """Trainer.run on the CPU: finite losses, a best-F1 .pth with the
    reference name that load_model takes (folded bf16 and float32) and
    predicts finite affinities from, and TensorBoard events."""
    imgs, labs = make_volumes()
    tr = port_trainer(tmp_path, batch_size=4, max_epochs=2, prefetch=True)
    assert tr.device == torch.device("cpu") and not tr.use_amp
    best = tr.run(
        dh.TrainDataset(imgs, labs, patch_shape=SHAPE, seed=0,
                        transform=True),
        dh.ValidateDataset(imgs, labs, patch_shape=SHAPE,
                           containment_buffer=0),
    )
    assert best > 0 and tr.epoch == 1
    pths = glob.glob(os.path.join(tr.log_dir, "UNet3d-*.pth"))
    assert pths
    assert glob.glob(os.path.join(tr.log_dir, "events.*"))
    for dtype in (torch.float32, torch.bfloat16):
        runner = inference.load_model(pths[0], device="cpu", dtype=dtype,
                                      width_multiplier=WIDTH)
        aff = inference.predict(imgs[0][:32, :32, :32], runner,
                                patch_shape=SHAPE, overlap=(4, 4, 4), trim=2,
                                batch_size=4, verbose=False)
        assert aff.shape == (3, 32, 32, 32) and np.isfinite(aff).all()


def test_device_augment_auto_default(tmp_path):
    imgs, labs = make_volumes()
    raw = dh.TrainDataset(imgs, labs, patch_shape=SHAPE, seed=0,
                          return_label_patches=True)
    t = port_trainer(tmp_path / "auto", batch_size=4)
    assert t.device_augment is None
    stats = t.train_step(raw, 0)
    assert t.device_augment is True and np.isfinite(stats["loss"])
    assert raw.wire_labels and not raw.wire_raw_images  # float volumes
    host = dh.TrainDataset(imgs, labs, patch_shape=SHAPE, seed=0,
                           transform=True)
    t2 = port_trainer(tmp_path / "host", batch_size=4)
    t2.train_step(host, 0)
    assert not t2.device_augment
    t3 = port_trainer(tmp_path / "force", batch_size=4, device_augment=True)
    with pytest.raises(ValueError, match="return_label_patches"):
        t3.train_step(host, 0)
    with pytest.raises(ValueError, match="prefetch"):
        port_trainer(tmp_path / "bad", num_workers=2, prefetch=False)


def test_raw_and_label_wire_change_no_parameter(tmp_path):
    """One device-augment epoch with and without the raw-u16 + compact
    label wire ends in exactly the same parameters."""
    imgs, labs = make_volumes(dtype=np.uint16)
    digests = []
    for wire in (False, True):
        ds = dh.TrainDataset(imgs, labs, patch_shape=SHAPE, seed=3,
                             return_label_patches=True)
        t = port_trainer(tmp_path / f"w{wire}", batch_size=4,
                         wire_labels=wire, seed=1)
        t.train_step(ds, 0)
        assert ds.wire_raw_images == ds.wire_labels == wire
        digests.append([p.detach().numpy().tobytes()
                        for p in t.model.parameters()])
    assert digests[0] == digests[1]


def test_prefetch_changes_no_parameter(tmp_path):
    imgs, labs = make_volumes()
    digests = []
    for prefetch in (False, True):
        ds = dh.TrainDataset(imgs, labs, patch_shape=SHAPE, seed=1,
                             transform=True)
        t = port_trainer(tmp_path / f"p{prefetch}", batch_size=4,
                         prefetch=prefetch)
        t.train_step(ds, 0)
        assert t.input_wait_s >= 0
        digests.append([p.detach().numpy().tobytes()
                        for p in t.model.parameters()])
    assert digests[0] == digests[1]


def test_to_cpu():
    t = torch.arange(3.0, requires_grad=True) * 2
    out = train.toCPU(t)
    assert isinstance(out, torch.Tensor) and not out.requires_grad
    np.testing.assert_array_equal(train.toCPU(t, to_numpy=True), [0, 2, 4])
