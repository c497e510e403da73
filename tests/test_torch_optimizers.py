"""Port parity of the memory-saving optimizers: `train/optimizers.py`
against optax's own `tx.update`, and the trainer's steps with them against
the reference's jitted step.

Leaves of every kind (1-D, of 96 and of an odd 77; 2-D with both axes below 128, so whole, and
above, so factored; a flax conv [3, 3, Cin, Cout] beside the port's
[Cout, Cin, 3, 3], with Cin = Cout (a tie in the factored axes) and not; a
temporal conv [3, 1, 1, Cin, Cout]) take 5 steps of seeded gradients
under a warmup schedule, in the reference's optimizer as its trainer
builds it (`_make_optimizer`, the clip set out of reach) and in the
port's (`trainer.build_optimizer`). Tolerances: the parameters within
1e-6 absolute (values ~1, fp32 arithmetic in another order: XLA's pow and
rsqrt against torch's); `adamw_bf16m`'s first moment equal to the bit.
The trainer's two steps reuse `test_torch_train`'s STEP_ATOL, but for the
elements whose Adafactor update rounding decides (`assert_steps_close`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import (  # noqa: F401  (ref: the reference pipeline fixture)
    LOSS_REL, STEP_ATOL, _batch, _flat, _t, jax_draws, port_pipeline, ref)
from wiw_tpu.train import trainer as JT
from wiw_tpu_torch.models.convert import flax_axes
from wiw_tpu_torch.train import optimizers as TO
from wiw_tpu_torch.train import trainer as TT

torch.set_num_threads(1)

# name: flax shape, flax path leaf (its layout in the port)
LEAVES = {
    "norm": ((96,), "scale"),
    "bias": ((77,), "bias"),
    "dense_small": ((64, 96), "kernel"),
    "dense": ((160, 256), "kernel"),
    "conv_tie": ((3, 3, 128, 128), "kernel"),
    "conv": ((3, 3, 128, 192), "kernel"),
    "temporal": ((3, 1, 1, 160, 128), "kernel"),
}
PARAM_ATOL = 1e-6
SCHED = dict(learning_rate=1e-2, lr_scheduler="constant_with_warmup", lr_warmup_steps=3,
             weight_decay=0.05, max_grad_norm=1e9)


def _leaves(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(shape).astype(np.float32) for k, (shape, _) in LEAVES.items()}


def _to_torch(name, value):
    """A copy: JAX's CPU arrays may share a numpy buffer, and its update,
    dispatched asynchronously, must not read the port's in-place step."""
    axes = flax_axes(("x", LEAVES[name][1]), value.ndim)
    return torch.tensor(value.transpose(np.argsort(axes)))


def _to_flax(name, t):
    return t.detach().numpy().transpose(flax_axes(("x", LEAVES[name][1]), t.ndim))


@pytest.mark.parametrize("optimizer", ["adamw_bf16m", "adafactor"])
def test_optimizer_leaves_match_optax(optimizer):
    cfg = dict(SCHED, optimizer=optimizer)
    jtr = JT.Trainer.__new__(JT.Trainer)
    jtr.cfg = JT.TrainConfig(**cfg)
    tx = jtr._make_optimizer()
    params = _leaves()
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    update = jax.jit(tx.update)

    tcfg = TT.TrainConfig(**cfg)
    lr_at = TT.lr_schedule(tcfg)
    tparams = {k: _to_torch(k, v).requires_grad_(True) for k, v in params.items()}
    names = {k: f"blk.{k}.weight" if LEAVES[k][1] == "kernel" else f"blk.norm_{k}.weight"
             for k in LEAVES}
    opt = TT.build_optimizer(tcfg, [(names[k], p) for k, p in tparams.items()])
    rng = np.random.default_rng(1)
    for step in range(5):
        grads = {k: (rng.standard_normal(v.shape) * 10.0 ** -step).astype(np.float32)
                 for k, v in params.items()}
        upd, jstate = update({k: jnp.asarray(g) for k, g in grads.items()}, jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, upd)
        for k, p in tparams.items():
            p.grad = _to_torch(k, grads[k])
        for group in opt.param_groups:
            group["lr"] = lr_at(step)
        opt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(_to_flax(k, p), np.asarray(jparams[k]),
                                       atol=PARAM_ATOL, rtol=0, err_msg=f"{k} step {step}")
        if optimizer == "adamw_bf16m":
            mu = jstate[1][0].mu  # chain(clip, adamw(scale_by_adam, ...))
            for k, p in tparams.items():
                got = opt.state[p]["mu"]
                assert got.dtype == torch.bfloat16
                want = np.asarray(mu[k].astype(jnp.float32))
                np.testing.assert_array_equal(_to_flax(k, got.float()), want, err_msg=k)
    if optimizer == "adafactor":
        factored = {k: "v_row" in opt.state[p] for k, p in tparams.items()}
        assert factored == {"norm": False, "bias": False, "dense_small": False, "dense": True,
                            "conv_tie": True, "conv": True, "temporal": True}


def test_factored_axes_follow_the_flax_leaf():
    # the conv tie: flax [3, 3, C, C] factors (Cin, Cout) = axes (2, 3), so
    # the port's [C, C, 3, 3] factors (1, 0), not its own order's (0, 1)
    for shape, want in (((3, 3, 128, 128), (2, 3)), ((160, 256), (0, 1)),
                        ((256, 160), (1, 0)), ((64, 96), None), ((7,), None),
                        ((3, 1, 1, 160, 128), (4, 3))):
        assert TO.factored_axes(shape) == want
    p = torch.zeros(128, 128, 3, 3, requires_grad=True)
    opt = TO.Adafactor([p], lr=1.0, layouts=[flax_axes(("x", "kernel"), 4)])
    assert opt._dims[p] == (1, 0)
    assert opt.state[p]["v_row"].shape == (128, 3, 3)  # the mean over Cout


def assert_steps_close(got: dict, want: dict, grads: dict, start: dict, lr: float,
                       steps: int, adafactor: bool, label: str = "") -> None:
    """Parameters `got` within STEP_ATOL of `want`, but where Adafactor's
    update is the sign of rounding. Its first update of a leaf it keeps
    whole is g / sqrt(g^2 + 1e-30), the sign of the gradient: where the
    gradient is zero in exact arithmetic (a GroupNorm of one channel a group
    normalises the time embedding's projection away: a leaf's gradient
    within 1e-6 of the largest) or an element's within rounding of zero
    (1e-4 of its leaf's largest), the sign, and so an update of
    lr * rms(p), is rounding's in either package. Those elements are held
    to the bound of the updates instead (|u| <= 1.5 a step), and a real
    leaf may have at most 1e-3 of its elements among them. `grads` are
    the port's first-step gradients."""
    top = max(float(g.norm()) for g in grads.values())
    for n, w in want.items():
        d = (got[n] - w).abs()
        off = d > STEP_ATOL
        if not off.any():
            continue
        g = grads.get(n)
        assert adafactor and g is not None, (label, n, float(d.max()))
        noise = float(g.norm()) <= 1e-6 * top
        near_zero = g.abs() <= 1e-4 * g.abs().max()
        assert noise or (bool(near_zero[off].all())
                         and int(off.sum()) <= max(1, 1e-3 * off.numel())), (label, n)
        rms = max(float(start[n].pow(2).mean().sqrt()), 1e-3)
        assert float(d.max()) <= 2 * 1.5 * steps * lr * rms, (label, n, float(d.max()))


def _two_steps(jpipe, params, kw, port_kw=None):
    """Two steps of the reference's jitted trainer and of the port's (its
    own config `port_kw` where given), from the same weights and draws.
    Returns the reference's state, the port's and its first gradients."""
    jtr = JT.Trainer(jpipe, JT.TrainConfig(**kw))
    jstate = jtr.init_state(params)
    frozen = {"vae": params["vae"], "clip": params["clip"]}
    step_fn = jtr.make_train_step()
    trainer = TT.Trainer(port_pipeline(params), TT.TrainConfig(**(port_kw or kw)))
    state = trainer.init_state()
    for s in range(2):
        batch = _batch(B=2, seed=30 + s)
        key = jax.random.PRNGKey(200 + s)
        jstate, jm = step_fn(jstate, frozen, jax.tree_util.tree_map(jnp.asarray, batch), key)
        m = trainer.train_step(state, _t(batch), draws=[jax_draws(key, 2)])
        assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_REL * abs(float(jm["loss"]))
        if s == 0:
            grads = {n: p.grad.clone() for n, p in state.params.items() if p.grad is not None}
    return jstate, state, grads


@pytest.mark.parametrize("optimizer,train_params", [
    ("adamw_bf16m", "full"), ("adafactor", "full"), ("adafactor", "new")])
def test_two_steps_match_reference(ref, optimizer, train_params):
    """Two steps of the trainer with each optimizer (clip live) on the tiny
    UNet, and the masked case: only the action parameters move."""
    jpipe, params = ref
    kw = dict(learning_rate=1e-3, max_grad_norm=0.05, weight_decay=0.1,
              optimizer=optimizer, train_params=train_params)
    jstate, state, grads = _two_steps(jpipe, params, kw)
    assert state.step == 2 == int(jstate["step"])
    start = _flat(params["unet"])
    trained = {n for g in state.optimizer.param_groups for n, p in state.params.items()
               if any(p is q for q in g["params"])}
    assert_steps_close({n: p.detach() for n, p in state.params.items()},
                       _flat(jstate["params"]), grads, start, kw["learning_rate"], 2,
                       optimizer == "adafactor")
    for name, p in state.params.items():
        if name not in trained:
            assert torch.equal(p.detach(), start[name]), name
    if train_params == "new":
        assert trained and len(trained) < len(state.params) // 4
    else:
        assert len(trained) == len(state.params)


@pytest.mark.parametrize("optimizer", ["adamw_bf16m", "adafactor"])
def test_optimizer_state_roundtrips_through_a_checkpoint(optimizer, tmp_path):
    """Two steps on the leaves, a `TrainState` saved and restored into a
    fresh optimizer, three more steps: equal to the bit to the run that was
    never interrupted. The bf16 moment comes back bf16 (the base class's
    load casts it to the parameter's dtype) and Adafactor's factored
    moments in their own shapes."""
    from wiw_tpu_torch.train.checkpoints import CheckpointManager

    cfg = TT.TrainConfig(**dict(SCHED, optimizer=optimizer))
    lr_at = TT.lr_schedule(cfg)
    rng = np.random.default_rng(2)
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in _leaves().items()} for _ in range(5)]

    def fresh():
        blk = torch.nn.Module()
        for k, v in _leaves().items():
            sub = torch.nn.Module()
            sub.weight = torch.nn.Parameter(_to_torch(k, v))
            setattr(blk, k if LEAVES[k][1] == "kernel" else f"norm_{k}", sub)
        module = torch.nn.Module()
        module.blk = blk
        params = dict(module.named_parameters())
        opt = TT.build_optimizer(cfg, list(params.items()))
        return TT.TrainState(module, params, opt, None)

    def step(state, s):
        for (n, p), k in zip(state.params.items(), LEAVES):
            p.grad = _to_torch(k, grads[s][k])
        for group in state.optimizer.param_groups:
            group["lr"] = lr_at(s)
        state.optimizer.step()
        state.step += 1

    whole, part = fresh(), fresh()
    for s in range(2):
        step(whole, s)
        step(part, s)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(part.step, part.state_dict())
    back = fresh()
    back.load_state_dict(mgr.restore())
    assert back.step == 2
    for p, q in zip(part.params.values(), back.params.values()):
        old, new = part.optimizer.state[p], back.optimizer.state[q]
        assert old.keys() == new.keys()
        for key in old:
            assert new[key].dtype == old[key].dtype, key
            torch.testing.assert_close(new[key], old[key], rtol=0, atol=0, msg=key)
    for s in range(2, 5):
        step(whole, s)
        step(back, s)
    for n, p in whole.params.items():
        torch.testing.assert_close(back.params[n], p, rtol=0, atol=0, msg=n)
