"""The checks that decide `correct`, at a tiny size on the CPU: a sound run
passes; the same run with the timed path broken underneath, and the
control in the system's place, fail. The limits here are the tiny size's
own (its sound readings are a few times below them); the cells' limits
come from the card, as PERF.md records."""

from __future__ import annotations

import pytest
import torch

from wmbench.runners import serve, train
from wmbench.tests import tiny

SERVE = {"runner": "serve", "agents": 2, "candidates": 2, "turn_max": 1}
TRAIN = {"runner": "train", "micro_batch": 2, "accumulation": 2}
SERVE_LIMIT = 8.0
TRAIN_LIMITS = {"loss_gap_limit": 0.005, "grad_gap_limit": 0.25, "change_gap_limit": 0.4,
                "ema_gap_limit": 0.2, "post_change_gap_limit": 0.2, "post_ema_gap_limit": 0.2,
                "window_bad_leaves_limit": 0, "window_bad_losses_limit": 0}


@pytest.fixture(autouse=True)
def tiny_settings(monkeypatch):
    """The tiny runs' own settings: every served candidate compared, a
    traced sub-window that fits a few seconds, three followed steps."""
    monkeypatch.setattr(serve, "CHECK_CANDIDATES", 64)
    monkeypatch.setattr(serve, "TRACE_START_S", 1)
    monkeypatch.setattr(serve, "TRACE_SECONDS", 1)
    monkeypatch.setattr(train, "FOLLOWED_STEPS", 3)
    monkeypatch.setattr(train, "TRACED_STEP", 1)


def serve_run(seconds=8.0):
    ctx = tiny.ctx("svd_dagger_int8", dict(SERVE), seconds=seconds,
                   end_to_end=["frames_per_s", "setup_s"])
    ctx.config["check"]["frame_rms_limit"] = SERVE_LIMIT
    return serve.run(ctx)


def train_run():
    ctx = tiny.ctx("svd_dagger_bf16_train", dict(TRAIN), seconds=3.0,
                   end_to_end=["clips_per_s", "setup_s"])
    ctx.config["check"].update(TRAIN_LIMITS)
    return train.run(ctx)


def test_sound_serving_run_is_correct():
    result, checks = serve_run()
    assert result["correct"], checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert checks[0][1] < SERVE_LIMIT / 2


def _frozen_step(self, state, cond_only=False):
    return dict(state)


def _half_step(self, state, cond_only=False):
    out = _SOUND_STEP(self, state, cond_only)
    keep = torch.arange(self.S, device=state["latents"].device) < self.S // 2
    out["latents"] = torch.where(keep[:, None, None, None, None], out["latents"], state["latents"])
    return out


def _altered_decode(self, latents):
    return (_SOUND_DECODE(self, latents).int() + 40).clamp(0, 255).to(torch.uint8)


from wiw_tpu_torch.serve.continuous import ContinuousEngine  # noqa: E402

_SOUND_STEP = ContinuousEngine._step_once
_SOUND_DECODE = ContinuousEngine._decode_slot


@pytest.mark.parametrize("attr, fault", [("_step_once", _frozen_step),
                                         ("_step_once", _half_step),
                                         ("_decode_slot", _altered_decode)],
                         ids=["state_unchanged", "half_the_pool", "answer_altered"])
def test_broken_serving_path_is_not_correct(monkeypatch, attr, fault):
    monkeypatch.setattr(ContinuousEngine, attr, fault)
    result, checks = serve_run()
    assert not result["correct"], checks


def test_serving_control_is_not_correct():
    from wmbench import controls

    ctx = tiny.ctx("svd_dagger_int8", dict(SERVE))
    ctx.config["check"]["frame_rms_limit"] = SERVE_LIMIT
    out = controls.serve_control(ctx)["control_int4"]
    assert not out["correct"] and out["checks"]["frame_rms"]["value"] > SERVE_LIMIT


def test_sound_training_run_is_correct():
    result, checks = train_run()
    assert result["correct"], checks
    assert result["attempted"] > 0


def test_frozen_training_state_is_not_correct(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, *a, **k: None)
    result, checks = train_run()
    assert not result["correct"], checks
    assert dict((n, v) for n, v, _ in checks)["change_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("skip", ["optimizer", "ema"])
def test_training_frozen_after_the_followed_steps_is_not_correct(monkeypatch, skip):
    """Steps after the followed ones leave the parameters (or the EMA)
    unchanged: the window's steps and the post step are what the check has
    to catch, since the followed steps are sound."""
    if skip == "optimizer":
        sound = torch.optim.AdamW.step
        calls = []

        def step(self, *a, **k):
            calls.append(1)
            return sound(self, *a, **k) if len(calls) <= train.FOLLOWED_STEPS else None

        monkeypatch.setattr(torch.optim.AdamW, "step", step)
    else:
        from wiw_tpu_torch.train.trainer import Trainer

        sound = Trainer.train_step
        calls = []

        def step(self, state, *a, **k):
            calls.append(1)
            kept = ([e.clone() for e in state.ema] if len(calls) > train.FOLLOWED_STEPS
                    else None)
            out = sound(self, state, *a, **k)
            for e, e0 in zip(state.ema, kept or ()):
                e.copy_(e0)
            return out

        monkeypatch.setattr(Trainer, "train_step", step)
    result, checks = train_run()
    got = dict((n, v) for n, v, _ in checks)
    assert not result["correct"], checks
    assert got["window_bad_leaves"] > 0
    assert got["post_change_gap" if skip == "optimizer" else "post_ema_gap"] == pytest.approx(1.0)


def test_half_batch_training_is_not_correct(monkeypatch):
    from wiw_tpu_torch.train.trainer import Trainer

    sound = Trainer.loss_fn

    def half(self, batch, draws=None, generator=None):
        B = batch["pixel_values"].shape[0] // 2
        rows = {k: v[:B] for k, v in batch.items()}
        cut = {k: v[: B * (v.shape[0] // batch["pixel_values"].shape[0])] for k, v in draws.items()}
        return sound(self, rows, cut, generator)

    monkeypatch.setattr(Trainer, "loss_fn", half)
    result, checks = train_run()
    assert not result["correct"], checks


def test_training_control_and_fault_are_not_correct():
    from wmbench import controls

    ctx = tiny.ctx("svd_dagger_bf16_train", dict(TRAIN))
    ctx.config["check"].update(TRAIN_LIMITS)
    out = controls.train_control(ctx)
    for reading in (out["control_fp8"], out["fault_half"]):
        assert not reading["correct"], reading


def test_no_jax_in_the_process_after_a_run():
    from wmbench import harness as H

    serve_run(seconds=2.0)
    assert H.forbidden_loaded() == []
