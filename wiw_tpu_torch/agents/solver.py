"""The part of the solver base that the closed-loop rollout client runs.

Port of the host logic that `wiw_tpu/serve/benchmarks.py` reaches in
`wiw_tpu/agents/solver.py`, under the reference's names: the unit actions,
`FakeSimulator` (the deterministic synthetic world), `roll_pano_np`, the
`SolverConfig` fields the client sets, the candidate-prefix analysis
`get_action_info_from_prior`, the padding of action sequences to
igenex_n_frame ([stop] + ids + [forward]*), `look_ahead_explore` (one
batched request of every candidate, its pano rolled by the candidate's
initial turn) and the heuristic sampler (no reverse, at most 4 repeated
turns, seeded draws, dedup).

It has no VLM, no task solvers (AR, AEQA, IGNav, ...) and no GTsim
oracle, and `imagine_by_model_type` takes only the pano WMs ('action',
'FTtext'): those stay host logic of `wiw_tpu.agents`, which the port does
not import.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from wiw_tpu_torch.agents.saver import Saver
from wiw_tpu_torch.serve.manager import WMClient

UNIT_FORWARD_M = 0.2
UNIT_TURN_DEG = 22.5

ACTION_IDS = {"forward": 1, "turn_left": 2, "turn_right": 3, "stop": 4}
ACTION_NAMES = {v: k for k, v in ACTION_IDS.items()}
ACTION_TEXT = {
    "forward": f"forward {UNIT_FORWARD_M}m",
    "turn_left": f"turn_left {UNIT_TURN_DEG}\N{DEGREE SIGN}",
    "turn_right": f"turn_right {UNIT_TURN_DEG}\N{DEGREE SIGN}",
    "stop": "stop",
}
TURN_DEGREES = {"forward": 0.0, "turn_left": UNIT_TURN_DEG,
                "turn_right": -UNIT_TURN_DEG, "stop": 0.0}


class FakeSimulator:
    """Deterministic synthetic world: the pano is a function of the agent's
    (x, y, heading) state, so rollouts are reproducible."""

    def __init__(self, height: int = 64, width: int = 128, seed: int = 0):
        self.H, self.W = height, width
        self.pos = np.zeros(2)
        self.heading_deg = 0.0
        self.seed = seed

    def get_pano(self) -> np.ndarray:
        # turning LEFT by theta shifts pano content RIGHT by W*theta/360
        # (roll_pano_np), so world longitude maps to column via -heading
        jj = np.arange(self.W)
        lon = (jj + 0.5) / self.W * 360.0 - 180.0 - self.heading_deg
        row = (127.5 + 80 * np.sin(np.radians(lon) * 2 + self.seed)
               + 20 * self.pos[0] + 10 * self.pos[1])
        img = np.tile(row[None, :, None], (self.H, 1, 3))
        return np.clip(img, 0, 255).astype(np.uint8)

    def step(self, action: str) -> None:
        if action == "forward":
            rad = np.radians(self.heading_deg)
            self.pos += UNIT_FORWARD_M * np.array([np.cos(rad), np.sin(rad)])
        elif action == "turn_left":
            self.heading_deg += UNIT_TURN_DEG
        elif action == "turn_right":
            self.heading_deg -= UNIT_TURN_DEG

    def get_agent_state(self):
        return (self.pos.copy(), self.heading_deg)

    def set_agent_state(self, state) -> None:
        self.pos, self.heading_deg = state[0].copy(), state[1]


@dataclasses.dataclass
class SolverConfig:
    world_model_type: str = "action"  # only the pano WMs: 'action' | 'FTtext'
    look_ahead_action_num: int = 4
    igenex_n_frame: int = 14
    wm_host: str = "127.0.0.1"
    wm_port: int = 7000
    request_model_name: str = "igenex"


def roll_pano_np(pano: np.ndarray, degrees: float) -> np.ndarray:
    """Cyclic yaw roll of an equirect pano [H, W, C]; +deg turns left,
    shifting content right by W*deg/360."""
    W = pano.shape[1]
    shift = int(round(W * degrees / 360.0))
    return np.roll(pano, shift, axis=1)


def text_to_action_name(text: str) -> str:
    """'forward 0.2m' -> 'forward' etc."""
    for name, t in ACTION_TEXT.items():
        if text == t or text.startswith(name):
            return name
    raise ValueError(f"unknown action text {text!r}")


class Solver:
    def __init__(self, config: SolverConfig, sim: Optional[FakeSimulator] = None):
        self.cfg = config
        self.sim = sim
        self._wm_client: Optional[WMClient] = None

    # -- WM socket client ----------------------------------------------
    def connect_to_WM_server(self) -> WMClient:
        if self._wm_client is None:
            self._wm_client = WMClient(self.cfg.wm_host, self.cfg.wm_port).connect()
        return self._wm_client

    def send_batch_to_server(self, batch_actions: np.ndarray, save_dirs: List[str],
                             batch_images: Optional[np.ndarray] = None,
                             return_objects: bool = True) -> dict:
        req = {
            "b_action": np.asarray(batch_actions, np.int64),
            "save_dirs": save_dirs,
            "request_model_name": self.cfg.request_model_name,
            "return_objects": [return_objects] * len(save_dirs),
        }
        if batch_images is not None:
            req["b_image"] = np.asarray(batch_images)
        return self.connect_to_WM_server().send_batch(req)

    # -- candidate analysis --------------------------------------------
    def get_action_info_from_prior(self, prior_actions: Sequence[Sequence[str]]):
        """Split each candidate action sequence into (initial cumulative
        turn degrees, leftover action ids, full ids): leading same-direction
        turns collapse into the initial pano roll."""
        init_turn_degrees: Dict[int, float] = {}
        remain_action_ids: Dict[int, List[int]] = {}
        all_action_ids: Dict[int, List[int]] = {}
        n = self.cfg.look_ahead_action_num
        for idx, raw_seq in enumerate(prior_actions):
            seq = [text_to_action_name(a) for a in raw_seq]
            cumulative = 0.0
            leftover: List[int] = []
            for ai, act in enumerate(seq[:n]):
                turn = TURN_DEGREES[act]
                if turn == 0 or cumulative * turn < 0:
                    leftover = [ACTION_IDS[a] for a in seq[ai:]]
                    break
                cumulative += turn
            init_turn_degrees[idx] = cumulative
            remain_action_ids[idx] = leftover
            all_action_ids[idx] = [ACTION_IDS[a] for a in seq]
        return init_turn_degrees, remain_action_ids, all_action_ids

    # -- WM imagination -------------------------------------------------
    def _pad_action_seq(self, action_ids: List[int]) -> List[int]:
        """[stop] + ids + [forward] * pad to igenex_n_frame."""
        remain = (self.cfg.igenex_n_frame - 1) - len(action_ids)
        assert remain >= 0, (action_ids, self.cfg.igenex_n_frame)
        return [ACTION_IDS["stop"]] + action_ids + [ACTION_IDS["forward"]] * remain

    def _prepare_common(self, pano, init_turn_degrees, prior_action_ids, save_dir):
        action_ids_list = list(range(len(init_turn_degrees)))
        batch_actions = np.stack(
            [np.asarray(self._pad_action_seq(prior_action_ids[i]), np.int64)
             for i in action_ids_list])
        images = np.stack(
            [roll_pano_np(pano, init_turn_degrees[i]) for i in action_ids_list])
        save_dirs = Saver.get_igenex_save_dirs(save_dir, action_ids_list)
        return action_ids_list, batch_actions, images, save_dirs

    def look_ahead_explore(self, pano, init_turn_degrees, prior_action_ids,
                           save_dir) -> dict:
        """Query the WM server with all candidates batched."""
        _, batch_actions, images, save_dirs = self._prepare_common(
            pano, init_turn_degrees, prior_action_ids, save_dir)
        return self.send_batch_to_server(batch_actions, save_dirs, images)

    def imagine_by_model_type(self, prior_actions, save_dir) -> dict:
        """The reference's dispatch for the pano WMs ('action', 'FTtext'):
        one `look_ahead_explore` of the candidates' leftover ids."""
        if self.cfg.world_model_type not in ("action", "FTtext"):
            raise NotImplementedError(
                f"world_model_type {self.cfg.world_model_type!r}: the port's "
                "solver serves only the pano WMs ('action', 'FTtext')")
        init_deg, remain_ids, _ = self.get_action_info_from_prior(prior_actions)
        pano = self.sim.get_pano() if self.sim is not None else None
        out = self.look_ahead_explore(pano, init_deg, remain_ids, save_dir)
        out["coord_type"] = "pano"
        return out

    # -- heuristic policy ----------------------------------------------
    def retrieve_action_space(self):
        names = ["forward", "turn_left", "turn_right"]
        return [str(i + 1) for i in range(len(names))], [ACTION_TEXT[n] for n in names]

    def heur_sample_next_action(self, action_seq: List[str], seed: int,
                                max_rep_turns: int = 4):
        idxs, texts = self.retrieve_action_space()
        space = list(texts)
        if action_seq:
            last = action_seq[-1]
            if "left" in last:
                space = [a for a in space if "right" not in a]
            elif "right" in last:
                space = [a for a in space if "left" not in a]
            if ("left" in last or "right" in last) and (
                    action_seq[-max_rep_turns:] == [last] * max_rep_turns):
                space = [a for a in space if a != last]
        choice = random.Random(seed).choice(space)
        return choice, idxs[texts.index(choice)]

    def heur_sample_next_action_seqs(self, action_seq: List[str], query_num: int):
        seen = set()
        seqs, idx_seqs = [], []
        for qi in range(1000 * query_num):
            if len(seqs) == query_num:
                break
            new_seq = list(action_seq)
            new_idx = []
            for ai in range(self.cfg.look_ahead_action_num):
                seed = qi * self.cfg.look_ahead_action_num + ai
                act, idx = self.heur_sample_next_action(new_seq, seed)
                new_seq.append(act)
                new_idx.append(idx)
            tail = tuple(new_seq[len(action_seq):])
            if tail not in seen:
                seen.add(tail)
                seqs.append(list(tail))
                idx_seqs.append(new_idx)
        return seqs, idx_seqs
