"""Action codecs: discrete nav actions and continuous manipulation poses.

Port of `wiw_tpu/core/actions.py`:
  * one-hot nav encoding ('action_block')
  * triangular "revealed so far" index encoding ('micro_cond' nav), and its
    inverse
  * the positional codec
  * manipulation 8-D pose (xyz, quaternion xyzw, gripper) -> normalized
    10-D (xyz, rot6d, grip), absolute or relative

Every codec is vectorised over the batch and frames, as in the reference.

Nav action vocabulary: 1 = forward (0.2 m), 2 = turn_left (22.5 deg),
3 = turn_right (22.5 deg), 4 = stop, 0 = placeholder.
"""

from __future__ import annotations

import math

import numpy as np
import torch

ACTION_FORWARD = 1
ACTION_TURN_LEFT = 2
ACTION_TURN_RIGHT = 3
ACTION_STOP = 4
ACTION_PLACEHOLDER = 0

NUM_ACTION_CLASSES = 4

# Manipulation workspace bounds (xmin, ymin, zmin, xmax, ymax, zmax)
SCENE_BOUNDS = np.array([-0.3, -0.5, 0.6, 0.7, 0.5, 1.6], dtype=np.float32)

TWO_PI = 2.0 * math.pi


def _check_rank(actions: torch.Tensor, ndim: int, what: str) -> None:
    if actions.ndim != ndim:
        raise ValueError(f"expected {what}, got {tuple(actions.shape)}")


def encode_onehot(actions: torch.Tensor) -> torch.Tensor:
    """'action_block' codec: [B, F] one-indexed ids -> fp32 [B, F, 4]
    one-hot. Frame 0 is forced to 'stop' ([0, 0, 0, 1]); the other frames
    are one_hot(clip(action - 1, 0, 3))."""
    _check_rank(actions, 2, "[B, F]")
    idx = (actions.to(torch.int64) - 1).clamp(0, NUM_ACTION_CLASSES - 1)
    onehot = torch.nn.functional.one_hot(idx, NUM_ACTION_CLASSES).float()
    onehot[:, 0] = 0.0
    onehot[:, 0, ACTION_STOP - 1] = 1.0
    return onehot


def encode_idx(actions: torch.Tensor) -> torch.Tensor:
    """'micro_cond' nav codec: [B, F] ids -> [B, F, F] triangular encoding.

    out[b, i, j] = a[b, j] for j <= i else 0, with a[b, 0] forced to stop.
    """
    _check_rank(actions, 2, "[B, F]")
    F = actions.shape[1]
    a = actions.to(torch.int32).clone()
    a[:, 0] = ACTION_STOP
    mask = torch.tril(torch.ones(F, F, dtype=torch.int32, device=a.device))
    return a[:, None, :] * mask[None, :, :]


def decode_idx(action_seq_frames: torch.Tensor) -> torch.Tensor:
    """Inverse of encode_idx: the diagonal holds frame i's own action id."""
    return torch.diagonal(action_seq_frames, dim1=-2, dim2=-1)


def encode_positional(actions: torch.Tensor) -> torch.Tensor:
    """Positional codec: [B, L, A] -> [B, L, L+A-1], row i holding its
    action vector at column offset i."""
    _check_rank(actions, 3, "[B, L, A]")
    B, L, A = actions.shape
    rows = torch.arange(L, device=actions.device)[:, None]
    cols = rows + torch.arange(A, device=actions.device)[None, :]
    out = actions.new_zeros((B, L, L + A - 1))
    out[:, rows, cols] = actions
    return out


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) (x, y, z, w) -> rotation matrix [..., 3, 3], as
    scipy's Rotation.from_quat (which normalises its input)."""
    q = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    x, y, z, w = q.unbind(-1)
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, -1) for r in rows], dim=-2)


def _to_range(z01: torch.Tensor, rescale: bool) -> torch.Tensor:
    """Linear map [0, 1] -> [-2pi, 2pi] (or [-pi, pi] when rescale)."""
    high = TWO_PI / (2.0 if rescale else 1.0)
    low = -high
    return z01 * (high - low) + low


def normalize_action(rel_xyz: torch.Tensor, rel_r6: torch.Tensor,
                     gripper: torch.Tensor) -> torch.Tensor:
    """(dxyz [..., 3], rot6d [..., 6], grip [...]) -> normalized [..., 10]."""
    bounds = torch.as_tensor(SCENE_BOUNDS, device=rel_xyz.device)
    span = (bounds[3:] - bounds[:3]).clamp_min(1e-8)
    xyz01 = ((rel_xyz / span).clamp(-1.0, 1.0) + 1.0) * 0.5
    r601 = (rel_r6.clamp(-1.0, 1.0) + 1.0) * 0.5
    g01 = gripper.clamp(0.0, 1.0)
    return torch.cat([_to_range(xyz01, rescale=False),
                      _to_range(r601, rescale=True),
                      _to_range(g01, rescale=True)[..., None]], dim=-1)


def _rot6d(rotmats: torch.Tensor) -> torch.Tensor:
    """The first two columns of R, row-major: [R00, R01, R10, R11, R20, R21]."""
    return rotmats[..., :, :2].reshape(*rotmats.shape[:-2], 6)


def encode_pose_absolute(continuous_action: torch.Tensor) -> torch.Tensor:
    """Manip codec, absolute pose: [T, 8] (xyz, quat xyzw, grip) -> [T, 10];
    xyz enters as the synthetic relative vector 2 * (xyz - scene centre)."""
    a = continuous_action.float()
    bounds = torch.as_tensor(SCENE_BOUNDS, device=a.device)
    center = 0.5 * (bounds[:3] + bounds[3:])
    rel_xyz = 2.0 * (a[..., :3] - center)
    return normalize_action(rel_xyz, _rot6d(quat_to_rotmat(a[..., 3:7])),
                            a[..., 7])


def encode_pose_relative(continuous_action: torch.Tensor) -> torch.Tensor:
    """Manip codec, relative pose: [T, 8] -> [T, 10], row 0 all zeros;
    rel_xyz = R_prev^T (xyz_t - xyz_{t-1}), rel_R = R_prev^T R_t."""
    a = continuous_action.float()
    xyz, grip = a[..., :3], a[..., 7]
    rotm = quat_to_rotmat(a[..., 3:7])
    prev_t = rotm[:-1].transpose(-1, -2)
    rel_xyz = torch.einsum("nij,nj->ni", prev_t, xyz[1:] - xyz[:-1])
    rel_rot = torch.einsum("nij,njk->nik", prev_t, rotm[1:])
    rows = normalize_action(rel_xyz, _rot6d(rel_rot), grip[1:])
    return torch.cat([rows.new_zeros((1, 10)), rows], dim=0)


def get_action_ids(actions: torch.Tensor, strategy: str,
                   use_absolute_pose: bool = True) -> torch.Tensor:
    """Encode `actions` ([B, F] nav ids or [B, F, 8] manipulation poses) for
    `strategy`: fp32 [B, F, 4] one-hot for action_block(_nocfg); for
    micro_cond fp32 [B, F, F] from nav ids or [B, F, 10] from poses; an
    empty tensor for no strategy."""
    if strategy in ("action_block", "action_block_nocfg"):
        return encode_onehot(actions)
    if strategy == "micro_cond":
        if actions.ndim == 2:
            return encode_idx(actions).to(torch.float32)
        encode = encode_pose_absolute if use_absolute_pose else encode_pose_relative
        return torch.stack([encode(a) for a in actions])
    return torch.zeros(0, dtype=torch.float32, device=actions.device)


def actions_to_prompt(action_ids, task_type: str = "navigation") -> str:
    """Text rendering of a nav action sequence for text-conditioned WMs."""
    names = {
        1: "forward 0.2m",
        2: "turn_left 22.5\N{DEGREE SIGN}",
        3: "turn_right 22.5\N{DEGREE SIGN}",
        4: "stop",
        0: "placeholder",
    }
    seq = [names.get(int(a), "placeholder")
           for a in np.asarray(action_ids).reshape(-1)]
    return "Follow this sequence of camera motions: " + str(seq)
