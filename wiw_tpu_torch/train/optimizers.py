"""The reference's memory-saving optimizers, as optax computes them.

`wiw_tpu/train/trainer.py:163-180` builds them through optax; these are
their ports, each a `torch.optim.Optimizer` whose state is made whole when
it is built (as optax's `init`) and travels in `state_dict()`:

* `AdamWBf16Moment`: `optax.adamw(lr, b1, b2, eps, weight_decay,
  mu_dtype=bfloat16)`. The first moment is kept in bf16 and the second in
  fp32. As the reference's jitted step computes it, the new first moment
  is (1 - b1)·g + b1'·mu in fp32, one fused multiply-add, where b1' is b1
  rounded to bf16 (the decay meets a bf16 operand) and the product b1'·mu
  is exact (XLA fuses the two and contracts them); the update takes
  that fp32 value, bias-corrected, and only then is the moment stored as
  bf16 (round to nearest even). The update is
  mu_hat / (sqrt(nu_hat) + eps) + wd·p, scaled by -lr.
  `torch.optim.AdamW` cannot serve: its moments take the parameters' dtype.
* `Adafactor`: `optax.adafactor(lr, weight_decay_rate=wd,
  clipping_threshold=None)` at optax 0.2.6's defaults: the second moment
  decays at 1 - (k + 1)^-0.8 on step k, is factored into row and column
  means over the two largest axes of the reference's leaf where the
  smaller of them has at least 128 entries (else kept whole), epsilon
  1e-30 on the squared gradient, no momentum; the update is scaled by the
  learning rate and by the parameter's RMS (at least 1e-3); the weight
  decay is added after both, so it is not multiplied by the learning
  rate: p <- p - lr·rms(p)·u - wd·p. `torch.optim.Adafactor` differs in its
  decay schedule, epsilons and weight decay.

The factored axes are those of the reference's (flax) leaf: `layouts`
gives each parameter's torch axes in flax order (`models/convert.
flax_axes`), so a torch conv weight [Cout, Cin, 3, 3] factors over the
axes the reference's [3, 3, Cin, Cout] does, ties included.

The arithmetic runs in `_foreach` passes over chunks of parameters, but for
Adafactor's factored leaves, one at a time. Both take parameters sharded by
FSDP2 (DTensors). Elementwise work runs on each rank's shard; Adafactor's
row and column means and the parameter's
RMS span the whole leaf, so where they reduce over a sharded axis the
partial sums are all-reduced over the shard group. A moment of a sharded
parameter is a DTensor sharded like the values it holds.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

# a foreach pass touches at most this many elements at once, which bounds
# the fp32 temporaries of a pass (256 MB each)
CHUNK_ELEMS = 2**26

# optax 0.2.6's adafactor defaults, the reference's settings
DECAY_RATE = 0.8
EPS = 1e-30
MIN_DIM_TO_FACTOR = 128
MIN_SCALE = 1e-3


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _chunks(params: Sequence[torch.Tensor]):
    """Index ranges over `params` of at most CHUNK_ELEMS elements each (a
    larger tensor alone)."""
    start, n = 0, 0
    for i, p in enumerate(params):
        if n and n + p.numel() > CHUNK_ELEMS:
            yield range(start, i)
            start, n = i, 0
        n += p.numel()
    if start < len(params):
        yield range(start, len(params))


class AdamWBf16Moment(torch.optim.Optimizer):
    """optax's adamw with a bf16 first moment (see the module docstring)."""

    def __init__(self, params, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-4):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))
        for group in self.param_groups:
            for p in group["params"]:
                self.state[p] = {
                    "step": torch.tensor(0.0),
                    "mu": torch.zeros_like(p, dtype=torch.bfloat16),
                    "nu": torch.zeros_like(p, dtype=torch.float32)}

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        for st in self.state.values():  # the base class casts to the param dtype
            st["mu"] = st["mu"].to(torch.bfloat16)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            b1_bf16 = float(torch.tensor(b1, dtype=torch.bfloat16))
            lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            states = [self.state[p] for p in params]
            count = states[0]["step"].item() + 1
            for st in states:
                st["step"].fill_(count)
            # optax's bias corrections, 1 - decay^count in fp32
            bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** count)
            bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** count)
            for idx in _chunks(params):
                ps = [_local(params[i]) for i in idx]
                gs = [_local(params[i].grad) for i in idx]
                mus = [_local(states[i]["mu"]) for i in idx]
                nus = [_local(states[i]["nu"]) for i in idx]
                # mu' = (1 - b1) g + b1' mu in fp32 (add with alpha: one
                # fused multiply-add); nu' = (1 - b2) g^2 + b2 nu
                m32 = torch._foreach_mul([m.float() for m in mus], b1_bf16)
                torch._foreach_add_(m32, gs, alpha=1 - b1)
                g2 = torch._foreach_mul(gs, gs)
                torch._foreach_mul_(g2, 1 - b2)
                torch._foreach_mul_(nus, b2)
                torch._foreach_add_(nus, g2)
                for m, v in zip(mus, m32):
                    m.copy_(v)  # bf16, round to nearest even
                # u = mu'/bc1 / (sqrt(nu'/bc2) + eps) + wd p;  p += -lr u
                den = torch._foreach_div(nus, bc2)
                torch._foreach_sqrt_(den)
                torch._foreach_add_(den, eps)
                torch._foreach_div_(m32, bc1)
                torch._foreach_div_(m32, den)
                torch._foreach_add_(m32, torch._foreach_mul(ps, wd))
                torch._foreach_mul_(m32, -lr)
                torch._foreach_add_(ps, m32)


def factored_axes(shape: Sequence[int]) -> Optional[tuple]:
    """optax's `_factored_dims`: (d1, d0), the second-largest and the
    largest axis (a stable sort: on a tie the later axis is d0), or None
    when the leaf has fewer than 2 axes or d1 has fewer than
    MIN_DIM_TO_FACTOR entries."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape, kind="stable")
    if shape[order[-2]] < MIN_DIM_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


class _Leaf:
    """How a parameter's values lie: its shard axis and the group it is
    split over (None for a whole tensor), to reduce over the whole leaf."""

    def __init__(self, p: torch.Tensor):
        self.axis = self.group = self.mesh = None
        if isinstance(p, DTensor):
            self.mesh, self.placements = p.device_mesh, p.placements
            for i, pl in enumerate(p.placements):
                if pl.is_shard():
                    self.axis, self.group = pl.dim, p.device_mesh.get_group(i)

    def reduced(self, dim: int) -> "_Leaf":
        """The layout after reducing `dim` away."""
        out = _Leaf.__new__(_Leaf)
        out.mesh, out.group = self.mesh, self.group
        out.axis = (None if self.axis is None or self.axis == dim
                    else self.axis - (self.axis > dim))
        if self.mesh is not None:
            out.placements = tuple(
                Shard(out.axis) if pl.is_shard() and out.axis is not None
                else Replicate() for pl in self.placements)
        return out

    def mean(self, x: torch.Tensor, dim: int, n: int, keepdim=False):
        """Mean over `dim` of the whole leaf whose local values are x."""
        s = x.sum(dim, keepdim=keepdim)
        if dim == self.axis:
            dist.all_reduce(s, group=self.group)
        return s / n

    def rms(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """sqrt(mean(x^2)) over the whole leaf (0-d tensor)."""
        s = (x * x).sum()
        if self.axis is not None:
            dist.all_reduce(s, group=self.group)
        return torch.sqrt(s / n)

    def wrap(self, local: torch.Tensor, shape) -> torch.Tensor:
        """A state tensor holding `local`: a DTensor laid out as this
        layout says where the parameter is one, else `local` itself."""
        if self.mesh is None:
            return local
        return DTensor.from_local(local, self.mesh, self.placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=torch.empty(shape, device="meta").stride())


class Adafactor(torch.optim.Optimizer):
    """optax's adafactor at the reference's settings (see the module
    docstring). `layouts[i]` is parameter i's torch axes in the reference's
    (flax) order, or None for the torch order."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0,
                 layouts: Optional[Sequence] = None):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))
        plist = [p for g in self.param_groups for p in g["params"]]
        layouts = list(layouts) if layouts is not None else [None] * len(plist)
        if len(layouts) != len(plist):
            raise ValueError(f"{len(layouts)} layouts for {len(plist)} parameters")
        self._dims = {}  # parameter -> its factored (d1, d0) torch axes, or None
        for p, axes in zip(plist, layouts):
            axes = tuple(range(p.ndim)) if axes is None else tuple(axes)
            dims = factored_axes([p.shape[a] for a in axes])
            st = {"step": torch.tensor(0.0)}
            self._dims[p] = dims and (axes[dims[0]], axes[dims[1]])
            if dims is None:
                st["v"] = torch.zeros_like(p, dtype=torch.float32)
            else:
                d1, d0 = self._dims[p]
                leaf = _Leaf(p)
                local = _local(p)
                for key, d in (("v_row", d0), ("v_col", d1)):
                    shape = [s for i, s in enumerate(p.shape) if i != d]
                    zeros = torch.zeros([s for i, s in enumerate(local.shape) if i != d],
                                        dtype=torch.float32, device=local.device)
                    st[key] = leaf.reduced(d).wrap(zeros, shape)
            self.state[p] = st

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            k = self.state[params[0]]["step"].item()  # the group steps together
            for p in params:
                self.state[p]["step"].fill_(k + 1)
            t = torch.tensor(k + 1, dtype=torch.float32)
            decay = float(1.0 - t ** -DECAY_RATE)
            whole = [p for p in params if self._dims[p] is None]
            for idx in _chunks(whole):
                self._whole_step([whole[i] for i in idx], group, decay)
            for p in params:
                if self._dims[p] is not None:
                    self._factored_step(p, group, decay)

    def _scales(self, params, xs, group) -> list:
        """lr * max(rms(p), MIN_SCALE) of each parameter (0-d tensors), the
        RMS over the whole leaf: sums of squares all-reduced over each
        shard group."""
        sq = list(torch._foreach_norm(xs))
        torch._foreach_mul_(sq, sq)
        leaves = [_Leaf(p) for p in params]
        for grp in {id(lf.group): lf.group for lf in leaves if lf.axis is not None}.values():
            idx = [i for i, lf in enumerate(leaves) if lf.axis is not None and lf.group is grp]
            part = torch.stack([sq[i] for i in idx])
            dist.all_reduce(part, group=grp)
            for i, v in zip(idx, part.unbind()):
                sq[i] = v
        torch._foreach_div_(sq, [float(p.numel()) for p in params])
        torch._foreach_sqrt_(sq)
        torch._foreach_clamp_min_(sq, MIN_SCALE)
        torch._foreach_mul_(sq, group["lr"])
        return sq

    def _whole_step(self, params, group, decay):
        """The leaves kept whole, in `_foreach` passes: v = decay v +
        (1 - decay)(g^2 + eps); u = g / sqrt(v)."""
        gs = [_local(p.grad) for p in params]
        xs = [_local(p) for p in params]
        vs = [_local(self.state[p]["v"]) for p in params]
        g2 = torch._foreach_mul(gs, gs)
        torch._foreach_add_(g2, EPS)
        torch._foreach_mul_(g2, 1.0 - decay)
        torch._foreach_mul_(vs, decay)
        torch._foreach_add_(vs, g2)
        u = torch._foreach_mul(gs, torch._foreach_rsqrt(vs))
        torch._foreach_mul_(u, self._scales(params, xs, group))
        torch._foreach_add_(u, torch._foreach_mul(xs, group["weight_decay"]))
        torch._foreach_sub_(xs, u)

    def _factored_step(self, p, group, decay):
        """A factored leaf: the row and column means of g^2 + eps over the
        whole leaf, u = g / sqrt(v_row v_col / mean(v_row))."""
        st = self.state[p]
        leaf, g, x = _Leaf(p), _local(p.grad), _local(p)
        g2 = g * g + EPS
        d1, d0 = self._dims[p]
        v_row, v_col = _local(st["v_row"]), _local(st["v_col"])
        v_row.mul_(decay).add_(leaf.mean(g2, d0, p.shape[d0]) * (1.0 - decay))
        v_col.mul_(decay).add_(leaf.mean(g2, d1, p.shape[d1]) * (1.0 - decay))
        r1 = d1 - 1 if d1 > d0 else d1  # d1's axis in v_row
        row_mean = leaf.reduced(d0).mean(v_row, r1, p.shape[d1], keepdim=True)
        u = g * (v_row / row_mean).rsqrt().unsqueeze(d0) * v_col.rsqrt().unsqueeze(d1)
        scale = torch.clamp(leaf.rms(x, p.numel()), min=MIN_SCALE)
        x.sub_(u * group["lr"] * scale + x * group["weight_decay"])
