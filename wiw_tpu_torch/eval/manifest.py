"""Real-weight readiness manifest for the eval towers (FVD's I3D and LPIPS).

The port's own copy of `wiw_tpu/eval/manifest.py` (which imports no JAX;
the port imports nothing of the reference package). It pins what can be
pinned offline, so that real weights load and are checked the day they
arrive:

  * the upstream file names and sources the loaders expect (the videogpt
    `i3d_pretrained_400.pt` I3D checkpoint; the `lpips` package's AlexNet
    heads with torchvision's AlexNet trunk, merged into one state dict)
  * the exact state-dict key layout and tensor shapes each loader takes
    (derived from the architecture, validated here)
  * SHA256 pinning with trust on first use: the first successful
    validation records the file's digest in a lockfile next to the
    weights, and every later load verifies against it. Digests are never
    invented here.

`validate_i3d_state_dict` / `validate_lpips_state_dict` run on the raw
torch state dicts and report missing, unexpected and mis-shaped keys; the
loaders (eval/fvd.py, eval/lpips.py) call them by default.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Iterable

# upstream sources (reference lineage, for the operator — not fetched here)
I3D_MANIFEST = {
    "file": "i3d_pretrained_400.pt",
    "source": "videogpt FVD backend (piergiaj/pytorch-i3d Kinetics-400 "
              "checkpoint), as fetched by the reference's "
              "evaluation/FVD/fvd/videogpt loader",
    "classes": 400,
}
LPIPS_MANIFEST = {
    "file": "alex.pth (lpips/weights/v0.1) + torchvision alexnet backbone",
    "source": "pip `lpips` package v0.1 linear heads; torchvision "
              "alexnet-owt weights for the trunk, merged into one "
              "state dict with net.features.* keys",
}

# I3D (pytorch-i3d) architecture constants: eval/fvd.py builds from these
_MIXED_SPECS = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}
_STEM = [
    # (module, in_ch, out_ch, kernel (t,h,w))
    ("Conv3d_1a_7x7", 3, 64, (7, 7, 7)),
    ("Conv3d_2b_1x1", 64, 64, (1, 1, 1)),
    ("Conv3d_2c_3x3", 64, 192, (3, 3, 3)),
]
# branch -> (kernel, in_from, out_index) within an inception module
_BRANCHES = ("b0", "b1a", "b1b", "b2a", "b2b", "b3b")


def _mixed_in_channels() -> dict:
    """Input channel count entering each Mixed module (sum of the previous
    module's concat outputs: b0 + b1b + b2b + b3b)."""
    ins = {}
    prev = 192  # after the stem
    for name, (b0, b1a, b1b, b2a, b2b, b3b) in _MIXED_SPECS.items():
        ins[name] = prev
        prev = b0 + b1b + b2b + b3b
    return ins


def expected_i3d_keys() -> dict:
    """{torch key: shape tuple} for every tensor load_i3d_weights consumes.

    Conv weights are OIDHW (torch Conv3d); bn entries are 1-d [C]."""
    keys = {}

    def unit(prefix, cin, cout, k, bn=True, bias=False):
        keys[f"{prefix}.conv3d.weight"] = (cout, cin) + tuple(k)
        if bias:
            keys[f"{prefix}.conv3d.bias"] = (cout,)
        if bn:
            for leaf in ("weight", "bias", "running_mean", "running_var"):
                keys[f"{prefix}.bn.{leaf}"] = (cout,)

    for name, cin, cout, k in _STEM:
        unit(name, cin, cout, k)
    ins = _mixed_in_channels()
    for name, (b0, b1a, b1b, b2a, b2b, b3b) in _MIXED_SPECS.items():
        cin = ins[name]
        unit(f"{name}.b0", cin, b0, (1, 1, 1))
        unit(f"{name}.b1a", cin, b1a, (1, 1, 1))
        unit(f"{name}.b1b", b1a, b1b, (3, 3, 3))
        unit(f"{name}.b2a", cin, b2a, (1, 1, 1))
        unit(f"{name}.b2b", b2a, b2b, (3, 3, 3))
        unit(f"{name}.b3b", cin, b3b, (1, 1, 1))
    final = sum(_MIXED_SPECS["Mixed_5c"][i] for i in (0, 2, 4, 5))  # 1024
    unit("logits", final, I3D_MANIFEST["classes"], (1, 1, 1),
         bn=False, bias=True)
    return keys


_LPIPS_TRUNK = {
    # torchvision alexnet features index -> (out, in, kh, kw)
    0: (64, 3, 11, 11),
    3: (192, 64, 5, 5),
    6: (384, 192, 3, 3),
    8: (256, 384, 3, 3),
    10: (256, 256, 3, 3),
}
_LPIPS_HEADS = (64, 192, 384, 256, 256)


def expected_lpips_keys() -> dict:
    keys = {}
    for i, c in enumerate(_LPIPS_HEADS):
        keys[f"lin{i}.model.1.weight"] = (1, c, 1, 1)
    for n, (co, ci, kh, kw) in _LPIPS_TRUNK.items():
        keys[f"net.features.{n}.weight"] = (co, ci, kh, kw)
        keys[f"net.features.{n}.bias"] = (co,)
    return keys


def validate_state_dict(sd: dict, expected: dict,
                        ignore_suffixes: Iterable[str] = (
                            "num_batches_tracked",)) -> dict:
    """Compare a torch state dict against an expected {key: shape} table.

    Returns {"ok": bool, "missing": [...], "unexpected": [...],
    "shape_mismatch": [(key, got, want), ...]}."""
    got = {k: tuple(v.shape) for k, v in sd.items()
           if not any(k.endswith(s) for s in ignore_suffixes)}
    missing = sorted(k for k in expected if k not in got)
    unexpected = sorted(k for k in got if k not in expected)
    mism = sorted((k, got[k], expected[k]) for k in expected
                  if k in got and got[k] != expected[k])
    return {"ok": not (missing or unexpected or mism),
            "missing": missing, "unexpected": unexpected,
            "shape_mismatch": mism}


def validate_i3d_state_dict(sd: dict) -> dict:
    return validate_state_dict(sd, expected_i3d_keys())


def validate_lpips_state_dict(sd: dict) -> dict:
    # heads-only checkpoints (the bare lpips lin weights) are also valid:
    # the trunk then loads from a separate torchvision file
    exp = expected_lpips_keys()
    res = validate_state_dict(sd, exp)
    if not res["ok"] and not res["unexpected"] and not res["shape_mismatch"]:
        heads = {k: v for k, v in exp.items() if k.startswith("lin")}
        if set(res["missing"]) == set(exp) - set(heads):
            res2 = validate_state_dict(sd, heads)
            res2["trunk"] = "absent (torchvision trunk required separately)"
            return res2
    return res


# ---------------------------------------------------------------------------
def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def pin_or_verify_sha256(path: str, lockfile: str = "") -> dict:
    """Trust-on-first-use digest pinning (zero-egress environment: true
    upstream digests cannot be fetched, and inventing them would be worse
    than recording what was actually validated).

    First call: writes {basename: digest} into the lockfile. Later calls:
    verifies and raises on mismatch."""
    lockfile = lockfile or os.path.join(os.path.dirname(path) or ".",
                                        "wiw_weights.lock.json")
    digest = sha256_file(path)
    name = os.path.basename(path)
    lock = {}
    if os.path.exists(lockfile):
        with open(lockfile) as f:
            lock = json.load(f)
    if name in lock:
        if lock[name] != digest:
            raise ValueError(
                f"SHA256 mismatch for {name}: pinned {lock[name][:16]}..., "
                f"file has {digest[:16]}... — the weight file changed since "
                "it was validated; re-run the exactness suite before "
                "trusting it")
        return {"status": "verified", "sha256": digest}
    lock[name] = digest
    with open(lockfile, "w") as f:
        json.dump(lock, f, indent=1, sort_keys=True)
    return {"status": "pinned", "sha256": digest}
