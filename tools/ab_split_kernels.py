"""K8-apply and K7-conv's quantisation pass against those of another
checkout, side by side on one card.

    python3 tools/ab_split_kernels.py BASE

BASE is a checkout of commit c44d0c1 (for example `git archive c44d0c1 |
tar -x -C BASE`): the split GroupNorm's combine entry then its apply entry,
the parameters cast to fp32 first, and K7-conv's pass on a zero-padded bf16
copy of a row shard. Its `group_norm.cu` and `w8a8.cu` are built with this
checkout's nvcc flags. Each case is timed in the order base, this, this,
base (device time from torch.profiler, one launch of the kernel named), and
each pair's outputs must be equal bit for bit:
  * K8-apply on the largest shard at fsdp 4 of each `chip_smoke.
    SPLIT_GN_SHAPES` shape, x in bf16 (the served UNet) and in fp32, the
    parameters fp32;
  * K7-conv's quantisation pass at the level-0 2-row conv and the decoder-
    sized conv (`chip_smoke.AMAX_DECODER`);
  * K7-conv-halo's pass on the level-0 shard and its two neighbour rows
    against the base's pass on the padded copy of the same rows.
Prints the card's name and power limit, a line a case and, last, one JSON
object of the times (ms). Needs a CUDA card and nvcc."""
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as C  # noqa: E402
from wiw_tpu_torch.ops import group_norm as TG  # noqa: E402
from wiw_tpu_torch.ops import native  # noqa: E402
from wiw_tpu_torch.ops import quant as TQ  # noqa: E402
from wiw_tpu_torch.parallel.clip_sharding import pad_rows, split_rows  # noqa: E402


def build_base(base: str) -> dict:
    """The base's two libraries, built at once."""
    out = tempfile.mkdtemp(prefix="wiw_ab_")
    procs = {}
    for name in ("group_norm", "w8a8"):
        so = os.path.join(out, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [native.nvcc_path(), *native.NVCC_FLAGS, "-o", so,
             os.path.join(base, "wiw_tpu_torch", "csrc", f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"the base's {name}.cu does not build:\n{log}")
        libs[name] = ctypes.CDLL(so)
    gn, w8 = libs["group_norm"], libs["w8a8"]
    gn.wiw_group_norm_combine.argtypes = ([ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int64, ctypes.c_float, ctypes.c_void_p])
    gn.wiw_group_norm_apply.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int64] * 2
                                        + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    w8.wiw_w8a8_conv.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
    return libs


def base_apply(lib, x, every, w, b, silu):
    """The base's split apply: fp32 parameters, its combine entry, then its
    apply entry."""
    dev = x.device
    R, N, G, _ = every.shape
    wf, bf = w.float(), b.float()
    mean = torch.empty(N, G, device=dev)
    rstd = torch.empty_like(mean)
    s = native.raw_stream(dev)
    if lib.wiw_group_norm_combine(every.data_ptr(), mean.data_ptr(), rstd.data_ptr(), R,
                                  N * G, 1e-5, s):
        raise RuntimeError("the base's combine entry failed")
    y = torch.empty_like(x)
    C_ = x.shape[-1]
    if lib.wiw_group_norm_apply(x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), wf.data_ptr(),
                                bf.data_ptr(), y.data_ptr(), N, x.numel() // (N * C_), C_, G,
                                int(x.dtype == torch.bfloat16), int(silu), s):
        raise RuntimeError("the base's apply entry failed")
    return y


def base_conv(lib, x, w8, ws, bias, pad, amax=None):
    """The base's K7-conv (stride 1), its amax pass unless `amax` is given."""
    Nb, H, W, C_ = x.shape
    O, kh, kw, _ = w8.shape
    OH, OW = H + 2 * pad - kh + 1, W + 2 * pad - kw + 1
    bn, bw = TQ.k7_plan(O, C_, 1, OW)
    x8 = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    out = torch.empty(Nb, OH, OW, O, dtype=torch.bfloat16, device=x.device)
    given = amax is not None
    am = amax if given else torch.empty(1, device=x.device)
    if lib.wiw_w8a8_conv(x.data_ptr(), x8.data_ptr(), am.data_ptr(), w8.data_ptr(),
                         ws.data_ptr(), bias.data_ptr(), out.data_ptr(), Nb, H, W, C_, O, kh,
                         kw, 1, pad, OH, OW, bn, bw,
                         int(x.dtype == torch.float32) | (int(given) << 2),
                         native.raw_stream(x.device)):
        raise RuntimeError("the base's K7-conv failed")
    return out


def abba(label, base_fn, this_fn, keys, bound, results):
    """Bits, then device times in the order base, this, this, base."""
    same = torch.equal(base_fn(), this_fn())
    t = [C.device_ms(f, keys, 20) for f in (base_fn, this_fn, this_fn, base_fn)]
    was, now = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
    print(f"{label}: bits equal {same}; device a launch base {t[0]:.4f} / {t[3]:.4f} ms, "
          f"this {t[1]:.4f} / {t[2]:.4f} ms (bound {bound:.4f} ms: {bound / was:.3f} / "
          f"{bound / now:.3f} of it)", flush=True)
    if not same:
        raise RuntimeError(f"{label}: this checkout's output departs from the base's")
    results[label] = {"base_ms": [t[0], t[3]], "ms": [t[1], t[2]], "bound_ms": bound}


def main(base: str) -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(C.card_line(), flush=True)
    native.load_libraries("group_norm", "w8a8")
    libs = build_base(base)
    g = torch.Generator(device=dev).manual_seed(0)
    results = {}
    for shape, silu in C.SPLIT_GN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.3).to(dtype)
            w = torch.randn(shape[-1], generator=g, device=dev)
            b = torch.randn(shape[-1], generator=g, device=dev)
            parts = [x.narrow(-3, r.start, len(r)).contiguous()
                     for r in split_rows(shape[-3], 4) if len(r)]
            every = torch.stack([TG.group_norm_stats(p, 32) for p in parts])
            s0 = parts[0]
            abba(f"K8-apply {tuple(s0.shape)} {str(dtype)[6:]}",
                 lambda: base_apply(libs["group_norm"], s0, every, w, b, silu),
                 lambda: TG.group_norm_apply(s0, every, w, b, 1e-5, silu), ("gn_apply",),
                 C.bound_ms(2 * s0.numel() * s0.element_size(), 0, C.BF16_FLOPS_S), results)
            del x, parts, every, s0
    for xshape in (C.SPLIT_CONV[0], C.AMAX_DECODER):
        x = torch.randn(xshape, generator=g, device=dev).to(torch.bfloat16)
        c = xshape[-1]
        w8 = torch.randint(-127, 128, (c, 3, 3, c), generator=g, device=dev, dtype=torch.int8)
        ws = torch.rand(c, generator=g, device=dev) * 1e-3
        bias = torch.randn(c, generator=g, device=dev)
        abba(f"K7-conv's quantisation pass {xshape}",
             lambda: base_conv(libs["w8a8"], x, w8, ws, bias, 1),
             lambda: TQ.w8a8_conv(x, w8, ws, bias, padding=1), ("quant_tensor",),
             C.bound_ms(3 * x.numel(), 0, C.BF16_FLOPS_S), results)
        if xshape == C.SPLIT_CONV[0]:
            r = split_rows(xshape[1], 4)[1]  # a shard with both neighbours
            own = x[:, r.start:r.stop].contiguous()
            top, bottom = (x[:, i:i + 1].contiguous() for i in (r.start - 1, r.stop))
            amax = TQ.conv_amax(x)
            padded = pad_rows(own, top, bottom)
            rows = own.shape[1] + 2
            abba(f"K7-conv-halo's pass {tuple(own.shape)} and two neighbour rows (base: "
                 f"the given-amax pass on the padded copy {tuple(padded.shape)})",
                 lambda: base_conv(libs["w8a8"], padded, w8, ws, bias, 0, amax),
                 lambda: TQ.w8a8_conv_halo(own, top, bottom, w8, ws, bias, amax=amax),
                 ("quant_tensor",),
                 C.bound_ms(3 * own.numel() // own.shape[1] * rows, 0, C.BF16_FLOPS_S),
                 results)
        del x, w8
        torch.cuda.empty_cache()
    print(json.dumps({"ab_split_kernels": results, "card": C.card_line()}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1]))
