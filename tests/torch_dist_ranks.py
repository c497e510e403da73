"""One rank of the port's multi-process tests (not collected by pytest).

    python tests/torch_dist_ranks.py INPUTS RANK WORLD OUT_DIR
    python -m torch.distributed.run --nproc_per_node N \
        tests/torch_dist_ranks.py cli CONFIGS [train_cli arguments]

The first form joins a gloo group of WORLD ranks through a file beside
INPUTS (`file://`: no port to collide on) and runs the scenarios INPUTS
names, in order, on the tiny pipeline INPUTS holds (its configs and
weights); rank 0 writes each scenario's results to OUT_DIR/<name>.pt. The
second runs `train_cli.main` with the tiny frozen towers of CONFIGS in
place of the CLI's full-size ones. Imports no jax: the tests compare what
it writes with the reference.
"""

import contextlib
import copy
import os
import sys

import torch
import torch.distributed as dist

torch.set_num_threads(1)

from wiw_tpu_torch.models import layers as L  # noqa: E402
from wiw_tpu_torch.ops import quant as Q  # noqa: E402
from wiw_tpu_torch.parallel import batch_rows, clip_sharding as CS, make_mesh  # noqa: E402
from wiw_tpu_torch.parallel.multihost import initialize_distributed  # noqa: E402
from wiw_tpu_torch.sampling.pipeline import SVDPipeline  # noqa: E402
from wiw_tpu_torch.train import trainer as TT  # noqa: E402
from wiw_tpu_torch.train.checkpoints import CheckpointManager  # noqa: E402


def pipeline(inputs, int8: bool = False, vae_int8: bool = False) -> SVDPipeline:
    pipe = SVDPipeline(*inputs["cfgs"], device="cpu")
    if int8:
        pipe.quantize_unet()
    if vae_int8:
        pipe.quantize_vae()
    pipe.load_state_dicts(*inputs["weights"])
    return pipe


def local_rows(mesh, batch: dict, accum: bool) -> dict:
    """This rank's rows of a global batch ([A, B, ...] with accumulation)."""
    n = next(iter(batch.values())).shape[1 if accum else 0]
    r = batch_rows(mesh, dist.get_rank(), n)
    return {k: (v[:, r.start:r.stop] if accum else v[r.start:r.stop])
            for k, v in batch.items()}


def trained(inputs, spec, mesh_shape, steps, restore=None, save=None) -> dict:
    """A sharded trainer's state after `steps` (batch, draws) pairs, from
    the initial weights or the checkpoint `restore` (dir, step); `save`
    (dir, after how many steps) writes one from rank 0."""
    mesh = make_mesh(*mesh_shape)
    cfg = TT.TrainConfig(**spec["kw"])
    trainer = TT.Trainer(pipeline(inputs), cfg, mesh=mesh)
    state = trainer.init_state()
    if restore is not None:
        state.load_state_dict(CheckpointManager(restore[0]).restore(restore[1]))
    metrics = []
    for i, (batch, draws) in enumerate(steps):
        m = trainer.train_step(state, local_rows(mesh, batch, cfg.grad_accum_steps > 1),
                               draws=draws)
        metrics.append({k: float(v) for k, v in m.items()})
        if save is not None and save[1] == i + 1:
            sd = state.state_dict()
            if dist.get_rank() == 0:
                CheckpointManager(save[0]).save(state.step, sd)
    sd = state.state_dict()
    shard_axes = {n: [pl.dim for pl in p.placements if pl.is_shard()]
                  for n, p in state.params.items()}
    return {"state": sd, "metrics": metrics, "shard_axes": shard_axes}


def scenario_steps(inputs, spec):
    return {f"{dp}x{fsdp}": trained(inputs, spec, (dp, fsdp),
                                    [(spec["batch"], spec["draws"])])
            for dp, fsdp in spec["meshes"]}


def scenario_draws(inputs, spec):
    """Every rank's `sample_draws` for its rows, from the same seed."""
    trainer = TT.Trainer(pipeline(inputs), TT.TrainConfig(), mesh=make_mesh(*spec["mesh"]))
    mine = trainer.sample_draws(spec["shape"], True, torch.Generator().manual_seed(spec["seed"]))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def scenario_checkpoint(inputs, spec):
    """Restore a checkpoint written at world size 1, step, write one at
    this world size, step again."""
    return trained(inputs, spec, spec["mesh"], spec["steps"],
                   restore=spec["restore"], save=spec["save"])


def scenario_generate(inputs, spec):
    mesh = make_mesh(*spec["mesh"])
    pipe = pipeline(inputs)
    out = {}
    for name, kw in spec["calls"].items():
        kw = dict(kw)
        if "seed" in kw:
            kw["generator"] = torch.Generator().manual_seed(kw.pop("seed"))
        out[name] = pipe.generate(spec["image"], kw.pop("gen", spec["gen"]), mesh=mesh,
                                  **kw)
    for name, (image, kw) in spec["refusals"].items():
        kw = dict(kw)
        where = mesh
        if "mesh_dims" in kw:  # a mesh of its own: {axis name: size}
            from torch.distributed.device_mesh import init_device_mesh

            dims = kw.pop("mesh_dims")
            where = init_device_mesh("cpu", tuple(dims.values()),
                                     mesh_dim_names=tuple(dims))
        try:
            pipe.generate(image, spec["gen"], mesh=where, **kw)
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


# ------------------------------------------------------------- shard_clip
CLIP_W = 8  # the width of the module cases' feature maps
CLIP_HEADS = (2, 3, 5, 20)
CLIP_CONV_HEIGHTS = (6, 3)


@torch.no_grad()
def clip_cases(seed: int = 0) -> dict:
    """The module-level shard_clip cases, the same in every process: a
    GroupNorm (+ SiLU) and its inputs in the spatial [N, H, W, C] and the
    temporal [B, F, H, W, C] layouts (3 rows: a rank without rows at fsdp
    4), a 3x3 conv, a Downsample2D and an Upsample2D in fp32 and as int8
    (W8A8) copies with their inputs, and q/k/v [2, heads, 6 * CLIP_W, 16]
    for each of CLIP_HEADS."""
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        gn = L.GroupNorm(32, 8, silu=True)
        gn.weight.normal_()
        gn.bias.normal_()
        convs = {"conv": L.Conv2d(16, 16, 3, padding=1), "down": L.Downsample2D(16),
                 "up": L.Upsample2D(16)}
        xs = {h: torch.randn(2, h, CLIP_W, 16) for h in CLIP_CONV_HEIGHTS}
        norms = {"gn": (torch.randn(2, 3, CLIP_W, 32), 1),
                 "gn_t": (torch.randn(2, 3, 3, CLIP_W, 32), 2)}
        qkv = {h: tuple(torch.randn(2, h, 6 * CLIP_W, 16) for _ in range(3))
               for h in CLIP_HEADS}
    int8 = {}
    for name, m in convs.items():
        m8 = copy.deepcopy(m)
        Q.quantize_module_(m8 if name == "conv" else m8.conv, torch.float32)
        int8[name] = m8
    return {"gn": gn, "norms": norms, "convs": convs, "int8": int8, "xs": xs, "qkv": qkv}


def _local(mesh, x, dim: int, height: int):
    r = CS.split_rows(height, mesh["fsdp"].size())[mesh.get_local_rank("fsdp")]
    return x.narrow(dim, r.start, len(r))


@torch.no_grad()
def clip_modules(mesh) -> dict:
    """This rank's outputs of the module cases under shard_clip: its rows
    of each GroupNorm, conv and resampler (with the level height after
    it), its amax and codes of each int8 conv's input, and its positions of
    the spatial attention by each arm."""
    c = clip_cases()
    out = {}
    for name, (x, dim) in c["norms"].items():
        with CS.activate(mesh, None, x.shape[dim], CLIP_W):
            out[name] = c["gn"](_local(mesh, x, dim, x.shape[dim]))
    for kind in ("convs", "int8"):
        for name, m in c[kind].items():
            for h, x in c["xs"].items():
                with CS.activate(mesh, None, h, CLIP_W) as cs:
                    y = m(_local(mesh, x, 1, h))
                out[(kind, name, h)] = (y, cs.height)
    for h, x in c["xs"].items():
        with CS.activate(mesh, None, h, CLIP_W) as cs:
            loc = _local(mesh, x, 1, h)
            amax = CS.global_amax(cs, loc)
            out[("codes", h)] = (amax, Q._quant_tensor(loc, amax)[0])
    for heads, (q, k, v) in c["qkv"].items():
        for arm in CS.ATTENTION_ARMS:
            cs = CS.ClipSharding(mesh, None, height=6, width=CLIP_W, attention=arm)
            out[("attn", heads, arm)] = CS.spatial_attention(
                cs, *(_seq(mesh, t) for t in (q, k, v)))
    return out


def _seq(mesh, t):
    """This rank's positions of [B, H, 6 * CLIP_W, D]: its rows of 6."""
    r = CS.split_rows(6, mesh["fsdp"].size())[mesh.get_local_rank("fsdp")]
    return t[:, :, r.start * CLIP_W:r.stop * CLIP_W]


@contextlib.contextmanager
def shard_attn(arm):
    old = os.environ.get("WIW_SHARD_ATTN")
    if arm is not None:
        os.environ["WIW_SHARD_ATTN"] = arm
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("WIW_SHARD_ATTN", None)
        else:
            os.environ["WIW_SHARD_ATTN"] = old


def scenario_clip(inputs, spec):
    """shard_clip on each mesh of the same group: the module cases, the
    frame-parallel decode of the given latents with an int8 decoder, then
    `generate(shard_clip=True)` for each call (its frames from every rank),
    then the refusals. Returns every rank's results."""
    pipes = {False: pipeline(inputs), True: pipeline(inputs, int8=True)}
    vae8 = pipeline(inputs, vae_int8=True)
    mine = {}
    for shape in spec["meshes"]:
        mesh = make_mesh(*shape)
        res = {"fsdp": mesh.get_local_rank("fsdp"), "dp": mesh.get_local_rank("dp"),
               "modules": clip_modules(mesh), "generate": {},
               "decode": {n: vae8._decode_chunked(spec["decode"], gen, mesh=mesh)
                          for n, gen in spec["decode_gens"].items()}}
        for name, kw in spec["calls"].items():
            kw = dict(kw)
            pipe = pipes[kw.pop("int8", False)]
            if "seed" in kw:
                kw["generator"] = torch.Generator().manual_seed(kw.pop("seed"))
            with shard_attn(kw.pop("attention", None)):
                res["generate"][name] = pipe.generate(
                    kw.pop("image"), kw.pop("gen"), mesh=mesh, shard_clip=True, **kw)
        mine["x".join(map(str, shape))] = res
    refusals = {}
    from torch.distributed.device_mesh import init_device_mesh

    from wiw_tpu_torch.parallel import shard_unet

    meshes = {"no_fsdp": lambda: init_device_mesh("cpu", (dist.get_world_size(),),
                                                  mesh_dim_names=("dp",)),
              "dp4": lambda: make_mesh(dist.get_world_size(), 1)}
    for name, mesh in meshes.items():
        refusals[name] = _refusal(pipes[False], spec, mesh())
    mesh = make_mesh(1, dist.get_world_size())
    sharded = pipeline(inputs)
    shard_unet(sharded.unet, mesh)
    refusals["fsdp2"] = _refusal(sharded, spec, mesh)
    mine["refusals"] = refusals
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return every


def _refusal(pipe, spec, mesh):
    try:
        video = spec["calls"]["video"]
        pipe.generate(video["image"], video["gen"], mesh=mesh, shard_clip=True)
        return None
    except ValueError as e:
        return f"{type(e).__name__}: {e}"


SCENARIOS = {"steps": scenario_steps, "checkpoint": scenario_checkpoint,
             "generate": scenario_generate, "draws": scenario_draws,
             "clip": scenario_clip}


def main(argv):
    if argv[0] == "cli":
        from wiw_tpu_torch.train import train_cli

        cfgs = torch.load(argv[1], weights_only=False)
        train_cli.VAE_CONFIG, train_cli.CLIP_CONFIG = cfgs["vae"], cfgs["clip"]
        train_cli.main(argv[2:])
        return
    inputs_path, rank, world, out_dir = argv[0], int(argv[1]), int(argv[2]), argv[3]
    inputs = torch.load(inputs_path, weights_only=False)
    initialize_distributed("cpu", init_method="file://" + inputs_path + ".pg",
                           world_size=world, rank=rank)
    try:
        for name, spec in inputs["scenarios"].items():
            out = SCENARIOS[spec["run"]](inputs, spec)
            if rank == 0:
                torch.save(out, os.path.join(out_dir, name + ".pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
