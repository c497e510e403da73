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

import os
import sys

import torch
import torch.distributed as dist

torch.set_num_threads(1)

from wiw_tpu_torch.parallel import batch_rows, make_mesh  # noqa: E402
from wiw_tpu_torch.parallel.multihost import initialize_distributed  # noqa: E402
from wiw_tpu_torch.sampling.pipeline import SVDPipeline  # noqa: E402
from wiw_tpu_torch.train import trainer as TT  # noqa: E402
from wiw_tpu_torch.train.checkpoints import CheckpointManager  # noqa: E402


def pipeline(inputs) -> SVDPipeline:
    pipe = SVDPipeline(*inputs["cfgs"], device="cpu")
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
        try:
            pipe.generate(image, spec["gen"], mesh=mesh, **kw)
            out[name] = None
        except (ValueError, NotImplementedError) as e:
            out[name] = f"{type(e).__name__}: {e}"
    return out


SCENARIOS = {"steps": scenario_steps, "checkpoint": scenario_checkpoint,
             "generate": scenario_generate, "draws": scenario_draws}


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
