from wiw_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_rows,
    gather_rows,
    leaf_axis,
    make_mesh,
    shard_unet,
)
