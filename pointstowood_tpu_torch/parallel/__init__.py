from pointstowood_tpu_torch.parallel.mesh import (
    DataGroup,
    data_group,
    fetch,
    maybe_init_distributed,
    shard_rows,
)

__all__ = ["DataGroup", "data_group", "fetch", "maybe_init_distributed",
           "shard_rows"]
