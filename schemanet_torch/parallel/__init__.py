"""Several GPUs: the ``data x model`` grid of ``torch.distributed`` ranks,
the sharding rules, the collectives and the rank launcher."""

from .mesh import (DEFAULT_PARAM_RULES, Mesh, all_gather, gather_params, gathered,
                   init_from_env, local_batch_slice, make_mesh, param_shardings, shard_module,
                   shard_params)

__all__ = [
    "DEFAULT_PARAM_RULES",
    "Mesh",
    "all_gather",
    "gather_params",
    "gathered",
    "init_from_env",
    "local_batch_slice",
    "make_mesh",
    "param_shardings",
    "shard_module",
    "shard_params",
]
