"""Data- and latent-axis parallelism on ``torch.distributed``
(``sharding.py``; the explicit collectives in ``collectives.py``)."""

from hetmogp_tpu_torch.parallel.collectives import (MeshComm,
                                                    collective_counts,
                                                    record_collectives,
                                                    zero_collective_counts)
from hetmogp_tpu_torch.parallel.sharding import (data_mesh, gather_params,
                                                 has_latent_axis,
                                                 make_sharded_elbo,
                                                 make_sharded_predictive_task,
                                                 make_sharded_svi_step,
                                                 mesh_comm, model_mesh,
                                                 param_shardings, shard_batch,
                                                 shard_params, shard_state,
                                                 spawn_local, state_shardings)

__all__ = ["data_mesh", "model_mesh", "has_latent_axis", "shard_batch",
           "shard_params", "shard_state", "gather_params", "param_shardings",
           "state_shardings", "make_sharded_svi_step", "make_sharded_elbo",
           "make_sharded_predictive_task", "spawn_local", "mesh_comm",
           "MeshComm", "collective_counts", "zero_collective_counts",
           "record_collectives"]
