"""Data parallelism over ``torch.distributed``: the counterpart of the JAX
package's ``rsoccer_tpu/parallel/`` (its "Multi-chip / multi-host" story).

- ``mesh.py``: the env mesh (the ranks of a process group, one device
  each), batch-axis sharding, the collectives, ``initialize_distributed``;
- ``rollout.py``: the sharded rollouts (``make_sharded_rollout``, equal to
  the unsharded one env for env; ``make_shard_map_rollout``, per-shard
  streams);
- ``ppo.py``: the helpers of ``models/ppo.PPOTrainer(..., mesh=)``;
- ``sac.py``: SAC with one replay ring per rank (``make_sharded_sac``).
"""
