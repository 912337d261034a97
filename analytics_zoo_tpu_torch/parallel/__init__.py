"""Parallelism strategies over the mesh of ranks.

Port of `analytics_zoo_tpu/parallel/` (`__init__.py`): FSDP sharding rules
(`sharding.py`), sequence-parallel ring attention on the flash kernels
(`ring_attention.py`) and pipeline stages (`pipeline.py`). The JAX
package's `compat.py` is a jax-version shim and has no counterpart.
"""

from analytics_zoo_tpu_torch.parallel.sharding import (  # noqa: F401
    P, ShardingRules, TRANSFORMER_RULES, param_specs, shard_batch)
