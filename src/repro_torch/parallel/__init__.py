from repro_torch.parallel.sharding import (Spec, batch_specs,  # noqa: F401
                                           cache_specs, decode_cache_specs,
                                           legalize_specs, opt_specs,
                                           param_specs, shard_block,
                                           shard_tree)
