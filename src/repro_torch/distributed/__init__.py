from repro_torch.distributed.sharding import (batch_specs, cache_specs,
                                              make_shardings, param_specs)

__all__ = ["param_specs", "batch_specs", "cache_specs", "make_shardings"]
