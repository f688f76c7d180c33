"""Distribution layer: sharding-rule resolution, batch specs, and
compute/comm overlap helpers."""
from .sharding import (AXIS_MAP_MULTI, AXIS_MAP_SINGLE, PartitionSpec,
                       batch_spec, named_shardings, resolve_specs)

__all__ = ["resolve_specs", "named_shardings", "batch_spec",
           "AXIS_MAP_SINGLE", "AXIS_MAP_MULTI", "PartitionSpec"]
