from repro_torch.sharding.ctx import (
    axis_rules, clear_mesh, current_mesh, set_mesh, shard_hint)

__all__ = ["axis_rules", "clear_mesh", "current_mesh", "set_mesh",
           "shard_hint"]
