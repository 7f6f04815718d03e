from .sharding import (DEFAULT_RULES, AbstractMesh, NamedSharding, axis_rules,
                       current_rules, placements, shard, spec_for,
                       tree_sharding)
