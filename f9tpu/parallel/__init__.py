from .mesh import (  # noqa: F401
    Mesh, NamedSharding, P, files_sharding, make_mesh,
)
from .sharding import (  # noqa: F401
    channels_shardable,
    process_batch_channels_sharded,
    process_files_sharded,
    required_frames_padding,
    resample_frames_sharded,
    shard_halos,
)
