from .mesh import make_mesh, default_mesh_shape
from .sharded import (
    sharded_count, sharded_sketch_batch, make_ingest_step, chunk_codes,
)
