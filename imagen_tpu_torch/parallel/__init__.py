"""Several GPUs: the mesh and placement rules (`mesh`), each rank's share
of the random draws (`rows`) and one unet's state on the mesh (`layout`)."""
from imagen_tpu_torch.parallel.mesh import (
    create_mesh,
    initialize_distributed,
    shard_batch,
)
