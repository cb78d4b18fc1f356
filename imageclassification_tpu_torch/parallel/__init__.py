"""Multi-process training over `torch.distributed` (port of the JAX package's
`parallel/`): one process a device, the process group as the mesh."""

from .dist import (
    any_process,
    get_rank,
    get_world_size,
    init_distributed_mode,
    is_main_process,
    save_on_master,
    setup_for_distributed,
)
from .mesh import (
    all_gather_rows,
    check_mesh,
    mean_across,
    rows_of,
    sum_across,
    sum_across_grad,
)
