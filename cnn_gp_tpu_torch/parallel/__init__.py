from . import scheduler  # noqa: F401
from .gram import (compute_gram, compute_gram_diag, save_K,
                   gram_in_memory)  # noqa: F401
from .gram_sharded import compute_gram_sharded  # noqa: F401
from .device_pipeline import gram_device, classify_device  # noqa: F401
from .device_large import (classify_device_large, make_scores_fn,
                           scores_regen, gram_matvec_regen, rebuild_factor,
                           variances_from_factor)  # noqa: F401
from .mesh import make_mesh, TILE_AXIS  # noqa: F401
from .solve_dist import cg_solve_sharded  # noqa: F401
from .chol_dist import (chol_solve_dist, chol_solve_ir32,
                        chol_solve_dist_from_store,
                        chol_solve_stream_from_store, cholesky_sharded,
                        cholesky_solve_sharded)  # noqa: F401
from .incremental import IncrementalGP  # noqa: F401
