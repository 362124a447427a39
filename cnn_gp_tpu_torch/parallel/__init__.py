from . import scheduler  # noqa: F401
from .gram import (compute_gram, compute_gram_diag, save_K,
                   gram_in_memory)  # noqa: F401
