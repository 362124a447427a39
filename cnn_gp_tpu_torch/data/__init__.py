from .datasets import (ArrayDataset, DatasetFromConfig, load_mnist_arrays,
                       load_cifar10_arrays, synthetic_arrays)  # noqa: F401
from .hard_mnist import digits, hard_mnist  # noqa: F401
from .store import GramStore, merge_stores  # noqa: F401
from .iterators import ProductIterator, DiagIterator  # noqa: F401
from .store_ts import TensorStoreGramStore, open_store  # noqa: F401
