"""Save a kernel matrix to disk.

PyTorch counterpart of ``exp_mnist_resnet/save_kernel.py``, with the same
flag names and defaults plus ``--device``: computes Kxx (train x train,
upper triangle), Kxvx (validation x train), Kxtx (test x train) sharded
across workers, and -- on rank 0 -- the Kv_diag / Kt_diag diagonals, into
one HDF5 file per worker, with tile-level resume.

    python -m cnn_gp_tpu_torch.exp_mnist_resnet.save_kernel \\
        --config=mnist_paper_convnet_gp --datasets_path=... \\
        --out_path=k.h5 --device=cuda

TF32 is turned off before any kernel runs (``settings.moment_precision``
is "highest").  ``--device=cuda`` without CUDA raises.
"""

import argparse

from cnn_gp_tpu_torch import configs, settings
from cnn_gp_tpu_torch.data import DatasetFromConfig, GramStore
from cnn_gp_tpu_torch.parallel import save_K
from cnn_gp_tpu_torch.utils import resolve_device


def run(config, out_path: str, *, datasets_path: str, device,
        batch_size: int = 200, n_workers: int = 1, worker_rank: int = 0):
    """Write this worker's share of the five Gram datasets to
    ``out_path``."""
    settings.disable_tf32()
    print("TF32 off for cuBLAS and cuDNN (moment_precision='highest')")
    dataset = DatasetFromConfig(datasets_path, config)
    model = config.initial_model
    kwargs = dict(worker_rank=worker_rank, n_workers=n_workers,
                  batch_size=batch_size, device=device, print_interval=2.0)
    with GramStore(out_path, "a") as f:
        save_K(f, model, "Kxx", dataset.train, None, diag=False, **kwargs)
        save_K(f, model, "Kxvx", dataset.validation, dataset.train,
               diag=False, **kwargs)
        save_K(f, model, "Kxtx", dataset.test, dataset.train,
               diag=False, **kwargs)
        if worker_rank == 0:
            save_K(f, model, "Kv_diag", dataset.validation, None, diag=True,
                   **kwargs)
            save_K(f, model, "Kt_diag", dataset.test, None, diag=True,
                   **kwargs)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--datasets_path", default="/tmp/datasets",
                   help="where to load datasets from")
    p.add_argument("--batch_size", type=int, default=200,
                   help="max number of examples to simultaneously compute "
                        "the kernel of")
    p.add_argument("--config", default="mnist",
                   help="which config to load from cnn_gp_tpu_torch.configs")
    p.add_argument("--n_workers", type=int, default=1, help="num of workers")
    p.add_argument("--worker_rank", type=int, default=0,
                   help="rank of worker")
    p.add_argument("--out_path", default=None,
                   help="path of h5 file to save kernels in")
    p.add_argument("--store_backend", default="auto", choices=["auto", "h5"],
                   help="HDF5 only; the TensorStore backend is not ported")
    p.add_argument("--device", default="cuda",
                   help="torch device to compute on")
    a = p.parse_args(argv)
    if a.out_path is None:
        p.error("--out_path is required")
    run(configs.load(a.config), a.out_path, datasets_path=a.datasets_path,
        device=resolve_device(a.device), batch_size=a.batch_size,
        n_workers=a.n_workers, worker_rank=a.worker_rank)


if __name__ == "__main__":
    main()
