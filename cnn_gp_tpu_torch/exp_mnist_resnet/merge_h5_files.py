"""Merge per-worker Gram shard files (NaN-fill semantics).

PyTorch-package counterpart of ``exp_mnist_resnet/merge_h5_files.py``:
NaN entries of the destination take the source's values; completion
bitmaps are OR-merged when present.

    python -m cnn_gp_tpu_torch.exp_mnist_resnet.merge_h5_files dest src...
"""

import sys

from cnn_gp_tpu_torch.data import merge_stores


def main(argv=None):
    argv = sys.argv if argv is None else argv
    if len(argv) < 3:
        print(f"Usage: {argv[0]} dest_file "
              f"[source_file1 source_file2 ...]")
        sys.exit(1)
    _, dest_file, *src_files = argv
    merge_stores(dest_file, src_files)
    print(f"merged {len(src_files)} shard(s) into {dest_file}")


if __name__ == "__main__":
    main()
