#!/usr/bin/env bash
# End-to-end MNIST pipeline on the PyTorch port: Gram assembly into HDF5
# shards (save_kernel) -> shard merge (merge_h5_files) -> GP
# classification (classify_gp), as exp_mnist_resnet/run.bash does with
# the JAX package.
#
# One process per worker; N_WORKERS>1 splits the tiles into shards, which
# merge the same way.  DEVICE picks the torch device of every step
# (cuda by default; cpu runs everything on the host).  The stores are
# HDF5, so this needs h5py: the card's machine has none, and the script
# is tested on the CPU only.
set -e

CONFIG=${CONFIG:-mnist_as_tf}
DATASETS=${DATASETS:-/tmp/datasets}
OUT_DIR=${OUT_DIR:-/tmp/grams_torch/$CONFIG}
BATCH=${BATCH:-200}
JITTER=${JITTER:-0.0}
SOLVER=${SOLVER:-chol_ir}
N_WORKERS=${N_WORKERS:-1}
DEVICE=${DEVICE:-cuda}
PYTHON=${PYTHON:-python3}

if [ -d "$OUT_DIR" ]; then
    echo "Output dir $OUT_DIR exists; tile-level resume will skip finished work."
fi
mkdir -p "$OUT_DIR"

pids=()
for rank in $(seq 0 $((N_WORKERS - 1))); do
    printf -v path "%s/%02d_nw%02d.h5" "$OUT_DIR" "$rank" "$N_WORKERS"
    $PYTHON -m cnn_gp_tpu_torch.exp_mnist_resnet.save_kernel \
        --config="$CONFIG" --datasets_path="$DATASETS" \
        --batch_size="$BATCH" --n_workers="$N_WORKERS" \
        --worker_rank="$rank" --out_path="$path" --device="$DEVICE" &
    pids+=($!)
done
for pid in "${pids[@]}"; do
    wait "$pid"
done

printf -v dest "%s/00_nw%02d.h5" "$OUT_DIR" "$N_WORKERS"
if [ "$N_WORKERS" -gt 1 ]; then
    srcs=()
    for rank in $(seq 1 $((N_WORKERS - 1))); do
        printf -v p "%s/%02d_nw%02d.h5" "$OUT_DIR" "$rank" "$N_WORKERS"
        srcs+=("$p")
    done
    $PYTHON -m cnn_gp_tpu_torch.exp_mnist_resnet.merge_h5_files "$dest" \
        "${srcs[@]}"
fi

$PYTHON -m cnn_gp_tpu_torch.exp_mnist_resnet.classify_gp \
    --config="$CONFIG" --datasets_path="$DATASETS" \
    --in_path="$dest" --jitter="$JITTER" --solver="$SOLVER" \
    --device="$DEVICE"
