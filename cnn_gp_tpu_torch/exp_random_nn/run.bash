#!/usr/bin/env bash
# Finite-NN convergence experiment on the PyTorch port: loop configs x
# channel widths {3, 10, 30, 100} through
# cnn_gp_tpu_torch.exp_random_nn.random_comparison, then plot.
#
# The plot step needs matplotlib, which the card's machine lacks: run the
# battery there with PLOT=0 and plot the CSVs on another host with
#   python -m cnn_gp_tpu_torch.exp_random_nn.random_plot <dir> <dir>/convergence.pdf
set -e

DATASETS=${DATASETS:-/tmp/datasets}
OUT_ROOT=${OUT_ROOT:-/tmp/random_nn}
N_SAMPLES=${N_SAMPLES:-10000}
DEVICE=${DEVICE:-cuda}
PLOT=${PLOT:-1}
CONFIGS=${CONFIGS:-"cifar10 mnist_paper_convnet_gp mnist_paper_residual_cnn_gp"}

for config in $CONFIGS; do
    out="$OUT_ROOT/$config"
    mkdir -p "$out"
    for channels in 3 10 30 100; do
        # Resume-by-skip: a completed width leaves both CSVs behind (each
        # written then renamed); a rerun computes only the rest.
        csv=$(printf '%s/%04d_0001_cov.csv' "$out" "$channels")
        if [ -s "$csv" ]; then
            echo "skip $config width $channels ($csv exists)"
            continue
        fi
        start=$(date +%s%N)
        python3 -m cnn_gp_tpu_torch.exp_random_nn.random_comparison \
            --config="$config" --datasets_path="$DATASETS" \
            --channels="$channels" --n_samples="$N_SAMPLES" \
            --out_path="$out" --device="$DEVICE"
        ms=$(( ($(date +%s%N) - start) / 1000000 ))
        printf 'done %s width %d in %d.%03d s\n' "$config" "$channels" \
            $((ms / 1000)) $((ms % 1000))
    done
    if [ "$PLOT" != 0 ]; then
        python3 -m cnn_gp_tpu_torch.exp_random_nn.random_plot "$out" \
            "$out/convergence.pdf"
    fi
done
