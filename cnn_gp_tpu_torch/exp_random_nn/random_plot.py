"""Publication figure: finite-NN convergence to the GP limit.

The port's own copy of ``exp_random_nn/random_plot.py``, for the CSVs that
``cnn_gp_tpu_torch.exp_random_nn.random_comparison`` writes, with the same
figure: row A, histograms of the normalised outputs against the N(0, 1)
pdf; row B, Q-Q plots against the limiting Gaussian; row C, empirical
against analytic covariance with the y = x line.  It reads the CSVs with
numpy, so it needs matplotlib and scipy but not pandas.

It runs on a host with matplotlib, not on the card's machine, which has
none: there ``run.bash`` runs with ``PLOT=0`` and the CSVs are plotted
afterwards.

    python -m cnn_gp_tpu_torch.exp_random_nn.random_plot <csv_dir> <out.pdf>
"""

import os
import sys

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import scipy.stats  # noqa: E402

WIDTHS = [3, 10, 30, 100]
SEED = 1

# paper figure geometry, inches
NROWS, NCOLS = 3, 4
POINTS = 10
FIG_W = 5.5
PANEL_WH_RATIO = 0.9
PANEL_LM, PANEL_RM, PANEL_TM, PANEL_BM = 0.55, 0.05, 0.2, 0.45

PANEL_W = FIG_W / NCOLS
PANEL_H = PANEL_WH_RATIO * PANEL_W
FIG_H = NROWS * PANEL_H
PW_S, PH_S = PANEL_W / FIG_W, PANEL_H / FIG_H
CHAR_W_S = POINTS / 72 / FIG_W
CHAR_H_S = POINTS / 72 / FIG_W


def _rect(row, col):
    left = col * PW_S + PANEL_LM / FIG_W
    bottom = (NROWS - row - 1) * PH_S + PANEL_BM / FIG_H
    return [left, bottom, PW_S - (PANEL_LM + PANEL_RM) / FIG_W,
            PH_S - (PANEL_TM + PANEL_BM) / FIG_H]


def _label(ax, s):
    (lm, bm), (rm, tm) = ax.get_position().get_points()
    ax.figure.text(lm - 3.3 * CHAR_W_S, tm + CHAR_H_S,
                   s, fontweight="bold")


def _ylabel(ax, text, yshift=0.0):
    (lm, bm), (rm, tm) = ax.get_position().get_points()
    h = tm - bm
    ax.set_ylabel(text)
    ax.yaxis.set_label_coords(lm - 2.5 * CHAR_W_S, bm + h / 2 + h * yshift,
                              transform=ax.figure.transFigure)


def _read_csv(path):
    """The CSV's columns by name (float64), as pandas would read them."""
    return np.genfromtxt(path, delimiter=",", names=True, dtype=np.float64)


def _despine(ax):
    ax.spines["right"].set_visible(False)
    ax.spines["top"].set_visible(False)


def main(csv_dir: str, out_path: str):
    matplotlib.rcParams.update({
        "font.family": "sans-serif", "font.size": POINTS,
        "axes.titlesize": POINTS, "axes.labelsize": POINTS,
        "xtick.labelsize": POINTS - 1, "ytick.labelsize": POINTS - 1,
    })
    fig = plt.figure(figsize=(FIG_W, FIG_H))
    z = scipy.stats.norm(0, 1)
    lim = 4

    samples, covs = [], []
    for c in WIDTHS:
        samples.append(_read_csv(
            os.path.join(csv_dir, f"{c:04d}_{SEED:04d}_samples.csv")))
        covs.append(_read_csv(
            os.path.join(csv_dir, f"{c:04d}_{SEED:04d}_cov.csv")))

    # Row A: histograms vs N(0,1) pdf
    for i, c in enumerate(WIDTHS):
        ax = fig.add_axes(_rect(0, i))
        r0 = np.array(samples[i]["r0"])
        ax.hist(r0, bins=50, range=(-lim, lim), density=True)
        xs = np.linspace(-lim, lim, 100)
        ax.plot(xs, z.pdf(xs), linewidth=1)
        ax.set_ylim(0, 0.7)
        _despine(ax)
        ax.set_title(f"C={c}", pad=-5)
        ax.set_xlim(-lim, lim)
        ax.set_xticks([-lim, 0, lim])
        ax.set_xlabel("output")
        if i == 0:
            _label(ax, "A")
            _ylabel(ax, "pdf")

    # Row B: Q-Q vs limiting Gaussian
    for i in range(4):
        ax = fig.add_axes(_rect(1, i))
        xs, ys = scipy.stats.probplot(np.array(samples[i]["r0"]), dist=z,
                                      fit=False)
        ax.plot(xs, ys, linewidth=1)
        ax.plot([-lim, lim], [-lim, lim], linewidth=1)
        _despine(ax)
        ax.set_xlim(-lim, lim)
        ax.set_ylim(-lim, lim)
        ax.set_xticks([-lim, 0, lim])
        ax.set_yticks([-lim, 0, lim])
        ax.set_xlabel("limiting q.")
        if i == 0:
            _label(ax, "B")
            _ylabel(ax, "sampled q.")

    # Row C: sampled vs limiting covariance
    for i in range(4):
        ax = fig.add_axes(_rect(2, i))
        est = np.array(covs[i]["est"])
        true = np.array(covs[i]["true"])
        hi_lim = int(1.1 * np.max([est, true]))
        order = 10 ** (len(str(hi_lim)) - 1)
        lims = (0, ((hi_lim + order - 1) // order) * order)
        ax.plot(lims, lims, color="tab:orange", linewidth=1)
        ax.scatter(true, est, 0.3, color="tab:blue")
        _despine(ax)
        ax.set_xlabel("limiting cov.")
        ax.set_xlim(*lims)
        ax.set_ylim(*lims)
        ax.set_xticks(np.linspace(*lims, 3))
        ax.set_yticks(np.linspace(*lims, 3))
        if i == 0:
            _label(ax, "C")
            _ylabel(ax, "sampled cov.", yshift=-0.05)

    fig.savefig(out_path, dpi=400)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    if len(sys.argv) != 3:
        print(f"Usage: {sys.argv[0]} csv_dir out_path")
        sys.exit(1)
    main(sys.argv[1], sys.argv[2])
