"""Run a module as ``python -m`` does, with one port config's ranges cut.

    CUT_CONFIG=mnist_as_tf_mini CUT_RANGES=32,16,16 \\
        python tests/_torch_cut_config.py -m <module> [args...]

Each of the config's train, validation and test ranges keeps its first
CUT_RANGES indices before the module runs, so a shell pipeline of the
port's entry scripts (the run.bash tests) runs a real config at toy size on the
CPU."""

import os
import runpy
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    if len(sys.argv) < 3 or sys.argv[1] != "-m":
        raise SystemExit(f"usage: {sys.argv[0]} -m module [args...]")
    module, args = sys.argv[2], sys.argv[3:]
    from cnn_gp_tpu_torch import configs
    cfg = configs.load(os.environ["CUT_CONFIG"])
    sizes = [int(s) for s in os.environ["CUT_RANGES"].split(",")]
    for name, n in zip(("train_range", "validation_range", "test_range"),
                       sizes):
        setattr(cfg, name, list(getattr(cfg, name))[:n])
    sys.argv = [module] + args
    runpy.run_module(module, run_name="__main__", alter_sys=True)


if __name__ == "__main__":
    main()
