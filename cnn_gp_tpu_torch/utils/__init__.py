import argparse

import torch

from .timing import (FP32_PEAK, hhmmss, print_timings,  # noqa: F401
                     synced_clock)


def round_up_div(a: int, b: int) -> int:
    return (a + b - 1) // b


def add_bool_flag(parser, name: str, default: bool, help: str) -> None:
    """An argparse boolean spelled as absl spells it: ``--name``,
    ``--noname`` and ``--name=true|false``, so the JAX drivers' command
    lines parse unchanged."""
    def parse(v: str) -> bool:
        if v.lower() in ("1", "true", "t", "yes"):
            return True
        if v.lower() in ("0", "false", "f", "no"):
            return False
        raise ValueError(f"not a boolean: {v!r}")
    parser.add_argument(f"--{name}", nargs="?", const=True, default=default,
                        type=parse, help=help)
    parser.add_argument(f"--no{name}", dest=name, action="store_false",
                        help=argparse.SUPPRESS)


def resolve_device(name: str) -> torch.device:
    """The device an entry point was asked for.  Asking for CUDA where
    there is none raises: nothing moves to the CPU on its own."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not "
                           f"available; pass --device=cpu to run on the CPU")
    return device
