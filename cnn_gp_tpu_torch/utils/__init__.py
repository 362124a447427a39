import torch

from .timing import print_timings, hhmmss  # noqa: F401


def round_up_div(a: int, b: int) -> int:
    return (a + b - 1) // b


def resolve_device(name: str) -> torch.device:
    """The device an entry point was asked for.  Asking for CUDA where
    there is none raises: nothing moves to the CPU on its own."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not "
                           f"available; pass --device=cpu to run on the CPU")
    return device
