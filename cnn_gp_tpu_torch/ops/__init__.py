from . import arccos, boxfilter, megakernel, solve  # noqa: F401
