"""nccl_share.gram: the NCCL kernels' seconds on the card over the traced
Gram call's wall, on the rank with the most, in percent.  Nothing to read
on one rank."""


def read(ctx):
    if ctx["kind"] != "gram" or ctx["chips"] < 2 or not ctx["traced"]:
        return None
    share = max(100.0 * t["nccl_s"] / t["wall_s"] for t in ctx["traced"])
    return share if share > 0 else None
