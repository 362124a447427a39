"""launches_per_tile.gram: the kernels the trace saw in a whole Gram call
over the tiles of the call that rank computed (the tiles dealt evenly),
on the rank with the most."""


def read(ctx):
    if ctx["kind"] != "gram" or not ctx["traced"]:
        return None
    tiles = ctx["tiles_per_call"] / ctx["chips"]
    return max(t["kernels"] / tiles for t in ctx["traced"])
