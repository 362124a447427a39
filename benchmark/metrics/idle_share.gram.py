"""idle_share.gram: the share of a traced whole Gram call in which nothing
ran on the card (1 - busy / wall), on the rank with the most, in
percent."""


def read(ctx):
    if ctx["kind"] != "gram" or not ctx["traced"]:
        return None
    return max(100.0 * (1.0 - t["busy_s"] / t["wall_s"])
               for t in ctx["traced"])
