"""idle_share.fit: the share of a traced whole fit call (its steps) in
which nothing ran on the card (1 - busy / wall), in percent."""


def read(ctx):
    if ctx["kind"] != "fit" or not ctx["traced"]:
        return None
    return max(100.0 * (1.0 - t["busy_s"] / t["wall_s"])
               for t in ctx["traced"])
