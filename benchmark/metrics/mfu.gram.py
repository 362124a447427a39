"""mfu.gram: the Gram calls' FP32 operations in the window (counted from
the architecture and the tile shapes, ``arch.gram_work``) over the
window's seconds times the cards' FP32 peak, in percent."""


def read(ctx):
    if ctx["kind"] != "gram":
        return None
    ops = ctx["calls"] * ctx["work_per_call"].ops
    return 100.0 * ops / (ctx["window_s"] * ctx["peaks"].FP32_FLOPS
                          * ctx["chips"])
