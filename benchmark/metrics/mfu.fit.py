"""mfu.fit: the fit steps' FP32 operations on the card in the window (the
Gram's forward and the VJP sweep, ``arch.fit_step_work``) over the
window's seconds times the card's FP32 peak, in percent."""


def read(ctx):
    if ctx["kind"] != "fit":
        return None
    ops = ctx["calls"] * ctx["work_per_call"].ops
    return 100.0 * ops / (ctx["window_s"] * ctx["peaks"].FP32_FLOPS
                          * ctx["chips"])
