"""gram_roofline: the least seconds the traced Gram call's work could take
(per tile the larger of its operations over the FP32 peak and its bytes
over the memory rate, ``arch.gram_work``) over the seconds the cards were
busy in the trace, summed over the ranks, in percent."""


def read(ctx):
    if ctx["kind"] != "gram" or not ctx["traced"]:
        return None
    busy = sum(t["busy_s"] for t in ctx["traced"])
    return 100.0 * ctx["work_per_call"].bound_s / busy if busy > 0 else None
