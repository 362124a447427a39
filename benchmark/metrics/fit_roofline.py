"""fit_roofline: the least seconds the traced fit call's card work could
take (``arch.fit_step_work``, per tile the larger of operations over the
FP32 peak and bytes over the memory rate) over the seconds the card was
busy in the trace, in percent."""


def read(ctx):
    if ctx["kind"] != "fit" or not ctx["traced"]:
        return None
    busy = sum(t["busy_s"] for t in ctx["traced"])
    return 100.0 * ctx["work_per_call"].bound_s / busy if busy > 0 else None
