"""host_f64_share.fit: the share of the traced fit call's steps spent in
the exact path's float64 phase (the Gram's upcast and jitter, Cholesky,
solve, inverse, the float32 cotangent's build), which runs on the step's
device (the card, in a cell) and ends in the loss's readback, in
percent: the program's ``fit.host_f64`` spans (the name kept from when
the phase ran on the host) over its ``fit.step`` spans
(``cnn_gp_tpu_torch.utils.timing``, on the host clock), which record
while the traced call runs under the profiler.  None without a trace, or
where the program records no ``fit.step`` span."""


def read(ctx):
    if ctx["kind"] != "fit" or not ctx["traced"]:
        return None
    from cnn_gp_tpu_torch.utils import timing
    found = timing.spans() if hasattr(timing, "spans") else []

    def total(name):
        return sum(s.end_ns - s.start_ns for s in found if s.name == name)

    step = total("fit.step")
    return 100.0 * total("fit.host_f64") / step if step else None
