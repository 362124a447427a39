"""cov_ntk_pool_roofline.gram: the NTK's tangent pool kernel
(the two-field block pool with its ReLU prologue: the global
average),
``cov_ntk_pool_kernel``: the least seconds its launches in the traced Gram
call could take (per launch the larger of its operations over the FP32
peak and its bytes over the memory rate, as the recursion counts them
as built: the work's ``kernels``, ``recursions/ntk.py``) over its device
seconds in the trace, summed over the ranks, in percent.  Nothing where
the work carries no count for it or the trace saw no such kernel (a
program without the NTK's tangent kernels)."""

KERNEL = "cov_ntk_pool_kernel"


def read(ctx):
    if ctx["kind"] != "gram" or not ctx["traced"]:
        return None
    bound = dict(getattr(ctx["work_per_call"], "kernels", ())).get(KERNEL)
    seconds = sum(s for t in ctx["traced"]
                  for name, s in t.get("device_ops", ()) if name == KERNEL)
    if not bound or seconds <= 0:
        return None
    return 100.0 * bound / seconds
