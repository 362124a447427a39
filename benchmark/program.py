"""What the benchmark takes from the program under test,
``cnn_gp_tpu_torch``: its public entries, and its model DSL to build a
configuration's model (the diagonal recursion's ``build_model``).
Besides this module only two kinds of file of the harness (its tests
aside) import the program: a recursion's ``build_model``
(``recursions/<r>.py``; the diagonal one takes it from here), and the
two span readers, ``metrics/host_f64_share.fit.py`` and
``metrics/grad_vjp_share.fit.py``, which read
``cnn_gp_tpu_torch.utils.timing``.  Each imports it inside a function,
never on import; ``reference/`` and ``arch.py`` never do."""

from __future__ import annotations

from . import arch


def build_model(tree, learnable: bool = False):
    """The program's model of ``tree``, built with its DSL
    (``cnn_gp_tpu_torch.Conv2d`` and friends) as its configs are."""
    from cnn_gp_tpu_torch import Conv2d, ReLU, Sequential, Sum

    def build(t):
        if isinstance(t, arch.Conv):
            return Conv2d(t.kernel_size, stride=t.stride, padding=t.padding,
                          dilation=t.dilation, var_weight=t.var_weight,
                          var_bias=t.var_bias,
                          in_channel_multiplier=t.in_channel_multiplier,
                          out_channel_multiplier=t.out_channel_multiplier,
                          learnable=learnable)
        if isinstance(t, arch.ReLU):
            return ReLU()
        if isinstance(t, arch.Seq):
            return Sequential(*[build(layer) for layer in t.layers])
        return Sum([build(b) for b in t.branches])
    return build(tree)


def entries():
    """The program's Gram-level and fit entries, imported on use."""
    from cnn_gp_tpu_torch.fit import fit_large
    from cnn_gp_tpu_torch.parallel.device_pipeline import gram_device
    from cnn_gp_tpu_torch.parallel.gram_sharded import compute_gram_sharded
    from cnn_gp_tpu_torch.parallel.mesh import make_mesh
    return {"gram_device": gram_device,
            "compute_gram_sharded": compute_gram_sharded,
            "fit_large": fit_large, "make_mesh": make_mesh}
