"""The Wukong FM kernels' share of their roofline in a training step: the
bytes every layer's FM forward and backward need (``counts_wukong.fm_bytes``
at the configuration's widths and the step's batch) at the card's bandwidth,
over the device time a step of the kernels ``wukong_fm_fwd_kernel``,
``wukong_fm_bwd_kernel`` and ``wukong_fm_grad_sum_kernel``, selected by name
(``counts_wukong.kernels_roofline``: nothing where no layer took them)."""

from benchmark import counts_wukong

KERNELS = ("wukong_fm_fwd_kernel", "wukong_fm_bwd_kernel", "wukong_fm_grad_sum_kernel")


def read(ctx):
    return counts_wukong.kernels_roofline(ctx, KERNELS, counts_wukong.fm_bytes)
