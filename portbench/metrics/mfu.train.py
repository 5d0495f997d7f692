"""The whole update's share of the card's bf16 peak in the PPO cells, in
%: the model FLOPs of the window's updates
(:func:`portbench.counting.update_flops`) over the window's seconds on
the host's clock, over 989 TFLOP/s."""

from portbench import counting


def read(ctx):
    s = ctx.shapes
    return 100 * s['flops'] * s['updates'] / s['window_s'] / counting.TENSOR_OPS_PER_S
