"""The whole step's share of the card's bf16 peak: the useful FLOPs of
every request completed in the window (``yardstick.request_flops``: real
tokens only, the unembedding where logits are read, attention's and the
SSD recurrence's own products) over the window's seconds times 989
TFLOP/s."""
from perfbench import yardstick


def read(ctx):
    if not ctx["flops"]:
        return None
    return 100.0 * ctx["flops"] / (ctx["window_s"]
                                   * yardstick.PEAK_BF16_FLOPS)
