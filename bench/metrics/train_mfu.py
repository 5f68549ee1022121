"""train_mfu: the model FLOPs of a training step (``yardstick.
train_step_flops``: what the model needs, three forwards) over the median
step's wall time in the run's window, as a share (%) of the card's bf16
dense peak (989 TFLOP/s)."""
import statistics

from bench import yardstick

UNIT = "%"
LAYER = "train step"
MOVES = "train_tokens_per_s"


def read(r):
    steps = r.info.get("step_s")
    if not steps:
        return None
    flops = yardstick.train_step_flops(r.sizes, r.info["batch"],
                                       r.info["seq"])
    return 100.0 * flops / statistics.median(steps) / yardstick.MFU_PEAK
