"""prefill_mfu: the model FLOPs of the window's prefills (``yardstick.
forward_flops`` of each batch) over the wall time of their ``generate``
calls, as a share (%) of the card's bf16 dense peak (989 TFLOP/s)."""
from bench import yardstick

UNIT = "%"
LAYER = "serve engine"
MOVES = "prefill_tokens_per_s"


def read(r):
    batches = r.info.get("batches")
    if not batches:
        return None
    flops = sum(yardstick.forward_flops(r.sizes, rows, length)
                for length, rows, _ in batches)
    return 100.0 * flops / sum(s for _, _, s in batches) / yardstick.MFU_PEAK
