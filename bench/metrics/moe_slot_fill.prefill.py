"""moe_slot_fill.prefill: the share (%) of the expert products' rows that
hold a kept pick, the program's counters ``moe.slots_kept`` over
``moe.slots`` (``models/moe.py::moe_apply``) over the traced ``generate``
calls; the batched expert products compute every slot, filled or not."""
from bench import spans

UNIT = "%"
LAYER = "mixers"
MOVES = "prefill_tokens_per_s"


def read(r):
    return spans.share(r, "moe.slots_kept", "moe.slots")
