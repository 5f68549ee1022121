"""moe_slot_fill.train: the share (%) of the expert products' rows that
hold a kept pick, the program's counters ``moe.slots_kept`` over
``moe.slots`` (``models/moe.py::moe_apply``) over the traced steps (remat
routes twice, which counts both sides alike)."""
from bench import spans

UNIT = "%"
LAYER = "mixers"
MOVES = "train_tokens_per_s"


def read(r):
    return spans.share(r, "moe.slots_kept", "moe.slots")
