"""moe_route_ms.prefill: the device time (ms) of MoE routing, the
program's ``moe.route`` span (``models/moe.py::moe_apply`` around
``route``: the router product, top-k, aux loss, dispatch table), between
its CUDA events, summed over the layers, per traced ``generate`` call."""
from bench import spans

UNIT = "ms"
LAYER = "mixers"
MOVES = "prefill_tokens_per_s"


def read(r):
    return spans.per_generate(r, spans.device_ms(r, "moe.route"))
