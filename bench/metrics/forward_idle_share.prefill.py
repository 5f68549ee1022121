"""forward_idle_share.prefill: the share (%) of the traced window in which
the device sat idle before work of the model's prefill forward pass: gaps
whose ending activity was launched inside the program's ``serve.prefill``
span, from the profiler's trace."""
from bench import spans

UNIT = "%"
LAYER = "model"
MOVES = "prefill_tokens_per_s"


def read(r):
    return spans.idle_share(r, "serve.prefill")
