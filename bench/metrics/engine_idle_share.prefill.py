"""engine_idle_share.prefill: the share (%) of the traced window in which
the device sat idle before work the engine launched outside the model's
forward pass: gaps whose ending activity was launched inside the
program's ``serve.generate`` span and not inside ``serve.prefill`` (the
prompt's upload, the re-home, the argmax), from the profiler's trace."""
from bench import spans

UNIT = "%"
LAYER = "serve engine"
MOVES = "prefill_tokens_per_s"


def read(r):
    return spans.idle_share(r, "serve.generate", "serve.prefill")
