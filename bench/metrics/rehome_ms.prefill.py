"""rehome_ms.prefill: the device time (ms) of the engine's re-home of
prefill's cache into the ``max_len`` decode buffers, the program's
``serve.rehome`` span (``ServeEngine.decode_cache``), between its CUDA
events, per traced ``generate`` call."""
from bench import spans

UNIT = "ms"
LAYER = "serve engine"
MOVES = "prefill_tokens_per_s"


def read(r):
    return spans.per_generate(r, spans.device_ms(r, "serve.rehome"))
