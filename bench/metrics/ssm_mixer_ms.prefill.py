"""ssm_mixer_ms.prefill: the device self time (ms) of the SSM mixer's
plain parts (projections, conv, chunk states and scan, gate and norm):
the program's ``ssm.mixer`` span (``models/ssm.py::ssm_apply``) less its
``ssm.ssd_diag`` span (the diagonal block's call in ``ssd_chunked``),
each between its CUDA events, per traced ``generate`` call."""
from bench import spans

UNIT = "ms"
LAYER = "mixers"
MOVES = "prefill_tokens_per_s"


def read(r):
    mixer = spans.device_ms(r, "ssm.mixer")
    diag = spans.device_ms(r, "ssm.ssd_diag")
    if mixer is None or diag is None:
        return None
    return spans.per_generate(r, mixer - diag)
