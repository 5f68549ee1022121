"""flash_fwd_roofline.prefill: prefill attention (``models/flash.py::
flash_attention`` as ``models/attention.py`` calls it, the ``flash_fwd``
kernel today) as a share of its roofline: the bound of its calls
(``kernel_counts.flash``) over their device time in the traced window
(CUDA events around each call)."""
from bench import kernel_counts

UNIT = "%"
LAYER = "kernels"
MOVES = "prefill_tokens_per_s"
HOOKS = (("repro_torch.models.attention", "flash_attention"),)


def read(r):
    return kernel_counts.roofline(r, "flash_attention", kernel_counts.flash)
