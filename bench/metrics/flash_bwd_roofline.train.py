"""flash_bwd_roofline.train: attention's backward as a share of its
roofline: the bound of FlashAttention-2's backward
(``kernel_counts.flash`` with ``backward``) over the device time of the
backward node of ``models/flash.py::flash_attention`` (as
``models/attention.py`` calls it), between CUDA events around its
execution."""
from bench import kernel_counts

UNIT = "%"
LAYER = "kernels"
MOVES = "train_tokens_per_s"
HOOKS = (("repro_torch.models.attention", "flash_attention"),)


def read(r):
    return kernel_counts.roofline(r, "flash_attention", kernel_counts.flash,
                                  backward=True)
