"""ssd_diag_roofline.train: the SSD diagonal block's forward (``models/ssm.py`` calling
``kernels/ssd/ops.py::ssd_diag``) as a share of its roofline: the bound of
its calls (``kernel_counts.ssd_diag``) over their device time in the traced
window (CUDA events around each call: every kernel it puts on the
stream)."""
from bench import kernel_counts

UNIT = "%"
LAYER = "kernels"
MOVES = "train_tokens_per_s"
HOOKS = (("repro_torch.models.ssm", "ssd_diag"),)


def read(r):
    return kernel_counts.roofline(r, "ssd_diag", kernel_counts.ssd_diag)
