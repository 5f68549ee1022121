"""ssd_bwd_roofline.train: the SSD diagonal block's gradient as a share of
its roofline: the bound of the published algorithm's gradient
(``kernel_counts.ssd_diag`` with ``backward``) over the device time of the
forward call's backward node (CUDA events around its execution; today the
plain autograd of ``ssd_diag_ref`` inside ``_SSDDiag.backward``)."""
from bench import kernel_counts

UNIT = "%"
LAYER = "kernels"
MOVES = "train_tokens_per_s"
HOOKS = (("repro_torch.models.ssm", "ssd_diag"),)


def read(r):
    return kernel_counts.roofline(r, "ssd_diag", kernel_counts.ssd_diag,
                                  backward=True)
