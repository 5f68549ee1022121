"""backward_ms.train: the device time (ms) of the training step's backward
pass, remat's recompute included, the program's ``train.backward`` span
(``train/loop.py::_value_and_grad``, around ``torch.autograd.grad``),
between its CUDA events, per traced step."""
from bench import spans

UNIT = "ms"
LAYER = "model"
MOVES = "train_tokens_per_s"


def read(r):
    return spans.per_step(r, spans.device_ms(r, "train.backward"))
