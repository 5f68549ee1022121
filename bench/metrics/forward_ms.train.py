"""forward_ms.train: the device time (ms) of the training step's forward
pass, the program's ``train.forward`` span (``train/loop.py::
_value_and_grad``, around the loss), between its CUDA events, per traced
step."""
from bench import spans

UNIT = "ms"
LAYER = "model"
MOVES = "train_tokens_per_s"


def read(r):
    return spans.per_step(r, spans.device_ms(r, "train.forward"))
