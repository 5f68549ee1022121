"""optimizer_ms.train: the device time (ms) of each ``adamw_update`` call
the train step makes (``train/loop.py`` looks it up at call time; the
traced run wraps it), between CUDA events around the call, the mean over
the traced steps."""
UNIT = "ms"
LAYER = "optimizer"
MOVES = "train_tokens_per_s"
HOOKS = (("repro_torch.train.loop", "adamw_update"),)


def read(r):
    if r.hooks is None:
        return None
    ms = r.hooks.event_ms("adamw_update")
    return sum(ms) / len(ms) if ms else None
