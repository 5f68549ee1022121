"""idle_share.train: the share (%) of the traced window in which nothing ran on
the device (kernels, copies and sets), from the profiler's trace."""
UNIT = "%"
LAYER = "device"
MOVES = "train_tokens_per_s"


def read(r):
    t = r.trace_data
    if t is None or t.window is None or t.window_s() <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s())
