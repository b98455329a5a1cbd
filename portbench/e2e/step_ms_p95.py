"""step_ms_p95: the 95th percentile of every step's time in the window
(host clock around `step` and a `torch.cuda.synchronize()`), in ms."""

import numpy as np


def read(r):
    return float(np.percentile(np.asarray(r.window.step_s) * 1e3, 95))
