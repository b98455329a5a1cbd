"""particle_steps_per_s: live fluid particles x steps completed in the
window, over the window's whole time (host clock), replays included."""


def read(r):
    w = r.window
    return w.n_live * w.steps / w.window_s
