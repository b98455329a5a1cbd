"""init_carry_s (layer: set-up): host seconds of the solver's build, its
boundary slot grid and `init_carry`, ending in a synchronize."""


def read(r):
    return r.init_carry_s
