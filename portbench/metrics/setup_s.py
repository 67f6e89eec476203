"""setup_s: seconds from the start of the process to the start of the window
(imports, the card's context, the kernels' build where it is cold, the
inputs, the warm-up that builds every graph the window launches, and the
burn-in)."""


def read(ctx, part):
    return ctx["setup_s"]
