"""Line-search trials a solved instance (iterations plus backtracks), from
the routes' own counts, over every instance of the window."""


def read(r):
    if r.window.instances == 0:
        return None
    return r.window.trials / r.window.instances
