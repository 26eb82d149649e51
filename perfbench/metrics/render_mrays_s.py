"""render_mrays_s: counted rays of the whole images of the window over
the window, in millions a second."""


def read(run):
    if run.unit_name != "image" or not run.window_s:
        return None
    return run.units * run.rays_per_unit / run.window_s / 1e6
