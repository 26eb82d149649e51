"""fwdbwd_mrays_s: counted rays of the forward+backward steps of the
window over the window, in millions a second (a step counts its camera
samples x depth x rays a bounce casts, dead lanes included)."""


def read(run):
    if run.unit_name != "fwdbwd_step" or not run.window_s:
        return None
    return run.units * run.rays_per_unit / run.window_s / 1e6
