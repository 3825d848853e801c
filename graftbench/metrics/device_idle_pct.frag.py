"""Share of the traced window in which no device operation ran."""


def read(ctx):
    p = ctx.get("profile")
    if not p or p["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
