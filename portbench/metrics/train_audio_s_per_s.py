"""Seconds of real audio trained on over the window's wall time, the last
step's update applied before the window closes."""


def read(ctx):
    if ctx.mix["mode"] != "train":
        return None
    return ctx.window["audio_s"] / ctx.window["seconds"]
