"""Seconds of real (unpadded) audio transcribed to token ids on the host,
over the window's wall time."""


def read(ctx):
    if ctx.mix["mode"] != "serve":
        return None
    return ctx.window["audio_s"] / ctx.window["seconds"]
