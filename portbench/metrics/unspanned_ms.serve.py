"""Device milliseconds a traced request in work launched outside every
program span (the encoder's input and output masks, the harness's
concatenation of the ids and their copy to the host) or with no launch in
the trace (`portbench/spans.py`)."""

from portbench.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "serve", ["(outside)", "(no launch)"])
