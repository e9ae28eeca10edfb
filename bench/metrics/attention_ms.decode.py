"""Device milliseconds of a decode step's attention layers, their norms
and cache write-backs (the program's ``layer.attn*`` spans), summed a
step, median over the traced batch's decode steps (``bench/spans.py``)."""

from bench.spans import layer_ms


def read(run):
    return layer_ms(run, "decode", lambda n: n.startswith("layer.attn"))
