"""Device milliseconds of a decode step's Mamba layers with their norms
and state write-backs (the program's ``layer.mamba`` spans), summed a
step, median over the traced batch's decode steps (``bench/spans.py``)."""

from bench.spans import layer_ms


def read(run):
    return layer_ms(run, "decode", lambda n: n == "layer.mamba")
