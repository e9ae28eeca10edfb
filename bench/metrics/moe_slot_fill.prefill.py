"""100 × the (token, expert) pairs the traced batch's prefill kept over
the expert slots its products ran over (the program's counters
``moe.pairs_kept`` and ``moe.slots``; ``bench/spans.py``)."""

from bench.spans import slot_fill


def read(run):
    return slot_fill(run, "prefill")
