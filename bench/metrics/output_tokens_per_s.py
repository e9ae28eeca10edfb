"""Every token the window served over the window's seconds."""


def read(run):
    return len(run.requests) * run.mix["new_tokens"] / run.window_s
