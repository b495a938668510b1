"""output_tok_s: tokens returned by the steps that ended in the window,
over the window's seconds (its start to the last step's return).  Host
clock."""


def read(w):
    return w.emitted / w.seconds if w.seconds > 0 else None
