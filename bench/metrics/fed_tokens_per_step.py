"""fed_tokens_per_step: the engine's ``fed_tokens`` over its
``model_steps`` in the window (prompt rows, replay and decode rows a
batched step feeds; the padding of a wide step is not counted).  Program
counters."""


def read(w):
    return w.fed_tokens / w.model_steps if w.model_steps else None
