"""moe_device_ms_per_step: device milliseconds of the kernels launched
inside the ``moe_ffn`` span (the harness's span around
``repro_torch.models.moe.moe_ffn``) per traced step.  Device trace."""


def read(w):
    t = w.trace
    if t is None or not t.span_count.get("moe_ffn") or \
            not t.span_count.get("Engine.step"):
        return None
    dev = t.span_device_s["moe_ffn"]
    return dev / t.span_count["Engine.step"] * 1e3 if dev > 0 else None
