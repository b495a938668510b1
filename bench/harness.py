"""One run of one cell: set-up, the measured window, the check, and the
result line.

Set-up draws the cell's weights from the seed on the card, builds the
engine on them (``repro_torch.serving.Engine``), serves one short request
that launches both step widths (the first run in a checkout also builds
the kernels there), then serves the cell's own traffic for its
``warmup_s`` so that the slots hold a steady mix when the window opens.
The window serves the same traffic for ``--seconds``: between steps every
request whose due time has passed is submitted; each step's return times
the tokens it carried.  Then the check (``bench.check``) judges the
served tokens against the reference, and each metric's reader
(``bench/metrics/<name>.py``) reads the window.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import json
import sys
import time
from collections import deque
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

from bench import check, traffic
from bench.trace import SLICE_S, Trace, Tracer

ROOT = Path(__file__).resolve().parents[1]
#: top-level module names no run may load: JAX and the JAX package
JAX_NAMES = ("jax", "jaxlib", "flax", "repro")
#: the harness's spans around the calls into the program
SPANS = ("Engine.step", "submit", "moe_ffn")
#: what an architecture module (``bench/archs/<name>.py``) exports
ARCH_API = ("draw", "Reference", "rank", "layer_gemms", "expert_gemms",
            "moe_layers", "matmul_params", "attn_layers", "tiny")


class CellError(ValueError):
    """A cell, configuration, mix or metric that the files do not hold."""


def _load(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod     # dataclasses look their module up by name
    spec.loader.exec_module(mod)
    return mod


def arch(name: str, root: Path = ROOT) -> ModuleType:
    """The architecture module ``bench/archs/<name>.py``: everything the
    harness knows of a model's layers (the raw weights' layout, the plain
    reference, the router's ranking, the work counts, the CPU cut), each
    name of ``ARCH_API``."""
    path = root / "bench" / "archs" / f"{name}.py"
    if not path.exists():
        raise CellError(f"no architecture module {path} for {name!r}")
    mod = _load(path, f"bench.archs.{name}")
    missing = [f for f in ARCH_API if not hasattr(mod, f)]
    if missing:
        raise CellError(f"{path} does not export {missing}")
    return mod


def load_cell(name: str, root: Path = ROOT) -> Dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration file,
    its traffic mix, the metrics it reports and its configuration's
    architecture module (its ``arch``, ``decoder`` where it names none),
    found by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise CellError(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    if cell["config"] not in cfgs:
        raise CellError(f"no configuration {cell['config']!r}")
    cfg = json.loads((root / cfgs[cell["config"]]["file"]).read_text())
    mix = json.loads((root / "bench" / "traffic" /
                      f"{cell['traffic']}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return dict(cell=cell, config=cfg, traffic=mix,
                end_to_end=mine(bench["end_to_end"]),
                per_layer=mine(bench["per_layer"]),
                arch=arch(cfg.get("arch", "decoder"), root))


def reader(metric: str, root: Path = ROOT) -> Callable:
    """The ``read(window)`` of a metric: ``bench/metrics/<base>.py``, where
    ``<base>`` is the name up to its first dot (a suffix names the
    end-to-end metric it moves)."""
    base = metric.split(".")[0]
    path = root / "bench" / "metrics" / f"{base}.py"
    if not path.exists():
        raise CellError(f"no reader {path} for metric {metric!r}")
    return _load(path, f"bench.metrics.{base}").read


def jax_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``repro_torch`` is not ``repro``)."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules)
                  if m.split(".")[0] in JAX_NAMES)


@dataclasses.dataclass
class Window:
    """What the metrics read.  Times are seconds from the window's start."""
    model: Dict
    arch: ModuleType                # the configuration's (``arch``)
    policy: str
    setup_s: float
    seconds: float                  # the start to the last step's return
    due: Dict[int, float]           # requests' due times
    first: Dict[int, float]         # return of the step with the 1st token
    returns: Dict[int, List[float]]  # returns of the steps with each token
    #: (start, return, tokens fed, tokens emitted) of every step that
    #: returned inside the window; fed from the engine's ``fed_tokens``
    steps: List[Tuple[float, float, int, int]]
    model_steps: int                # the engine's ``model_steps`` in it
    fed_tokens: int                 # the engine's ``fed_tokens`` in it
    trace: Optional[Trace] = None

    @property
    def emitted(self) -> int:
        return sum(s[3] for s in self.steps)


@dataclasses.dataclass
class Outcome:
    """The run's outcome besides the window: requests due in the window,
    those refused, the finished requests for the check."""
    attempted: int
    failed: int
    finished: Dict[int, check.Served]
    late_s: float                   # how late the generator submitted


def build(cfg: Dict, params: Dict, device):
    """The engine of a configuration file on raw ``params``."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.serving import Engine, EngineConfig
    return Engine(EngineConfig(model=ModelConfig(**cfg["model"]),
                               policy=cfg["policy"], device=device,
                               **cfg["engine"]), params=params)


def prewarm(eng, vocab: int, seed: int) -> None:
    """One request whose prompt is a chunk and a token: a chunk-wide step,
    then one-token steps (the two step widths the traffic uses)."""
    from repro_torch.serving import SamplingParams
    prompt = traffic.rng(seed, 9).integers(0, vocab, eng.prefill_chunk + 1)
    eng.generate([prompt.tolist()], SamplingParams(max_new_tokens=2,
                                                   min_new_tokens=2))


@contextlib.contextmanager
def moe_span(on: bool):
    """Put ``repro_torch.models.moe.moe_ffn`` under a ``moe_ffn`` span."""
    if not on:
        yield
        return
    import torch
    from repro_torch.models import moe
    orig = moe.moe_ffn

    def moe_ffn(*a, **k):
        with torch.profiler.record_function("moe_ffn"):
            return orig(*a, **k)
    moe.moe_ffn = moe_ffn
    try:
        yield
    finally:
        moe.moe_ffn = orig


def drive(eng, reqs: List[traffic.Request], mix: Dict, seconds: float,
          tracer: Optional[Tracer], at_start: Callable[[], None]):
    """Serve ``reqs`` through the warm-up and the window, calling
    ``at_start`` once as the window opens; returns the window's records,
    the outcome, and the window's start (perf_counter)."""
    import torch
    from repro_torch.serving import EngineError, SamplingParams
    clock = time.perf_counter
    span = (torch.profiler.record_function if tracer is not None
            else lambda _: contextlib.nullcontext())
    is_open = mix["loop"] == "open"
    w0 = clock() + float(mix["warmup_s"])
    due, first, returns, done = {}, {}, {}, {}
    req_of, steps = {}, []
    counts = dict(attempted=0, failed=0, in_flight=0)
    late = 0.0
    opened = False

    def submit(r: traffic.Request, t_due: float) -> None:
        nonlocal late
        inside = 0 <= t_due < seconds
        counts["attempted"] += inside
        late = max(late, clock() - w0 - t_due)
        try:
            rid = eng.submit(r.prompt, SamplingParams(
                max_new_tokens=r.new_tokens, min_new_tokens=r.new_tokens))
        except EngineError:
            counts["failed"] += inside
            return
        due[rid], req_of[rid] = t_due, r
        counts["in_flight"] += 1

    if is_open:
        pending = deque(sorted(reqs, key=lambda r: r.due_s))
    else:
        queues: Dict[int, deque] = {}
        for r in reqs:
            queues.setdefault(r.client, deque()).append(r)
        t_start = -float(mix["warmup_s"])
        for q in queues.values():
            submit(q.popleft(), t_start)
    while True:
        now = clock() - w0
        if now >= seconds:
            break
        if not opened and now >= 0:
            at_start()
            opened = True
        if is_open and pending and pending[0].due_s <= now:
            with span("submit"):
                while pending and pending[0].due_s <= now:
                    r = pending.popleft()
                    submit(r, r.due_s)
        if counts["in_flight"] == 0:
            nxt = pending[0].due_s if is_open and pending else seconds
            time.sleep(max(0.0, min(nxt, seconds) - now))
            continue
        if tracer is not None and not tracer.on and \
                now >= seconds - SLICE_S:
            tracer.start(len([s for s in steps if s[1] > 0]))
            now = clock() - w0
        fed0 = eng.fed_tokens
        with span("Engine.step"):
            outs = eng.step()
        t1 = clock() - w0
        steps.append((now, t1, eng.fed_tokens - fed0, len(outs),
                      eng.model_steps))
        nxt_reqs = []
        for o in outs:
            returns.setdefault(o.rid, []).append(t1)
            first.setdefault(o.rid, t1)
            if o.finished:
                counts["in_flight"] -= 1
                done[o.rid] = (t1, list(o.output_token_ids))
                if not is_open and queues[req_of[o.rid].client]:
                    nxt_reqs.append(queues[req_of[o.rid].client].popleft())
        if nxt_reqs:
            with span("submit"):
                for r in nxt_reqs:
                    submit(r, t1)
    end = clock() - w0
    trace = tracer.stop() if tracer is not None and tracer.on else None
    inside = [s for s in steps if 0 < s[1] <= end]
    before = [s for s in steps if s[1] <= 0]
    steps0 = before[-1][4] if before else inside[0][4] - 1
    win = dict(seconds=end, due=due, first=first, returns=returns,
               steps=[s[:4] for s in inside],
               model_steps=inside[-1][4] - steps0 if inside else 0,
               fed_tokens=sum(s[2] for s in inside), trace=trace)
    finished = {rid: check.Served(req_of[rid].prompt, toks,
                                  req_of[rid].new_tokens)
                for rid, (t, toks) in done.items() if 0 < t <= end}
    return win, Outcome(counts["attempted"], counts["failed"], finished,
                        late), w0


def shapes(cfg: Dict) -> Dict:
    """The sizes the weights are drawn at: the configuration's ``model``
    (the program's ``ModelConfig``) with its ``drawn`` widths, which that
    class has no field for (arctic's dense residual at d_model)."""
    return {**cfg["model"], **cfg.get("drawn", {})}


def serve(c: Dict, seed: int, seconds: float, trace: bool, device,
          t0: float) -> Tuple[Window, Outcome, int]:
    """Set-up and the window of one run of the loaded cell ``c``
    (``load_cell``) on ``device``; ``t0`` is the process's start.  Returns
    the window, the outcome and the device's peak bytes in the window
    (the fullest the card was while serving; set-up's transient draw of
    the bf16 weights is left out); the engine is freed."""
    import torch
    cfg, mix = c["config"], c["traffic"]
    model = shapes(cfg)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    reqs = traffic.generate(mix, seed, seconds, model["vocab"])
    params = c["arch"].draw(model, seed, device)
    eng = build(cfg, params, device)
    del params
    with torch.no_grad():
        prewarm(eng, model["vocab"], seed)
        tracer = None
        if trace:
            tracer = Tracer(SPANS)
            tracer.warm(lambda: prewarm(eng, model["vocab"], seed))
        with moe_span(trace and bool(model.get("n_experts"))):
            win, out, w0 = drive(
                eng, reqs, mix, seconds, tracer,
                lambda: torch.cuda.reset_peak_memory_stats(dev) if cuda
                else None)
    window = Window(model=model, arch=c["arch"], policy=cfg["policy"],
                    setup_s=w0 - t0, **win)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return window, out, peak


def run(c: Dict, seed: int, seconds: float, trace: bool, device,
        t0: float) -> Tuple[Dict, List[str]]:
    """One run of the loaded cell ``c``: ``serve``, then the check and the
    metrics; returns the result line's object and the check's lines."""
    import torch
    window, out, peak = serve(c, seed, seconds, trace, device, t0)
    params = c["arch"].draw(shapes(c["config"]), seed, device)
    numbers, info = check.compare(c, params, out.finished, seed)
    del params
    metrics = {}
    for m in (c["per_layer"] if trace else c["end_to_end"]):
        v = reader(m["name"])(window)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = torch.device(device)
    result = {"correct": check.judged(numbers), "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                         "kind": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else "cpu"),
                         "count": c["cell"]["chips"],
                         "memory_peak_bytes": peak}}
    if window.trace is not None:
        result["device"]["busy_s"] = window.trace.busy_s
        result["device"]["window_s"] = window.trace.window_s
        result["breakdown"] = window.trace.breakdown()
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in numbers.items()}
    lines = [f"run: {out.attempted} requests due in the window, "
             f"{len(out.finished)} finished, generator at most "
             f"{out.late_s * 1e3:.1f} ms late; checked {info}"]
    lines += [f"check {k}: {v} (limit {lim})"
              for k, (v, lim) in numbers.items()]
    return result, lines


def main(argv: List[str], t0: float) -> int:
    ap = argparse.ArgumentParser(prog="bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    c = load_cell(args.workload)
    import torch
    chips = c["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: the cell needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    result, lines = run(c, args.seed, args.seconds, bool(args.trace),
                        "cuda", t0)
    found = jax_modules()
    if found:
        print(f"bench: JAX or the JAX package was loaded: {found}",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
