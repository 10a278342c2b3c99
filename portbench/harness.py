"""The benchmark's driver: one run of one cell of ``BENCHMARK.json``.

Everything is found by name.  The cell names a configuration, whose file
(``configs/<name>.json``) holds the numbers it runs at, and a traffic mix,
whose file (``traffic/<name>.json``) names the entry it drives
(``entries/<entry>.py``) and that entry's parameters.  Each metric is read by
``metrics/<metric>.py`` from the run's record, or, where no file has the
metric's whole name, by the file of its name without the last ``.<part>``
(``device_idle_pct.prove`` by ``device_idle_pct.py``).  A new configuration,
mix or metric is new files and an entry in ``BENCHMARK.json``; no file here
changes.

A run: set-up (import, the kernel library, the cell's state made on the
device from the seed, a few requests of the cell's own shapes; the seconds
of each part on standard error), then a
closed loop with the traffic's ``clients`` (one by default) for
``--seconds`` (under ``torch.profiler`` with ``--trace 1``), then, with the
program's state freed, the plain reference over a sample of the window's
answers drawn from the seed.  The last line of standard output is the
result; the numbers compared, each beside its limit, are the last lines of
standard error and the result's last key.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import importlib.util
import json
import pathlib
import random
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "c_lwe_snarks_tpu")
CONFIG_KEYS = ("d", "m", "n", "logq", "p", "log_smudging", "log_sigma")
SETTLE_S = 0.01  # the profiler traces no kernel in its first ~1 ms


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path):
    """Import a file of the benchmark by its path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_file(name: str, root: pathlib.Path = ROOT) -> pathlib.Path:
    """The reader of metric ``name``: ``metrics/<name>.py``, else the file of
    the name without its last ``.<part>``."""
    metrics = root / "portbench" / "metrics"
    whole = metrics / f"{name}.py"
    return whole if whole.is_file() or "." not in name else metrics / f"{name.rsplit('.', 1)[0]}.py"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    """A cell of BENCHMARK.json and the files it names."""

    name: str
    chips: int
    config_name: str
    cfg: dict
    traffic: dict
    entry: object
    end_to_end: list
    per_layer: list

    @classmethod
    def find(cls, bench: dict, name: str, root: pathlib.Path = ROOT) -> "Cell":
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
        traffic = load_json(root / "portbench" / "traffic" / f"{w['traffic']}.json")
        entry = load_module(root / "portbench" / "entries" / f"{traffic['entry']}.py")

        def mine(metrics):
            return [m for m in metrics if name in m.get("workloads", [name])]

        return cls(name, int(w["chips"]), conf["name"], load_json(root / conf["file"]), traffic,
                   entry, mine(bench["end_to_end"]), mine(bench["per_layer"]))


class Spans:
    """Host spans from the benchmark's own files.  Off, a span costs nothing;
    on (the traced run), it is a ``record_function`` range in the profiler's
    timeline and a host-clock record, optionally with a synchronize on both
    sides."""

    def __init__(self, on: bool, device):
        self.on, self.device, self.records = on, device, []

    @contextlib.contextmanager
    def __call__(self, name: str, sync: bool = False):
        if not self.on:
            yield
            return
        import torch

        if sync and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            yield
            if sync and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.records.append((name, t0, time.perf_counter()))

    def total_s(self, name: str) -> float:
        return sum(e - s for n, s, e in self.records if n == name)

    def names(self) -> set:
        return {n for n, _, _ in self.records} | {"window", "request"}


@dataclasses.dataclass
class Context:
    """What an entry is given: the cell, the seed, the device and the spans."""

    cell: Cell
    seed: int
    device: object
    spans: Spans
    phases: list = dataclasses.field(default_factory=list)  # [(set-up's part, its start)]

    @property
    def cfg(self) -> dict:
        return self.cell.cfg

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def seed_bytes(self, *labels) -> bytes:
        """40 bytes (an AES-CTR seed: nonce, then key) hashed from the run's
        seed, the configuration and the labels."""
        text = "/".join(["portbench", str(self.seed), self.cell.config_name, *map(str, labels)])
        return hashlib.sha512(text.encode()).digest()[:40]

    def rng(self, *labels) -> random.Random:
        return random.Random(int.from_bytes(self.seed_bytes("rng", *labels), "little"))

    def port_params(self):
        from c_lwe_snarks_tpu_torch.utils.params import Params

        return Params(**{k: int(self.cfg[k]) for k in CONFIG_KEYS})

    def ref_params(self, q_bits: int | None = None):
        from portbench.reference.protocol import Params

        return Params.from_config(self.cfg, q_bits)

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def phase(self, name: str) -> None:
        """Set-up's part ``name`` begins now, once the device has done the
        work of the part before (where it has a context)."""
        import torch

        if self.device.type == "cuda" and torch.cuda.is_initialized():
            torch.cuda.synchronize(self.device)
        self.phases.append((name, time.perf_counter()))


@dataclasses.dataclass
class Record:
    """What the metric readers read."""

    cfg: dict
    setup_s: float
    window_s: float
    requests: int
    latencies_s: list
    spans: Spans
    trace: object = None  # trace.Trace of the traced run
    traffic: dict = dataclasses.field(default_factory=dict)  # the cell's traffic file


class Reservoir:
    """The answers the check reads: with the traffic's ``check`` = k, a
    uniform sample of k of the requests the window finished, drawn from the
    seed, with no more than k answers held at any time (algorithm R);
    without it, every answer.  A request that failed (answer None) is always
    kept, and the check counts it as wholly wrong."""

    def __init__(self, ctx: Context):
        k = ctx.traffic.get("check")
        self.k, self.rng, self.seen, self.slots, self.failed = k, ctx.rng("check"), 0, {}, {}

    def offer(self, i: int, answer) -> None:
        if answer is None:
            self.failed[i] = None
            return
        slot = self.seen
        self.seen += 1
        if self.k is not None and slot >= self.k:
            slot = self.rng.randrange(self.seen)
            if slot >= self.k:
                return
        self.slots[slot] = (i, answer)

    def answers(self) -> dict:
        return dict(sorted([*self.slots.values(), *self.failed.items()]))


def one_by_one(ctx: Context, state, indices):
    """The ``serve`` of an entry that has none: ``request`` on each index in
    turn, a request that raises answered None."""
    for i in indices:
        try:
            answer = ctx.cell.entry.request(ctx, state, i)
        except Exception as exc:  # noqa: BLE001 - a failed request is counted, the loop goes on
            print(f"request {i} failed: {exc!r}", file=sys.stderr)
            answer = None
        yield i, answer


def closed_loop(ctx: Context, state, first: int, seconds: float):
    """The traffic's ``clients`` (C, 1 by default), each with one request
    outstanding: requests first .. first + C - 1 are issued at the start,
    and a client issues its next request (the next index) as soon as its
    answer comes back.  Every outstanding request is handed to the entry at
    once, through ``serve(ctx, state, indices)`` where the entry has it
    (``one_by_one`` where not), which yields (index, answer) as each answer
    is done; each call runs inside one ``request`` span.  A request's latency
    runs from its issue to its answer; a request that ``serve`` left
    unanswered, or that was outstanding when ``serve`` raised, fails then.
    The window ends when the first answer after ``seconds`` comes back;
    requests still in flight then are not counted.  Returns (the reservoir
    of answers, None for a request that failed; latencies; failures; the
    window's seconds)."""
    serve = getattr(ctx.cell.entry, "serve", None) or one_by_one
    kept, lat, failed = Reservoir(ctx), [], 0
    t0 = time.perf_counter()
    issued = {i: t0 for i in range(first, first + int(ctx.traffic.get("clients", 1)))}
    nxt = first + len(issued)
    while True:
        batch, issued = issued, {}
        answers = []
        with ctx.spans("request"):
            calls = serve(ctx, state, list(batch))
            try:
                for i, answer in calls:
                    answers.append((i, answer, time.perf_counter()))
                    if answers[-1][2] - t0 >= seconds:
                        break
            except Exception as exc:  # noqa: BLE001 - the outstanding requests fail, the loop goes on
                print(f"serve {list(batch)} failed: {exc!r}", file=sys.stderr)
            finally:
                calls.close()
            answered = {i for i, _, _ in answers}
            end = time.perf_counter()
            answers += [(i, None, end) for i in batch if i not in answered]
        for i, answer, t in answers:
            lat.append(t - batch.pop(i))
            failed += answer is None
            kept.offer(i, answer)
            if t - t0 >= seconds:
                return kept, lat, failed, t - t0
            issued[nxt] = t
            nxt += 1


def control_answers(ctx: Context, indices, q_bits: int) -> dict:
    """The control's answers to the requests ``indices`` as the check keeps
    them: the plain reference's at ``q_bits``, in the program's place."""
    kept = Reservoir(ctx)
    for i in indices:
        kept.offer(i, i)
    return ctx.cell.entry.control(ctx, list(kept.answers()), q_bits)


def _counters():
    from c_lwe_snarks_tpu_torch.ops import aes, digits, eval_fused, modp, ntt, verify

    return (aes.LAUNCHES, eval_fused.LAUNCHES, ntt.LAUNCHES, modp.LAUNCHES, digits.LAUNCHES,
            verify.LAUNCHES)


def _reset_counters() -> None:
    for c in _counters():
        for k in c:
            c[k] = 0


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, root: pathlib.Path = ROOT, phases: list | None = None) -> dict:
    """One run of a cell on ``device``; returns the result line's object.
    ``phases``: set-up's parts before this call, [(name, start)]; by default
    one, "imports", from ``t_start``."""
    phases = [*(phases or [("imports", t_start)]), ("benchmark files", time.perf_counter())]
    import torch

    from portbench import trace as tracing

    cell = Cell.find(bench, workload, root)
    device = torch.device(device)
    spans = Spans(trace, device)
    ctx = Context(cell, seed, device, spans, phases)
    entry = cell.entry
    if device.type == "cuda":
        ctx.phase("cuda context")
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)  # the context and the allocator, before their peak is reset
        torch.cuda.reset_peak_memory_stats(device)
        ctx.phase("port and kernel library")
        from c_lwe_snarks_tpu_torch.ops import _build

        _build.library()  # built in a checkout's first run, loaded in every run
    ctx.phase("state")
    state = entry.prepare(ctx)  # an entry marks the start of its warm requests: ctx.phase("warm")
    ctx.sync()
    t_setup = time.perf_counter()
    setup_s = t_setup - t_start
    marks = [*ctx.phases, ("", t_setup)]
    print(f"set-up {setup_s:.6f} s: " + ", ".join(
        f"{name} {end - start:.6f} s" for (name, start), (_, end) in zip(marks, marks[1:])),
        file=sys.stderr)
    first = int(cell.traffic["warm"])
    _reset_counters()
    prof = None
    if trace:
        window = min(seconds, float(cell.traffic["trace_seconds"]))
        restore = entry.instrument(ctx) if hasattr(entry, "instrument") else (lambda: None)
        try:
            with tracing.profiler(device) as prof:
                time.sleep(SETTLE_S)
                with torch.profiler.record_function("window"):
                    answers, lat, failed, window_s = closed_loop(ctx, state, first, window)
                ctx.sync()
        finally:
            restore()
    else:
        answers, lat, failed, window_s = closed_loop(ctx, state, first, seconds)
    counts = {k: v for c in _counters() for k, v in c.items() if v}
    print(f"launches per request: { {k: v / len(lat) for k, v in counts.items()} }",
          file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    dev = ({"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": peak} if device.type == "cuda"
           else {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0})
    record = Record(cell.cfg, setup_s, window_s, len(lat) - failed, lat, spans,
                    traffic=cell.traffic)
    if prof is not None:
        record.trace = tracing.Trace.read(prof, spans.names())
        if device.type == "cuda" and not record.trace.device:
            raise RuntimeError("the profiler traced no device item in the window: "
                               "every device_trace metric would be blind")
        dev.update(busy_s=record.trace.busy_s, window_s=record.trace.window_s)
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = entry.judge(ctx, answers.answers())
    print(f"reference check {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_module(metric_file(m["name"], root)).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        elif device.type == "cuda" or m["source"] != "device_trace":
            # left out of the line, as a reader that finds nothing is; said here
            print(f"portbench: {m['name']} read nothing in {workload}: what it reads "
                  f"(a kernel's name, a span) is no longer on the timed path", file=sys.stderr)
    result = {"correct": all(v <= lim for _, v, lim in checks), "attempted": len(lat),
              "failed": failed, "metrics": metrics, "device": dev}
    if record.trace is not None:
        result["breakdown"] = record.trace.breakdown()
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return result


def main(argv, t_start: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    chips = int({w["name"]: w for w in bench["workloads"]}[args.workload]["chips"])
    import torch

    phases = [("imports", t_start), ("cuda driver", time.perf_counter())]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0",
                      t_start, phases=phases)
    found = forbidden_modules()
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0
