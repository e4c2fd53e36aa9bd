"""One run of one benchmark cell of the PyTorch/CUDA port.

    python3 -m benchmark.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  ``BENCHMARK.json`` names the cell: its
configuration (``benchmark/configs/<name>.json``), its traffic mix
(``benchmark/traffic/<name>.json``, read by :mod:`benchmark.gen`, whose
content kinds are ``benchmark/content/<kind>.py``) and the
cards it takes; each metric is read by ``benchmark/metrics/<name>.py``.
A run loads the program, makes the mix's files from the seed on card 0,
warms up with one round trip of each file, then runs a closed loop of
one caller for ``S`` seconds: each round trip ``redux_tpu_torch.api.encode``
of a file, then ``api.decode`` of its archive, the files in the mix's
order.  Every encode call, the warm-up's included, gets the
configuration's parameters, ``delta`` and ``prior_budget``, and the
keyword settings of its optional ``encode`` object (such as
``{"block_size": 16384}`` or ``{"use_prior": false}``), checked before
the first call (:func:`codec_kwargs`).  ``--trace 0`` runs the window
under ``torch.profiler``'s CUDA activity alone, for the cards' busy
time, and prints the end-to-end metrics; ``--trace 1`` runs it under
CPU and CUDA activity, half the round trips with the program's
``_timings`` (:mod:`benchmark.trace`), and prints the per-layer ones.  Every run also prints, on standard
error, the plain calls' bytes and wall seconds.  Once the window has closed, a sample of its round trips drawn
from the seed is held to the plain reference (:mod:`benchmark.reference`).

The last line of standard output is one JSON object.  Without the cards
the cell asks for, or with JAX or the JAX package loaded, the run prints
no result and exits with another code than 0.  The program builds its
kernels into ``build/`` of the checkout at its first run there; a run
writes nothing else.
"""

from __future__ import annotations

import time

_T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import inspect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Optional  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import gen, reference, trace, work  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "redux_tpu")
# Round trips a traced window holds at most: the profiler's events stay
# within memory and the reduction within seconds.
TRACE_MAX_ROUND_TRIPS = 200
# Round trips the check keeps, drawn from the seed, beside the last of
# the longest file; blocks of an archive the reference codes where it has
# more.
SAMPLE_ROUND_TRIPS = 48
SAMPLE_BLOCKS = 1024
# api.encode's keywords that are the run's own: the input, the cards and
# the recorder of a timed call.
HARNESS_KEYWORDS = ("data", "device", "_timings")


def process_age() -> float:
    """Seconds since this process started (the kernel's start time), or
    since this module was imported where /proc is not there."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return float(Path("/proc/uptime").read_text().split()[0]) - started
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


_T0 = time.perf_counter() - process_age()


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole (``redux_tpu_torch`` is not ``redux_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Manifest:
    """``BENCHMARK.json`` and the files it names, found by name."""

    def __init__(self, root: Path = ROOT):
        self.root = root
        self.data = json.loads((root / "BENCHMARK.json").read_text())
        self.bench = root / "benchmark"
        self.content = self.bench / "content"

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise SystemExit(f"no config {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> dict:
        return gen.load_mix(self.bench / "traffic" / f"{name}.json", self.content)

    def metrics(self, cell: str, traced: bool) -> list[dict]:
        """The cell's metrics of one kind: ``end_to_end`` untraced,
        ``per_layer`` traced; an entry with ``workloads`` only in those."""
        kind = "per_layer" if traced else "end_to_end"
        return [m for m in self.data[kind] if cell in m.get("workloads", [cell])]

    def reader(self, name: str):
        """``benchmark/metrics/<name>.py``'s ``read``."""
        path = self.bench / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


class Run:
    """What a run measured, as the metric readers see it."""

    def __init__(self, cell: dict, config: dict, mix: dict, n_cards: int):
        self.cell, self.config, self.mix, self.n_cards = cell, config, mix, n_cards
        self.calls: list[dict] = []  # kind, mode, file, bytes, seconds
        self.work: dict[int, work.ArchiveWork] = {}  # file -> what its round trip moves
        self.trace: Optional[trace.Trace] = None
        self.card_busy_ns: Optional[dict] = None  # card -> busy ns of an untraced window
        self.setup_s = 0.0
        self.peak_bytes = 0

    def plain(self, kind: str) -> list[dict]:
        return [c for c in self.calls if c["kind"] == kind and c["mode"] == "plain"]


def codec_kwargs(config: dict) -> dict:
    """``api.encode``'s settings of a configuration: its parameters,
    ``delta`` and the prior's budget, merged with the keyword settings of
    its optional ``encode`` object, which define the deployment; the
    reference honours those that change an archive's bytes
    (:class:`benchmark.reference.Config`).  Without ``encode`` the block
    size and the prior's use are the program's defaults.  SystemExit,
    naming the key, where ``encode`` sets a keyword set here already, one
    of :data:`HARNESS_KEYWORDS`, or one that ``api.encode`` does not take."""
    from redux_tpu_torch import api
    from redux_tpu_torch.params import Parameters

    kw = dict(params=Parameters(config["symbol_bits"], config["freq_bits"], config["code_bits"]),
              delta=config["delta"], prior_budget=config["prior_budget"])
    settings = config.get("encode", {})
    if not isinstance(settings, dict):
        raise SystemExit(f"configuration {config.get('name')!r}: \"encode\" is not an object")
    takes = {p.name for p in inspect.signature(api.encode).parameters.values()
             if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)}
    for key in settings:
        if key in kw or key in HARNESS_KEYWORDS:
            raise SystemExit(f"configuration {config.get('name')!r}: \"encode\" key {key!r} is "
                             "the harness's to set")
        if key not in takes:
            raise SystemExit(f"configuration {config.get('name')!r}: \"encode\" key {key!r} is "
                             "not a keyword of redux_tpu_torch.api.encode")
    return {**kw, **settings}


class Sampler:
    """The round trips the check holds to the reference: a reservoir of
    ``k`` drawn from the seed, and the last round trip of the longest file."""

    def __init__(self, seed: int, k: int, longest: int):
        self.rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 5])
        self.k, self.longest, self.seen = k, longest, 0
        self.kept: list = []
        self.last_longest = None

    def offer(self, item: tuple) -> None:
        if item[0] == self.longest:
            self.last_longest = item
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.kept[j] = item

    def items(self) -> list:
        return self.kept + ([self.last_longest] if self.last_longest is not None else [])


def run_cell(manifest: Manifest, name: str, seed: int, seconds: float, traced: bool,
             device=None, gen_device=None) -> dict:
    """One run of cell ``name``; ``device`` is what the program is given
    (default: card 0, or every card of a cell on several)."""
    from redux_tpu_torch import api
    from redux_tpu_torch.parallel import data_parallel_mesh

    cell = manifest.cell(name)
    config, mix = manifest.config(cell["config"]), manifest.mix(cell["traffic"])
    kw, cfg = codec_kwargs(config), reference.Config(config)  # before any call
    chips = int(cell["chips"])
    if device is None:
        device = "cuda" if chips == 1 else data_parallel_mesh(n=chips)
    cards = [torch.device(d) for d in (device if isinstance(device, list) else [device])]
    cuda = cards[0].type == "cuda"
    if cuda:
        from redux_tpu_torch import _build

        _build.lib()
    run = Run(cell, config, mix, len(cards))
    files = gen.make_files(mix, seed, gen_device or (torch.device("cuda", 0) if cuda else "cpu"),
                           manifest.content)
    if cuda:
        torch.cuda.empty_cache()
    failed, first_error = 0, None
    for f in files:  # warm-up: every shape of the window
        try:
            api.decode(api.encode(f.data, device=device, **kw), device=device)
        except Exception:  # counted as a failed call, as in the window
            failed += 1
            first_error = first_error or traceback.format_exc()
    order = gen.file_order(mix, seed)
    longest = int(np.argmax([len(f.data) for f in files]))
    sampler = Sampler(seed, SAMPLE_ROUND_TRIPS if len(files) > 1 else 2, longest)
    setup_peak = max((torch.cuda.max_memory_allocated(d) for d in cards), default=0) if cuda else 0
    for d in cards if cuda else ():
        torch.cuda.reset_peak_memory_stats(d)
    run.setup_s = time.perf_counter() - _T0

    activities = (([torch.profiler.ProfilerActivity.CPU] if traced else [])
                  + ([torch.profiler.ProfilerActivity.CUDA] if cuda else []))
    prof = torch.profiler.profile(activities=activities) if activities else contextlib.nullcontext()
    mark = torch.profiler.record_function if traced else (lambda _: contextlib.nullcontext())
    n_rt = 0
    with prof:
        t_end = time.perf_counter() + seconds  # the profiler's start is set-up
        while time.perf_counter() < t_end and not (traced and n_rt >= TRACE_MAX_ROUND_TRIPS):
            j = next(order)
            data = files[j].data
            mode = "timed" if traced and n_rt % 2 else "plain"
            n_rt += 1
            try:
                tt_e = trace.PhaseLog() if mode == "timed" else None
                with mark(f"enc.{mode}"):
                    t0 = time.perf_counter()
                    arch = api.encode(data, device=device, _timings=tt_e, **kw)
                    t1 = time.perf_counter()
                tt_d = trace.PhaseLog() if mode == "timed" else None
                with mark(f"dec.{mode}"):
                    t2 = time.perf_counter()
                    out = api.decode(arch, device=device, _timings=tt_d)
                    t3 = time.perf_counter()
            except Exception:  # a call that fails is counted, and the loop goes on
                failed += 1
                first_error = first_error or traceback.format_exc()
                continue
            run.calls.append(dict(kind="enc", mode=mode, file=j, bytes=len(data),
                                  seconds=t1 - t0))
            run.calls.append(dict(kind="dec", mode=mode, file=j, bytes=len(out),
                                  seconds=t3 - t2))
            if j not in run.work:
                run.work[j] = work.archive_work(arch)
            sampler.offer((j, arch, out))
            del arch, out
    if cuda:
        run.peak_bytes = max(torch.cuda.max_memory_allocated(d) for d in cards)
    if traced:
        run.trace = trace.reduce(trace.events(prof))
    elif cuda:
        run.card_busy_ns = trace.card_busy_ns(trace.events(prof))
    if first_error:
        print(first_error, file=sys.stderr)

    metrics = {}
    for m in manifest.metrics(name, traced):
        value = manifest.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # The check, once the window has closed and its memory is read.
    del prof
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 3])
    kept = sampler.items()
    items = [(files[j].data, [a for i, a, _ in kept if i == j], [o for i, _, o in kept if i == j])
             for j in sorted({item[0] for item in kept})]
    check = reference.compare_files(items, cfg, rng, SAMPLE_BLOCKS, cards[0] if cuda else "cpu")
    check["empty"] = int(not kept)  # a window that finished no round trip has nothing checked
    print(f"check: {len(kept)} round trips of {sampler.seen} held to the reference "
          f"in {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)

    attempted = len(files) + n_rt  # the warm-up's round trips and the window's
    enc, dec = run.plain("enc"), run.plain("dec")
    print(f"window: {attempted} round trips, {failed} failed; plain encode "
          f"{sum(c['bytes'] for c in enc)} B in {sum(c['seconds'] for c in enc):.6f} s, decode "
          f"{sum(c['bytes'] for c in dec)} B in {sum(c['seconds'] for c in dec):.6f} s; "
          f"{len(enc)} plain round trips", file=sys.stderr)
    for kind, calls in (("encode", enc), ("decode", dec)):
        if calls:
            q = np.percentile([c["seconds"] for c in calls], [0, 25, 50, 75, 100])
            print(f"{kind} call s: min {q[0]:.6f} q1 {q[1]:.6f} median {q[2]:.6f} q3 {q[3]:.6f} "
                  f"max {q[4]:.6f}; first five {[round(c['seconds'], 6) for c in calls[:5]]}",
                  file=sys.stderr)
    dev_info = {"platform": "gpu" if cuda else cards[0].type,
                "kind": torch.cuda.get_device_name(cards[0]) if cuda else cards[0].type,
                "count": len(cards), "memory_peak_bytes": max(run.peak_bytes, setup_peak)}
    result = {"correct": failed == 0 and all(v == 0 for v in check.values()),
              "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev_info}
    if traced and run.trace is not None:
        tr = run.trace
        dev_info["busy_s"] = sum(tr.busy_ns.values()) / max(len(cards), 1) / 1e9
        dev_info["window_s"] = tr.window_ns / 1e9
        result["breakdown"] = trace.breakdown(tr)
    result["check"] = {k: {"value": v, "limit": 0} for k, v in check.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = Manifest()
    cell = manifest.cell(args.workload)
    codec_kwargs(manifest.config(cell["config"]))  # a bad ``encode`` key stops any machine here
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result = run_cell(manifest, args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}; no result", file=sys.stderr)
        return 4
    for k, v in result["check"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
