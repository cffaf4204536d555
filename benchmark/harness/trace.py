"""The traced window: a ``torch.profiler`` record of a fixed number of
requests, reduced to what the per-layer metrics read.

The record opens with ``PAD_KERNELS`` spin kernels on each card, as the
port's ``chip_smoke.py`` and ``scripts/profile_torch.py`` do: the profiler
may drop events at a record's start, and a record counts only if it kept
at least one spin kernel on every card (else it is made again, at most
``ATTEMPTS`` times).  The requests run inside the host span
``bench.window``, each inside ``bench.request`` with ``bench.submit`` (the
program's call) and ``bench.wait`` (the wait for its output); the device
events after a card's last spin kernel are the window's.

The port's own spans (``musica.*``, its ``utils/spans.py``) are kept apart
in ``Trace.program``: host spans, and the device-side ranges the profiler
draws over the operations issued inside a span and no inner one, each
carrying its host span's id.  ``Trace.idle_split`` splits a card's idle
time by them.
"""

from __future__ import annotations

import bisect
import collections
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .labels import label

PAD_KERNELS = 64
ATTEMPTS = 3
TOP = 10  # entries of each breakdown list
PARTS = ("graph", "image", "request")  # the parts of ``Trace.idle_split``
Interval = Tuple[float, float]


def _merge(iv) -> List[Interval]:
    out: List[List[float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _inside(merged: List[Interval], t: float) -> bool:
    i = bisect.bisect_right(merged, (t, float("inf"))) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


@dataclass
class Trace:
    """Device events (seconds on the profiler's clock) and host spans of a
    traced window of ``images`` images lasting ``window_s`` seconds."""
    images: int
    window_s: float
    devices: List[int]
    kernels: List[Tuple[str, float, float, int]] = field(default_factory=list)
    copies: List[Tuple[str, float, float, int]] = field(default_factory=list)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    # the port's spans clipped to the window: (name, start, end, card or -1
    # for a host span, thread, id)
    program: List[Tuple[str, float, float, int, int, int]] = field(default_factory=list)
    window: Tuple[float, float] = (0.0, 0.0)
    latency_s: List[float] = field(default_factory=list)  # each request's, host clock
    cfg: Optional[object] = None
    peak_bytes_per_s: float = 0.0
    stages: Dict[str, List[re.Pattern]] = field(default_factory=dict)
    stage_bytes: Optional[Callable[[str], object]] = None

    # ---- sums ----------------------------------------------------------
    def kernel_s(self) -> float:
        return sum(b - a for _, a, b, _ in self.kernels)

    def copy_s(self, kinds: Sequence[str]) -> float:
        return sum(b - a for name, a, b, _ in self.copies
                   if any(k in name for k in kinds))

    def busy_s(self, dev: int) -> float:
        """Seconds in which a kernel or a copy ran on card ``dev``."""
        return sum(b - a for a, b in self._merged(dev))

    def _merged(self, dev: int) -> List[Interval]:
        return _merge((a, b) for _, a, b, d in self.kernels + self.copies if d == dev)

    def idle_gaps(self, dev: int) -> List[Interval]:
        """The gaps of the window in which card ``dev`` runs neither a
        kernel nor a copy."""
        w0, w1 = self.window
        out, edge = [], w0
        for a, b in self._merged(dev) + [(w1, w1)]:
            if a > edge:
                out.append((edge, a))
            edge = max(edge, b)
        return out

    # ---- the port's spans ----------------------------------------------
    def idle_split(self, dev: int) -> Optional[Dict[str, float]]:
        """Card ``dev``'s idle seconds by part, {"graph", "image",
        "request"}, summing to its idle time; None where the window holds no
        ``musica.request`` span.  A copy of the port's
        ``scripts/idle_split.py::idle_split``: a request issues nothing
        itself, so its device extent is the hull of the device-side ranges
        of the spans its host span holds on its thread; each idle gap goes,
        by its midpoint, to ``graph`` inside a ``musica.graph`` range (gaps
        between the captured graph's nodes), to ``image`` inside a
        request's extent but in no graph (an image's copies' edges, the
        launch's latency, the host's issue between images), else to
        ``request`` (the caller's turnaround between requests)."""
        requests = [s for s in self.program if s[3] < 0 and s[0] == "musica.request"]
        if not requests:
            return None
        owner = {}  # the id of a host span -> the id of the request that holds it
        for name, a, b, card, thread, sid in self.program:
            if card < 0:
                owner.update({sid: r[5] for r in requests
                              if r[4] == thread and r[1] <= a and b <= r[2]})
        hull: Dict[int, List[float]] = {}
        for name, a, b, card, _, sid in self.program:
            if card == dev and sid in owner:
                h = hull.setdefault(owner[sid], [a, b])
                h[0], h[1] = min(h[0], a), max(h[1], b)
        graphs = _merge((a, b) for name, a, b, card, *_ in self.program
                        if card == dev and name == "musica.graph")
        extents = _merge((a, b) for a, b in hull.values())
        out = dict.fromkeys(PARTS, 0.0)
        for a, b in self.idle_gaps(dev):
            mid = (a + b) / 2
            part = ("graph" if _inside(graphs, mid) else
                    "image" if _inside(extents, mid) else "request")
            out[part] += b - a
        return out

    def gap_pct(self, part: str) -> Optional[float]:
        """``part`` of the idle split in % of the window, the mean over
        the cards; None where the port emitted no ``musica.request``."""
        splits = [self.idle_split(d) for d in self.devices]
        if not splits or splits[0] is None:
            return None
        return 100.0 * sum(s[part] for s in splits) / len(splits) / self.window_s

    # ---- stages --------------------------------------------------------
    def stage_of(self, lab: str) -> str:
        hits = [s for s, pats in self.stages.items() if any(p.search(lab) for p in pats)]
        if len(hits) > 1:
            raise ValueError(f"kernel {lab!r} matches the stages {hits}")
        return hits[0] if hits else "other"

    def stage_s(self, stage: str) -> float:
        return sum(b - a for lab, a, b, _ in self.kernels if self.stage_of(lab) == stage)

    def unstaged(self) -> List[str]:
        return sorted({lab for lab, *_ in self.kernels if self.stage_of(lab) == "other"})

    def roofline_pct(self, stage: str) -> Optional[float]:
        """The stage's least time (its bytes over the peak bandwidth) over
        its kernels' device time, in %; None where no kernel of it ran."""
        t = self.stage_s(stage)
        if t <= 0.0:
            return None
        nbytes = self.stage_bytes(stage).bytes_per_image(self.cfg) * self.images
        return 100.0 * nbytes / self.peak_bytes_per_s / t

    # ---- breakdown -----------------------------------------------------
    def breakdown(self) -> dict:
        ops: Dict[str, float] = collections.defaultdict(float)
        for lab, a, b, _ in self.kernels + self.copies:
            ops[lab] += b - a
        gaps: Dict[str, List[float]] = collections.defaultdict(list)
        for dev in self.devices:
            for a, b in self.idle_gaps(dev):
                gaps[self._host_doing((a + b) / 2)].append(b - a)
        idle = sorted(((f"{name} ({len(g)} gaps, longest {max(g):.6g} s)", sum(g))
                       for name, g in gaps.items()), key=lambda kv: -kv[1])
        return {"device_ops": [[k, v] for k, v in
                               sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]],
                "idle_gaps": [[k, v] for k, v in idle[:TOP]]}

    def _host_doing(self, t: float) -> str:
        """The innermost harness span around host time ``t``."""
        best = None
        for name, a, b in self.spans:
            if a <= t <= b and (best is None or b - a < best[1]):
                best = (name, b - a)
        return best[0] if best else "outside the harness's spans"


def reduce_events(events, images: int, device_type_cuda, device_type_cpu) -> Optional[Trace]:
    """A ``Trace`` of a profiler's ``events()``; None where a card kept no
    spin kernel (the record is then not counted)."""
    # the harness's and the port's spans also appear as device-side ranges:
    # not operations
    dev_events = [e for e in events if e.device_type == device_type_cuda
                  and not e.name.startswith(("bench.", "musica."))]
    host = [e for e in events if e.device_type == device_type_cpu
            and e.name.startswith("bench.")]
    window = [e for e in host if e.name == "bench.window"]
    if not window:
        return None
    w0, w1 = window[0].time_range.start / 1e6, window[0].time_range.end / 1e6
    program = []
    for e in events:
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.name.startswith("musica.") and a < w1 and b > w0:
            card = e.device_index if e.device_type == device_type_cuda else -1
            program.append((e.name, max(a, w0), min(b, w1), card, e.thread, e.id))
    by_dev: Dict[int, list] = collections.defaultdict(list)
    for e in dev_events:
        by_dev[e.device_index].append(e)
    trace = Trace(images=images, window_s=w1 - w0, devices=sorted(by_dev), window=(w0, w1),
                  spans=[(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
                         for e in host], program=program)
    for dev, evs in by_dev.items():
        spins = [e.time_range.end for e in evs if "spin_kernel" in e.name]
        if not spins:
            return None
        last_spin = max(spins)
        for e in evs:
            if e.time_range.start < last_spin or "spin_kernel" in e.name:
                continue
            a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
            if e.name.startswith(("Memcpy", "Memset")):
                trace.copies.append((e.name, a, b, dev))
            else:
                trace.kernels.append((label(e.name), a, b, dev))
    return trace
