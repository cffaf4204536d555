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
"""

from __future__ import annotations

import collections
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .labels import label

PAD_KERNELS = 64
ATTEMPTS = 3
TOP = 10  # entries of each breakdown list


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

    def _merged(self, dev: int) -> List[Tuple[float, float]]:
        iv = sorted((a, b) for _, a, b, d in self.kernels + self.copies if d == dev)
        out: List[List[float]] = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

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
        w0, w1 = self.window
        for dev in self.devices:
            edge = w0
            for a, b in self._merged(dev) + [(w1, w1)]:
                if a > edge:
                    gaps[self._host_doing((edge + a) / 2)].append(a - edge)
                edge = max(edge, b)
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
    # the harness's spans also appear as device-side ranges: not operations
    dev_events = [e for e in events if e.device_type == device_type_cuda
                  and not e.name.startswith(("bench.", "musica."))]
    host = [e for e in events if e.device_type == device_type_cpu
            and e.name.startswith("bench.")]
    window = [e for e in host if e.name == "bench.window"]
    if not window:
        return None
    w0, w1 = window[0].time_range.start / 1e6, window[0].time_range.end / 1e6
    by_dev: Dict[int, list] = collections.defaultdict(list)
    for e in dev_events:
        by_dev[e.device_index].append(e)
    trace = Trace(images=images, window_s=w1 - w0, devices=sorted(by_dev), window=(w0, w1),
                  spans=[(e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
                         for e in host])
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
