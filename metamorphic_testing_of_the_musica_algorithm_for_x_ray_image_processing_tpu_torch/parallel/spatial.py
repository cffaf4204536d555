"""The spatial path: one image's rows split over the ``space`` entries of a
mesh row, the counterpart of what GSPMD derives for the JAX package's
``parallel/sharding.py`` at ``space > 1`` (``P("space", None)`` on the
image's rows: the 2-row halos of the 5x5 stencils and the all-reduces of
the histograms).

Here the schedule is written out.  ``RowPlan`` fixes each level's rows per
shard: level 0 split at multiples of the histogram tile (the gradation
histograms' tiles never straddle two shards; 300 over 4 gives
80/80/80/60), each finer level's boundaries halved while they stay even
and every shard keeps at least 2 rows.  The first level where that fails
is the replication level ``R``: the last sharded level's image is gathered
onto every entry, and from there on the coarse levels, the coarse end of
the expand and every small curve are computed whole, identically, on each
entry.  At 3072 over 4, levels 0-8 are sharded (768 rows to 3 rows).

Every sharded op is a row-window form of the whole-image op
(``ops.pyramid.*_rows``, ``ops.stats.img_sdev_rows``, the windowed noise,
relevance and nearest-upsample ops): it computes exactly the rows it owns
from its own rows and its halo rows, with the mirror or zero boundary only
at the image's true first and last rows, in the same float64 tap order,
so the sharded result equals the unsharded one bit for bit.  The
pyramid's steps (``pyramid.smooth_downsample_rows``, ``upsample_subtract``,
``upsample_add`` on windows) go through KP1 and KP2 (``csrc/pyramid.cu``)
on a CUDA device, as in the unsharded path, and so does the analysis
levels' sdev (``fused_hist.sdevs_rows``, KS: every level's sdev rows of the
shard in one launch), the contrast stage (``contrast_apply.contrast_apply``,
KA: every level's curve, gain and noise reduction on the shard's rows in one
launch) and the tone map (``tonemap.tone_map``, KT: the shard's graded rows
and its rows of the crop).  The
histograms go through the kernels on row windows: K1 (``noise_hists_rows``)
on each shard's rows inside each analysis level's coverage (a shard with no
covered row launches nothing), or with ``fused_sdev`` K7
(``sdev_noise_hists_rows``: every analysis level's sdev rows of the shard,
from its band rows and the 2-row halos, and their histograms) once per
shard, then a sum of the int32 partials and one launch of K2
(``hist_argmax``) for the first-max bins of the image; K3 or K4 on each
shard's rows under the unsharded path's condition, then a sum of the
1,024-bin partials and the tone curve on every entry.  With
``cfg.enable_clahe`` each shard's joint CLAHE histogram at global tiles
goes through KH (the relevance test inside it, from the shard's CNR rows),
the partials are summed, every entry makes the tile LUTs (KC), and K5
blends each shard's reconstruction rows (``clahe_graded``).  A replicated analysis level is computed whole on
every entry and its histogram counted by the first alone.

Transport is plain tensor copies between entries (``Entry.send``): on the
sender's stream, the receiver's stream waiting for it; an entry on the same
device and another stream passes the tensor itself, marked as used by the
receiver's stream.  An all-reduce is a gather of the partials onto the
row's first entry, a sum there and a copy back.  The same code runs on CPU
entries (the tests).

``forward`` runs the schedule through a ``Transport``: which entry's device
and stream are current (``on``) and how a tensor reaches another entry
(``send``).  The default runs it eagerly, one thread driving a mesh row's
entries in turn; ``models/graphs.py::SpatialGraph`` passes one that captures
the same schedule into CUDA graphs, cut at the exchanges between devices.
Every op of the schedule runs inside ``on`` of an entry, so a capture sees
them all on the entries' streams.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..config import MusicaConfig
from ..models.musica import _band_dtype
from ..ops import clahe, gradation, noise, normalize, pyramid
from ..ops.cuda import clahe_apply, clahe_hist, contrast_apply, fused_hist, tonemap

OUTPUTS = ("out_u8", "graded", "recon", "cnr", "clahe_graded")


def check_outputs(cfg: MusicaConfig, outputs: Sequence[str]) -> None:
    """Raise for an output the spatial path does not give."""
    bad = set(outputs) - set(OUTPUTS)
    if bad:
        raise ValueError(f"outputs {sorted(bad)}: the spatial path gives {OUTPUTS}")
    if "clahe_graded" in outputs and not cfg.enable_clahe:
        raise ValueError("outputs ['clahe_graded']: the spatial path gives it only with "
                         "cfg.enable_clahe")


class Entry:
    """One ``space`` entry of a mesh row: a device and, on a CUDA device,
    the stream its work is issued on."""

    def __init__(self, device: torch.device, stream: Optional["torch.cuda.Stream"] = None):
        self.device = torch.device(device)
        self.stream = stream

    def __repr__(self):
        return f"Entry({self.device})"

    @contextlib.contextmanager
    def on(self):
        """This entry's device and stream current."""
        if self.stream is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            yield

    def send(self, t: torch.Tensor, dst: "Entry") -> torch.Tensor:
        """``t`` (made on this entry) for use on ``dst``."""
        if dst is self or self.stream is None and dst.stream is None:
            return t.to(dst.device)
        if self.device == dst.device:
            # the same memory: dst's stream waits for this entry's, and the
            # allocator keeps t's block until dst's stream has used it
            ev = torch.cuda.Event()
            ev.record(self.stream)
            dst.stream.wait_event(ev)
            t.record_stream(dst.stream)
            return t
        # a copy between devices on this entry's stream; PyTorch orders it
        # after the receiver's current stream and that stream after it
        with self.on(), (torch.cuda.stream(dst.stream) if dst.stream is not None
                         else contextlib.nullcontext()):
            return t.to(dst.device, non_blocking=True)


@dataclass(frozen=True)
class RowPlan:
    """The rows of each shard at each level, for an [n, n] image over
    ``space`` entries.

    ``sizes[k]``: level k's image size (``sizes[0] = n``, then ceil halves).
    ``bounds[k]``: for each sharded level k < ``replicated`` (R), the S + 1
    row boundaries of the shards; shard i holds rows [bounds[k][i],
    bounds[k][i + 1])."""
    n: int
    space: int
    sizes: Tuple[int, ...]
    bounds: Tuple[Tuple[int, ...], ...]

    @property
    def replicated(self) -> int:
        return len(self.bounds)

    def rows(self, k: int, i: int) -> Tuple[int, int]:
        return self.bounds[k][i], self.bounds[k][i + 1]


def row_plan(n: int, space: int, cfg: MusicaConfig) -> RowPlan:
    """Level 0 split at multiples of the histogram tile, ceil(n / space)
    rounded up to the tile a shard (the last takes the rest); each finer
    level sharded at half its parent's boundaries while those are even and
    every shard holds at least 2 rows, at most every pyramid level."""
    if space < 2:
        raise ValueError(f"space={space}: the spatial path splits over at least 2 entries")
    tile = cfg.histogram_area_size
    per = -(-(-(-n // space)) // tile) * tile
    b = tuple(min(n, i * per) for i in range(space)) + (n,)
    if any(b[i + 1] - b[i] < 2 for i in range(space)):
        raise ValueError(f"{n} rows do not split over {space} shards of whole {tile}-px "
                         f"tiles with at least 2 rows each ({list(b)})")
    sizes = [n]
    for _ in range(cfg.pyramid_levels):
        sizes.append(-(-sizes[-1] // 2))
    bounds = [b]
    while len(bounds) < cfg.pyramid_levels:
        prev, k = bounds[-1], len(bounds)
        if any(x % 2 for x in prev[1:-1]):
            break
        nxt = (0,) + tuple(x // 2 for x in prev[1:-1]) + (sizes[k],)
        if any(nxt[i + 1] - nxt[i] < 2 for i in range(space)):
            break
        bounds.append(nxt)
    return RowPlan(n, space, tuple(sizes), tuple(bounds))


class Transport:
    """How ``forward`` runs on a mesh row's entries: eagerly.  ``on(i)``
    makes entry i current; ``send(t, i, j)`` gives entry j the tensor ``t``
    made on entry i."""

    def __init__(self, entries: Sequence[Entry]):
        self.e = list(entries)

    def on(self, i: int):
        return self.e[i].on()

    def send(self, t: torch.Tensor, i: int, j: int) -> torch.Tensor:
        return self.e[i].send(t, self.e[j])


class _Row:
    """One image's run on one mesh row: the entries and the transport
    between them."""

    def __init__(self, entries: Sequence[Entry], plan: RowPlan, transport: Transport):
        self.e = list(entries)
        self.plan = plan
        self.S = len(self.e)
        self.t = transport

    def on(self, i: int):
        """Entry i's device and stream current."""
        return self.t.on(i)

    def each(self, fn) -> list:
        """``fn(i)`` on every entry, with that entry current."""
        out = []
        for i in range(self.S):
            with self.on(i):
                out.append(fn(i))
        return out

    def fetch(self, parts: List[torch.Tensor], k: int, lo: int, hi: int, dst: int) -> torch.Tensor:
        """Rows [lo, hi) of level k's sharded image (``parts[i]``: shard i's
        rows), on entry ``dst``: its own rows as they are, the others sent
        by the shards that hold them (the halo exchange)."""
        pieces = []
        for i in range(self.S):
            r0, r1 = self.plan.rows(k, i)
            a, b = max(lo, r0), min(hi, r1)
            if a < b:
                piece = parts[i].narrow(-2, a - r0, b - a)
                pieces.append(piece if i == dst else self.t.send(piece, i, dst))
        if len(pieces) == 1:
            return pieces[0]
        with self.on(dst):
            return torch.cat(pieces, dim=-2)

    def to_first(self, parts) -> list:
        """Each entry's tensor (None: nothing) sent to the first entry."""
        return [None if t is None else self.t.send(t, i, 0) for i, t in enumerate(parts)]

    def broadcast(self, t: torch.Tensor) -> list:
        """``t`` (on the first entry) for every entry."""
        return [t if i == 0 else self.t.send(t, 0, i) for i in range(self.S)]

    def all_reduce(self, parts, op) -> list:
        """``op`` over the entries' tensors (None: no part), on the first
        entry, then copied to every entry."""
        got = [t for t in self.to_first(parts) if t is not None]
        with self.on(0):
            total = op(got)
        return self.broadcast(total)

    def gather(self, parts, k: int = 0) -> torch.Tensor:
        """The whole of a level-k sharded image on the first entry."""
        return self.fetch(parts, k, 0, self.plan.sizes[k], 0)


def _sum_int32(parts, like_shape, dev):
    if not parts:
        return torch.zeros(like_shape, dtype=torch.int32, device=dev)
    return torch.stack(parts).sum(0, dtype=torch.int32)


def forward(img_u16, cfg: MusicaConfig, entries: Sequence[Entry],
            outputs: Sequence[str] = ("out_u8",), fused_sdev: bool = False,
            transport: Optional[Transport] = None) -> Dict[str, torch.Tensor]:
    """``musica_forward`` of one [n, n] integer image (on any device) with
    its rows split over ``entries``; returns the requested results
    (``OUTPUTS``; ``clahe_graded`` with ``cfg.enable_clahe``), each whole,
    on the first entry's device.  ``fused_sdev`` as in ``musica_forward``.
    Equal to ``musica_forward``'s bit for bit.  ``img_u16`` may instead be
    a list of each entry's level-0 rows (``row_plan(n, S, cfg).rows(0, i)``),
    contiguous on that entry's device, which the run reads in place (a
    graph's static input).  ``transport``: ``Transport(entries)`` when
    None."""
    check_outputs(cfg, outputs)
    n = cfg.image_size
    plan = row_plan(n, len(entries), cfg)
    if isinstance(img_u16, (list, tuple)):
        shapes = [tuple(t.shape) for t in img_u16]
        if shapes != [(b - a, n) for a, b in zip(plan.bounds[0], plan.bounds[0][1:])]:
            raise ValueError(f"row blocks {shapes} do not match the plan {list(plan.bounds[0])}")
    elif tuple(img_u16.shape) != (n, n):
        raise ValueError(f"image {tuple(img_u16.shape)} != cfg.image_size {n}")
    row = _Row(entries, plan, Transport(entries) if transport is None else transport)
    sd, L, R, S = _band_dtype(cfg), cfg.pyramid_levels, plan.replicated, len(entries)
    sizes, E = plan.sizes, row.e

    # ---- normalize: the extrema all-reduced over the shards -----------------
    if isinstance(img_u16, (list, tuple)):
        x = list(img_u16)
    else:
        x = row.each(lambda i: img_u16[slice(*plan.rows(0, i))].to(E[i].device).contiguous())
    ext = row.each(lambda i: normalize.extrema_partials(x[i]))
    ext = row.all_reduce(ext, lambda p: torch.stack([torch.cat(p)[:, 0].amax(),
                                                     torch.cat(p)[:, 1].amin()]))
    normalized = row.each(lambda i: normalize.normalize_from_u16(
        x[i], cfg.quirks, extrema=(ext[i][0], ext[i][1]))[0])

    # ---- reduce: sharded levels, then the coarse levels whole ----------------
    bandpass: List[list] = []  # bandpass[k][i]: shard i's rows (k < R), the whole (k >= R)
    cur = normalized
    for k in range(R):
        h = sizes[k]
        if k + 1 < R:
            def down(i, k=k, h=h, cur=cur):
                j0, j1 = plan.rows(k + 1, i)
                lo, hi = pyramid.needed_rows("smooth_downsample", h, j0, j1)
                return pyramid.smooth_downsample_rows(row.fetch(cur, k, lo, hi, i), lo, h, j0, j1)
            dn = row.each(down)

            def band(i, k=k, h=h, cur=cur, dn=dn):
                r0, r1 = plan.rows(k, i)
                lo, hi = pyramid.needed_rows("upsample_smooth", h, r0, r1)
                return pyramid.upsample_subtract(cur[i], row.fetch(dn, k + 1, lo, hi, i), lo,
                                                 r0).to(sd)
            bandpass.append(row.each(band))
            cur = dn
        else:
            whole = [row.fetch(cur, k, 0, h, i) for i in range(S)]
            dn = row.each(lambda i, whole=whole: pyramid.smooth_downsample(whole[i]))
            bandpass.append(row.each(lambda i, k=k, cur=cur, dn=dn: pyramid.upsample_subtract(
                cur[i], dn[i], 0, plan.rows(k, i)[0]).to(sd)))
            coarse = row.each(lambda i, dn=dn: pyramid.reduce_ladder(dn[i], L - R))
            for j in range(L - R):
                bandpass.append(row.each(lambda i, j=j: coarse[i][0][j].to(sd)))
            top = [c[1][-1] if L > R else d for c, d in zip(coarse, dn)]  # downs[L - 1]

    def sharded(k: int) -> bool:
        return k < R

    def rows_of(k: int, i: int) -> Tuple[int, int]:
        return plan.rows(k, i) if sharded(k) else (0, sizes[k])

    # ---- analysis: sdev on each shard's rows, K1 (or K7) partials, K2 on the sum
    levels = list(cfg.analysis_levels)
    bands = {k: row.each(lambda i, k=k: bandpass[k][i].float()) for k in levels}

    def band_window(k: int, i: int) -> Tuple[torch.Tensor, int]:
        """The band rows that level k's sdev rows on shard i read, and the
        first (a replicated level: the whole band)."""
        if not sharded(k):
            return bands[k][i], 0
        lo, hi = pyramid.needed_rows("img_sdev", sizes[k], *plan.rows(k, i))
        return row.fetch(bandpass[k], k, lo, hi, i).float(), lo

    sdevs = {}
    if fused_sdev:
        def k7(i):
            wins = [band_window(k, i) for k in levels]
            # a replicated level is counted by the first entry alone
            return fused_hist.sdev_noise_hists_rows(
                [w for w, _ in wins], [lo for _, lo in wins], [rows_of(k, i) for k in levels],
                cfg, [sharded(k) or i == 0 for k in levels])
        res = row.each(k7)
        for j, k in enumerate(levels):
            sdevs[k] = [r[0][j] for r in res]
        parts = [r[1] for r in res]
    else:
        def sdev(i):
            wins = [band_window(k, i) for k in levels]
            return fused_hist.sdevs_rows([w for w, _ in wins], [lo for _, lo in wins],
                                         [rows_of(k, i) for k in levels])
        res = row.each(sdev)
        for j, k in enumerate(levels):
            sdevs[k] = [r[j] for r in res]

        def partial(i):
            # a replicated level is scanned by the first entry alone
            wins = [sdevs[k][i] if sharded(k) or i == 0 else sdevs[k][i][:0] for k in levels]
            return fused_hist.noise_hists_rows(wins, [rows_of(k, i)[0] for k in levels], cfg)
        parts = row.each(partial)
    got = [t for t in row.to_first(parts) if t is not None]
    with row.on(0):
        hsum = _sum_int32(got, (len(levels), cfg.noise_histogram_bins), E[0].device)
        mb_first = fused_hist.hist_argmax(hsum)
    max_bins = row.broadcast(mb_first)
    max_bin = [{k: mb[j] for j, k in enumerate(levels)} for mb in max_bins]

    # ---- apply: CNR, then contrast and noise reduction (KA) on each shard ----
    c = cfg.cnr_level
    cnr = row.each(lambda i: noise.img_cnr(sdevs[c][i], max_bin[i][c], cfg))

    def cnr_window(i: int, k: int) -> Tuple[torch.Tensor, int]:
        """The CNR rows that level k's rows on shard i read, and the first."""
        r0, r1 = rows_of(k, i)
        lo, hi = noise.cnr_rows(sizes[c], sizes[k], r0, r1)
        if sharded(c):
            return row.fetch(cnr, c, lo, hi, i), lo
        return cnr[i], 0

    # every level's curve, gain and (below cnr_level - 1, the levels the
    # expand reads) noise reduction on the shard's rows, in one launch
    bands_in = row.each(lambda i: contrast_apply.contrast_apply(
        [bandpass[k][i] for k in range(L)], {k: sdevs[k][i] for k in levels}, max_bin[i],
        {k: cnr_window(i, k) for k in contrast_apply.nr_levels(cfg, False)}, cfg,
        [rows_of(k, i)[0] for k in range(L)])[0])

    # ---- expand: the coarse end whole, then down through the sharded levels --
    def band_of(k: int, i: int) -> torch.Tensor:
        """Level k's band on entry i, in its storage dtype (the expand reads
        it as float32)."""
        return bands_in[i][k]

    recon_w = row.each(lambda i: pyramid.expand_ladder(top[i], [band_of(k, i)
                                                                 for k in range(R, L)]))
    k = R - 1
    recon = row.each(lambda i: pyramid.upsample_add(recon_w[i], band_of(k, i), 0,
                                                    plan.rows(k, i)[0]))
    for k in range(R - 2, -1, -1):
        def up(i, k=k, finer=recon):
            r0, r1 = plan.rows(k, i)
            lo, hi = pyramid.needed_rows("upsample_smooth", sizes[k], r0, r1)
            return pyramid.upsample_add(row.fetch(finer, k + 1, lo, hi, i), band_of(k, i), lo, r0)
        recon = row.each(up)

    # ---- gradation: K3 or K4 per shard, the partials summed -------------------
    grad_input = (row.each(lambda i: recon[i] * recon[i]) if cfg.grad_with_linear_image
                  else recon)
    tile = cfg.histogram_area_size
    scale = int(math.ceil(n / sizes[c]))
    fused_relevance = tile % scale == 0 and n % tile == 0

    def relevance(i):
        win, w0 = cnr_window(i, 0)
        return noise.img_relevant(normalized[i], win, cfg, plan.rows(0, i)[0], w0)
    relevant = None if fused_relevance else row.each(relevance)

    def ghist(i):
        r0 = plan.rows(0, i)[0]
        if fused_relevance:
            win, w0 = cnr_window(i, 0)
            return fused_hist.grad_hist_relevant(grad_input[i], normalized[i], win, cfg, r0, w0)
        return fused_hist.grad_hist(grad_input[i], relevant[i], cfg, r0)
    ghists = row.all_reduce(row.each(ghist), lambda p: _sum_int32(
        p, (cfg.grad_histogram_bins,), E[0].device))
    gcurve = row.each(lambda i: gradation.gradation_curve(ghists[i], cfg))

    # ---- CLAHE: KH per shard, the partials summed, KC, K5 on each shard's rows
    # (it grades the reconstruction itself, never the squared image)
    if cfg.enable_clahe:
        t, cb = cfg.clahe_tiles, cfg.clahe_bins

        def chist(i):
            win, w0 = cnr_window(i, 0)
            return clahe_hist.clahe_hist(recon[i], normalized[i], win, cfg, plan.rows(0, i)[0], w0)
        chists = row.all_reduce(row.each(chist), lambda p: _sum_int32(p, (t, t, cb), E[0].device))
        luts = row.each(lambda i: clahe.clahe_curves(chists[i], cfg))
        clahe_graded = row.each(lambda i: clahe_apply.clahe_apply(
            recon[i], *luts[i], cfg, plan.rows(0, i)[0]))

    # ---- tone map, crop, gather ---------------------------------------------
    # each shard's graded rows and its rows of the crop, one KT launch
    tm = row.each(lambda i: tonemap.tone_map(grad_input[i], gcurve[i][0], gcurve[i][1],
                                             cfg.out_margin, plan.rows(0, i)[0]))
    graded = [g for g, _ in tm]
    out_parts = [o for _, o in tm]
    sharded_out = {"graded": (graded, 0), "recon": (recon, 0), "cnr": (cnr, c)}
    if cfg.enable_clahe:
        sharded_out["clahe_graded"] = (clahe_graded, 0)
    result = {}
    for name in outputs:
        if name == "out_u8":
            got = [t for t in row.to_first(out_parts) if t.shape[0]]
            with row.on(0):
                result[name] = torch.cat(got) if len(got) > 1 else got[0]
        elif name == "cnr" and not sharded(c):
            result[name] = cnr[0]
        else:
            result[name] = row.gather(*sharded_out[name])
    return result
