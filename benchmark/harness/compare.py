"""The comparison that decides ``correct``: the outputs that the window's
requests returned, for a sample of the requests drawn from the seed,
against the plain reference (``benchmark/reference/musica_plain.py``)
computed again from the same raw images.

Numbers compared, each the worst over the sampled images:

* ``u8_diff_share``: the share of the output's uint8 pixels that differ
  from the reference's;
* ``u8_max_diff``: the largest |difference| of a uint8 pixel;
* ``clahe_diff_share``, ``clahe_max_diff`` (with CLAHE on): the same for
  the float32 CLAHE image (a pixel differs unless both are equal or both
  NaN; the largest |difference| over pixels finite on both sides);
* ``missing``: sampled requests whose outputs have the wrong shape or type.

Each has its limit in ``benchmark/limits/<cell>.json``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable

import numpy as np
import torch


def _as_tensor(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(dev)


def u8_numbers(got: torch.Tensor, want: torch.Tensor):
    d = (got.to(torch.int16) - want.to(torch.int16)).abs()
    return float((d != 0).double().mean()), int(d.max())


def float_numbers(got: torch.Tensor, want: torch.Tensor):
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    finite = torch.isfinite(got) & torch.isfinite(want)
    d = torch.where(finite, (got.double() - want.double()).abs(), 0.0)
    return float((~same).double().mean()), float(d.max())


def compare(items: Iterable[tuple], raw: Callable[[int], torch.Tensor],
            reference: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
            names: tuple, dev: torch.device) -> Dict[str, float]:
    """The numbers over the sampled requests ``items`` ((start, count,
    outputs) with one output per name of ``names``): ``raw(i)`` is pool
    image i on ``dev``, ``reference(img)`` the reference's outputs."""
    nums = {"u8_diff_share": 0.0, "u8_max_diff": 0, "missing": 0}
    if "clahe_graded" in names:
        nums.update(clahe_diff_share=0.0, clahe_max_diff=0.0)
    for start, count, outs in items:
        for i in range(count):
            want = reference(raw(start + i))
            for name, out in zip(names, outs):
                got = _as_tensor(out[i], dev) if len(out) == count else None
                if got is None or tuple(got.shape) != tuple(want[name].shape) \
                        or got.dtype != want[name].dtype:
                    nums["missing"] += 1
                    continue
                if name == "out_u8":
                    share, dmax = u8_numbers(got, want[name])
                    key = "u8"
                else:
                    share, dmax = float_numbers(got, want[name])
                    key = "clahe"
                nums[f"{key}_diff_share"] = max(nums[f"{key}_diff_share"], share)
                nums[f"{key}_max_diff"] = max(nums[f"{key}_max_diff"], dmax)
    return nums


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{number: {"value", "limit", "ok"}} for each number compared."""
    out = {}
    for name, value in nums.items():
        if name not in limits:
            raise KeyError(f"no limit for the compared number {name!r}")
        out[name] = {"value": value, "limit": limits[name], "ok": value <= limits[name]}
    return out
