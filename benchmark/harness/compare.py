"""The comparison that decides ``correct``: the outputs that the window's
requests returned, for a sample of the requests drawn from the seed,
against the outputs that the entry's ``expected`` has the plain reference
(``benchmark/reference/musica_plain.py``) compute again from the same raw
images (``harness/entries.py``).

Numbers compared, each the worst over the sampled images, named by the key
that the entry gives each product (``u8`` for the uint8 image, ``clahe``
for the float32 CLAHE image):

* ``<key>_diff_share``: the share of the product's pixels that differ from
  the reference's (a float pixel differs unless both are equal or both
  NaN);
* ``<key>_max_diff``: the largest |difference| of a pixel (of a float
  product, over pixels finite on both sides);
* ``missing``: outputs of a sampled image with the wrong shape or type.

A uint8 product is compared by ``u8_numbers``, any other by
``float_numbers``.  Each number has its limit in
``benchmark/limits/<cell>.json``.
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


def compare(items: Iterable[tuple], expected: Callable[[tuple], Iterable[Dict[str, torch.Tensor]]],
            keys: Dict[str, str], dev: torch.device) -> Dict[str, float]:
    """The numbers over the sampled requests ``items`` (``traffic.Done``,
    one output per product in the order of ``keys``, {product: key}):
    ``expected(item)`` gives the reference's outputs of each image of the
    request, a dict by product."""
    nums: Dict[str, float] = {}
    missing = 0
    for item in items:
        for i, want in enumerate(expected(item)):
            for (name, key), out in zip(keys.items(), item.outputs):
                ref = want[name]
                got = _as_tensor(out[i], dev) if len(out) == item.count else None
                if got is None or tuple(got.shape) != tuple(ref.shape) or got.dtype != ref.dtype:
                    missing += 1
                    continue
                numbers = u8_numbers if ref.dtype == torch.uint8 else float_numbers
                for k, v in zip((f"{key}_diff_share", f"{key}_max_diff"), numbers(got, ref)):
                    nums[k] = max(nums.get(k, v), v)
    for key in keys.values():  # nothing compared: the run is not correct anyway
        nums.setdefault(f"{key}_diff_share", 0.0)
        nums.setdefault(f"{key}_max_diff", 0)
    nums["missing"] = missing
    return nums


def judge(nums: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{number: {"value", "limit", "ok"}} for each number compared."""
    out = {}
    for name, value in nums.items():
        if name not in limits:
            raise KeyError(f"no limit for the compared number {name!r}")
        out[name] = {"value": value, "limit": limits[name], "ok": value <= limits[name]}
    return out
