"""A kernel's short identity from its demangled name: a copy of the port's
``scripts/profile_torch.py::label`` (the kernel and its template arguments:
vector width, functor or lambda with its types; no ``void``, argument list,
namespaces or iterator plumbing; never cut).

``void at::native::vectorized_elementwise_kernel<4,
at::native::CUDAFunctor_add<double>, std::array<char*, 3ul> >(int, ...)``
gives ``vectorized_elementwise_kernel<4, CUDAFunctor_add<double>>``.
"""

from __future__ import annotations

import re

_PLUMBING = (r"array<char\*, \d+ul>", r"(Trivial)?OffsetCalculator<[^<>]*>",
             r"LoadWithoutCast", r"StoreWithoutCast")


def _strip_call(name: str) -> str:
    """``name`` without its trailing argument list."""
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i]
    return name


def label(name: str) -> str:
    s = _strip_call(name.removeprefix("void "))
    s = s.replace("::operator()() const", "").replace("(anonymous namespace)::", "")
    while ")::" in s:  # a lambda's enclosing function's parameters
        end = s.index(")::")
        s = _strip_call(s[:end + 1]) + s[end + 1:]
    s = re.sub(r"::\{lambda\(\)#\d+\}", "", s)
    s = re.sub(r"::\{lambda\(([^()]*)\)#\d+\}", r" lambda(\1)", s)
    s = re.sub(r"\b[A-Za-z_]\w*::", "", s)
    for p in _PLUMBING:
        s = re.sub(rf",\s*{p}", "", s)
    return re.sub(r">\s+>", ">>", re.sub(r">\s+>", ">>", s)).strip()
