"""The benchmark's initializer: every parameter made from the seed.

The layout (each leaf's path, shape and dtype) is the port's; the values
are the benchmark's own.  A configuration's ``init`` rules map a leaf's
path (the first regular expression that matches it) to a constant
(``const``), a normal draw of a fixed deviation (``normal``) or a normal
draw scaled by 1/sqrt(fan-in) (``fan_in``, the fan-in the product of the
listed dims); draws are clamped at 3 deviations.  The random leaves are
drawn as one stream of standard normals, in ``CHUNK`` values a call, from
one ``torch.Generator`` on the device: a few large calls, and the same
values on every device of one kind for one seed.  ``diff_sq`` draws the
stream again to measure how far each leaf has moved from it, without a
second copy of the weights.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Iterator, List, Sequence, Tuple

import torch

CHUNK = 1 << 26

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class Leaf:
    path: str
    shape: Tuple[int, ...]
    dtype: str
    kind: str          # "const" or "random"
    value: float       # the constant, or the deviation of the draw

    @property
    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def torch_dtype(self) -> torch.dtype:
        return DTYPES[self.dtype]


def table(leaves: Sequence[Tuple[str, Sequence[int], str]],
          rules: Sequence[Sequence]) -> List[Leaf]:
    """Each (path, shape, dtype) with its rule applied."""
    out = []
    for path, shape, dtype in leaves:
        shape = tuple(int(s) for s in shape)
        for pattern, kind, arg in rules:
            if re.search(pattern, path):
                break
        else:
            raise ValueError(f"no init rule matches {path}")
        if kind == "const":
            out.append(Leaf(path, shape, dtype, "const", float(arg)))
        elif kind == "normal":
            out.append(Leaf(path, shape, dtype, "random", float(arg)))
        elif kind == "fan_in":
            fan = math.prod(shape[d] for d in arg)
            out.append(Leaf(path, shape, dtype, "random",
                            1.0 / math.sqrt(fan)))
        else:
            raise ValueError(f"unknown init kind {kind!r} for {path}")
    return out


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def _pieces(seed: int, leaves: Sequence[Leaf], device
            ) -> Iterator[Tuple[int, int, int, torch.Tensor]]:
    """(leaf index, lo, hi, f32 values of [lo, hi) of the leaf's flat
    view), over the random leaves in order."""
    gen = generator(seed, device)
    rand = [(i, leaf) for i, leaf in enumerate(leaves)
            if leaf.kind == "random"]
    total = sum(leaf.numel for _, leaf in rand)
    at_leaf, at_val = 0, 0
    for start in range(0, total, CHUNK):
        n = min(CHUNK, total - start)
        vals = torch.randn(n, generator=gen, device=device,
                           dtype=torch.float32).clamp_(-3.0, 3.0)
        used = 0
        while used < n:
            i, leaf = rand[at_leaf]
            take = min(n - used, leaf.numel - at_val)
            yield i, at_val, at_val + take, \
                vals[used:used + take].mul_(leaf.value)
            used += take
            at_val += take
            if at_val == leaf.numel:
                at_leaf, at_val = at_leaf + 1, 0


def make(seed: int, leaves: Sequence[Leaf], device) -> Dict[str, torch.Tensor]:
    """Every leaf, by path, on ``device``."""
    out = {}
    for leaf in leaves:
        if leaf.kind == "const":
            out[leaf.path] = torch.full(leaf.shape, leaf.value,
                                        dtype=leaf.torch_dtype, device=device)
        else:
            out[leaf.path] = torch.empty(leaf.shape, dtype=leaf.torch_dtype,
                                         device=device)
    with torch.no_grad():
        for i, lo, hi, vals in _pieces(seed, leaves, device):
            out[leaves[i].path].view(-1)[lo:hi] = vals
    return out


def diff_sq(seed: int, leaves: Sequence[Leaf],
            current: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Per leaf, sum((current - initial)^2) in f64, the initial values
    drawn again from the seed (as ``make`` drew them, in their dtype):
    a tensor on the leaves' device, one entry a leaf in order."""
    device = next(iter(current.values())).device
    out = torch.zeros(len(leaves), dtype=torch.float64, device=device)
    with torch.no_grad():
        for i, leaf in enumerate(leaves):
            if leaf.kind == "const":
                d = current[leaf.path].double() - leaf.value
                out[i] = d.square().sum()
        for i, lo, hi, vals in _pieces(seed, leaves, device):
            cur = current[leaves[i].path].reshape(-1)[lo:hi].double()
            init = vals.to(leaves[i].torch_dtype).double()
            out[i] += (cur - init).square().sum()
    return out


def tree_paths(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, leaf) of a nested dict / list tree, in the order of
    ``repro_torch.core.tree.param_leaves`` (dicts in insertion order)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_paths(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def fill_tree(tree, values: Dict[str, torch.Tensor], prefix: str = ""):
    """A tree shaped like ``tree`` (a nest of dicts and lists) whose
    leaves are ``values`` by path."""
    if isinstance(tree, dict):
        return {k: fill_tree(v, values, f"{prefix}/{k}")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [fill_tree(v, values, f"{prefix}/{i}")
                for i, v in enumerate(tree)]
    return values[prefix]
