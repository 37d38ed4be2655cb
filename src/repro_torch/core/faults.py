"""Fault injection — the single-bit-flip adversary of ``repro/core/faults.py``.

Pick a state leaf weighted by element count (the execution-weighted
analogue of the paper's §5.1 methodology), flip one bit of one element at
a chosen step, and let the instrumented loop classify the outcome.  The
leaf catalog walks the tree in the reference's flatten order (dict keys
sorted), so a ``random.Random`` seeded alike names the same leaf, element
and bit in both packages.

The reference's ``flip_bit`` returned a new array; the port flips the bit
IN PLACE through an integer view of the tensor's storage, which is what an
upset in device memory does and what keeps in-place state (and the
pointers its kernels hold) stable.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Optional, Set, Tuple

import torch

from repro_torch.tree import flatten_with_path, leaf_key

#: bit width per dtype name, as the reference samples it
_WIDTH = {"float32": 32, "int32": 32, "uint32": 32, "bfloat16": 16,
          "float16": 16, "int16": 16, "int8": 8, "uint8": 8}
#: the integer view a flip goes through, by element size
_VIEW = {4: torch.int32, 2: torch.int16, 1: torch.uint8}


@dataclass(frozen=True)
class InjectionPlan:
    leaf: str          # leaf path key
    element: int       # flat element index
    bit: int           # bit position within the element's width
    step: int          # training step at which to inject
    target: str = "params"  # 'params' | 'opt' | 'iv'


def dtype_name(t: torch.Tensor) -> str:
    """numpy-style dtype name (``float32``, ``bfloat16``, ...)."""
    return str(t.dtype).replace("torch.", "")


def bit_width(t: torch.Tensor) -> int:
    """Bits a flip of ``t``'s dtype samples from, as the reference."""
    return _WIDTH.get(dtype_name(t), 32)


def _leaf_catalog(tree) -> List[Tuple[str, int, str]]:
    """[(key, size, dtype_name)] for every leaf, in flatten order."""
    return [(leaf_key(p), t.numel(), dtype_name(t))
            for p, t in flatten_with_path(tree)]


def sample_plan(rng: random.Random, state, max_step: int,
                target: str = "params",
                only: Optional[Set[str]] = None) -> InjectionPlan:
    """Size-weighted leaf choice; uniform element/bit/step — the paper's
    execution-weighted single-bit-flip model.  ``only`` restricts the
    choice to the leaves whose full state paths it names."""
    tree = state[target] if target in ("params", "opt", "iv") else state
    catalog = _leaf_catalog(tree)
    if only is not None:
        prefix = f"{target}/" if tree is not state else ""
        catalog = [c for c in catalog if prefix + c[0] in only]
        if not catalog:
            raise ValueError(f"no {target} leaf among {sorted(only)}")
    pick = rng.randrange(sum(size for _, size, _ in catalog))
    acc = 0
    for key, size, dtype in catalog:
        acc += size
        if pick < acc:
            return InjectionPlan(leaf=key, element=rng.randrange(size),
                                 bit=rng.randrange(_WIDTH.get(dtype, 32)),
                                 step=rng.randrange(max_step), target=target)
    raise AssertionError("unreachable")


def _signed_mask(bit: int, width: int) -> int:
    """1 << bit as a signed ``width``-bit value (wraps the sign bit)."""
    m = 1 << bit
    return m - (1 << width) if m >= 1 << (width - 1) else m


def flip_bit(t: torch.Tensor, element: int, bit: int) -> torch.Tensor:
    """Flip ``bit`` of flat element ``element`` of a contiguous tensor of
    a dtype the reference can flip (4-, 2- and 1-byte), in place; the bit
    is clamped to the element's width as in the reference.  Returns
    ``t``."""
    if dtype_name(t) not in _WIDTH or not t.is_contiguous():
        raise TypeError(f"flip_bit: contiguous float32/int32/uint32/bf16/"
                        f"f16/int16/int8/uint8 tensors only, got {t.dtype}")
    if not 0 <= element < t.numel():
        raise IndexError(f"flip_bit: element {element} of {t.numel()}")
    width = 8 * t.element_size()
    if not 0 <= bit < 32:
        raise ValueError(f"flip_bit: bit {bit} out of range")
    view = _VIEW[t.element_size()]
    words = t.view(-1).view(view)
    mask = _signed_mask(min(bit, width - 1), width) if width > 8 \
        else 1 << min(bit, 7)
    words[element:element + 1].bitwise_xor_(mask)
    return t


def inject(state, plan: InjectionPlan, shardings=None):
    """Apply the plan to a train state IN PLACE; returns ``state``.

    On a mesh ``state`` is this rank's blocks, ``shardings`` the state's
    ``LeafSharding`` tree and ``plan.element`` a global flat index (a
    plan sampled over the global shapes, ``sharding.global_struct``):
    every rank whose block holds the element flips its copy, so a flip of
    a replicated leaf lands on every shard, as an upset of the reference's
    global array does."""
    def pick(tree):
        tree = tree[plan.target] if plan.target in ("params", "opt", "iv") \
            else tree
        return {leaf_key(p): x for p, x in flatten_with_path(tree)}
    leaf = pick(state).get(plan.leaf)
    if leaf is None:
        raise KeyError(f"leaf not found: {plan.leaf}")
    element = plan.element
    if shardings is not None:
        element = pick(shardings)[plan.leaf].local_index(plan.element)
        if element is None:
            return state           # another rank's block
    flip_bit(leaf, element, plan.bit)
    return state
