"""FV — a thin operator wrapper over (L, ...) limbs-leading Montgomery Fr
tensors so protocol formulas read like the scalar spec
(`protocol/widgets.py`). Port of `zprize_tpu/fields/frvec.py`.

A constant (`FV.const`, `FV.one`) holds a plain int and becomes a (L,)
tensor on the device of the tensor it meets; two constants combine as
ints."""

import torch

from ..params import R_MOD
from . import mont
from .mont import FR

M = R_MOD
_SCALARS = {}


def _scalar(x, device):
    key = (x, str(device))
    t = _SCALARS.get(key)
    if t is None:
        if len(_SCALARS) > 4096:
            _SCALARS.clear()
        t = FR.scalar(x, device)
        _SCALARS[key] = t
    return t


class FV:
    __slots__ = ("v",)

    def __init__(self, v):
        self.v = v

    @staticmethod
    def const(x: int):
        return FV(int(x) % M)

    @staticmethod
    def one():
        return FV(1)

    def _bin(self, o, op, intop):
        a, b = self.v, o.v
        if isinstance(a, int) and isinstance(b, int):
            return FV(intop(a, b) % M)
        dev = (a if isinstance(a, torch.Tensor) else b).device
        if isinstance(a, int):
            a = _scalar(a, dev)
        if isinstance(b, int):
            b = _scalar(b, dev)
        return FV(op(FR, a, b))

    def __add__(self, o):
        return self._bin(o, mont.add, lambda x, y: x + y)

    def __sub__(self, o):
        return self._bin(o, mont.sub, lambda x, y: x - y)

    def __mul__(self, o):
        return self._bin(o, mont.mont_mul, lambda x, y: x * y)

    def __neg__(self):
        if isinstance(self.v, int):
            return FV(-self.v % M)
        return FV(mont.neg(FR, self.v))

    def sqr(self):
        return self * self

    def pow5(self):
        s4 = self.sqr().sqr()
        return s4 * self

    def scale(self, k: int):
        """multiply by a small integer constant"""
        return self * FV.const(k)

    def roll(self, k):
        return FV(torch.roll(self.v, -k, dims=1))

    @property
    def shape(self):
        return self.v.shape[1:]
