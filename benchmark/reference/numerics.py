"""The precision a reference computation runs in.

A configuration states two precisions: ``float64`` for the parts it
computes in double (the Haar cascade's integrals, norms and stage sums)
and ``float32`` for the rest, with TF32 off.  The reference runs both in
float64.  The control runs each one step lower: float64 parts in
float32, float32 parts in TF32, emulated exactly: both operands of every
product are rounded to TF32 (10 mantissa bits, nearest, ties away from
zero, as ``cvt.rna.tf32.f32``) and the products are summed in float32,
which is what a TF32 tensor core does whatever algorithm the library
picks."""

from __future__ import annotations

import dataclasses

import torch


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32, kept as float32."""
    bits = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    return torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32).view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Arith:
    """``low`` False: the reference; True: the control."""

    low: bool = False

    @staticmethod
    def control() -> "Arith":
        return Arith(True)

    @property
    def single(self) -> torch.dtype:
        """The type of the parts the configuration states as float32."""
        return torch.float32 if self.low else torch.float64

    @property
    def double(self) -> torch.dtype:
        """The type of the parts the configuration states as float64."""
        return torch.float32 if self.low else torch.float64

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as an operand of a product of a float32 part."""
        return tf32_round(x) if self.low else x.to(torch.float64)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` of a float32 part, in full float32 or float64 sums."""
        with no_tf32():
            return self.operand(a) @ self.operand(b)


class no_tf32:
    """Both TF32 switches off inside the block, restored after it, so that
    a float32 product sums exact products of its (rounded) operands."""

    def __enter__(self):
        self.before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.before
