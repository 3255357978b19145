"""Stack-wide cost ledger: one accounting scheme for every engine.

A host copy of ``repro.obs.ledger``: every result of the port reports
the same keys as the reference, so the two packages' accounting can be
compared number for number.

Keys (all integers, all additive):

======================  ==================================================
``row_iters``           device row-iterations dispatched (incl. padding
                        and freeze — what the hardware actually executed)
``live_iters``          useful per-instance iterations (what the
                        requests actually needed)
``device_flops``        matvec currency: row_iters × m × program_width
``padding_iters``       rows burned on empty slots / padded clones
``freeze_iters``        rows burned stepping converged-but-held
                        instances (lockstep tails)
``compiles``            program signatures this work ran (the port builds
                        no compiled programs; on the λ-path, the distinct
                        (program width, solver config) pairs)
======================  ==================================================

Conservation: ``row_iters == live_iters + padding_iters + freeze_iters``
whenever the producer can attribute waste (engines that cannot split
freeze from padding fold the remainder into ``padding_iters``).
"""
from __future__ import annotations

from dataclasses import dataclass, fields

__all__ = ["LEDGER_KEYS", "CostLedger"]

#: Canonical key order — snapshot/JSON consumers rely on this set.
LEDGER_KEYS = ("row_iters", "live_iters", "device_flops",
               "padding_iters", "freeze_iters", "compiles")


@dataclass
class CostLedger:
    """Additive work accounting with identical keys across the stack."""

    row_iters: int = 0
    live_iters: int = 0
    device_flops: int = 0
    padding_iters: int = 0
    freeze_iters: int = 0
    compiles: int = 0

    def add(self, **kw: int) -> "CostLedger":
        """Accumulate in place; unknown keys are an error."""
        for k, v in kw.items():
            if k not in LEDGER_KEYS:
                raise KeyError(f"unknown ledger key {k!r}")
            setattr(self, k, getattr(self, k) + int(v))
        return self

    def merge(self, other: "CostLedger") -> "CostLedger":
        """Accumulate another ledger in place (Σ over engines/devices)."""
        for f in fields(self):
            setattr(self, f.name,
                    getattr(self, f.name) + getattr(other, f.name))
        return self

    def __add__(self, other: "CostLedger") -> "CostLedger":
        return CostLedger(*(getattr(self, f.name) + getattr(other, f.name)
                            for f in fields(self)))

    def copy(self) -> "CostLedger":
        return CostLedger(**{k: getattr(self, k) for k in LEDGER_KEYS})

    @property
    def waste_iters(self) -> int:
        return self.padding_iters + self.freeze_iters

    @property
    def utilization(self) -> float:
        """live / row fraction (1.0 when nothing was dispatched)."""
        return self.live_iters / self.row_iters if self.row_iters else 1.0

    def conserved(self) -> bool:
        """row == live + padding + freeze (the producer contract)."""
        return self.row_iters == (self.live_iters + self.padding_iters
                                  + self.freeze_iters)

    def as_dict(self) -> dict:
        """Canonical keys plus the derived utilization ratio."""
        d = {k: int(getattr(self, k)) for k in LEDGER_KEYS}
        d["utilization"] = round(self.utilization, 6)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CostLedger":
        return cls(**{k: int(d.get(k, 0)) for k in LEDGER_KEYS})
