"""Service policy for the solver server, as pure host-side state (a
port of ``repro.remote.policy``, behaviour for behaviour).

Everything here is transport-independent and clock-injected so the
policy tests exercise it without a server (or real time):

* :class:`TokenBucket`     — the admission-rate limiter.  Deterministic:
  refill is a pure function of elapsed time, no background thread.
* :class:`TenantQuota`     — the per-tenant policy knobs (max in-flight
  tickets + token-bucket rate/burst).
* :class:`QuotaPolicy`     — quota state over tenants: ``admit`` either
  reserves capacity or raises the typed :class:`QuotaExceeded` (reason
  ``"in_flight"`` or ``"rate"``); ``release`` returns it.  Rejections
  are counted per tenant/reason — the server's ``/stats`` surface.
* :class:`SLOClass` / :func:`resolve_slo` — the service classes mapped
  onto the serve engines' native scheduling vocabulary: ``priority``
  feeds the admission heap's priority policy, ``deadline_s`` becomes an
  absolute deadline the engine's ``expire_overdue`` sweep enforces
  (``status="timeout"`` through the normal eviction path).

:class:`QuotaExceeded` derives from
:class:`~repro_torch.client.errors.ClientError` so remote-backend callers
catch it at the same session boundary as every other client failure.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.client.errors import ClientError


class QuotaExceeded(ClientError):
    """A tenant exceeded its admission quota (typed 429).

    ``reason`` is machine-readable: ``"in_flight"`` (too many tickets
    outstanding — retry after results are consumed) or ``"rate"``
    (token bucket empty — retry after ``1/rate`` seconds).
    """

    def __init__(self, tenant: str, reason: str, message: str):
        super().__init__(message)
        self.tenant = tenant
        self.reason = reason


# ------------------------------------------------------------------ #
# Rate limiting                                                      #
# ------------------------------------------------------------------ #
class TokenBucket:
    """Deterministic token bucket: ``rate`` tokens/second, capacity
    ``burst``.  Starts full; time is always injected."""

    def __init__(self, rate: float, burst: float):
        if rate <= 0 or burst <= 0:
            raise ValueError("rate and burst must be positive")
        self.rate = float(rate)
        self.burst = float(burst)
        self.tokens = float(burst)
        self._t: float | None = None    # last refill time

    def refill(self, now: float) -> None:
        if self._t is None:
            self._t = now
            return
        if now > self._t:
            self.tokens = min(self.burst,
                              self.tokens + (now - self._t) * self.rate)
        # A clock that moves backwards neither refills nor drains.
        self._t = max(self._t, now)

    def try_take(self, now: float, n: float = 1.0) -> bool:
        self.refill(now)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


# ------------------------------------------------------------------ #
# Quotas                                                             #
# ------------------------------------------------------------------ #
@dataclass(frozen=True)
class TenantQuota:
    """Per-tenant admission limits (immutable policy, mutable state
    lives in :class:`QuotaPolicy`)."""
    max_in_flight: int = 8          # tickets submitted but not completed
    rate: float = 50.0              # admissions per second
    burst: float = 50.0             # token-bucket capacity


class _TenantState:
    def __init__(self, quota: TenantQuota):
        self.quota = quota
        self.bucket = TokenBucket(quota.rate, quota.burst)
        self.in_flight = 0
        self.admitted = 0
        self.rejected = {"in_flight": 0, "rate": 0}


class QuotaPolicy:
    """Admission control over tenants.

    ``admit(tenant, now)`` reserves one in-flight slot and one rate
    token, or raises :class:`QuotaExceeded` without reserving anything
    (rejection is atomic: the in-flight check runs before the bucket is
    drained, so a rejected request costs no tokens).  ``release`` must
    be called exactly once per admitted ticket when it completes.
    """

    def __init__(self, default: TenantQuota | None = None,
                 per_tenant: dict[str, TenantQuota] | None = None):
        self.default = default or TenantQuota()
        self.per_tenant = dict(per_tenant or {})
        self._tenants: dict[str, _TenantState] = {}

    def _state(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            st = self._tenants[tenant] = _TenantState(
                self.per_tenant.get(tenant, self.default))
        return st

    def admit(self, tenant: str, now: float) -> None:
        st = self._state(tenant)
        if st.in_flight >= st.quota.max_in_flight:
            st.rejected["in_flight"] += 1
            raise QuotaExceeded(
                tenant, "in_flight",
                f"tenant {tenant!r} has {st.in_flight} tickets in "
                f"flight (quota {st.quota.max_in_flight}); consume "
                "results before submitting more")
        if not st.bucket.try_take(now):
            st.rejected["rate"] += 1
            raise QuotaExceeded(
                tenant, "rate",
                f"tenant {tenant!r} exceeded its admission rate "
                f"({st.quota.rate}/s, burst {st.quota.burst}); retry "
                f"after {1.0 / st.quota.rate:.3g}s")
        st.in_flight += 1
        st.admitted += 1

    def release(self, tenant: str, n: int = 1) -> None:
        st = self._state(tenant)
        st.in_flight = max(0, st.in_flight - int(n))

    def stats(self) -> dict:
        """Per-tenant counters for the server's ``/stats`` endpoint."""
        return {t: {"in_flight": st.in_flight,
                    "admitted": st.admitted,
                    "rejected": dict(st.rejected),
                    "quota": {"max_in_flight": st.quota.max_in_flight,
                              "rate": st.quota.rate,
                              "burst": st.quota.burst}}
                for t, st in sorted(self._tenants.items())}


# ------------------------------------------------------------------ #
# SLO classes                                                        #
# ------------------------------------------------------------------ #
@dataclass(frozen=True)
class SLOClass:
    """A service class in the serve engines' scheduling vocabulary."""
    name: str
    priority: int                   # higher = admitted first
    deadline_s: float | None        # budget from admission; None = none
    doc: str = ""


#: The service classes the server offers.  Priorities only order
#: requests relative to each other under the "priority" queue policy;
#: deadlines are enforced unconditionally by the per-tick
#: ``expire_overdue`` sweep.
SLO_CLASSES: dict[str, SLOClass] = {
    c.name: c for c in (
        SLOClass("interactive", priority=10, deadline_s=10.0,
                 doc="latency-sensitive; tight deadline"),
        SLOClass("standard", priority=5, deadline_s=120.0,
                 doc="the default class"),
        SLOClass("batch", priority=0, deadline_s=None,
                 doc="throughput work; never expired"),
    )
}


def resolve_slo(name: str, now: float,
                deadline_s: float | None = None
                ) -> tuple[int, float | None]:
    """``(priority, absolute deadline)`` of one admission at time
    ``now``.  ``deadline_s`` overrides the class budget (tests and
    impatient tenants); the class must exist — unknown names are a
    caller error, not a silent default."""
    try:
        cls = SLO_CLASSES[name]
    except KeyError:
        raise ValueError(
            f"unknown SLO class {name!r}; available: "
            f"{tuple(sorted(SLO_CLASSES))}") from None
    budget = cls.deadline_s if deadline_s is None else float(deadline_s)
    return cls.priority, None if budget is None else now + budget


def deadline_order(entries) -> list:
    """Sort ``(name, deadline)`` pairs the way the admission heap's
    "deadline" policy serves them: earliest deadline first, ``None``
    (no deadline) last, ties stable.  Pure — the policy tests pin the
    SLO-class ordering against this."""
    indexed = list(enumerate(entries))
    return [e for _, e in sorted(
        indexed,
        key=lambda t: (t[1][1] is None,
                       t[1][1] if t[1][1] is not None else 0.0,
                       t[0]))]
