"""``repro_torch.remote`` — the solver stack as a standalone network
service (a port of ``repro.remote``; the wire is the same, so either
package's client talks to either package's server).

* :mod:`repro_torch.remote.protocol` — the schema-versioned JSON wire
  format: base64 ndarray payloads, codecs for the four client spec kinds
  (solo/batch/path/cv) and their result contracts.
* :mod:`repro_torch.remote.policy`   — service policy as pure host
  state: per-tenant admission quotas (token-bucket rate + in-flight
  slots, typed :class:`QuotaExceeded` rejection) and the SLO classes
  that map onto the serve engines' ``(priority, deadline)`` admission.
* :mod:`repro_torch.remote.server`   — the asyncio front door
  (``python -m repro_torch.remote.server``): a minimal HTTP/JSON server
  wrapping a continuous backend on its ``--device``, with per-tick
  deadline expiry, graceful SIGTERM drain and a ``/snapshot`` endpoint
  ``repro_torch.obs.dashboard --follow`` renders live.
* :mod:`repro_torch.remote.backend`  — :class:`RemoteBackend`, registered
  as ``backend="remote"`` with :class:`~repro_torch.client.FlexaClient`
  (``ClientConfig.remote_url`` points at the server).

The names below are loaded on first access, so importing this package
imports none of its modules; the backend registers itself when
``ClientConfig.backend == "remote"`` is first used.
"""
import importlib

_EXPORTS = {
    "SCHEMA": "protocol", "ProtocolError": "protocol",
    "encode_array": "protocol", "decode_array": "protocol",
    "encode_item": "protocol", "decode_spec": "protocol",
    "encode_result": "protocol", "decode_result": "protocol",
    "QuotaExceeded": "policy", "QuotaPolicy": "policy",
    "TenantQuota": "policy", "TokenBucket": "policy",
    "SLOClass": "policy", "SLO_CLASSES": "policy",
    "resolve_slo": "policy",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
