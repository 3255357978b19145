"""Wire protocol of the solver service: schema-versioned JSON (a port of
``repro.remote.protocol`` with the wire unchanged, so a client of either
package talks to a server of either package).

One schema number (:data:`SCHEMA`) covers the whole request/response
surface; both ends reject messages whose schema they do not understand
(:class:`ProtocolError`) instead of mis-decoding them.  Arrays travel as
base64 little-endian payloads tagged with dtype + shape — JSON-safe,
byte-exact for float32 (no decimal round trip), and self-describing
enough that a non-Python client could speak the format.  A tensor is
copied to host memory before it is encoded.

The unit of work on the wire is the client's normalized
:class:`~repro_torch.client.specs.WorkItem` minus the local-only bits:
specs are encoded field by field per kind (solo/batch/path/cv), problems
as ``(family, data arrays, c, block_size)`` tuples the server rebuilds
on its device through the family registry
(:func:`repro_torch.problems.families.build_problem`).  Results come back
as the backend-independent client contracts (SoloResult / BatchResult /
PathResult / CVResult, host arrays as every backend gives them) with
``raw`` dropped (engine response objects do not cross process
boundaries) and ledgers preserved.
"""
from __future__ import annotations

import base64
import json

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device

#: Wire-format version.  Bump on any incompatible change to the
#: request or response encoding; additions of optional keys are
#: compatible.
SCHEMA = 1


class ProtocolError(ValueError):
    """A message is malformed or speaks an unknown schema version."""


def check_schema(d: dict, where: str = "message") -> None:
    got = d.get("schema")
    if got != SCHEMA:
        raise ProtocolError(
            f"{where}: schema {got!r} is not supported (this end speaks "
            f"schema {SCHEMA}); upgrade the older side")


def _host(a) -> np.ndarray:
    """``a`` as a host array (a tensor is copied off its device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# ------------------------------------------------------------------ #
# ndarray codec                                                      #
# ------------------------------------------------------------------ #
def encode_array(a) -> dict | None:
    """Tagged base64 payload of one array or tensor (``None`` passes
    through — optional fields stay optional on the wire)."""
    if a is None:
        return None
    a = np.ascontiguousarray(_host(a))
    # Little-endian on the wire whatever the host byte order.
    le = a.astype(a.dtype.newbyteorder("<"), copy=False)
    return {"__nd__": 1, "dtype": str(a.dtype),
            "shape": list(a.shape),
            "b64": base64.b64encode(le.tobytes()).decode("ascii")}


def decode_array(d) -> np.ndarray | None:
    """The host array of one payload (a writable copy of the bytes)."""
    if d is None:
        return None
    if not isinstance(d, dict) or d.get("__nd__") != 1:
        raise ProtocolError(f"not an encoded ndarray: {d!r}")
    dtype = np.dtype(d["dtype"]).newbyteorder("<")
    a = np.frombuffer(base64.b64decode(d["b64"]), dtype=dtype)
    return a.reshape(d["shape"]).astype(np.dtype(d["dtype"]))


# ------------------------------------------------------------------ #
# Problem codec                                                      #
# ------------------------------------------------------------------ #
def encode_problem(p) -> dict:
    """Family-registry encoding: the data arrays + the shape signature.

    Only registry families can cross the wire (an ad-hoc ``Problem``
    carries closures) — the serve backends enforce the same restriction,
    so the remote backend loses no capability the server could honor.
    """
    from repro_torch.problems.families import get_family, infer_family
    family = infer_family(p)
    keys = get_family(family).data_keys
    return {"family": family,
            "g_kind": p.g_kind,
            "block_size": int(p.block_size),
            "n": int(p.n),
            "c": float(p.g_weight),
            "data": {k: encode_array(_host(p.data[k]).astype(np.float32,
                                                             copy=False))
                     for k in keys}}


def decode_problem(d: dict, device=DEFAULT_DEVICE):
    """The family :class:`~repro_torch.problems.base.Problem` of one
    payload, its data on ``device``."""
    from repro_torch.problems.families import build_problem, get_family
    dev = resolve_device(device)
    keys = get_family(d["family"]).data_keys
    arrays = tuple(torch.from_numpy(decode_array(d["data"][k])).to(dev)
                   for k in keys)
    return build_problem(d["family"], arrays, float(d["c"]),
                         n=int(d["n"]), block_size=int(d["block_size"]),
                         g_kind=d["g_kind"])


# ------------------------------------------------------------------ #
# Spec codec (client -> server)                                      #
# ------------------------------------------------------------------ #
def encode_item(item) -> dict:
    """Encode one normalized :class:`WorkItem` for ``POST /v1/submit``.

    Inline-only spec features (record_history, lam_batch, custom score
    callables, ...) are rejected by the remote backend's ``validate``
    before this runs, so the codec only carries what a serve backend
    can execute.
    """
    spec, kind = item.spec, item.kind
    d: dict = {"schema": SCHEMA, "kind": kind}
    if kind == "solo":
        d["problem"] = encode_problem(spec.problem)
        d["x0"] = encode_array(spec.x0)
    elif kind == "batch":
        d["problems"] = [encode_problem(p) for p in item.problems]
        d["x0"] = encode_array(spec.x0)
        d["active"] = encode_array(spec.active)
    elif kind in ("path", "cv"):
        if kind == "path":
            d["problem"] = encode_problem(spec.problem)
        else:
            d["problems"] = [encode_problem(p) for p in item.problems]
            d["tol_coarse"] = spec.tol_coarse
            d["validation"] = (
                None if spec.validation is None else
                [[encode_array(_host(Av).astype(np.float32, copy=False)),
                  encode_array(_host(bv).astype(np.float32, copy=False))]
                 for Av, bv in spec.validation])
        d["lambdas"] = encode_array(
            None if spec.lambdas is None
            else _host(spec.lambdas).astype(np.float64))
        d["n_points"] = int(spec.n_points)
        d["lam_min_ratio"] = float(spec.lam_min_ratio)
        d["warm"] = bool(spec.warm)
        d["screen"] = bool(spec.screen)
        d["kkt_slack"] = float(spec.kkt_slack)
    else:
        raise ProtocolError(f"unknown work kind {kind!r}")
    return d


def decode_spec(d: dict, device=DEFAULT_DEVICE):
    """Server side: message dict -> the typed client spec it encodes,
    its problems on ``device`` (the server then runs the normal
    ``normalize`` + backend validation, so a hand-rolled message gets the
    same error taxonomy as a local client)."""
    from repro_torch.client.specs import (BatchSpec, CVSpec, PathSpec,
                                          SoloSpec)
    check_schema(d, "submit")
    kind = d.get("kind")
    if kind == "solo":
        return SoloSpec(problem=decode_problem(d["problem"], device),
                        x0=decode_array(d.get("x0")))
    if kind == "batch":
        return BatchSpec(problems=[decode_problem(p, device)
                                   for p in d["problems"]],
                         x0=decode_array(d.get("x0")),
                         active=decode_array(d.get("active")))
    if kind == "path":
        return PathSpec(problem=decode_problem(d["problem"], device),
                        lambdas=decode_array(d.get("lambdas")),
                        n_points=int(d["n_points"]),
                        lam_min_ratio=float(d["lam_min_ratio"]),
                        warm=bool(d["warm"]), screen=bool(d["screen"]),
                        kkt_slack=float(d["kkt_slack"]))
    if kind == "cv":
        val = d.get("validation")
        return CVSpec(problems=[decode_problem(p, device)
                                for p in d["problems"]],
                      lambdas=decode_array(d.get("lambdas")),
                      n_points=int(d["n_points"]),
                      lam_min_ratio=float(d["lam_min_ratio"]),
                      warm=bool(d["warm"]), screen=bool(d["screen"]),
                      kkt_slack=float(d["kkt_slack"]),
                      tol_coarse=d.get("tol_coarse"),
                      validation=None if val is None else
                      [(decode_array(Av), decode_array(bv))
                       for Av, bv in val])
    raise ProtocolError(f"unknown work kind {kind!r}")


# ------------------------------------------------------------------ #
# Result codec (server -> client)                                    #
# ------------------------------------------------------------------ #
def _enc_ledger(led):
    return None if led is None else led.as_dict()


def _dec_ledger(d):
    if d is None:
        return None
    from repro_torch.obs.ledger import CostLedger
    return CostLedger.from_dict(d)


def _enc_path(res) -> dict:
    return {
        "lambdas": encode_array(res.lambdas),
        "x": encode_array(res.x),
        "V": encode_array(res.V),
        "iters": encode_array(res.iters),
        "converged": encode_array(res.converged),
        "support": encode_array(res.support),
        "active_blocks": encode_array(res.active_blocks),
        "screened": [{"n_blocks": s.n_blocks,
                      "screened_out": s.screened_out,
                      "kkt_rounds": s.kkt_rounds}
                     for s in res.screened],
        "row_iters": int(res.row_iters),
        "device_flops": int(res.device_flops),
        "lam_max": float(res.lam_max),
        "meta": dict(res.meta),
        "ledger": _enc_ledger(res.ledger),
    }


def _dec_path(d: dict, backend: str):
    from repro_torch.path.driver import PathResult
    from repro_torch.path.screening import ScreenReport
    meta = dict(d.get("meta") or {})
    meta["backend"] = backend
    return PathResult(
        lambdas=decode_array(d["lambdas"]),
        x=decode_array(d["x"]),
        V=decode_array(d["V"]),
        iters=decode_array(d["iters"]),
        converged=decode_array(d["converged"]),
        support=decode_array(d["support"]),
        active_blocks=decode_array(d["active_blocks"]),
        screened=[ScreenReport(n_blocks=int(s["n_blocks"]),
                               screened_out=int(s["screened_out"]),
                               kkt_rounds=int(s["kkt_rounds"]))
                  for s in d["screened"]],
        row_iters=int(d["row_iters"]),
        device_flops=int(d["device_flops"]),
        lam_max=float(d["lam_max"]),
        meta=meta,
        ledger=_dec_ledger(d.get("ledger")))


def encode_result(kind: str, res) -> dict:
    """One completed result for ``GET /v1/result`` — ``raw`` engine
    objects are dropped (they are process-local), everything else of
    the client contract survives the round trip."""
    d: dict = {"schema": SCHEMA, "kind": kind}
    if kind == "solo":
        d["result"] = {"x": encode_array(res.x), "iters": int(res.iters),
                       "converged": bool(res.converged),
                       "stat": None if res.stat is None
                       else float(res.stat),
                       "status": res.status,
                       "ledger": _enc_ledger(res.ledger)}
    elif kind == "batch":
        d["result"] = {"x": encode_array(res.x),
                       "iters": encode_array(res.iters),
                       "converged": encode_array(res.converged),
                       "stat": encode_array(res.stat),
                       "status": list(res.status or []),
                       "ledger": _enc_ledger(res.ledger)}
    elif kind == "path":
        d["result"] = _enc_path(res)
    elif kind == "cv":
        d["result"] = {
            "folds": [_enc_path(f) for f in res.folds],
            "lambdas": encode_array(res.lambdas),
            "scores": encode_array(res.scores),
            "scores_mean": encode_array(res.scores_mean),
            "best_index": res.best_index,
            "best_lambda": res.best_lambda,
            "x_best": encode_array(res.x_best),
            "meta": dict(res.meta),
            "ledger": _enc_ledger(res.ledger),
        }
    else:
        raise ProtocolError(f"unknown work kind {kind!r}")
    return d


def decode_result(d: dict, backend: str = "remote"):
    """Client side: response dict -> the typed result contract, with
    ``backend`` stamped so equivalence tests and dashboards can tell
    where it executed."""
    from repro_torch.client.specs import BatchResult, CVResult, SoloResult
    check_schema(d, "result")
    kind, r = d.get("kind"), d["result"]
    if kind == "solo":
        return SoloResult(x=decode_array(r["x"]), iters=int(r["iters"]),
                          converged=bool(r["converged"]),
                          stat=None if r["stat"] is None
                          else float(r["stat"]),
                          backend=backend, raw=None,
                          ledger=_dec_ledger(r.get("ledger")),
                          status=r.get("status", "ok"))
    if kind == "batch":
        return BatchResult(x=decode_array(r["x"]),
                           iters=decode_array(r["iters"]),
                           converged=decode_array(r["converged"]),
                           stat=decode_array(r.get("stat")),
                           backend=backend, raw=None,
                           ledger=_dec_ledger(r.get("ledger")),
                           status=list(r.get("status") or []) or None)
    if kind == "path":
        return _dec_path(r, backend)
    if kind == "cv":
        meta = dict(r.get("meta") or {})
        return CVResult(
            folds=[_dec_path(f, backend) for f in r["folds"]],
            lambdas=decode_array(r["lambdas"]),
            backend=backend,
            scores=decode_array(r.get("scores")),
            scores_mean=decode_array(r.get("scores_mean")),
            best_index=r.get("best_index"),
            best_lambda=r.get("best_lambda"),
            x_best=decode_array(r.get("x_best")),
            meta=meta,
            ledger=_dec_ledger(r.get("ledger")))
    raise ProtocolError(f"unknown work kind {kind!r}")


def dumps(obj: dict) -> bytes:
    """JSON bytes with numpy and torch scalars coerced (snapshot payloads
    carry np.float64 percentiles, meta dicts may carry 0-d tensors)."""
    def default(o):
        if isinstance(o, torch.Tensor):
            o = o.detach().cpu()
            return o.item() if o.dim() == 0 else o.tolist()
        if isinstance(o, (np.integer,)):
            return int(o)
        if isinstance(o, (np.floating,)):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.bool_,)):
            return bool(o)
        raise TypeError(
            f"not JSON-serializable: {type(o).__name__}")
    return json.dumps(obj, default=default).encode("utf-8")


def loads(data: bytes) -> dict:
    try:
        obj = json.loads(data.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"malformed JSON body: {e}") from None
    if not isinstance(obj, dict):
        raise ProtocolError("message body must be a JSON object")
    return obj
