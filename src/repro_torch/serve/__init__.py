"""repro_torch.serve — serving layers: token decoding and plan solving.

Two engines share the continuous-batching idea:

  * :class:`ServeEngine` (:mod:`repro_torch.serve.engine`) — slot-based
    token serving over the LM decode step;
  * :class:`PlanServer` (:mod:`repro_torch.serve.planserver`) —
    multi-tenant ``Scenario.optimize`` serving: signature micro-batching
    into the fused GIA solver on the card plus a warm-start plan cache.

Imports are lazy: ``PlanServer`` consumers never pull the LM model stack
and ``ServeEngine`` consumers never pull the optimizer.
"""
_ENGINE = ("Request", "ServeEngine")
_PLAN = ("PlanServer", "PlanHandle", "PlanCache", "fingerprint",
         "fingerprint_distance")

__all__ = list(_ENGINE + _PLAN)


def __getattr__(name):
    if name in _ENGINE:
        from . import engine
        return getattr(engine, name)
    if name in _PLAN:
        from . import planserver
        return getattr(planserver, name)
    raise AttributeError(
        f"module 'repro_torch.serve' has no attribute {name!r}")
