"""repro_torch.serve — token serving (``repro/serve``).

:class:`ServeEngine` (:mod:`repro_torch.serve.engine`) is slot-based token
serving over the LM decode step.  The JAX package's PlanServer (plan
solving) is not carried yet (ROADMAP.md, Queue 1, item 8).
"""
from .. import not_ported

_ENGINE = ("Request", "ServeEngine")
_PLAN = ("PlanServer", "PlanHandle", "PlanCache", "fingerprint",
         "fingerprint_distance")

__all__ = list(_ENGINE)


def __getattr__(name):
    if name in _ENGINE:
        from . import engine
        return getattr(engine, name)
    if name in _PLAN:
        raise not_ported(f"{name} (plan serving)", 8)
    raise AttributeError(
        f"module 'repro_torch.serve' has no attribute {name!r}")
