"""Fault tolerance: elastic pod membership, heartbeats and bounded
staleness (counterpart of ``repro.ft``).

``ElasticGossip``, ``HeartbeatMonitor`` and ``BoundedStalenessBuffer``
(``ft.elastic``) are ported. The fault plans of ``repro.ft.faults``
(``ChurnEvent``, ``ChurnPlan``, ``FaultPlan``, ``LinkFault``,
``StragglerSpec``, ``as_fault_plan``) are not: each name resolves to a
stand-in that raises ``NotImplementedError`` naming ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

_ELASTIC = ("ElasticGossip", "HeartbeatMonitor", "BoundedStalenessBuffer")
_FAULTS = (
    "ChurnEvent",
    "ChurnPlan",
    "FaultPlan",
    "LinkFault",
    "StragglerSpec",
    "as_fault_plan",
)

__all__ = list(_ELASTIC + _FAULTS)


def _not_ported(name: str):
    def raiser(*args, **kwargs):
        raise NotImplementedError(
            f"repro_torch.ft.{name}: the fault plans of repro.ft.faults are not "
            "ported (ROADMAP Queue 1 item 9)"
        )

    raiser.__name__ = name
    raiser.__doc__ = f"Not ported: {name} (ROADMAP Queue 1 item 9); calling it raises."
    return raiser


def __getattr__(name: str):
    """Resolve re-exports on first access (PEP 562)."""
    if name in _ELASTIC:
        from repro_torch.ft import elastic

        return getattr(elastic, name)
    if name in _FAULTS:
        return _not_ported(name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
