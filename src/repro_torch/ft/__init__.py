"""Fault tolerance: elastic membership, heartbeats and fault plans
(counterpart of ``repro.ft``).

``ElasticGossip``, ``HeartbeatMonitor`` and ``BoundedStalenessBuffer``
live in ``ft.elastic``; the fault plans (``ChurnEvent``, ``ChurnPlan``,
``FaultPlan``, ``LinkFault``, ``StragglerSpec``, ``as_fault_plan``) in
``ft.faults``, which imports only numpy and ``core.mixing``. Re-exports
are lazy, so building a plan never pulls in the gossip training stack.
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


def __getattr__(name: str):
    """Resolve re-exports on first access (PEP 562)."""
    if name in _ELASTIC:
        from repro_torch.ft import elastic

        return getattr(elastic, name)
    if name in _FAULTS:
        from repro_torch.ft import faults

        return getattr(faults, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
