"""One structured ``explain()`` surface (port of
``repro.core.query.explain``).

``str(report)`` gives the one-line decision trail; ``as_dict()`` a stable
JSON-friendly mapping with the same key set as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ExplainReport:
    """Structured plan introspection."""

    kind: str
    backend: Optional[str] = None
    join_backend: Optional[str] = None
    agg_backend: Optional[str] = None
    serve_backend: Optional[str] = None
    plan_reason: str = ""
    trail: Tuple[str, ...] = ()
    shared_artifacts: Tuple[tuple, ...] = ()
    extras: Tuple[Tuple[str, object], ...] = ()

    def as_dict(self) -> dict:
        return {
            "kind": self.kind,
            "backend": self.backend,
            "join_backend": self.join_backend,
            "agg_backend": self.agg_backend,
            "serve_backend": self.serve_backend,
            "plan_reason": self.plan_reason,
            "trail": list(self.trail),
            "shared_artifacts": [list(k) for k in self.shared_artifacts],
            "extras": {k: v for k, v in self.extras},
        }

    def __str__(self) -> str:
        return "; ".join(p for p in (self.plan_reason, *self.trail) if p)
