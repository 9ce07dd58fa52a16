"""RibPolicy: match/action transform applied to computed routes.

Behavioral port of openr/decision/RibPolicy.{h,cpp}: statements match routes
by exact prefix; the set-weight action assigns per-area weights (weight 0
drops the nexthop); the policy expires after ttl seconds and Decision
re-applies routes when it does.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Set

from openr_tpu_torch.solver.routes import RibUnicastEntry
from openr_tpu_torch.types import IpPrefix, NextHop, replace


@dataclass
class SetWeightAction:
    """thrift::RibRouteActionWeight equivalent."""

    default_weight: int = 0
    area_to_weight: Dict[str, int] = field(default_factory=dict)


@dataclass
class RibPolicyStatement:
    name: str
    prefixes: Set[IpPrefix]
    action: SetWeightAction

    def __post_init__(self) -> None:
        if not self.prefixes:
            raise ValueError("policy statement requires match prefixes")

    def match(self, route: RibUnicastEntry) -> bool:
        return route.prefix in self.prefixes

    def apply_action(self, route: RibUnicastEntry) -> bool:
        if not self.match(route):
            return False
        new_nexthops: Set[NextHop] = set()
        for nh in route.nexthops:
            weight = self.action.default_weight
            if nh.area is not None:
                weight = self.action.area_to_weight.get(
                    nh.area, self.action.default_weight
                )
            if weight > 0:
                new_nexthops.add(replace(nh, weight=weight))
            # weight 0 drops the nexthop
        route.nexthops = new_nexthops
        return True


class RibPolicy:
    def __init__(
        self, statements: List[RibPolicyStatement], ttl_secs: float
    ) -> None:
        if not statements:
            raise ValueError("policy requires statements")
        self.statements = statements
        self._valid_until = time.monotonic() + ttl_secs

    def get_ttl_duration(self) -> float:
        return self._valid_until - time.monotonic()

    def is_active(self) -> bool:
        return self.get_ttl_duration() > 0

    def match(self, route: RibUnicastEntry) -> bool:
        return any(s.match(route) for s in self.statements)

    def apply_action(self, route: RibUnicastEntry) -> bool:
        for s in self.statements:
            if s.apply_action(route):
                return True
        return False

    # -- ctrl-plane (de)serialization (OpenrCtrl.thrift RibPolicy:84-123) --

    def to_dict(self) -> dict:
        return {
            "ttl_secs": max(0.0, self.get_ttl_duration()),
            "statements": [
                {
                    "name": s.name,
                    "prefixes": sorted(str(p) for p in s.prefixes),
                    "default_weight": s.action.default_weight,
                    "area_to_weight": dict(s.action.area_to_weight),
                }
                for s in self.statements
            ],
        }

    @staticmethod
    def from_dict(data: dict) -> "RibPolicy":
        statements = [
            RibPolicyStatement(
                name=s["name"],
                prefixes={IpPrefix(p) for p in s["prefixes"]},
                action=SetWeightAction(
                    default_weight=s.get("default_weight", 0),
                    area_to_weight=dict(s.get("area_to_weight", {})),
                ),
            )
            for s in data["statements"]
        ]
        return RibPolicy(statements, float(data["ttl_secs"]))
