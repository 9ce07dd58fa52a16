"""BGP-style metric vector comparison.

Behavioral port of openr/common/Util.cpp MetricVectorUtils (:1051-1228):
entities sorted by descending priority are compared pairwise; an entity
present on only one side resolves by its CompareType ("loner" rules); a
tie-breaker entity can only produce TIE_WINNER/TIE_LOOSER, which a later
decisive (non-tiebreak) entity overrides.
"""

from __future__ import annotations

import enum
from typing import List, Optional, Sequence, Tuple

from openr_tpu_torch.types import CompareType, MetricEntity, MetricVector


class CompareResult(enum.Enum):
    WINNER = 4
    TIE_WINNER = 3
    TIE = 2
    TIE_LOOSER = 1
    LOOSER = 0
    ERROR = -1


def invert(r: CompareResult) -> CompareResult:
    return {
        CompareResult.WINNER: CompareResult.LOOSER,
        CompareResult.TIE_WINNER: CompareResult.TIE_LOOSER,
        CompareResult.TIE: CompareResult.TIE,
        CompareResult.TIE_LOOSER: CompareResult.TIE_WINNER,
        CompareResult.LOOSER: CompareResult.WINNER,
        CompareResult.ERROR: CompareResult.ERROR,
    }[r]


def is_decisive(r: CompareResult) -> bool:
    return r in (CompareResult.WINNER, CompareResult.LOOSER, CompareResult.ERROR)


def _sorted_metrics(mv: MetricVector) -> List[MetricEntity]:
    return sorted(mv.metrics, key=lambda e: -e.priority)


def compare_metrics(
    l: Sequence[int], r: Sequence[int], tie_breaker: bool
) -> CompareResult:
    if len(l) != len(r):
        return CompareResult.ERROR
    for lv, rv in zip(l, r):
        if lv > rv:
            return (
                CompareResult.TIE_WINNER if tie_breaker else CompareResult.WINNER
            )
        if lv < rv:
            return (
                CompareResult.TIE_LOOSER if tie_breaker else CompareResult.LOOSER
            )
    return CompareResult.TIE


def result_for_loner(entity: MetricEntity) -> CompareResult:
    if entity.op == CompareType.WIN_IF_PRESENT:
        return (
            CompareResult.TIE_WINNER
            if entity.is_best_path_tiebreaker
            else CompareResult.WINNER
        )
    if entity.op == CompareType.WIN_IF_NOT_PRESENT:
        return (
            CompareResult.TIE_LOOSER
            if entity.is_best_path_tiebreaker
            else CompareResult.LOOSER
        )
    return CompareResult.TIE  # IGNORE_IF_NOT_PRESENT


def _maybe_update(target: CompareResult, update: CompareResult) -> CompareResult:
    if is_decisive(update) or target == CompareResult.TIE:
        return update
    return target


def compare_metric_vectors(
    l: Optional[MetricVector], r: Optional[MetricVector]
) -> CompareResult:
    if l is None or r is None:
        return CompareResult.ERROR
    if l.version != r.version:
        return CompareResult.ERROR

    lm, rm = _sorted_metrics(l), _sorted_metrics(r)
    result = CompareResult.TIE
    i = j = 0
    while not is_decisive(result) and i < len(lm) and j < len(rm):
        le, re = lm[i], rm[j]
        if le.id == re.id:
            if le.is_best_path_tiebreaker != re.is_best_path_tiebreaker:
                result = _maybe_update(result, CompareResult.ERROR)
            else:
                result = _maybe_update(
                    result,
                    compare_metrics(
                        le.metric, re.metric, le.is_best_path_tiebreaker
                    ),
                )
            i += 1
            j += 1
        elif le.priority > re.priority:
            result = _maybe_update(result, result_for_loner(le))
            i += 1
        elif le.priority < re.priority:
            result = _maybe_update(result, invert(result_for_loner(re)))
            j += 1
        else:
            # same priority, different entity types
            result = _maybe_update(result, CompareResult.ERROR)
    while not is_decisive(result) and i < len(lm):
        result = _maybe_update(result, result_for_loner(lm[i]))
        i += 1
    while not is_decisive(result) and j < len(rm):
        result = _maybe_update(result, invert(result_for_loner(rm[j])))
        j += 1
    return result


def get_metric_entity_by_type(
    mv: MetricVector, entity_id: int
) -> Optional[MetricEntity]:
    for e in mv.metrics:
        if e.id == entity_id:
            return e
    return None


# Entity ids/priorities used when augmenting BGP vectors with IGP cost
# (thrift::MetricEntityType::OPENR_IGP_COST / MetricEntityPriority)
OPENR_IGP_COST_TYPE = 1
OPENR_IGP_COST_PRIORITY = 100


def create_igp_cost_entity(igp_metric: int) -> MetricEntity:
    """OPENR_IGP_COST entity: lower IGP metric wins (Decision.cpp:757-763)."""
    return MetricEntity(
        id=OPENR_IGP_COST_TYPE,
        priority=OPENR_IGP_COST_PRIORITY,
        op=CompareType.WIN_IF_NOT_PRESENT,
        is_best_path_tiebreaker=False,
        metric=(-igp_metric,),
    )
