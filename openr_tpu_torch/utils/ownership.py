"""Thread/task-ownership annotations for module state.

The daemon runs every module on one asyncio loop, but state is still
*owned*: each module's mutable attributes belong to that module's task set,
while the ctrl server's per-connection tasks (and the monitor's drain task)
reach into modules from outside. `owned_by` declares that ownership so the
static thread-ownership analyzer (openr_tpu/analysis/thread_ownership.py)
can flag externally-reachable methods that mutate owned state without a
declared handover.

Usage:

    @owned_by("decision-loop")          # class: who owns the state
    class Decision(...):
        ...
        # analysis: shared              # method: deliberately shared —
        def set_rib_policy(self, p):    # sync, so loop-serialized with the
            ...                         # owner's callbacks

The decorator is a runtime no-op (it only stamps ``__analysis_owner__``);
the convention is enforced at analysis time, not at run time. A method may
alternatively be decorated `@owned_by("ctrl")` instead of carrying the
`# analysis: shared` comment — both declare the same thing, and the
analyzer additionally requires such methods to be synchronous (an async
shared method could interleave with the owner at its awaits).
"""

from __future__ import annotations


def owned_by(owner: str):
    """Declare the owning loop/task of a class's state (class decorator) or
    declare a method safe to invoke from outside the owner (method
    decorator). Metadata only; see openr_tpu/analysis/thread_ownership.py."""

    def mark(obj):
        obj.__analysis_owner__ = owner
        return obj

    return mark
