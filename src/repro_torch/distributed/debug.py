"""The collectives a DTensor program issues, by kind, bytes and shape.

:func:`collective_log` is a ``torch.distributed.tensor.debug.CommDebugMode``
(its counts by op, ``get_comm_counts()``) that also keeps, for each
``_c10d_functional`` collective of this rank, its kind in the
reference's HLO names (:data:`COLLECTIVE_KINDS`), the local shape of its
input and the bytes of its result.  The dry-run's step counter reads the
same table.  Nothing happens at import.
"""

from __future__ import annotations

# ``_c10d_functional`` op -> the reference's HLO collective kind
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def collective_log():
    """A ``CommDebugMode`` whose ``records`` list ``(kind, input shape,
    result bytes)`` a collective, and whose ``by_kind()`` gives each
    kind's ``{"count", "bytes"}`` (result bytes summed)."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode

    class CollectiveLog(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.records: list[tuple[str, tuple, int]] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if (out is not NotImplemented
                    and not isinstance(func, torch._ops.HigherOrderOperator)
                    and func.namespace == "_c10d_functional"):
                kind = COLLECTIVE_KINDS.get(func._overloadpacket.__name__)
                if kind is not None:
                    self.records.append(
                        (kind, tuple(args[0].shape), int(out.nbytes)))
            return out

        def by_kind(self) -> dict[str, dict[str, int]]:
            out: dict[str, dict[str, int]] = {}
            for kind, _, n in self.records:
                c = out.setdefault(kind, {"count": 0, "bytes": 0})
                c["count"] += 1
                c["bytes"] += n
            return out

    return CollectiveLog()
