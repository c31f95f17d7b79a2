"""Compressed-reduction subsystem of the port (``repro/comm``).

Pick a reducer by spec string (``HierAvgParams.reducer`` / plan levels):

    "mean"                dense full-precision mean
    "cast[:dtype]"        narrow payload dtype, default bfloat16
    "topk[:ratio]"        magnitude top-k of the delta, error feedback

A trailing ``:perleaf`` modifier pins the per-leaf pipeline (the only
one the port has); ``:serial`` pins the serial schedule.  Ported so far:
the per-leaf reductions.  ``:bucketed`` / ``:pipelined`` (the bucket
engine, ROADMAP Queue 1 item 3) and ``randk`` / ``qint8`` / ``powersgd``
(ROADMAP Queue 1 item 2) raise ``NotImplementedError``.
"""
from repro_torch.comm.reducer import (DEFAULT_BUCKET_BYTES,  # noqa: F401
                                      CastReducer, MeanReducer, Reducer,
                                      reduce_with, serial_reduce)
from repro_torch.comm.sparse import EFState, TopKReducer  # noqa: F401

REDUCER_NAMES = ("mean", "cast", "topk", "randk", "qint8", "powersgd")
_MODIFIERS = ("bucketed", "perleaf", "pipelined", "serial")
_NOT_PORTED = {
    "randk": "ROADMAP Queue 1 item 2", "qint8": "ROADMAP Queue 1 item 2",
    "powersgd": "ROADMAP Queue 1 item 2"}


def get_reducer(spec, **kw) -> Reducer:
    """Resolve a reducer from a spec string (or pass a Reducer through).

    ``kw`` (e.g. ``impl="plain"`` for top-k) overrides defaults.
    """
    if isinstance(spec, Reducer):
        return spec
    if spec is None:
        return MeanReducer()
    spec = str(spec)
    modifiers = []
    while True:                     # modifiers may stack (":perleaf:serial")
        head, _, tail = spec.rpartition(":")
        if head and tail in _MODIFIERS:
            spec = head
            modifiers.append(tail)
        else:
            break
    if "perleaf" in modifiers and ("pipelined" in modifiers
                                   or "bucketed" in modifiers):
        raise ValueError(
            f"contradictory modifiers {modifiers} on reducer spec "
            f"{spec!r}: ':perleaf' disables the packing ':pipelined'/"
            f"':bucketed' require")
    if "pipelined" in modifiers and "serial" in modifiers:
        raise ValueError(
            f"contradictory modifiers {modifiers} on reducer spec "
            f"{spec!r}: pick one of ':pipelined' / ':serial'")
    name, _, arg = spec.partition(":")
    if name == "mean":
        red = MeanReducer()
    elif name == "cast":
        red = CastReducer(arg or "bfloat16")
    elif name == "topk":
        red = TopKReducer(float(arg or 0.1), **kw)
    elif name in _NOT_PORTED:
        raise NotImplementedError(
            f"reducer {name!r} is not ported yet: {_NOT_PORTED[name]}")
    else:
        raise ValueError(
            f"unknown reducer spec {spec!r}; known: {REDUCER_NAMES} "
            f"(+ optional ':bucketed'/':perleaf' and "
            f"':pipelined'/':serial' modifiers)")
    if "bucketed" in modifiers or "pipelined" in modifiers:
        raise NotImplementedError(
            f"the bucket engine (':bucketed' / ':pipelined') is not ported "
            f"yet: ROADMAP Queue 1 item 3; use ':perleaf'")
    if "perleaf" in modifiers:
        red.bucket_opt_out = True
    if "serial" in modifiers:
        red.overlap_opt_out = True
    return red
