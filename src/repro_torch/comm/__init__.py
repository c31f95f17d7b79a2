"""Compressed-reduction subsystem of the port (``repro/comm``).

Pick a reducer by spec string (``HierAvgParams.reducer`` / plan levels):

    "mean"                dense full-precision mean
    "cast[:dtype]"        narrow payload dtype, default bfloat16
    "topk[:ratio]"        magnitude top-k of the delta, error feedback
    "randk[:ratio]"       shared-support random-k, error feedback
    "qint8[:block]"       per-block int8 scale quantization (fused
                          single-buffer pack; ``:twopass`` pins the
                          two-message quantize path)
    "powersgd[:rank]"     PowerSGD low-rank factors, EF + warm-started Q

A trailing ``:bucketed`` / ``:perleaf`` modifier forces packing on or off
for that reducer (comm/bucket.py); without one, plan resolution
(core/plan.py) buckets the coordinate-wise codecs by default.  A trailing
``:pipelined`` / ``:serial`` modifier forces the bucket schedule; without
one, plan resolution pipelines bucketed reducers whenever the plan's
``overlap`` knob (default on) allows.  Modifiers may stack.
"""
from repro_torch.comm.reducer import (CastReducer, MeanReducer,  # noqa: F401
                                      Reducer, reduce_with, serial_reduce)
from repro_torch.comm.sparse import (EFState, RandKReducer,  # noqa: F401
                                     TopKReducer)
from repro_torch.comm.quant import QInt8Reducer  # noqa: F401
from repro_torch.comm.lowrank import (LowRankState,  # noqa: F401
                                      PowerSGDReducer)
from repro_torch.comm.bucket import (DEFAULT_BUCKET_BYTES,  # noqa: F401
                                     Bucketed, BucketLayout, Pipelined)

REDUCER_NAMES = ("mean", "cast", "topk", "randk", "qint8", "powersgd")
_MODIFIERS = ("bucketed", "perleaf", "pipelined", "serial")


def get_reducer(spec, **kw) -> Reducer:
    """Resolve a reducer from a spec string (or pass a Reducer through).

    ``kw`` (e.g. ``impl="plain"`` for topk / qint8 / powersgd) overrides
    defaults.
    """
    if isinstance(spec, Reducer):
        return spec
    if spec is None:
        return MeanReducer()
    spec = str(spec)
    modifiers = []
    while True:                     # modifiers may stack (":bucketed:serial")
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
    elif name == "randk":
        red = RandKReducer(float(arg or 0.1), **kw)
    elif name == "qint8":
        # "qint8[:block][:twopass]": ":twopass" pins the two-message path
        if arg == "twopass" or arg.endswith(":twopass"):
            kw.setdefault("fused", False)
            arg = arg[:-len("twopass")].rstrip(":")
        red = QInt8Reducer(int(arg or 256), **kw)
    elif name == "powersgd":
        red = PowerSGDReducer(int(arg or 2), **kw)
    else:
        raise ValueError(
            f"unknown reducer spec {spec!r}; known: {REDUCER_NAMES} "
            f"(+ optional ':bucketed'/':perleaf' and "
            f"':pipelined'/':serial' modifiers)")
    if "perleaf" in modifiers:
        red.bucket_opt_out = True
        if "serial" in modifiers:
            red.overlap_opt_out = True
        return red
    if "pipelined" in modifiers:
        wrapped = Pipelined(red)
        wrapped.pipeline_pin = True   # plan resolution keeps it pipelined
        return wrapped
    if "bucketed" in modifiers:
        wrapped = Bucketed(red)
        if "serial" in modifiers:
            wrapped.overlap_opt_out = True
        return wrapped
    if "serial" in modifiers:
        # schedule pin on the raw reducer: plan resolution may still
        # auto-bucket it, but keeps the serial engine
        red.overlap_opt_out = True
    return red
